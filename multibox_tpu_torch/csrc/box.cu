// Box decode / encode (MultiBox residual parameterization) for sm_90a.
//
// Replaces _decode_kernel / _encode_kernel (via _run_elementwise) of
// multibox_tpu/ops/pallas/box_kernel.py:
//   decode: out[r][p] = clip?(prior[p] + offset[r][p], 0, 1)
//   encode: out[r][p] = gt[r][p] - prior[p]
// for boxes [rows, P, 4] and priors [P, 4]: the broadcast over the leading
// dimensions is the row loop, never a materialised copy.
//
// What bounds it: bytes (two 16-byte reads and one 16-byte write a box for
// four flops). The first version gave each thread one float and found the prior
// with a 64-bit `i % period`, which the card computes in software, dozens of
// instructions an element. Now each thread takes one whole box with 16-byte
// loads and stores; a 2-D grid puts x over the P boxes of a prior set and y
// over the rows, so the prior's index is the thread's x index and the row
// offset a multiply (no division anywhere), and a thread loads its prior
// once for all the rows it visits (a grid-stride loop over y past 65,535
// rows). The wrapper plans the grid and checks the 16-byte alignment that
// float4 accesses need. At small sizes the floor is the launch and one
// round trip to memory.
//
// Plain C interface: pointers are device pointers, `stream` is a
// cudaStream_t. Each entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

extern "C" const char* mbx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace {

constexpr unsigned kThreads = 256;
constexpr unsigned kMaxGridY = 65535;

enum Mode { kEncode = 0, kDecode = 1, kDecodeClip = 2 };

template <int kMode>
__global__ void __launch_bounds__(kThreads)
box_kernel(const float4* __restrict__ a, const float4* __restrict__ pri,
           float4* __restrict__ out, int P, long long rows) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const float4 q = pri[p];
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const size_t i = static_cast<size_t>(r) * P + p;
    const float4 v = a[i];
    float4 o;
    if (kMode == kEncode) {
      o = make_float4(__fsub_rn(v.x, q.x), __fsub_rn(v.y, q.y), __fsub_rn(v.z, q.z),
                      __fsub_rn(v.w, q.w));
    } else {
      // One rounded f32 add each, and a compare-select clip through which a
      // NaN passes, as torch.clamp lets it.
      o = make_float4(__fadd_rn(q.x, v.x), __fadd_rn(q.y, v.y), __fadd_rn(q.z, v.z),
                      __fadd_rn(q.w, v.w));
      if (kMode == kDecodeClip) {
        o.x = o.x < 0.0f ? 0.0f : (o.x > 1.0f ? 1.0f : o.x);
        o.y = o.y < 0.0f ? 0.0f : (o.y > 1.0f ? 1.0f : o.y);
        o.z = o.z < 0.0f ? 0.0f : (o.z > 1.0f ? 1.0f : o.z);
        o.w = o.w < 0.0f ? 0.0f : (o.w > 1.0f ? 1.0f : o.w);
      }
    }
    out[i] = o;
  }
}

template <int kMode>
int launch(const void* a, const void* pri, void* out, int P, long long rows,
           unsigned grid_x, unsigned grid_y, void* stream) {
  if (P <= 0 || rows <= 0) return 0;
  if (static_cast<long long>(grid_x) * kThreads < P || grid_y == 0 || grid_y > kMaxGridY ||
      grid_y > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  box_kernel<kMode><<<dim3(grid_x, grid_y), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(a), static_cast<const float4*>(pri),
      static_cast<float4*>(out), P, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, out: [rows, P, 4] f32; pri: [P, 4] f32; all 16-byte aligned. The grid
// (blocks of 256 threads, grid_x * 256 >= P, 1 <= grid_y <= min(rows, 65535))
// comes from the wrapper's plan.
extern "C" int mbx_box_decode(const void* off, const void* pri, void* out, int P,
                              long long rows, unsigned grid_x, unsigned grid_y, int clip,
                              void* stream) {
  return clip ? launch<kDecodeClip>(off, pri, out, P, rows, grid_x, grid_y, stream)
              : launch<kDecode>(off, pri, out, P, rows, grid_x, grid_y, stream);
}

extern "C" int mbx_box_encode(const void* gt, const void* pri, void* out, int P,
                              long long rows, unsigned grid_x, unsigned grid_y,
                              void* stream) {
  return launch<kEncode>(gt, pri, out, P, rows, grid_x, grid_y, stream);
}
