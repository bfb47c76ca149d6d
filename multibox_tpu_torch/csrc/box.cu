// Box decode / encode (MultiBox residual parameterization) for sm_90a.
//
//   decode: out[i] = clip?(prior[i % period] + offset[i], 0, 1)
//   encode: out[i] = gt[i] - prior[i % period]
//
// `period` is the element count of the prior tensor; the broadcast over the
// leading batch dimensions is the modulo, never a materialised copy.
// Bound by bytes (2 reads + 1 write of 4 B per element, 1 flop): one thread
// per element, neighbouring threads on neighbouring addresses.
//
// Plain C interface: pointers are device pointers, `stream` is a
// cudaStream_t. Each entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

extern "C" const char* mbx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace {

constexpr int kThreads = 256;

__global__ void box_decode_kernel(const float* __restrict__ off,
                                  const float* __restrict__ pri,
                                  float* __restrict__ out, long long n,
                                  long long period, int clip) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // Written as add-then-compare so that the sum is one rounded f32 add and
  // a NaN passes through the clip, as torch.clamp lets it.
  float v = __fadd_rn(pri[i % period], off[i]);
  if (clip) v = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
  out[i] = v;
}

__global__ void box_encode_kernel(const float* __restrict__ gt,
                                  const float* __restrict__ pri,
                                  float* __restrict__ out, long long n,
                                  long long period) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = __fsub_rn(gt[i], pri[i % period]);
}

}  // namespace

extern "C" int mbx_box_decode(const void* off, const void* pri, void* out,
                              long long n, long long period, int clip,
                              void* stream) {
  if (n <= 0) return 0;
  unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  box_decode_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(off), static_cast<const float*>(pri),
      static_cast<float*>(out), n, period, clip);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mbx_box_encode(const void* gt, const void* pri, void* out,
                              long long n, long long period, void* stream) {
  if (n <= 0) return 0;
  unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  box_encode_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gt), static_cast<const float*>(pri),
      static_cast<float*>(out), n, period);
  return static_cast<int>(cudaGetLastError());
}
