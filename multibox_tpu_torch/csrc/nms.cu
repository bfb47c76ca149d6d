// Batched hard NMS + top-k for sm_90a. One thread block per image.
//
// K rounds; each round takes the live box with the highest score (lowest
// index on ties), records (index, score), then kills the winner and every
// box whose IoU with it exceeds the threshold. Boxes under score_threshold
// never live. Slots left over keep index -1 and score -1.
//
// What bounds it: neither bytes nor flops. An image moves P*20 B in and
// K*8 B out; the floor is the K dependent rounds, each a block-wide
// argmax plus two barriers. So the design keeps everything a round touches
// in shared memory (live score and the four coordinates of every box,
// 20 B per box, up to the 227 KB a block may use), reduces with warp
// shuffles, uses two __syncthreads() per round, and stops at the first
// round that finds nothing live.
//
// Arithmetic is held to the plain PyTorch version op for op, each a
// correctly rounded f32 operation (no FMA contraction, IEEE division), so
// a box that sits on the threshold falls on the same side in both:
//   area  = max(y1-y0,0) * max(x1-x0,0)
//   inter = max(min(y1,by1)-max(y0,by0),0) * max(min(x1,bx1)-max(x0,bx0),0)
//   union = (area_best + area_i) - inter
//   iou   = union > 0 ? inter / max(union, 1e-8) : 0;  suppress if iou > thr
// This file is compiled with -fmad=false as well.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr float kEps = 1e-8f;

struct Best {
  float v;
  int i;
};

// Higher score wins; on equal scores the lower index wins.
__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__global__ void __launch_bounds__(kMaxThreads) nms_kernel(const float* __restrict__ boxes,   // [B, P, 4]
                           const float* __restrict__ scores,  // [B, P]
                           int* __restrict__ sel_idx,         // [B, K]
                           float* __restrict__ sel_scores,    // [B, K]
                           int P, int K, float iou_thr, float score_thr) {
  extern __shared__ float4 smem4[];
  float4* sbox = smem4;                                   // [P]
  float* live = reinterpret_cast<float*>(smem4 + P);      // [P]
  __shared__ float warp_v[32];
  __shared__ int warp_i[32];

  const int img = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nthreads + 31) >> 5;

  const float* gbox = boxes + static_cast<size_t>(img) * P * 4;
  const float* gscore = scores + static_cast<size_t>(img) * P;
  int* out_idx = sel_idx + static_cast<size_t>(img) * K;
  float* out_score = sel_scores + static_cast<size_t>(img) * K;

  for (int i = tid; i < P; i += nthreads) {
    sbox[i] = make_float4(gbox[4 * i], gbox[4 * i + 1], gbox[4 * i + 2],
                          gbox[4 * i + 3]);
    float s = gscore[i];
    // -inf marks a dead box; a NaN score fails the comparison and is dead.
    live[i] = (s >= score_thr) ? s : -CUDART_INF_F;
  }
  for (int k = tid; k < K; k += nthreads) {
    out_idx[k] = -1;
    out_score[k] = -1.0f;
  }
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    // Block-wide (max score, lowest index).
    Best best{-CUDART_INF_F, 0x7fffffff};
    for (int i = tid; i < P; i += nthreads) {
      float v = live[i];
      if (v > best.v) best = Best{v, i};  // ascending i: first max is kept
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      Best o{__shfl_down_sync(0xffffffffu, best.v, d),
             __shfl_down_sync(0xffffffffu, best.i, d)};
      best = better(best, o);
    }
    if (lane == 0) {
      warp_v[warp] = best.v;
      warp_i[warp] = best.i;
    }
    __syncthreads();
    // Every warp reduces the per-warp winners itself: no broadcast barrier.
    best = (lane < nwarps) ? Best{warp_v[lane], warp_i[lane]}
                           : Best{-CUDART_INF_F, 0x7fffffff};
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      Best o{__shfl_xor_sync(0xffffffffu, best.v, d),
             __shfl_xor_sync(0xffffffffu, best.i, d)};
      best = better(best, o);
    }
    // Nothing live (the same value in every thread): later rounds would
    // find nothing either, and their slots already hold -1.
    if (!(best.v > -CUDART_INF_F)) break;

    if (tid == 0) {
      out_idx[k] = best.i;
      out_score[k] = best.v;
    }
    const float4 bb = sbox[best.i];
    const float barea = box_area(bb);
    for (int i = tid; i < P; i += nthreads) {
      const float4 b = sbox[i];
      const float ih =
          fmaxf(__fsub_rn(fminf(b.z, bb.z), fmaxf(b.x, bb.x)), 0.0f);
      const float iw =
          fmaxf(__fsub_rn(fminf(b.w, bb.w), fmaxf(b.y, bb.y)), 0.0f);
      const float inter = __fmul_rn(ih, iw);
      const float uni = __fsub_rn(__fadd_rn(barea, box_area(b)), inter);
      const float iou =
          (uni > 0.0f) ? __fdiv_rn(inter, fmaxf(uni, kEps)) : 0.0f;
      if (iou > iou_thr || i == best.i) live[i] = -CUDART_INF_F;
    }
    __syncthreads();  // live[] and warp_v/warp_i are free for the next round
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue when P
// does not fit the block's shared memory.
extern "C" int mbx_nms(const void* boxes, const void* scores, void* sel_idx,
                       void* sel_scores, int B, int P, int K, float iou_thr,
                       float score_thr, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(P) * (sizeof(float4) + sizeof(float));
  // 227 KB a block, less the static arrays above.
  if (smem + 512 > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int threads = ((P + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  nms_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<int*>(sel_idx), static_cast<float*>(sel_scores), P, K,
      iou_thr, score_thr);
  return static_cast<int>(cudaGetLastError());
}
