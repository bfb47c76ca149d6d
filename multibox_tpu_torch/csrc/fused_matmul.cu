// Fused matmul + bias + ReLU for sm_90a:  out = relu?(x @ w + b)
//
//   x [M, K] row-major, w [K, N] row-major (f32 or bf16), b [N] f32,
//   out [M, N] in x's type. f32 accumulation, f32 bias add, optional ReLU
//   and the cast to the output type all happen in the epilogue, so the
//   pre-activation never goes to device memory.
//
// A tiled shared-memory GEMM on the CUDA cores: 64x64 output tile per
// block of 256 threads, K walked 16 at a time, a 4x4 micro-tile of f32
// accumulators per thread. Ragged M, N and K are masked in the loads and
// the stores; no padded copies of x or w are made. bf16 inputs are widened
// with __bfloat162float as they are staged into shared memory.
//
// What bounds it: with M in the thousands (the bottleneck layer and the
// folded 1x1 units) the product is bound by operations, and this simple
// kernel runs on the f32 pipes, not the tensor cores; with M = batch size
// (the two fully connected layers) it is bound by reading w once, and a
// 64-row tile then launches only N/64 blocks. Both are left as they are:
// the kernel is the simple, right one.
//
// Plain C interface; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ out,
                    int M, int K, int N, int relu) {
  // As is stored k-major (transposed) so the inner loop reads a column of
  // the x tile contiguously; +1 pads away the bank conflicts of that store.
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // column group
  const int ty = tid / (BN / TN);  // row group
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: BM x BK, neighbouring threads along k.
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K)
                     ? to_float(x[static_cast<size_t>(gm) * K + gk])
                     : 0.0f;
    }
    // w tile: BK x BN, neighbouring threads along n.
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N)
                     ? to_float(w[static_cast<size_t>(gk) * N + gn])
                     : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: bias, ReLU, cast, masked store.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      float v = acc[i][j] + bias[gn];
      if (relu) v = fmaxf(v, 0.0f);
      store(out + static_cast<size_t>(gm) * N + gn, v);
    }
  }
}

}  // namespace

extern "C" int mbx_fused_matmul(const void* x, const void* w, const void* b,
                                void* out, int M, int K, int N, int relu,
                                int is_bf16, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    fused_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(b),
        static_cast<__nv_bfloat16*>(out), M, K, N, relu);
  } else {
    fused_matmul_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(out), M, K, N, relu);
  }
  return static_cast<int>(cudaGetLastError());
}
