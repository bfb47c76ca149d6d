// Fused matmul + bias + ReLU for sm_90a:  out = relu?(x @ w + b)
//
//   x [M, K] row-major, w [K, N] row-major (f32 or bf16), b [N] f32,
//   out [M, N] in x's type. f32 accumulation, f32 bias add, optional ReLU
//   and the cast to the output type happen in an epilogue, so the
//   pre-activation is never written as a finished [M, N] tensor.
//
// Replaces fused_matmul_bias_relu of multibox_tpu/ops/pallas/fused_matmul.py.
// The shapes the port runs are limited by different things, so the caller
// (ops/kernels/fused_matmul.py::_plan) picks one of four routes from
// (M, K, N, dtype) before the launch and passes the route, the split along
// K and the slice length here:
//
// 1 skinny (f32, M <= 64: the two FC layers at batch 32). Bound by reading
//   w once (25 MB for Locations). A block owns a 128-column tile and one
//   slice of K; there are enough slices for two blocks an SM. x and w
//   come through a 3-stage cp.async ring of 16-byte copies; a thread holds
//   an MR x 4 micro-tile (MR = M rounded up to 8 rows, / 8).
// 2 tall f32 (f32, M >= 512: the Bottleneck, 2048 x 2048 x 96). Bound by
//   f32 operations. A register-blocked SIMT kernel, the same code as 1
//   with a 128 x 96 tile and an 8 x 6 micro-tile, split along K until at
//   least 128 blocks run. Chosen over 3xTF32 on the tensor cores because
//   it keeps plain f32 products (TF32 stays off in the port) and shares
//   one kernel with route 1; the f32 bound is 12 us against a split-K
//   SIMT kernel's expected 15-20.
//   Routes 1 and 2 write each slice's partial sums to an f32 workspace
//   [S, M, N] (the wrapper owns it); a second kernel sums the slices in a
//   fixed order and applies bias, ReLU and the store. No float atomics:
//   the same inputs give the same bits on every launch. With S = 1 the
//   first kernel's epilogue does it and the second is not launched.
// 3 tall bf16 (bf16, K and N multiples of 8: the folded 1x1 units). Bound
//   by reading x once. Tensor cores through mma.sync.m16n8k16 (bf16 in,
//   f32 accumulate): 128-row tiles, the whole output width in one tile up
//   to N = 128 (64 columns beyond), a 3-stage cp.async ring of 64-wide K
//   steps (128-byte rows of x), ldmatrix fragment loads, and an epilogue
//   that stages the bf16 tile in shared memory for 16-byte stores. Where
//   the tiles fill a quarter of the SMs or less (the 8x8 units at small
//   batches) it is split along K like routes 1 and 2, and the second
//   kernel casts to bf16.
// 0 general: the first port's kernel, for what no fast route takes (K or N
//   not a multiple of the 16-byte row, f32 with 64 < M < 512). A 64 x 64
//   tile of f32 FMAs, ragged M, N and K masked in the loads.
//
// Plain C interface; returns cudaGetLastError() after the last launch,
// cudaErrorInvalidValue for arguments the route does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Route { kGeneral = 0, kSkinny = 1, kTallF32 = 2, kTallBf16 = 3 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with pred false the destination is
// zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 16-byte copies one thread makes, stage after stage, of a tile of
// ROWS rows x CPR chunks of a row-major matrix. Between stages the tile
// moves only along K (the columns of x, the rows of w), so each copy's
// source, destination and bounds test are worked out once, and a stage
// costs an add and a compare a copy.
template <typename T, int ROWS, int CPR, int THREADS>
struct TileCopy {
  static constexpr int kE = 16 / static_cast<int>(sizeof(T));  // elements a chunk
  static constexpr int kChunks = ROWS * CPR;
  static constexpr int kPer = (kChunks + THREADS - 1) / THREADS;
  const T* src[kPer];  // at the slice's first K
  int dst[kPer];       // in the stage, in elements; -1: no copy of this thread
  int k[kPer];         // the copy's own offset along K
  bool ok[kPer];       // inside the matrix, K apart

  // x [M, ld]: rows m0 + r, columns kbeg + chunk; K runs along the row.
  static __device__ TileCopy of_x(const T* x, int ld, int m0, int M, int kbeg, int stride,
                                  int tid) {
    TileCopy t;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / CPR, kc = (c % CPR) * kE;
      t.ok[i] = c < kChunks && m0 + r < M;
      t.src[i] = t.ok[i] ? x + static_cast<size_t>(m0 + r) * ld + kbeg + kc : x;
      t.dst[i] = c < kChunks ? r * stride + kc : -1;
      t.k[i] = kc;
    }
    return t;
  }
  // w [K, ld]: rows kbeg + r, columns n0 + chunk; K runs down the rows.
  static __device__ TileCopy of_w(const T* w, int ld, int kbeg, int n0, int N, int stride,
                                  int tid) {
    TileCopy t;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / CPR, nc = (c % CPR) * kE;
      t.ok[i] = c < kChunks && n0 + nc < N;
      t.src[i] = t.ok[i] ? w + static_cast<size_t>(kbeg + r) * ld + n0 + nc : w;
      t.dst[i] = c < kChunks ? r * stride + nc : -1;
      t.k[i] = r;
    }
    return t;
  }
  // The stage kk elements of K into the slice (klen long); step = how far
  // one element of K moves the source (1 for x, ld for w). Past the
  // slice or the matrix the stage is zero-filled.
  __device__ __forceinline__ void copy(T* stage, const T* base, int kk, int klen,
                                       size_t step) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (kChunks % THREADS != 0 && dst[i] < 0) continue;
      const bool live = ok[i] && k[i] + kk < klen;
      cp_async16(stage + dst[i], live ? src[i] + kk * step : base, live);
    }
  }
};

// ---------------------------------------------------------------- route 0

constexpr int GBM = 64;
constexpr int GBN = 64;
constexpr int GBK = 16;
constexpr int GTM = 4;
constexpr int GTN = 4;
constexpr int kGeneralThreads = (GBM / GTM) * (GBN / GTN);  // 256

template <typename T>
__global__ void __launch_bounds__(kGeneralThreads)
general_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ out,
               int M, int K, int N, int relu) {
  // As is stored k-major (transposed) so the inner loop reads a column of
  // the x tile contiguously; +1 pads away the bank conflicts of that store.
  __shared__ float As[GBK][GBM + 1];
  __shared__ float Bs[GBK][GBN];

  const int tid = threadIdx.x;
  const int tx = tid % (GBN / GTN);
  const int ty = tid / (GBN / GTN);
  const int m0 = blockIdx.x * GBM;
  const int n0 = blockIdx.y * GBN;

  float acc[GTM][GTN];
#pragma unroll
  for (int i = 0; i < GTM; ++i)
#pragma unroll
    for (int j = 0; j < GTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += GBK) {
    for (int e = tid; e < GBM * GBK; e += kGeneralThreads) {
      const int r = e / GBK, c = e % GBK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K)
                     ? to_float(x[static_cast<size_t>(gm) * K + gk])
                     : 0.0f;
    }
    for (int e = tid; e < GBK * GBN; e += kGeneralThreads) {
      const int r = e / GBN, c = e % GBN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N)
                     ? to_float(w[static_cast<size_t>(gk) * N + gn])
                     : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      float a[GTM], b[GTN];
#pragma unroll
      for (int i = 0; i < GTM; ++i) a[i] = As[kk][ty * GTM + i];
#pragma unroll
      for (int j = 0; j < GTN; ++j) b[j] = Bs[kk][tx * GTN + j];
#pragma unroll
      for (int i = 0; i < GTM; ++i)
#pragma unroll
        for (int j = 0; j < GTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < GTM; ++i) {
    const int gm = m0 + ty * GTM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < GTN; ++j) {
      const int gn = n0 + tx * GTN + j;
      if (gn >= N) continue;
      float v = acc[i][j] + bias[gn];
      if (relu) v = fmaxf(v, 0.0f);
      store(out + static_cast<size_t>(gm) * N + gn, v);
    }
  }
}

// ------------------------------------------------------- routes 1 and 2

constexpr int kThreads = 256;
constexpr int SBK = 32;      // K rows a ring stage holds
constexpr int kStages = 3;

template <int BM, int BN>
constexpr int splitk_smem_bytes() {
  return kStages * (BM * (SBK + 4) + SBK * BN) * 4;
}

// Block (tile_m, tile_n, slice): the [BM, BN] tile of x[:, slice] @
// w[slice, :]. Thread (ty, tx) owns rows ty + i*(BM/TM) and columns
// tx*TN + j. K, N and the slice bounds are multiples of 4, so a 16-byte
// chunk lies wholly inside or outside; outside ones are zero-filled.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
splitk_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ out,
              float* __restrict__ ws, int M, int K, int N, int kslice,
              int relu, int tiles_on_x_are_n) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "256 threads");
  static_assert(TN == 4 || TN == 6, "column micro-tile of 4 or 6");
  constexpr int AS = SBK + 4;  // x tile row stride: float4-aligned, 2 rows conflict-free
  constexpr int RS = BM / TM;  // stride between a thread's rows
  constexpr int CX = BN / TN;  // threads along N
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                           // [kStages][BM][AS]
  float* Bs = smem + kStages * BM * AS;       // [kStages][SBK][BN]

  const int tid = threadIdx.x;
  const int tx = tid % CX;
  const int ty = tid / CX;
  const int tile_m = tiles_on_x_are_n ? blockIdx.y : blockIdx.x;
  const int tile_n = tiles_on_x_are_n ? blockIdx.x : blockIdx.y;
  const int m0 = tile_m * BM;
  const int n0 = tile_n * BN;
  const int s = blockIdx.z;
  const int kbeg = s * kslice;
  const int kend = min(K, kbeg + kslice);
  const int nchunks = (kend - kbeg + SBK - 1) / SBK;

  const auto xa = TileCopy<float, BM, SBK / 4, kThreads>::of_x(x, K, m0, M, kbeg, AS, tid);
  const auto wb = TileCopy<float, SBK, BN / 4, kThreads>::of_w(w, N, kbeg, n0, N, BN, tid);
  const int klen = kend - kbeg;
  auto load = [&](int chunk, int stage) {
    xa.copy(As + stage * BM * AS, x, chunk * SBK, klen, 1);
    wb.copy(Bs + stage * SBK * BN, w, chunk * SBK, klen, static_cast<size_t>(N));
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nchunks) load(st, st);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c landed; stage (c-1) % kStages is free
    if (c + kStages - 1 < nchunks) load(c + kStages - 1, (c + kStages - 1) % kStages);
    cp_async_commit();
    const float* a = As + (c % kStages) * BM * AS;
    const float* b = Bs + (c % kStages) * SBK * BN;
#pragma unroll
    for (int kk = 0; kk < SBK; kk += 4) {
      float av[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(a + (ty + i * RS) * AS + kk);
        av[i][0] = v.x; av[i][1] = v.y; av[i][2] = v.z; av[i][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float bv[TN];
        const float* brow = b + (kk + q) * BN + tx * TN;
        if constexpr (TN == 4) {
          const float4 v = *reinterpret_cast<const float4*>(brow);
          bv[0] = v.x; bv[1] = v.y; bv[2] = v.z; bv[3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < TN; j += 2) {
            const float2 v = *reinterpret_cast<const float2*>(brow + j);
            bv[j] = v.x; bv[j + 1] = v.y;
          }
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i][q], bv[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

  // N is a multiple of 4: a column pair (TN = 6) or quad (TN = 4) is wholly
  // inside or outside.
  float* dst = ws ? ws + static_cast<size_t>(s) * M * N : out;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * RS;
    if (m >= M) continue;
    float* row = dst + static_cast<size_t>(m) * N;
#pragma unroll
    for (int j = 0; j < TN; j += (TN == 4 ? 4 : 2)) {
      const int n = n0 + tx * TN + j;
      if (n >= N) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < (TN == 4 ? 4 : 2); ++e) {
        v[e] = acc[i][j + e];
        if (!ws) {
          v[e] += bias[n + e];
          if (relu) v[e] = fmaxf(v[e], 0.0f);
        }
      }
      if constexpr (TN == 4) {
        *reinterpret_cast<float4*>(row + n) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        *reinterpret_cast<float2*>(row + n) = make_float2(v[0], v[1]);
      }
    }
  }
}

// out[m, n] = act(bias[n] + sum_s ws[s, m, n]). A block owns 32 float4
// outputs; its 8 warps take the slices s = warp, warp + 8, ... each in
// ascending order, then warp 0 adds the 8 partial sums in warp order. The
// order is fixed by (S, the output's index): bit-equal on every launch.
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
splitk_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                     T* __restrict__ out, long long MN4, int N, int S, int relu) {
  __shared__ float4 part[kThreads / 32][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long idx = static_cast<long long>(blockIdx.x) * 32 + lane;
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (idx < MN4) {
#pragma unroll 4
    for (int s = warp; s < S; s += kThreads / 32) {
      const float4 v = w4[static_cast<size_t>(s) * MN4 + idx];
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp != 0 || idx >= MN4) return;
  float4 t = part[0][lane];
#pragma unroll
  for (int g = 1; g < kThreads / 32; ++g) {
    const float4 v = part[g][lane];
    t.x += v.x; t.y += v.y; t.z += v.z; t.w += v.w;
  }
  const int n = static_cast<int>((idx * 4) % N);
  float r[4] = {t.x + bias[n], t.y + bias[n + 1], t.z + bias[n + 2], t.w + bias[n + 3]};
  if (relu) {
#pragma unroll
    for (int e = 0; e < 4; ++e) r[e] = fmaxf(r[e], 0.0f);
  }
  store4(out + idx * 4, r);
}

// ---------------------------------------------------------------- route 3

constexpr int HBM = 128;  // rows of a tile: a warp per 16
constexpr int HBK = 64;   // K of a ring stage (k16 steps): 128-byte rows of x
constexpr int HStages = 3;
constexpr int HThreads = HBM / 16 * 32;
constexpr int HAS = HBK + 8;  // x tile row stride in bf16: 144 B, ldmatrix conflict-free

template <int BN>
constexpr int bf16_smem_bytes() {
  return HStages * (HBM * HAS + HBK * (BN + 8)) * 2;
}

__device__ __forceinline__ void ldmatrix_x4(unsigned& r0, unsigned& r1, unsigned& r2,
                                            unsigned& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned& r0, unsigned& r1, unsigned& r2,
                                                  unsigned& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float* c, unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Block (tile_m, tile_n): out[HBM rows, BN cols]. Warp w owns rows
// 16w..16w+15 and all BN columns (BN/8 m16n8 accumulators). K and N are
// multiples of 8, so a 16-byte chunk is wholly inside or outside.
template <int BN>
__global__ void __launch_bounds__(HThreads)
bf16_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                float* __restrict__ ws, int M, int K, int N, int kslice, int relu) {
  static_assert(BN % 16 == 0 && BN <= 128, "BN a multiple of 16, at most 128");
  constexpr int BS = BN + 8;  // w tile row stride in bf16
  constexpr int NT = BN / 8;  // n8 tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [HStages][HBM][HAS]
  __nv_bfloat16* Bs = As + HStages * HBM * HAS;                        // [HStages][HBK][BS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * HBM;
  const int n0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * kslice;
  const int kend = min(K, kbeg + kslice);
  const int nchunks = (kend - kbeg + HBK - 1) / HBK;

  const auto xa = TileCopy<__nv_bfloat16, HBM, HBK / 8, HThreads>::of_x(x, K, m0, M, kbeg,
                                                                         HAS, tid);
  const auto wb = TileCopy<__nv_bfloat16, HBK, BN / 8, HThreads>::of_w(w, N, kbeg, n0, N, BS,
                                                                       tid);
  const int klen = kend - kbeg;
  auto load = [&](int chunk, int stage) {
    xa.copy(As + stage * HBM * HAS, x, chunk * HBK, klen, 1);
    wb.copy(Bs + stage * HBK * BS, w, chunk * HBK, klen, static_cast<size_t>(N));
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

#pragma unroll
  for (int st = 0; st < HStages - 1; ++st) {
    if (st < nchunks) load(st, st);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<HStages - 2>();
    __syncthreads();
    if (c + HStages - 1 < nchunks) load(c + HStages - 1, (c + HStages - 1) % HStages);
    cp_async_commit();
    const __nv_bfloat16* a = As + (c % HStages) * HBM * HAS;
    const __nv_bfloat16* b = Bs + (c % HStages) * HBK * BS;
#pragma unroll
    for (int kb = 0; kb < HBK; kb += 16) {
      unsigned a0, a1, a2, a3;
      // matrices: rows 0-7 / 8-15 of the warp's 16, k 0-7 / 8-15
      ldmatrix_x4(a0, a1, a2, a3, a + (warp * 16 + (lane & 15)) * HAS + kb + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        unsigned b0, b1, b2, b3;
        // matrices: k 0-7 / 8-15 of n8 tile j, then of tile j + 1
        ldmatrix_x4_trans(b0, b1, b2, b3,
                          b + (kb + (lane & 7) + ((lane >> 3) & 1) * 8) * BS + j * 8 +
                              (lane >> 4) * 8);
        mma_bf16(acc[j], a0, a1, a2, a3, b0, b1);
        mma_bf16(acc[j + 1], a0, a1, a2, a3, b2, b3);
      }
    }
  }
  cp_async_wait<0>();
  // accumulator (g = lane/4, t = lane%4): rows g and g+8, columns 2t, 2t+1
  const int g = lane >> 2, t = lane & 3;
  if (ws) {  // a slice of a split: raw f32 partial sums to the workspace
    float* part = ws + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + warp * 16 + g + 8 * h;
        if (m < M && n < N)
          *reinterpret_cast<float2*>(part + static_cast<size_t>(m) * N + n) =
              make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
    return;
  }
  __syncthreads();  // the ring is free: stage the output tile there
  __nv_bfloat16* Cs = As;  // [HBM][BS]
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = j * 8 + 2 * t;
    const float b0 = (n0 + col < N) ? bias[n0 + col] : 0.0f;
    const float b1 = (n0 + col + 1 < N) ? bias[n0 + col + 1] : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[j][2 * h] + b0, v1 = acc[j][2 * h + 1] + b1;
      if (relu) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      }
      *reinterpret_cast<__nv_bfloat162*>(Cs + (warp * 16 + g + 8 * h) * BS + col) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  __syncthreads();
  for (int c = tid; c < HBM * (BN / 8); c += HThreads) {
    const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    if (m0 + r < M && n0 + nc < N) {
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(m0 + r) * N + n0 + nc) =
          *reinterpret_cast<const uint4*>(Cs + r * BS + nc);
    }
  }
}

// Dynamic shared memory above 48 KB has to be granted per kernel and
// device; remember which were.
template <typename F>
cudaError_t allow_smem(F* kernel, int bytes, bool* done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

// After the main kernel: with a split, the fixed-order sum of the slices.
template <typename T>
int finish_split(const float* ws, const float* b, T* out, int M, int N, int relu, int split,
                 cudaStream_t s) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split <= 1) return static_cast<int>(e);
  const long long mn4 = static_cast<long long>(M) * N / 4;
  const long long blocks = (mn4 + 31) / 32;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  splitk_reduce_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      ws, b, out, mn4, N, split, relu);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int TM, int TN>
int launch_splitk(const float* x, const float* w, const float* b, float* out, float* ws,
                  int M, int K, int N, int relu, int split, int kslice, bool n_on_x,
                  cudaStream_t s) {
  static bool done[64];
  constexpr int smem = splitk_smem_bytes<BM, BN>();
  auto kernel = splitk_kernel<BM, BN, TM, TN>;
  cudaError_t e = allow_smem(kernel, smem, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned mt = (M + BM - 1) / BM, nt = (N + BN - 1) / BN;
  dim3 grid(n_on_x ? nt : mt, n_on_x ? mt : nt, split);
  if (grid.y > 65535u || grid.z > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, kThreads, smem, s>>>(x, w, b, out, split > 1 ? ws : nullptr, M, K, N,
                                      kslice, relu, n_on_x ? 1 : 0);
  return finish_split(ws, b, out, M, N, relu, split, s);
}

template <int BN>
int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* b,
                __nv_bfloat16* out, float* ws, int M, int K, int N, int relu, int split,
                int kslice, cudaStream_t s) {
  static bool done[64];
  constexpr int smem = bf16_smem_bytes<BN>();
  auto kernel = bf16_mma_kernel<BN>;
  cudaError_t e = allow_smem(kernel, smem, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((M + HBM - 1) / HBM, (N + BN - 1) / BN, split);
  if (grid.y > 65535u || grid.z > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, HThreads, smem, s>>>(x, w, b, out, split > 1 ? ws : nullptr, M, K, N,
                                      kslice, relu);
  return finish_split(ws, b, out, M, N, relu, split, s);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// route: 0 general, 1 skinny, 2 tall f32, 3 tall bf16. split and kslice:
// the slices along K of routes 1-3 (slice s is [s*kslice, min((s+1)*kslice,
// K)), all non-empty); ws: f32 workspace of split*M*N floats when
// split > 1. tile_n: route 3's column tile (32, 64, 96, 128).
extern "C" int mbx_fused_matmul(const void* x, const void* w, const void* b, void* out,
                                void* ws, int M, int K, int N, int relu, int is_bf16,
                                int route, int split, int kslice, int tile_n,
                                void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return 0;
  if (K < 0) return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fast_ptrs = aligned16(x) && aligned16(w) && aligned16(out);
  if (route == kGeneral) {
    dim3 grid((M + GBM - 1) / GBM, (N + GBN - 1) / GBN);
    if (grid.y > 65535u) return invalid;
    if (is_bf16) {
      general_kernel<__nv_bfloat16><<<grid, kGeneralThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
          static_cast<const float*>(b), static_cast<__nv_bfloat16*>(out), M, K, N, relu);
    } else {
      general_kernel<float><<<grid, kGeneralThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<const float*>(b), static_cast<float*>(out), M, K, N, relu);
    }
    return static_cast<int>(cudaGetLastError());
  }
  // the fast routes: 16-byte rows, slices that partition K
  const int row = route == kTallBf16 ? 8 : 4;
  if (K <= 0 || K % row || N % row || !fast_ptrs) return invalid;
  if (split < 1 || kslice < row || kslice % row) return invalid;
  if (static_cast<long long>(split - 1) * kslice >= K ||
      static_cast<long long>(split) * kslice < K)
    return invalid;
  if (split > 1 && (ws == nullptr || !aligned16(ws))) return invalid;
  auto wsf = static_cast<float*>(ws);
  if (route == kTallBf16) {
    if (!is_bf16) return invalid;
    auto xb = static_cast<const __nv_bfloat16*>(x);
    auto wb = static_cast<const __nv_bfloat16*>(w);
    auto ob = static_cast<__nv_bfloat16*>(out);
    auto bb = static_cast<const float*>(b);
    switch (tile_n) {
      case 32: return launch_bf16<32>(xb, wb, bb, ob, wsf, M, K, N, relu, split, kslice, s);
      case 64: return launch_bf16<64>(xb, wb, bb, ob, wsf, M, K, N, relu, split, kslice, s);
      case 96: return launch_bf16<96>(xb, wb, bb, ob, wsf, M, K, N, relu, split, kslice, s);
      case 128: return launch_bf16<128>(xb, wb, bb, ob, wsf, M, K, N, relu, split, kslice, s);
      default: return invalid;
    }
  }
  if (is_bf16) return invalid;
  auto xf = static_cast<const float*>(x);
  auto wf = static_cast<const float*>(w);
  auto bf = static_cast<const float*>(b);
  auto of = static_cast<float*>(out);
  if (route == kSkinny) {
    if (M > 64) return invalid;
    if (M <= 8) return launch_splitk<8, 128, 1, 4>(xf, wf, bf, of, wsf, M, K, N, relu, split, kslice, true, s);
    if (M <= 16) return launch_splitk<16, 128, 2, 4>(xf, wf, bf, of, wsf, M, K, N, relu, split, kslice, true, s);
    if (M <= 32) return launch_splitk<32, 128, 4, 4>(xf, wf, bf, of, wsf, M, K, N, relu, split, kslice, true, s);
    return launch_splitk<64, 128, 8, 4>(xf, wf, bf, of, wsf, M, K, N, relu, split, kslice, true, s);
  }
  if (route == kTallF32) {
    return launch_splitk<128, 96, 8, 6>(xf, wf, bf, of, wsf, M, K, N, relu, split, kslice, false, s);
  }
  return invalid;
}
