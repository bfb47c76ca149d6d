// Batched hard NMS + top-k for sm_90a. One thread block per image.
//
// Replaces _nms_kernel / nms_pallas_batched of
// multibox_tpu/ops/pallas/nms_kernel.py. The spec (ops/nms.py::_nms_jnp):
// K rounds, each taking the live box with the highest score (lowest index
// on ties), recording (index, score), then killing the winner and every
// box whose IoU with it exceeds the threshold. A box is never live when
// `score >= score_threshold` is false (NaN included) or its score is -inf.
// Slots left over keep index -1 and score -1.
//
// What bounds it: neither bytes (an image moves P*20 B in and K*8 B out)
// nor operations, but the chain of dependent steps. The first version ran the
// spec's K rounds literally: a block-wide arg-max with two barriers a round,
// about 1 us a round on this card. Only winners suppress, and the winners
// come out in (score desc, index asc) order, so greedy NMS is also: sort the
// live boxes by that order, walk them, and keep each one that no box kept
// before it suppresses, until K are kept. The design, one block of 512
// threads an image:
// - Stage: one round trip loads the scores and, when they fit in shared
//   memory, the boxes (16-byte loads); each box gets a 64-bit key, the
//   order-preserving bits of its score (-0.0 made +0.0 first: the spec
//   treats the two as equal and breaks the tie by index), then its
//   complemented index; 0 for a dead box. When the boxes do not fit (the SSD
//   prior count), their lines are prefetched into L2 and the scan reads them
//   from there.
// - Sort: a bitonic sort of the keys, descending. The passes of stride
//   <= 32 run in registers with shuffles, each warp on segments of 64 keys;
//   a wider stride is a pass over shared memory between block barriers.
// - Scan, kChunk candidates at a time, two block barriers a chunk (not two
//   a selected box): (a) every candidate against every box kept so far (a
//   list in shared memory), and (b) against the chunk's earlier candidates
//   (row c: which of them would suppress it), both spread over the block's
//   16 thread groups, verdicts gathered with ballots; (c) warp 0 resolves
//   the chunk in order with ballots (keep = F(keep) to its fixed point,
//   where F keeps a live candidate that no kept earlier one suppresses) and
//   appends the kept ones to the outputs and the kept list. It stops at K
//   kept or at the first dead candidate (the dead sort last).
//
// Shared memory: 8 B a key (the sort pads P to a power of two), 16 B a kept
// box, 20 B a staged box and score. P <= 16384 keys fit (128 KiB) with a kept
// list of up to 5,312 boxes beside them (any K at P <= 8192). Boxes that do
// not fit stay in global memory.
//
// Past that (more keys than 16384, or a kept list that does not fit beside
// them: the SSD detect with flip TTA gives 18,936 boxes an image) the keys
// live in a global scratch [B, npad] that the caller allocates, and the
// block still owns its image: `nms_global_kernel`. It sorts the keys in
// tiles of 16384 with the same shared-memory passes (each tile's direction
// taken from its position in the whole sequence, so that the tiles form the
// bitonic runs of the full sort), then runs the merges of larger strides as
// coalesced compare-exchange passes over global memory between block
// barriers, each followed by the strides inside a tile on the tile in shared
// memory. The scan then reads the keys from global memory, with the kept
// list in the shared memory the tiles used. Only a kept list larger than
// shared memory is refused (about 13,500 boxes). Same keys, same scan, so the
// same result as the shared route, bitwise.
//
// Arithmetic is held to the plain PyTorch version op for op, each a
// correctly rounded f32 operation (no FMA contraction), so a box that sits
// on the threshold falls on the same side in both; the kept box is the
// spec's `best` operand:
//   area  = max(y1-y0,0) * max(x1-x0,0)
//   inter = max(min(y1,by1)-max(y0,by0),0) * max(min(x1,bx1)-max(x0,bx0),0)
//   union = (area_best + area_i) - inter
//   iou   = union > 0 ? inter / max(union, 1e-8) : 0;  suppress if iou > thr
// The last line's rounded division is decided exactly without dividing (see
// `Threshold`). This file is compiled with -fmad=false as well.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // candidates a chunk: 32 or 64
constexpr int kGroups = kThreads / kChunk;
constexpr int kBatch = 4;  // kept boxes a thread tests at a time
constexpr int kRowTests = (kChunk + kGroups - 1) / kGroups;  // earlier candidates a thread tests
constexpr int kMaxKeys = 16384;
constexpr float kEps = 1e-8f;
// Dynamic shared memory a block may use on sm_90 (227 KiB), less the static
// arrays of the kernel (about 4 KiB at 512 threads) and a margin.
constexpr size_t kSmemLimit = 227 * 1024 - 16 * 1024;

static_assert(kChunk == 32 || kChunk == 64, "a chunk is one or two warps wide");

typedef unsigned long long u64;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

// The threshold test without a division. The spec's test is
// fl(inter / u) > thr, u = max(union, 1e-8) > 0, fl() rounding to nearest
// even. That holds exactly when the real quotient is above `mid`, the
// midpoint between thr and the next float up, or equals it and the next
// float up is the even one (`tie_up`): inter > mid * u, where mid has at
// most 25 significant bits and u 24, so the double product is exact. The
// caller works out mid and tie_up from thr once (an infinite or NaN thr
// gives a test that never passes, as the spec's).
struct Threshold {
  float thr;
  double mid;
  bool tie_up;
};

// True when `best` (kept first) suppresses `b`.
__device__ __forceinline__ bool suppresses(float4 best, float best_area, float4 b,
                                           float b_area, const Threshold& t) {
  const float ih = fmaxf(__fsub_rn(fminf(b.z, best.z), fmaxf(b.x, best.x)), 0.0f);
  const float iw = fmaxf(__fsub_rn(fminf(b.w, best.w), fmaxf(b.y, best.y)), 0.0f);
  const float inter = __fmul_rn(ih, iw);
  const float uni = __fsub_rn(__fadd_rn(best_area, b_area), inter);
  if (!(uni > 0.0f)) return 0.0f > t.thr;  // the spec's iou of 0
  const double lhs = static_cast<double>(inter);
  const double rhs = __dmul_rn(t.mid, static_cast<double>(fmaxf(uni, kEps)));
  return lhs > rhs || (t.tie_up && lhs == rhs);
}

// Sort key of a live score: its bits made order-preserving as unsigned (every
// live score is above -inf, so the word is >= 1 and a live key is never 0),
// then the complemented index, so that among equal scores the lower index
// sorts first in descending order.
__device__ __forceinline__ u64 live_key(float s, int i) {
  const unsigned bits = __float_as_uint(__fadd_rn(s, 0.0f));  // -0.0 -> +0.0
  const unsigned ord = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return (static_cast<u64>(ord) << 32) | static_cast<unsigned>(~i);
}

__device__ __forceinline__ int key_index(u64 key) {
  return key ? static_cast<int>(~static_cast<unsigned>(key)) : -1;
}

// The boxes' lines prefetched into L2 for a scan that reads them from global
// memory, in a loop of their own so that the score loads are not held behind
// them.
__device__ __forceinline__ void prefetch_boxes(const float4* gbox, int P) {
  for (int i = 8 * threadIdx.x; i < P; i += 8 * kThreads)  // 8 boxes a 128-byte line
    asm volatile("prefetch.global.L2 [%0];" ::"l"(gbox + i));
}

// Stage: the keys of boxes first .. first + n - 1 into skey[0, n), 0 for a
// dead box and for the padding; with `sbox` (first = 0), also the boxes
// (16-byte loads) and the scores into shared memory, in the same round trip.
__device__ __forceinline__ void stage_keys(u64* skey, float4* sbox, float* sscore,
                                           const float4* gbox, const float* gscore, int P,
                                           int first, int n, float score_thr) {
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int gi = first + i;
    u64 key = 0;
    if (gi < P) {
      const float s = gscore[gi];
      if (sbox) {
        sbox[i] = gbox[gi];
        sscore[i] = s;
      }
      if (s >= score_thr && s != -CUDART_INF_F) key = live_key(s, gi);
    }
    skey[i] = key;
  }
}

// One compare-exchange of a bitonic pass of stride j < 32, in registers: this
// lane holds the key at position e, its partner (position e ^ j) is in lane
// lane ^ j. In a descending run the lower position keeps the larger key.
__device__ __forceinline__ u64 exchange(u64 a, int e, int j, int k) {
  const u64 p = __shfl_xor_sync(0xffffffffu, a, j);
  const bool desc = (e & k) == 0;
  const bool lower = (e & j) == 0;
  return (lower == desc) ? (a > p ? a : p) : (a < p ? a : p);
}

// The passes of strides <= 32 for k = k_lo ... k_hi (the first from stride
// j_first), which stay inside aligned segments of 64 keys: each warp loads a
// segment into two registers a lane (positions lane and lane + 32), runs the
// passes with shuffles and stores it back. skey[0, n) holds the keys at
// positions first .. first + n - 1 of the whole sequence (first a multiple
// of n), from which the direction of each run is taken.
__device__ __forceinline__ void segment_passes(u64* skey, int n, int first, int k_lo,
                                               int k_hi, int j_first) {
  const int lane = threadIdx.x & 31;
  for (int base = 64 * (threadIdx.x >> 5); base < n; base += 2 * kThreads) {
    u64 a0 = skey[base + lane], a1 = skey[base + lane + 32];
    const int e0 = first + base + lane, e1 = e0 + 32;
    for (int k = k_lo; k <= k_hi; k <<= 1) {
      for (int j = (k == k_lo) ? j_first : (k >> 1); j > 0; j >>= 1) {
        if (j == 32) {  // partners in one lane
          const u64 hi = a0 > a1 ? a0 : a1, lo = a0 > a1 ? a1 : a0;
          const bool desc = (e0 & k) == 0;
          a0 = desc ? hi : lo;
          a1 = desc ? lo : hi;
        } else {
          a0 = exchange(a0, e0, j, k);
          a1 = exchange(a1, e1, j, k);
        }
      }
    }
    skey[base + lane] = a0;
    skey[base + lane + 32] = a1;
  }
}

// A pass of stride j (64 <= j < n) over skey[0, n), the keys at positions
// first .. first + n - 1, for the runs of length k; the caller puts a block
// barrier before and after.
__device__ __forceinline__ void shared_pass(u64* skey, int n, int first, int k, int j) {
  for (int i = threadIdx.x; i < (n >> 1); i += kThreads) {
    const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
    const int hi = lo + j;
    const u64 a = skey[lo], b = skey[hi];
    if ((((first + lo) & k) == 0) ? (a < b) : (a > b)) {
      skey[lo] = b;
      skey[hi] = a;
    }
  }
}

// Bitonic sort of skey[0, n) (a power of two >= 64), the keys at positions
// first .. first + n - 1 of the whole sequence: descending when that tile is
// the whole sequence (first = 0), else in the direction the tile's run of
// length n has in the full sort. Every thread of the block calls it, after a
// barrier that follows the keys' writes, and a barrier follows it. Strides
// <= 32 run in registers (segment_passes); a wider stride is a pass over
// shared memory between two block barriers.
__device__ __forceinline__ void sort_keys_desc(u64* skey, int n, int first) {
  segment_passes(skey, n, first, 2, 64, 1);
  for (int k = 128; k <= n; k <<= 1) {
    __syncthreads();
    for (int j = k >> 1; j >= 64; j >>= 1) {
      shared_pass(skey, n, first, k, j);
      __syncthreads();
    }
    segment_passes(skey, n, first, k, k, 32);
  }
}

// The strides n/2 .. 1 of the runs of length k > n on the tile skey[0, n)
// (positions first .. first + n - 1); barriers as for sort_keys_desc.
__device__ __forceinline__ void merge_tile(u64* skey, int n, int first, int k) {
  for (int j = n >> 1; j >= 64; j >>= 1) {
    shared_pass(skey, n, first, k, j);
    __syncthreads();
  }
  segment_passes(skey, n, first, k, k, 32);
}

__host__ __device__ inline int pad_keys(int P) {
  int n = 64;
  while (n < P) n <<= 1;
  return n;
}

// Shared memory of a block: the keys, the kept list, then (when they fit
// too) the image's boxes and scores, staged so that the scan reads them from
// shared memory.
__host__ __device__ inline size_t smem_bytes(int P, int K, bool staged) {
  const int cap = K < P ? K : P;
  return static_cast<size_t>(pad_keys(P)) * sizeof(u64) +
         static_cast<size_t>(cap) * sizeof(float4) +
         (staged ? static_cast<size_t>(P) * (sizeof(float4) + sizeof(float)) : 0);
}

// The scan over the sorted keys skey[0, npad) (in shared or global memory),
// kChunk candidates at a time, and the outputs' tail; every thread of the
// block calls it after a barrier that follows the sort. `kept` holds room for
// min(K, P) boxes in shared memory; the candidates' boxes and scores are read
// from cand_box / cand_score.
__device__ __forceinline__ void scan_chunks(const u64* skey, int npad, float4* kept,
                                            const float4* cand_box, const float* cand_score,
                                            int* out_idx, float* out_score, int K,
                                            const Threshold& thr) {
  __shared__ u64 rowpart[kGroups][kChunk];
  __shared__ unsigned deadw[kWarps];
  __shared__ int s_nk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int R = kChunk / 32;  // candidates a lane of warp 0 resolves
  const int c = tid % kChunk;      // this thread's candidate
  const int g = tid / kChunk;      // and its group
  int nk = 0;
  for (int c0 = 0; c0 < npad && skey[c0] != 0; c0 += kChunk) {
    const int idx = key_index(skey[c0 + c]);  // c0 + kChunk <= npad
    const float4 mine = cand_box[idx < 0 ? 0 : idx];
    const float mine_area = box_area(mine);
    // (b) against the chunk's earlier candidates (row c: which would
    // suppress c), and (a) against the kept list, kBatch boxes a thread at a
    // time. Each batch loads first and tests after, without branches (an
    // index past the list is clamped and its verdict dropped), so that the
    // latencies overlap; (b)'s loads go first, to overlap (a)'s first batch.
    int jdx[kRowTests];
    float4 jb[kRowTests];
#pragma unroll
    for (int m = 0; m < kRowTests; ++m) {
      const int j = g + m * kGroups;
      jdx[m] = key_index(skey[c0 + (j < kChunk ? j : 0)]);
      jb[m] = cand_box[jdx[m] < 0 ? 0 : jdx[m]];
    }
    bool dead = idx < 0;
    for (int base = g; base < nk; base += kBatch * kGroups) {
      float4 kb[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int kk = base + u * kGroups;
        kb[u] = kept[kk < nk ? kk : nk - 1];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        dead |= (base + u * kGroups < nk) &
                suppresses(kb[u], box_area(kb[u]), mine, mine_area, thr);
    }
    u64 row = 0;
#pragma unroll
    for (int m = 0; m < kRowTests; ++m) {
      const int j = g + m * kGroups;
      const bool hit = (j < c) & (jdx[m] >= 0) &
                       suppresses(jb[m], box_area(jb[m]), mine, mine_area, thr);
      row |= static_cast<u64>(hit) << (j < kChunk ? j : 0);
    }
    rowpart[g][c] = row;
    const unsigned ballot = __ballot_sync(0xffffffffu, dead);
    if (lane == 0) deadw[warp] = ballot;
    __syncthreads();

    // (c) resolve and append: warp 0, lane l holding candidates l (and l + 32)
    if (warp == 0) {
      u64 dead_mask = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        dead_mask |= static_cast<u64>(deadw[w]) << (32 * (w % R));
      u64 row_of[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        row_of[r] = 0;
#pragma unroll
        for (int q = 0; q < kGroups; ++q) row_of[r] |= rowpart[q][lane + 32 * r];
      }
      // Candidate i is kept when it lives and no kept earlier candidate
      // suppresses it. Iterate keep = F(keep) from "every live one" with
      // ballots: F's bit i reads only bits below i, so after t rounds bits
      // 0 .. t-1 are final, and the first repeat is the one fixed point.
      u64 keep = ~dead_mask & (kChunk == 64 ? ~0ull : 0xffffffffull);
      for (;;) {
        u64 next = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int cc = lane + 32 * r;
          const bool k = !((dead_mask >> cc) & 1ull) && !(row_of[r] & keep);
          next |= static_cast<u64>(__ballot_sync(0xffffffffu, k)) << (32 * r);
        }
        if (next == keep) break;
        keep = next;
      }
      // a candidate's fate does not depend on later ones: past the room
      // left, drop the last kept
      while (__popcll(keep) > K - nk) keep &= ~(1ull << (63 - __clzll(keep)));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int cc = lane + 32 * r;
        if ((keep >> cc) & 1ull) {
          const int pos = nk + __popcll(keep & ((1ull << cc) - 1ull));
          const int kidx = key_index(skey[c0 + cc]);
          out_idx[pos] = kidx;
          out_score[pos] = cand_score[kidx];
          kept[pos] = cand_box[kidx];
        }
      }
      if (lane == 0) s_nk = nk + __popcll(keep);
    }
    __syncthreads();
    nk = s_nk;
    if (nk >= K) break;
  }

  for (int k = nk + tid; k < K; k += kThreads) {
    out_idx[k] = -1;
    out_score[k] = -1.0f;
  }
}

// kStaged: the boxes and scores are in shared memory beside the keys and the
// kept list, so that every access of the scan is a shared-memory one.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
nms_kernel(const float4* __restrict__ boxes,  // [B, P]
           const float* __restrict__ scores,  // [B, P]
           int* __restrict__ sel_idx,         // [B, K]
           float* __restrict__ sel_scores,    // [B, K]
           int P, int K, Threshold thr, float score_thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int img = blockIdx.x;
  const int npad = pad_keys(P);
  const int cap = K < P ? K : P;

  const float4* gbox = boxes + static_cast<size_t>(img) * P;
  const float* gscore = scores + static_cast<size_t>(img) * P;
  u64* skey = reinterpret_cast<u64*>(smem);
  float4* kept = reinterpret_cast<float4*>(skey + npad);
  float4* sbox = kept + cap;
  float* sscore = reinterpret_cast<float*>(sbox + P);

  if (!kStaged) prefetch_boxes(gbox, P);
  stage_keys(skey, kStaged ? sbox : nullptr, sscore, gbox, gscore, P, 0, npad, score_thr);
  __syncthreads();
  sort_keys_desc(skey, npad, 0);
  __syncthreads();
  scan_chunks(skey, npad, kept, kStaged ? sbox : gbox, kStaged ? sscore : gscore,
              sel_idx + static_cast<size_t>(img) * K, sel_scores + static_cast<size_t>(img) * K,
              K, thr);
}

// The global-keys route: the keys of image b in keys[b * npad, (b + 1) *
// npad), sorted in tiles of min(npad, kMaxKeys) in shared memory and merged
// over global memory (see the head of the file); the kept list in the shared
// memory the tiles used; boxes and scores read from global memory (L2).
__global__ void __launch_bounds__(kThreads)
nms_global_kernel(const float4* __restrict__ boxes,  // [B, P]
                  const float* __restrict__ scores,  // [B, P]
                  int* __restrict__ sel_idx,         // [B, K]
                  float* __restrict__ sel_scores,    // [B, K]
                  u64* keys,                         // [B, npad] scratch
                  int P, int K, Threshold thr, float score_thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int img = blockIdx.x;
  const int tid = threadIdx.x;
  const int npad = pad_keys(P);
  const int tile = npad < kMaxKeys ? npad : kMaxKeys;
  const float4* gbox = boxes + static_cast<size_t>(img) * P;
  const float* gscore = scores + static_cast<size_t>(img) * P;
  u64* gkey = keys + static_cast<size_t>(img) * npad;
  u64* stile = reinterpret_cast<u64*>(smem);

  prefetch_boxes(gbox, P);
  // runs of length <= tile: each tile sorted in shared memory
  for (int t0 = 0; t0 < npad; t0 += tile) {
    stage_keys(stile, nullptr, nullptr, gbox, gscore, P, t0, tile, score_thr);
    __syncthreads();
    sort_keys_desc(stile, tile, t0);
    __syncthreads();
    for (int i = tid; i < tile; i += kThreads) gkey[t0 + i] = stile[i];
    __syncthreads();
  }
  // runs of length k > tile: strides >= tile over global memory, the rest
  // tile by tile in shared memory
  for (int k = 2 * tile; k <= npad; k <<= 1) {
    for (int j = k >> 1; j >= tile; j >>= 1) {
      for (int i = tid; i < (npad >> 1); i += kThreads) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const u64 a = gkey[lo], b = gkey[hi];
        if (((lo & k) == 0) ? (a < b) : (a > b)) {
          gkey[lo] = b;
          gkey[hi] = a;
        }
      }
      __syncthreads();
    }
    for (int t0 = 0; t0 < npad; t0 += tile) {
      for (int i = tid; i < tile; i += kThreads) stile[i] = gkey[t0 + i];
      __syncthreads();
      merge_tile(stile, tile, t0, k);
      __syncthreads();
      for (int i = tid; i < tile; i += kThreads) gkey[t0 + i] = stile[i];
      __syncthreads();
    }
  }
  scan_chunks(gkey, npad, reinterpret_cast<float4*>(smem), gbox, gscore,
              sel_idx + static_cast<size_t>(img) * K, sel_scores + static_cast<size_t>(img) * K,
              K, thr);
}

// Shared memory of the global-keys route: a tile of keys during the sort,
// the kept list after it.
__host__ __device__ inline size_t global_smem_bytes(int P, int K) {
  const int npad = pad_keys(P);
  const size_t tile = static_cast<size_t>(npad < kMaxKeys ? npad : kMaxKeys) * sizeof(u64);
  const size_t kept = static_cast<size_t>(K < P ? K : P) * sizeof(float4);
  return tile > kept ? tile : kept;
}

// The boxes and scores are staged when they fit beside the keys and the
// kept list.
inline bool stage_fits(int P, int K) { return smem_bytes(P, K, true) <= kSmemLimit; }

}  // namespace

// Returns cudaGetLastError() after the launch. (thr_mid, thr_tie_up) is the
// threshold test of `suppresses`, worked out from iou_thr by the caller. With
// `key_scratch` null the keys stay in shared memory, and cudaErrorInvalidValue
// is returned when P is past the keys that fit or the kept list does not fit
// beside them; with `key_scratch` ([B, pad_keys(P)] 64-bit words) the keys go
// there (the global-keys route), and cudaErrorInvalidValue is returned when
// the kept list alone does not fit in shared memory. The wrapper refuses all
// of these first.
extern "C" int mbx_nms(const void* boxes, const void* scores, void* sel_idx,
                       void* sel_scores, void* key_scratch, int B, int P, int K,
                       float iou_thr, double thr_mid, int thr_tie_up, float score_thr,
                       void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (P <= 0 || P > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const Threshold thr{iou_thr, thr_mid, thr_tie_up != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (key_scratch) {
    const size_t smem = global_smem_bytes(P, K);
    if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          nms_global_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    nms_global_kernel<<<B, kThreads, smem, st>>>(
        static_cast<const float4*>(boxes), static_cast<const float*>(scores),
        static_cast<int*>(sel_idx), static_cast<float*>(sel_scores),
        static_cast<u64*>(key_scratch), P, K, thr, score_thr);
    return static_cast<int>(cudaGetLastError());
  }
  if (P > kMaxKeys) return static_cast<int>(cudaErrorInvalidValue);
  const bool staged = stage_fits(P, K);
  const size_t smem = smem_bytes(P, K, staged);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = staged ? nms_kernel<true> : nms_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<B, kThreads, smem, st>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<int*>(sel_idx), static_cast<float*>(sel_scores), P, K, thr, score_thr);
  return static_cast<int>(cudaGetLastError());
}
