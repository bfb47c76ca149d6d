// Batched hard NMS + top-k for sm_90a.
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
// nor operations, but the chain of dependent steps. Only winners suppress,
// and they come out in (score desc, index asc) order, so greedy NMS is also:
// walk the live boxes in that order and keep each one that no box kept
// before it suppresses, until K are kept. Each box gets a 64-bit key, the
// order-preserving bits of its score (-0.0 made +0.0 first: the spec treats
// the two as equal and breaks the tie by index), then its complemented
// index; 0 for a dead box. Keys of live boxes are unique, and a larger key
// comes first. The walk reads only the first few hundred keys of the order
// (the scan stops at K kept), so the kernel orders no more than it reads:
//
// - A small image (the wrapper's choice: at most 1,024 boxes) is staged
//   whole in shared memory (`nms_full_kernel`): scores and boxes in
//   one round trip, by 16-byte and 4-byte loads (bulk copies were no faster
//   at 256 and 1,024 boxes); then a bitonic sort of all its keys (strides <= 32 in registers with shuffles, wider ones
//   as passes over shared memory between block barriers), then the scan.
// - A larger one goes window by window (`nms_window_kernel`). A window is
//   an exact prefix of what is left of the order: the keys in [floor,
//   ceiling). A radix selection finds the floor: histogram passes over the
//   keys' 8-bit digits, highest first, counting the keys below the ceiling
//   that share the digits fixed so far; counting the bins from the top, the
//   first whose running count passes the room left is b1; when the bins
//   above b1 hold at least half the window (less what is taken), the floor
//   is the start of bin b1 + 1, else b1's digit is fixed and the next pass
//   splits it by the next digit. A pass whose keys all share its digit goes
//   straight to the digit of their highest differing bit (from the OR and
//   AND of the keys), so equal scores cost one pass before the index
//   digits. The window's keys are compacted into shared memory, sorted
//   (the same bitonic passes on at most `window` keys), their boxes
//   gathered beside them, and scanned. Fewer than K kept with live keys
//   left below the floor: the next window, four times as large (within
//   the room allocated), is selected below it (the refill), and the scan
//   goes on with the same kept list. Exact for any data; the window only
//   changes the speed. With `staged` (the wrapper's plan: where they fit
//   beside the window and the kept list), each block's slice of the scores
//   is staged in shared memory by bulk copies (cp.async.bulk) in tiles of
//   16 KiB, each tile on its own mbarrier, the first histogram pass
//   consuming tile t while later tiles are in flight; else every pass reads
//   the scores from global memory (L2).
//   A pass is bound by latency (16 warps an SM): each thread holds kUnroll
//   keys at once, the lanes of a warp that share a bin add once
//   (__match_any_sync), and the compaction reserves a warp's room with one
//   atomic for its kUnroll * 32 keys.
// - With `cluster` > 1, an image's blocks form a thread-block cluster on
//   neighbouring SMs: each stages and counts its slice of the keys, the
//   counts meet in the first block's shared memory over distributed shared
//   memory (cluster.map_shared_rank), the first block decides each pass,
//   every block writes its window keys straight into the first block's
//   shared memory, and the first block sorts and scans.
// - The scan, kChunk candidates at a time, two block barriers a chunk:
//   (a) every candidate against every box kept so far (a list in shared
//   memory), and (b) against the chunk's earlier candidates (row c: which
//   of them would suppress it), both spread over the block's 16 thread
//   groups, verdicts gathered with ballots; (c) warp 0 resolves the chunk
//   in order with ballots (keep = F(keep) to its fixed point, where F keeps
//   a live candidate that no kept earlier one suppresses) and appends the
//   kept ones to the outputs and the kept list. It stops at K kept or at
//   the window's end.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// Phase stamps for scripts/torch_kernel_design.py, which defines these to
// read %globaltimer; nothing in this build.
#ifndef NMS_STAMP
#define NMS_STAMP_BEGIN
#define NMS_STAMP(slot)
#define NMS_COUNT(slot)
#define NMS_STAMP_END(cond, img)
#endif

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // candidates a chunk: 32 or 64
constexpr int kGroups = kThreads / kChunk;
constexpr int kBatch = 4;  // kept boxes a thread tests at a time
constexpr int kRowTests = (kChunk + kGroups - 1) / kGroups;  // earlier candidates a thread tests
constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr int kUnroll = 4;  // keys a thread holds at once in a pass over the keys
constexpr int kWindowMax = 4096;  // the largest window (keys) a launch may ask for
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kTileBytes = 16384;  // one bulk copy of staged scores
constexpr int kMaxTiles = 16;
constexpr float kEps = 1e-8f;
// Dynamic shared memory a block may use on sm_90 (227 KiB), less the static
// arrays of the kernel (about 6 KiB at 512 threads) and a margin.
constexpr size_t kSmemLimit = 227 * 1024 - 16 * 1024;

static_assert(kChunk == 32 || kChunk == 64, "a chunk is one or two warps wide");
static_assert(kBins == 8 * 32, "warp 0 reads the histogram 8 bins a lane");


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

__device__ __forceinline__ u64 score_key(float s, int i, float score_thr) {
  return (s >= score_thr && s != -CUDART_INF_F) ? live_key(s, i) : 0ull;
}

__device__ __forceinline__ int key_index(u64 key) {
  return key ? static_cast<int>(~static_cast<unsigned>(key)) : -1;
}

// ---------------------------------------------------------------- bulk copies

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(u64* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Thread 0: arrive on `bar` expecting `bytes`, and copy them global -> shared
// (both 16-byte aligned, bytes a multiple of 16), completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, u64* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(u64* bar) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
}

// Scores src[0, n) staged into shared memory: the part between the first and
// the last 16-byte boundary by bulk copies of kTileBytes, each on its own
// mbarrier (thread 0 issues them), the ragged ends by plain loads. `base`
// has room for n + 4 floats; the returned pointer p (p[i] holds src[i]) is
// base shifted so that p and src agree modulo 16 bytes. Every thread calls
// it; the caller puts a block barrier after the call and, before reading a
// float of the bulk part, waits on its tile's barrier (`Staged`).
struct Staged {
  float* s;   // s[i] = src[i]
  int head;   // floats before the bulk part
  int tiles;  // bulk copies, on bars[0, tiles)
};

__device__ __forceinline__ Staged stage_scores(float* base, const float* src, int n, u64* bars) {
  const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  Staged st;
  st.s = base + shift;
  st.head = min((4 - shift) & 3, n);
  const int body = (n - st.head) & ~3;  // floats in the bulk part
  st.tiles = (body * 4 + kTileBytes - 1) / kTileBytes;
  if (threadIdx.x < st.head) st.s[threadIdx.x] = src[threadIdx.x];
  for (int i = st.head + body + threadIdx.x; i < n; i += kThreads) st.s[i] = src[i];
  if (threadIdx.x == 0) {
    for (int t = 0; t < st.tiles; ++t) mbar_init(&bars[t]);
    mbar_init_fence();
    for (int t = 0; t < st.tiles; ++t) {
      const int off = st.head + t * (kTileBytes / 4);
      const int bytes = min(kTileBytes, (st.head + body - off) * 4);
      bulk_load(st.s + off, src + off, static_cast<unsigned>(bytes), &bars[t]);
    }
  }
  return st;
}

// Waits (every thread) for the tiles holding floats up to `last`, the tiles
// before `*waited` having been waited for already.
__device__ __forceinline__ void wait_tiles(const Staged& st, u64* bars, int last, int* waited) {
  const int t = last < st.head ? -1 : min((last - st.head) / (kTileBytes / 4), st.tiles - 1);
  while (*waited <= t) mbar_wait(&bars[(*waited)++]);
}

// ------------------------------------------------------------------- the sort

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
// passes with shuffles and stores it back.
__device__ __forceinline__ void segment_passes(u64* skey, int n, int k_lo, int k_hi,
                                               int j_first) {
  const int lane = threadIdx.x & 31;
  for (int base = 64 * (threadIdx.x >> 5); base < n; base += 2 * kThreads) {
    u64 a0 = skey[base + lane], a1 = skey[base + lane + 32];
    const int e0 = base + lane, e1 = e0 + 32;
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

// A pass of stride j (64 <= j < n) over skey[0, n) for the runs of length k;
// the caller puts a block barrier before and after.
__device__ __forceinline__ void shared_pass(u64* skey, int n, int k, int j) {
  for (int i = threadIdx.x; i < (n >> 1); i += kThreads) {
    const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
    const int hi = lo + j;
    const u64 a = skey[lo], b = skey[hi];
    if (((lo & k) == 0) ? (a < b) : (a > b)) {
      skey[lo] = b;
      skey[hi] = a;
    }
  }
}

// Bitonic sort of skey[0, n) (a power of two >= 64), descending. Every thread
// of the block calls it, after a barrier that follows the keys' writes, and a
// barrier follows it. Strides <= 32 run in registers (segment_passes); a
// wider stride is a pass over shared memory between two block barriers.
__device__ __forceinline__ void sort_keys_desc(u64* skey, int n) {
  segment_passes(skey, n, 2, 64, 1);
  for (int k = 128; k <= n; k <<= 1) {
    __syncthreads();
    for (int j = k >> 1; j >= 64; j >>= 1) {
      shared_pass(skey, n, k, j);
      __syncthreads();
    }
    segment_passes(skey, n, k, k, 32);
  }
}

__host__ __device__ inline int pad_keys(int P) {
  int n = 64;
  while (n < P) n <<= 1;
  return n;
}

// ------------------------------------------------------------------- the scan

// The scan over the sorted keys skey[0, npad), kChunk candidates at a time,
// appending to the kept list kept[0, nk) (room for min(K, P) boxes) and to
// the outputs; returns the new nk. Every thread of the block calls it after a
// barrier that follows the sort (and the gather). A candidate's box is
// cand_box[its position] with kByPos (the window's gathered boxes), else
// cand_box[its index] (the image staged whole); its score cand_score[its
// index].
template <bool kByPos>
__device__ __forceinline__ int scan_chunks(const u64* skey, int npad, float4* kept, int nk,
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
  for (int c0 = 0; nk < K && c0 < npad && skey[c0] != 0; c0 += kChunk) {
    const int idx = key_index(skey[c0 + c]);  // c0 + kChunk <= npad
    const float4 mine = cand_box[kByPos ? c0 + c : (idx < 0 ? 0 : idx)];
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
      const int jj = j < kChunk ? j : 0;
      jdx[m] = key_index(skey[c0 + jj]);
      jb[m] = cand_box[kByPos ? c0 + jj : (jdx[m] < 0 ? 0 : jdx[m])];
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
          kept[pos] = cand_box[kByPos ? c0 + cc : kidx];
        }
      }
      if (lane == 0) s_nk = nk + __popcll(keep);
    }
    __syncthreads();
    nk = s_nk;
  }
  return nk;
}

__device__ __forceinline__ void fill_tail(int* out_idx, float* out_score, int nk, int K) {
  for (int k = nk + threadIdx.x; k < K; k += kThreads) {
    out_idx[k] = -1;
    out_score[k] = -1.0f;
  }
}

// ------------------------------------------------------- an image staged whole

// Shared memory of nms_full_kernel: the keys (P padded), the kept list, the
// boxes, the scores.
__host__ __device__ inline size_t full_smem_bytes(int P, int K) {
  const int cap = K < P ? K : P;
  return static_cast<size_t>(pad_keys(P)) * sizeof(u64) + static_cast<size_t>(cap + P) * 16 +
         static_cast<size_t>(P) * sizeof(float);
}

// One block an image staged whole (at most 4,096 boxes fit; the wrapper
// takes this for at most 1,024): stage the boxes and scores by 16-byte and
// 4-byte loads in the same round trip as the keys, sort every key, scan.
__global__ void __launch_bounds__(kThreads)
nms_full_kernel(const float4* __restrict__ boxes,  // [B, P]
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
  NMS_STAMP_BEGIN;
  u64* skey = reinterpret_cast<u64*>(smem);
  float4* kept = reinterpret_cast<float4*>(skey + npad);
  float4* sbox = kept + cap;
  float* sscore = reinterpret_cast<float*>(sbox + P);

#pragma unroll 4
  for (int i = threadIdx.x; i < npad; i += kThreads) {
    u64 key = 0;
    if (i < P) {
      const float s = gscore[i];
      sbox[i] = gbox[i];
      sscore[i] = s;
      key = score_key(s, i, score_thr);
    }
    skey[i] = key;
  }
  __syncthreads();
  NMS_STAMP(0);
  sort_keys_desc(skey, npad);
  __syncthreads();
  NMS_STAMP(3);
  int* out_idx = sel_idx + static_cast<size_t>(img) * K;
  float* out_score = sel_scores + static_cast<size_t>(img) * K;
  const int nk = scan_chunks<false>(skey, npad, kept, 0, sbox, sscore, out_idx, out_score, K, thr);
  NMS_STAMP(4);
  fill_tail(out_idx, out_score, nk, K);
  NMS_STAMP_END(true, img);
}

// ------------------------------------------------------ window by window

// The selection's state, in the first block of the image's cluster.
struct Select {
  u64 prefix, mask, floor;
  int cap, shift, room, need, count;
  int state;  // kGoOn: another pass; kFound: the window is [floor, ceiling); kFinal: and
              // it holds every live key left
};
constexpr int kGoOn = 0, kFound = 1, kFinal = 2;

__device__ __forceinline__ void cluster_sync(int csize) {
  if (csize > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// p in the first block of the cluster (p itself without a cluster).
template <typename T>
__device__ __forceinline__ T* in_first(T* p, int csize) {
  return csize > 1 ? cg::this_cluster().map_shared_rank(p, 0) : p;
}

__device__ __forceinline__ int cluster_rank(int csize) {
  return csize > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
}

// Shared memory of nms_window_kernel: the window's keys and boxes, the kept
// list, then (when `slice` is not 0) the block's slice of scores.
__host__ __device__ inline size_t window_smem_bytes(int window, int K, int P, int slice) {
  const int cap = K < P ? K : P;
  return static_cast<size_t>(window) * (sizeof(u64) + 16) + static_cast<size_t>(cap) * 16 +
         (slice ? static_cast<size_t>(slice + 4) * sizeof(float) : 0);
}

// One cluster of `csize` blocks an image (one block when csize is 1), block
// r owning the boxes [r * slice, (r + 1) * slice); `staged`: each block's
// scores in its shared memory, else read from global memory at every pass. The first window holds up to `window` keys,
// each refill's four times the last, up to `window_max` (the room
// allocated).
__global__ void __launch_bounds__(kThreads)
nms_window_kernel(const float4* __restrict__ boxes,  // [B, P]
                  const float* __restrict__ scores,  // [B, P]
                  int* __restrict__ sel_idx,         // [B, K]
                  float* __restrict__ sel_scores,    // [B, K]
                  int P, int K, Threshold thr, float score_thr, int window,
                  int window_max, int csize, int slice, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) u64 bars[kMaxTiles];
  __shared__ unsigned hist[kBins];
  __shared__ u64 s_or, s_and;
  __shared__ Select s_sel, s_cur;
  __shared__ int s_count, s_more;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int img = blockIdx.x / csize;
  const int rank = cluster_rank(csize);
  const bool first = rank == 0;
  const int lo = min(P, rank * slice), hi = min(P, lo + slice);
  const int cap = K < P ? K : P;
  const float4* gbox = boxes + static_cast<size_t>(img) * P;
  const float* gscore = scores + static_cast<size_t>(img) * P;
  u64* wkey = reinterpret_cast<u64*>(smem);
  float4* wbox = reinterpret_cast<float4*>(wkey + window_max);
  float4* kept = wbox + window_max;
  Select* sel = in_first(&s_sel, csize);
  int* count0 = in_first(&s_count, csize);
  u64* wkey0 = in_first(wkey, csize);
  const int* more0 = in_first(&s_more, csize);
  NMS_STAMP_BEGIN;

  Staged st{nullptr, 0, 0};
  if (staged) st = stage_scores(reinterpret_cast<float*>(kept + cap), gscore + lo, hi - lo, bars);
  int waited = staged ? 0 : st.tiles;
  __syncthreads();
  NMS_STAMP(0);
  // the key of box i of this block's slice
  auto key_at = [&](int i) -> u64 {
    return score_key(staged ? st.s[i - lo] : __ldg(gscore + i), i, score_thr);
  };

  int nk = 0;
  u64 ceiling = ~0ull;  // above every live key (+inf's at index 0 is 0xff800000ffffffff)
  for (int wcap = window;; wcap = min(4 * wcap, window_max)) {
    // ---- select the window below the ceiling
    if (first && tid == 0)
      s_sel = Select{0ull, 0ull, 0ull, wcap, 64 - kDigitBits, wcap, wcap / 2, 0, kGoOn};
    cluster_sync(csize);
    NMS_COUNT(6);
    for (int pass = 0;; ++pass) {
      for (int b = tid; b < kBins; b += kThreads) hist[b] = 0;
      if (tid == 0) {
        s_cur = *sel;  // one read of the first block's state a block
        s_or = 0ull;
        s_and = ~0ull;
      }
      __syncthreads();
      const Select cur = s_cur;
      if (cur.state != kGoOn) break;
      NMS_COUNT(7);
      u64 any = 0ull, all = ~0ull;
      for (int base = lo; base < hi; base += kUnroll * kThreads) {
        if (waited < st.tiles)
          wait_tiles(st, bars, min(base + kUnroll * kThreads, hi) - 1 - lo, &waited);
        u64 key[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = base + u * kThreads + tid;
          key[u] = i < hi ? key_at(i) : 0ull;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool in =
              key[u] != 0ull && key[u] < ceiling && (key[u] & cur.mask) == cur.prefix;
          const unsigned bin =
              in ? static_cast<unsigned>(key[u] >> cur.shift) & (kBins - 1) : kBins;
          const unsigned peers = __match_any_sync(0xffffffffu, bin);
          if (in && lane == __ffs(peers) - 1)
            atomicAdd(&hist[bin], static_cast<unsigned>(__popc(peers)));
          if (in) {
            any |= key[u];
            all &= key[u];
          }
        }
      }
      const unsigned any_hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(any >> 32));
      const unsigned any_lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(any));
      const unsigned all_hi = __reduce_and_sync(0xffffffffu, static_cast<unsigned>(all >> 32));
      const unsigned all_lo = __reduce_and_sync(0xffffffffu, static_cast<unsigned>(all));
      if (lane == 0) {
        atomicOr(&s_or, (static_cast<u64>(any_hi) << 32) | any_lo);
        atomicAnd(&s_and, (static_cast<u64>(all_hi) << 32) | all_lo);
      }
      __syncthreads();
      cluster_sync(csize);
      if (first && warp == 0) {
        // lane l: bins 8l .. 8l + 7, summed over the cluster's blocks
        unsigned h[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) h[k] = 0;
        u64 or_all = 0ull, and_all = ~0ull;
        for (int r = 0; r < csize; ++r) {
          const unsigned* hr = csize > 1 ? cg::this_cluster().map_shared_rank(hist, r) : hist;
#pragma unroll
          for (int k = 0; k < 8; ++k) h[k] += hr[8 * lane + k];
          or_all |= csize > 1 ? *cg::this_cluster().map_shared_rank(&s_or, r) : s_or;
          and_all &= csize > 1 ? *cg::this_cluster().map_shared_rank(&s_and, r) : s_and;
        }
        unsigned mine = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) mine += h[k];
        unsigned suffix = mine;  // the keys in lanes l .. 31
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned y = __shfl_down_sync(0xffffffffu, suffix, o);
          if (lane + o < 32) suffix += y;
        }
        const unsigned total = __shfl_sync(0xffffffffu, suffix, 0);
        // cum[8l + k] = the keys in bins 8l + k .. 255
        unsigned cum[8];
        unsigned run = suffix;
        int over = 0;  // this lane's bins whose running count passes the room
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          cum[k] = run;
          run -= h[k];
          over += cum[k] > static_cast<unsigned>(cur.room);
        }
        // cum is non-increasing: bins 0 .. b1 pass the room
        const int b1 = static_cast<int>(__reduce_add_sync(0xffffffffu, static_cast<unsigned>(over))) - 1;
        const int nb = b1 + 1;  // the bin past b1 (256: none)
        unsigned cum_nb = 0, cum_b1 = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (8 * lane + k == nb) cum_nb = cum[k];
          if (8 * lane + k == b1) cum_b1 = cum[k];
        }
        const unsigned above = nb < kBins ? __shfl_sync(0xffffffffu, cum_nb, nb >> 3) : 0u;
        const unsigned at_b1 = b1 >= 0 ? __shfl_sync(0xffffffffu, cum_b1, b1 >> 3) - above : 0u;
        if (lane == 0) {
          Select next = cur;
          if (pass == 0 && total <= static_cast<unsigned>(cur.room)) {
            next.floor = 1ull;
            next.count = static_cast<int>(total);
            next.state = kFinal;
          } else if (above >= static_cast<unsigned>(cur.need)) {
            next.floor = cur.prefix | (static_cast<u64>(nb) << cur.shift);
            next.count = cur.cap - cur.room + static_cast<int>(above);
            next.state = kFound;
          } else {
            next.room -= static_cast<int>(above);
            next.need -= static_cast<int>(above);
            if (at_b1 == total) {  // a digit they all share: on to their first difference
              const int top = 63 - __clzll(or_all ^ and_all);
              next.shift = top / kDigitBits * kDigitBits;
              next.mask = ~((1ull << (next.shift + kDigitBits)) - 1ull);
              next.prefix = or_all & next.mask;
            } else {
              next.prefix = cur.prefix | (static_cast<u64>(b1) << cur.shift);
              next.mask = cur.mask | (static_cast<u64>(kBins - 1) << cur.shift);
              next.shift = cur.shift - kDigitBits;
            }
          }
          if (next.state != kGoOn) s_count = 0;
          s_sel = next;
        }
      }
      cluster_sync(csize);
    }
    const Select win = s_cur;
    NMS_STAMP(1);

    // ---- compact the window's keys into the first block, pad, sort: a warp
    // reserves the room for its kUnroll * 32 keys' window keys with one atomic
    for (int base = lo; base < hi; base += kUnroll * kThreads) {
      u64 key[kUnroll];
      unsigned ballot[kUnroll];
      int n = 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads + tid;
        key[u] = i < hi ? key_at(i) : 0ull;
        // floor >= 1: live keys only
        ballot[u] = __ballot_sync(0xffffffffu, key[u] >= win.floor && key[u] < ceiling);
        n += __popc(ballot[u]);
      }
      int slot = 0;
      if (lane == 0 && n) slot = atomicAdd(count0, n);
      slot = __shfl_sync(0xffffffffu, slot, 0);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if ((ballot[u] >> lane) & 1u) {
          wkey0[slot + __popc(ballot[u] & ((1u << lane) - 1u))] = key[u];
          asm volatile("prefetch.global.L2 [%0];" ::"l"(gbox + base + u * kThreads + tid));
        }
        slot += __popc(ballot[u]);
      }
    }
    cluster_sync(csize);
    NMS_STAMP(2);
    if (first) {
      const int n = win.count;  // == s_count
      const int npad = pad_keys(n);
      for (int i = n + tid; i < npad; i += kThreads) wkey[i] = 0ull;
      __syncthreads();
      sort_keys_desc(wkey, npad);
      __syncthreads();
      for (int p = tid; p < n; p += kThreads) wbox[p] = gbox[key_index(wkey[p])];
      __syncthreads();
      NMS_STAMP(3);
      nk = scan_chunks<true>(wkey, npad, kept, nk, wbox, gscore,
                             sel_idx + static_cast<size_t>(img) * K,
                             sel_scores + static_cast<size_t>(img) * K, K, thr);
      if (tid == 0) s_more = nk < K && win.state != kFinal;
      NMS_STAMP(4);
    }
    cluster_sync(csize);
    NMS_STAMP(5);
    if (!*more0) break;
    ceiling = win.floor;
  }
  if (first)
    fill_tail(sel_idx + static_cast<size_t>(img) * K, sel_scores + static_cast<size_t>(img) * K,
              nk, K);
  NMS_STAMP_END(first, img);
  cluster_sync(csize);  // no block leaves while another reads its shared memory
}

// Past 48 KiB of shared memory a block, static arrays (up to 8 KiB here)
// included, a launch needs the kernel's opt-in. It is set once a device for
// the largest size asked so far (`granted`, per kernel), so that a launch
// captured into a CUDA graph after a first one sets nothing.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, int* granted) {
  if (smem <= 40 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (granted[dev] >= static_cast<int>(smem)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess) granted[dev] = static_cast<int>(smem);
  return e;
}

}  // namespace

// Returns cudaGetLastError() after the launch, or the error that stopped it.
// (thr_mid, thr_tie_up) is the threshold test of `suppresses`, worked out
// from iou_thr by the caller. `window` 0: each image staged whole; else
// window by window, the first of `window` keys, each refill's four times
// the last, within `window_max` (powers of two, 64 <= window <= window_max
// <= kWindowMax), with `cluster` blocks an image (1 .. kMaxCluster; more
// than 1 launches a thread-block cluster), each block's slice of the scores
// staged in shared memory when `staged`. cudaErrorInvalidValue when P is
// past what the kernel indexes, the kept list does not fit beside the image
// or the window, or `staged` scores do not fit beside them; the wrapper
// plans within all three first (nms_kernel.nms_plan). A refused cluster
// launch returns its error.
extern "C" int mbx_nms(const void* boxes, const void* scores, void* sel_idx, void* sel_scores,
                       int B, int P, int K, float iou_thr, double thr_mid, int thr_tie_up,
                       float score_thr, int window, int window_max, int cluster, int staged,
                       void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (P <= 0 || P > (1 << 30) || window < 0 || window_max > kWindowMax ||
      (window & (window - 1)) || (window_max & (window_max - 1)) ||
      (window && (window < 64 || window_max < window)) || cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const Threshold thr{iou_thr, thr_mid, thr_tie_up != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* b4 = static_cast<const float4*>(boxes);
  const float* sc = static_cast<const float*>(scores);
  int* oi = static_cast<int*>(sel_idx);
  float* os = static_cast<float*>(sel_scores);
  if (window == 0) {
    const size_t smem = full_smem_bytes(P, K);
    if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
    static int granted[64];
    cudaError_t e = allow_smem(nms_full_kernel, smem, granted);
    if (e != cudaSuccess) return static_cast<int>(e);
    nms_full_kernel<<<B, kThreads, smem, st>>>(b4, sc, oi, os, P, K, thr, score_thr);
    return static_cast<int>(cudaGetLastError());
  }
  const int slice = ((P + cluster - 1) / cluster + 3) & ~3;
  const size_t smem = window_smem_bytes(window_max, K, P, staged ? slice : 0);
  if (smem > kSmemLimit ||
      (staged && (static_cast<size_t>(slice) * 4 + kTileBytes - 1) / kTileBytes > kMaxTiles))
    return static_cast<int>(cudaErrorInvalidValue);
  static int granted[64];
  cudaError_t e = allow_smem(nms_window_kernel, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, nms_window_kernel, b4, sc, oi, os, P, K, thr, score_thr, window,
                         window_max, cluster, slice, staged ? 1 : 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
