"""CUDA kernel: batched hard NMS + top-k.

Replaces ``nms_pallas_batched`` / ``nms_pallas`` of the JAX package
(``multibox_tpu/ops/pallas/nms_kernel.py``). Semantics are those of that
package's ``ops.nms._nms_jnp``: select boxes in descending score order
(lowest index on ties), suppressing any box whose IoU with a selected box
exceeds ``iou_threshold``; boxes below ``score_threshold`` are never
selected; empty slots carry index −1 and score −1.

Bound on this card: neither bytes (B=32, P=256 moves about 164 KB) nor
flops, but the chain of dependent steps. Only winners suppress and they
come out in (score descending, index ascending) order, so the kernel walks
the live boxes in that order, in chunks of 32: each candidate is tested
against the boxes kept so far and against the chunk's earlier candidates by
all the block's threads at once, then one warp resolves the chunk in order
with ballots. Two block barriers a chunk instead of two a selected box. The
order is that of 64-bit keys: the score's order-preserving bits with −0.0
made +0.0, then the complemented index (:func:`nms_keys`). The IoU
threshold test is the plain version's rounded division decided without
dividing (:func:`threshold_split`). It stops at K kept.

The walk reads a few hundred keys, so the kernel orders no more than it
reads. An image of at most :data:`WHOLE` boxes is staged whole in shared
memory and all its keys bitonic-sorted. A larger one goes window by window
(:func:`nms_plan` picks the window from K, a thread-block cluster of up
to 8 blocks an image when B is small for the card's SMs, and whether each
block's scores are staged in shared memory by bulk copies): a radix selection over the keys'
8-bit digits (:func:`radix_select`) finds the floor of the next keys in the
order, those are compacted into shared memory, sorted and scanned, and
while fewer than K are kept and live keys remain below the floor, the next
window is selected below it (the refill) and the scan goes on with the same
kept list. Exact for any data; the window only sets the speed. One refusal
(:func:`nms_fits`): more boxes than the kernel indexes, or a kept list that
does not fit in shared memory beside the window.
:func:`sorted_scan_emulation` is the same algorithm step by step in numpy,
for the CPU tests and for the work ``chip_smoke.py`` counts. The TPU
kernel's shape (8 images on the sublane axis, 128-lane padding, masked row
sums instead of indexing) answered that compiler's limits and is not
carried over.

The launch is the operator ``multibox_torch::nms_select``
(``torch.library.custom_op``), so that ``torch.export`` records it as one
call and an exported program counts its launches when it runs.

:func:`nms_batched_plain` is the plain PyTorch version: same arithmetic op
for op, so indices and scores agree exactly.

Source: ``csrc/nms.cu``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from multibox_tpu_torch.ops import boxes as box_ops
from multibox_tpu_torch.ops import kernels as K

CHUNK = 32  # csrc/nms.cu kChunk
SMEM_LIMIT = 227 * 1024 - 16 * 1024  # csrc/nms.cu kSmemLimit
MAX_P = 1 << 30  # csrc/nms.cu mbx_nms: indices and the padded count stay int
DIGIT_BITS = 8  # csrc/nms.cu kDigitBits: the radix selection's digit
# The plan's constants, from scripts/torch_kernel_design.py's b1_window sweep
# (PERF.md §6). An image of at most WHOLE boxes (padded to a power of
# two) is staged whole and all its keys sorted; a larger one goes window by
# window, the first window's capacity a power of two between MIN_WINDOW and
# 1,024 keys, each refill's four times the last, up to the largest that fits
# beside the kept list (at most MAX_WINDOW; csrc/nms.cu kWindowMax at most):
# the selection stops once the keys at or above its floor number at least
# half of the capacity and at most all of it.
WHOLE = 1024
MIN_WINDOW, FIRST_WINDOW_MAX, MAX_WINDOW = 256, 1024, 2048
WINDOW_KEY_BYTES = 8 + 16  # a window's key and its gathered box
MAX_CLUSTER = 8  # blocks an image at most (the portable cluster size)
# A cluster an image past CLUSTER_MIN_P boxes, while B * cluster stays within
# half the card's SMs and each block of it counts at least CLUSTER_SLICE keys.
CLUSTER_MIN_P = 8192
CLUSTER_SLICE = 2048
TILE_BYTES, MAX_TILES = 16384, 16  # csrc/nms.cu kTileBytes, kMaxTiles: the staged scores


class NmsPlan(NamedTuple):
    """How ``mbx_nms`` runs one call: ``window`` 0 stages each image whole,
    else the first window's capacity in keys, each refill's four times
    the last up to ``window_max``; ``cluster`` blocks an image (a thread-block
    cluster when more than one); ``staged``: window by window, each block's
    slice of the scores is staged in shared memory by bulk copies, else
    every histogram pass reads them from global memory."""
    window: int
    window_max: int
    cluster: int
    staged: bool


def pad_keys(P: int) -> int:
    """P padded to a power of two, at least 64 (csrc/nms.cu ``pad_keys``)."""
    return max(64, 1 << (max(P, 1) - 1).bit_length())


def window_for(max_outputs: int) -> int:
    """The first window for K outputs: twice K padded to a power of two,
    within [MIN_WINDOW, FIRST_WINDOW_MAX]. The scan reads about 2K keys on
    random boxes (5-6 chunks of 32 at K = 100, 11-12 at K = 200), and a
    window holds at least half its capacity, so one window mostly does.
    Where suppression is heavier (the SSD path's own inputs read 17-22
    chunks an image at K = 100), the refill's window is four times the
    last, so one refill mostly does."""
    return min(FIRST_WINDOW_MAX, max(MIN_WINDOW, pad_keys(2 * max_outputs)))


def window_max_for(max_outputs: int, P: int) -> int:
    """The room a launch allocates for its windows: the largest power of
    two up to :data:`MAX_WINDOW` that fits beside the kept list, and never
    less than the first window."""
    room = MAX_WINDOW
    kept = min(max_outputs, P) * 16
    while room > window_for(max_outputs) and room * WINDOW_KEY_BYTES + kept > SMEM_LIMIT:
        room //= 2
    return room


def nms_fits(P: int, max_outputs: int) -> bool:
    """Does csrc/nms.cu run this image? At most :data:`MAX_P` boxes, and a
    kept list (min(K, P) boxes of 16 B) that fits in one block's shared
    memory beside the image staged whole (its padded keys, 16 B a box and 4
    B a score, for at most :data:`WHOLE` boxes) or beside one window (8 B a
    key and 16 B its box)."""
    if P > MAX_P:
        return False
    kept = min(max_outputs, P) * 16
    if pad_keys(P) <= WHOLE:
        return pad_keys(P) * 8 + P * 20 + kept <= SMEM_LIMIT
    return window_for(max_outputs) * WINDOW_KEY_BYTES + kept <= SMEM_LIMIT


def nms_windows(P: int, max_outputs: int) -> Tuple[int, int]:
    """``(window, window_max)`` of an image of P boxes: ``(0, 0)`` where it
    is staged whole (at most :data:`WHOLE` boxes, padded), else
    :func:`window_for` and :func:`window_max_for`."""
    if pad_keys(P) <= WHOLE:
        return 0, 0
    return window_for(max_outputs), window_max_for(max_outputs, P)


def scores_staged(P: int, max_outputs: int, window_max: int, cluster: int) -> bool:
    """Do a block's scores fit in shared memory (csrc/nms.cu
    ``window_smem_bytes``) beside the window's room and the kept list, in at
    most :data:`MAX_TILES` bulk copies? Each of an image's ``cluster``
    blocks holds a slice of P / cluster scores, rounded up to 4, and 16 B
    more to align the copies."""
    slice_ = (-(-P // cluster) + 3) & ~3
    smem = window_max * WINDOW_KEY_BYTES + min(max_outputs, P) * 16 + (slice_ + 4) * 4
    return smem <= SMEM_LIMIT and -(-slice_ * 4 // TILE_BYTES) <= MAX_TILES


def nms_plan(B: int, P: int, max_outputs: int, sms: int) -> NmsPlan:
    """The launch's plan on a card of ``sms`` SMs (:func:`sm_count`);
    raises ValueError where :func:`nms_fits` says the kernel does not run
    the image. Past :data:`CLUSTER_MIN_P` boxes, the cluster is the largest
    of 1, 2, 4, 8 blocks an image that keeps B × cluster within half the
    SMs and gives each block at least :data:`CLUSTER_SLICE` keys (at P =
    4,096 one block was faster than two; at B = 32 a cluster of 4, on 128
    of an H100's 132 SMs, lost to 2). The scores are staged where
    :func:`scores_staged` says they fit."""
    K.require(P <= MAX_P, "nms: {} boxes per image exceed the {} the kernel indexes",
              P, MAX_P)
    K.require(nms_fits(P, max_outputs),
              "nms: a kept list of {} boxes does not fit in one block's shared memory "
              "beside a window of {} keys ({} bytes)", min(max_outputs, P),
              window_for(max_outputs), SMEM_LIMIT)
    window, window_max = nms_windows(P, max_outputs)
    if not window:
        return NmsPlan(0, 0, 1, False)
    cluster = 1
    while (P > CLUSTER_MIN_P and 2 * cluster <= MAX_CLUSTER
           and B * 2 * cluster <= sms // 2 and P >= 2 * cluster * CLUSTER_SLICE):
        cluster *= 2
    return NmsPlan(window, window_max, cluster,
                   scores_staged(P, max_outputs, window_max, cluster))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The SMs of the CUDA device ``device``, read once a device."""
    device = torch.device(device)
    return _sm_count(torch.cuda.current_device() if device.index is None else device.index)


def nms_keys(scores: np.ndarray, score_threshold: float) -> np.ndarray:
    """One image's 64-bit sort keys as csrc/nms.cu makes them: the score's
    bits made order-preserving (-0.0 made +0.0 first), then the complemented
    index, so that a larger key comes first in the spec's order (score
    descending, lowest index on ties); 0 for a box that is never live (below
    the score threshold, NaN, -inf). Keys of live boxes are unique."""
    s = np.asarray(scores, np.float32)
    live = (s >= np.float32(score_threshold)) & (s != np.float32(-np.inf))
    bits = (s + np.float32(0)).view(np.uint32)  # -0.0 + 0.0 = +0.0
    order_bits = np.where(bits & np.uint32(0x80000000), ~bits, bits | np.uint32(0x80000000))
    key = (order_bits.astype(np.uint64) << np.uint64(32)) | \
        (~np.arange(len(s), dtype=np.uint32)).astype(np.uint64)
    key[~live] = 0
    return key


NO_CEILING = (1 << 64) - 1  # above every live key (the largest is +inf's at index 0)


class Window(NamedTuple):
    """A window of the radix selection: the live keys in [floor, ceiling),
    ``count`` of them; ``final`` when they are every live key below the
    ceiling; ``passes`` histogram passes over the keys found it."""
    floor: int
    count: int
    passes: int
    final: bool


def radix_select(keys: np.ndarray, ceiling: int = NO_CEILING,
                 cap: int = MAX_WINDOW) -> Window:
    """csrc/nms.cu's selection of the next window below ``ceiling``, in
    numpy. Histogram passes over the keys' 8-bit digits, highest first, over
    the live keys below the ceiling that share the digits fixed so far:
    counting the bins from the top, the first whose running count passes
    the room left (``cap`` less the keys taken) is b1. When the bins above
    b1 hold at least what is still needed (half of ``cap``, less the keys
    taken), the window's floor is the start of bin b1 + 1; else b1's digit is
    fixed, the bins above it are taken, and the next pass counts b1's keys
    by the next digit. A pass whose keys all share its digit goes straight
    to the digit of their highest differing bit. On the first pass, when
    every live key below the ceiling fits, they are the window (``final``).
    Keys are unique, so a pass over the last digit always stops."""
    keys = np.asarray(keys, np.uint64)
    live = keys[(keys != 0) & (keys < np.uint64(ceiling))]
    prefix, mask, shift = 0, 0, 64 - DIGIT_BITS
    room, need = cap, cap // 2
    passes = 0
    while True:
        cand = live[(live & np.uint64(mask)) == np.uint64(prefix)]
        passes += 1
        if passes == 1 and len(cand) <= room:
            return Window(1, len(cand), passes, True)
        hist = np.bincount(((cand >> np.uint64(shift)) & np.uint64(255)).astype(np.int64),
                           minlength=256)
        cum = np.cumsum(hist[::-1])[::-1]  # cum[b]: the keys in bins b .. 255
        b1 = int(np.flatnonzero(cum > room).max())
        above = int(cum[b1 + 1]) if b1 < 255 else 0
        if above >= need:
            return Window(prefix | ((b1 + 1) << shift), cap - room + above, passes, False)
        room, need = room - above, need - above
        if hist[b1] == len(cand):  # a digit they all share: on to their first difference
            top = int(np.bitwise_or.reduce(cand)) ^ int(np.bitwise_and.reduce(cand))
            shift = (top.bit_length() - 1) // DIGIT_BITS * DIGIT_BITS
            mask = ((1 << 64) - 1) ^ ((1 << (shift + DIGIT_BITS)) - 1)
            prefix = int(cand[0]) & mask
        else:
            prefix |= b1 << shift
            mask |= 255 << shift
            shift -= DIGIT_BITS


def nms_batched_plain(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_outputs: int,
    iou_threshold: float = 0.5,
    score_threshold: float = float("-inf"),
):
    """Plain PyTorch batched NMS: ``boxes [B, P, 4]``, ``scores [B, P]`` →
    ``(sel_idx [B, K] int32, sel_scores [B, K] float32)``. K rounds, each
    vectorised over the batch and the boxes."""
    B, P = scores.shape
    dev = scores.device
    neg_inf = float("-inf")
    sel_idx = torch.full((B, max_outputs), -1, dtype=torch.int32, device=dev)
    sel_scores = torch.full((B, max_outputs), -1.0, dtype=torch.float32, device=dev)
    if P == 0:
        return sel_idx, sel_scores
    boxes = boxes.to(torch.float32)
    scores32 = scores.to(torch.float32)
    live = torch.where(scores32 >= score_threshold, scores32,
                       torch.full_like(scores32, neg_inf))
    col = torch.arange(P, device=dev)
    for k in range(max_outputs):
        best_score = live.max(dim=1).values  # [B]
        # lowest index among the maxima, explicitly
        best = torch.where(live == best_score[:, None], col, P).min(dim=1).values
        valid = best_score > neg_inf
        sel_idx[:, k] = torch.where(valid, best, -1).to(torch.int32)
        sel_scores[:, k] = torch.where(valid, best_score, -1.0)
        best_box = torch.gather(boxes, 1, best[:, None, None].expand(B, 1, 4))
        ious = box_ops.iou_pairwise(best_box, boxes)  # [B, P]
        suppress = (ious > iou_threshold) | (col[None, :] == best[:, None])
        live = torch.where(valid[:, None] & suppress,
                           torch.full_like(live, neg_inf), live)
    return sel_idx, sel_scores


@functools.lru_cache(maxsize=64)
def threshold_split(iou_threshold: float):
    """``(mid, tie_up)`` such that, for inter >= 0 and u > 0 in float32,
    ``fl(inter / u) > thr`` (thr = ``iou_threshold`` as float32, fl rounding
    to nearest even) exactly when ``inter > mid * u`` or, with ``tie_up``,
    ``inter == mid * u``, in double precision, where ``mid * u`` is exact.
    ``mid`` is the midpoint between thr and the next float32 up, where the
    rounding of the quotient changes sides; ``tie_up`` says whether a
    quotient on it rounds up (the float above is the even one). The kernel
    tests its threshold this way, without a division."""
    thr = np.float32(iou_threshold)
    if np.isnan(thr) or thr == np.inf:
        return float(thr), False  # the spec's test never passes
    with np.errstate(over="ignore"):
        up = np.nextafter(thr, np.float32(np.inf))
    if np.isinf(up):  # thr is the largest float: past it a quotient overflows
        return float(thr) + 2.0 ** 103, True
    return (float(thr) + float(up)) / 2, bool((up.view(np.uint32) & 1) == 0)


def _suppresses(best: np.ndarray, box: np.ndarray, iou_threshold: float):
    """``csrc/nms.cu::suppresses`` in numpy: float32 operations rounded one
    at a time, then the threshold test of :func:`threshold_split` in double.
    Does each row of ``best [N, 4]`` (kept first) suppress ``box [4]``?"""
    def area(b):
        return np.fmax(b[..., 2] - b[..., 0], np.float32(0)) * \
            np.fmax(b[..., 3] - b[..., 1], np.float32(0))

    ih = np.fmax(np.fmin(box[2], best[:, 2]) - np.fmax(box[0], best[:, 0]), np.float32(0))
    iw = np.fmax(np.fmin(box[3], best[:, 3]) - np.fmax(box[1], best[:, 1]), np.float32(0))
    inter = ih * iw
    union = (area(best) + area(box)) - inter
    mid, tie_up = threshold_split(iou_threshold)
    lhs = inter.astype(np.float64)
    rhs = mid * np.fmax(union, np.float32(1e-8)).astype(np.float64)
    hit = (lhs > rhs) | (tie_up & (lhs == rhs))
    return np.where(union > 0, hit, np.float32(0) > np.float32(iou_threshold))


def _candidates(s: np.ndarray, score_threshold: float) -> np.ndarray:
    """The live boxes of one image in the kernel's order: its keys
    (:func:`nms_keys`) sorted descending, the dead dropped."""
    key = nms_keys(s, score_threshold)
    return np.argsort(key, kind="stable")[::-1][:int((key != 0).sum())]


class ScanWork(NamedTuple):
    """The work csrc/nms.cu does on each image ([B] each): chunks of
    candidates scanned, windows selected (1 for an image staged whole) and
    histogram passes of the selection (0 for an image staged whole)."""
    chunks: np.ndarray
    windows: np.ndarray
    passes: np.ndarray


def _scan_window(boxes, cand, kept, max_outputs, thr, chunk):
    """The scan of one window's candidates (box indices in the kernel's
    order) in chunks, appending to ``kept``; returns the chunks run: (a)
    each candidate against the kept list, (b) the chunk's suppression bits
    (row i: the earlier candidates j whose IoU with i exceeds the
    threshold), (c) the ballot iteration ``keep = F(keep)`` from "every live
    one" to its fixed point, the cut at K, the append."""
    chunks = 0
    for c0 in range(0, len(cand), chunk):
        if len(kept) >= max_outputs:
            break
        chunks += 1
        ch = cand[c0:c0 + chunk]
        kept_boxes = boxes[kept] if kept else np.zeros((0, 4), np.float32)
        dead = [bool(_suppresses(kept_boxes, boxes[i], thr).any()) for i in ch]  # (a)
        rows = [sum(1 << j for j in np.flatnonzero(_suppresses(boxes[ch[:i]], boxes[ch[i]], thr)))
                for i in range(len(ch))]  # (b)
        keep = sum(1 << i for i in range(len(ch)) if not dead[i])  # (c)
        while True:
            nxt = sum(1 << i for i in range(len(ch)) if not dead[i] and not rows[i] & keep)
            if nxt == keep:
                break
            keep = nxt
        order = [i for i in range(len(ch)) if keep >> i & 1]
        kept.extend(int(ch[i]) for i in order[:max_outputs - len(kept)])
    return chunks


def sorted_scan_emulation(boxes, scores, max_outputs: int, iou_threshold: float = 0.5,
                          score_threshold: float = float("-inf"), chunk: int = CHUNK,
                          window: Optional[int] = None, window_max: Optional[int] = None):
    """What ``csrc/nms.cu`` does, step by step in numpy, with ``window``
    and ``window_max`` as :func:`nms_windows`' (None) or given (``window_max``
    defaults to ``window``). ``window`` 0: each image staged whole, its keys
    (:func:`nms_keys`) sorted descending. Else window by window:
    :func:`radix_select` finds the floor of the next keys in the order,
    those keys are sorted, and the scan (:func:`_scan_window`) goes on over
    them with the same kept list; while fewer than K are kept and live keys
    remain below the floor, the next window, four times as large up to
    ``window_max``, is selected below it.
    ``boxes [B, P, 4]``, ``scores [B, P]`` (float32 arrays) → ``(sel_idx [B,
    K] int32, sel_scores [B, K] float32, ScanWork)``."""
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    B, P = scores.shape
    sel_idx = np.full((B, max_outputs), -1, np.int32)
    sel_scores = np.full((B, max_outputs), -1.0, np.float32)
    work = ScanWork(*(np.zeros(B, np.int64) for _ in range(3)))
    if window is None:
        window, window_max = nms_windows(P, max_outputs)
    window_max = window_max or window
    for b in range(B):
        s = scores[b]
        kept = []
        if not window:
            work.windows[b] = 1
            work.chunks[b] = _scan_window(boxes[b], _candidates(s, score_threshold), kept,
                                          max_outputs, iou_threshold, chunk)
        else:
            keys = nms_keys(s, score_threshold)
            ceiling, cap = NO_CEILING, window
            while len(kept) < max_outputs:
                win = radix_select(keys, ceiling, cap)
                work.windows[b] += 1
                work.passes[b] += win.passes
                inside = keys[(keys >= np.uint64(win.floor)) & (keys < np.uint64(ceiling))]
                assert len(inside) == win.count
                cand = (~(np.sort(inside)[::-1] & np.uint64(0xFFFFFFFF)).astype(np.uint32)) \
                    .astype(np.int64)
                work.chunks[b] += _scan_window(boxes[b], cand, kept, max_outputs,
                                               iou_threshold, chunk)
                if win.final:
                    break
                ceiling, cap = win.floor, min(4 * cap, window_max)
        sel_idx[b, :len(kept)] = kept
        sel_scores[b, :len(kept)] = s[kept]
    return sel_idx, sel_scores, work


def greedy_iou_tests(boxes, scores, sel_idx, iou_threshold: float = 0.5,
                     score_threshold: float = float("-inf")) -> int:
    """The IoU tests that greedy NMS needs for this output, summed over the
    images: each live candidate, in score order up to the last one the
    selection reached, against the boxes kept before it, stopping at the
    first that suppresses it. The work a bound of the kernel may count.
    ``sel_idx [B, K]`` is the selection (-1 in empty slots) for ``boxes
    [B, P, 4]`` and ``scores [B, P]``; raises if it is not greedy NMS's."""
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    sel_idx = np.asarray(sel_idx)
    K_out = sel_idx.shape[1]
    tests = 0
    for b in range(scores.shape[0]):
        kept = [int(i) for i in sel_idx[b] if i >= 0]
        j = 0  # boxes kept so far
        for c in _candidates(scores[b], score_threshold):
            if j == K_out:
                break
            if j < len(kept) and c == kept[j]:
                tests += j  # none of the j kept before it suppresses it
                j += 1
                continue
            hit = np.flatnonzero(_suppresses(boxes[b, kept[:j]], boxes[b, c], iou_threshold))
            if not len(hit):
                raise ValueError(f"image {b}: candidate {c} is neither kept nor suppressed")
            tests += int(hit[0]) + 1
        if j != len(kept):
            raise ValueError(f"image {b}: {len(kept) - j} selected boxes were not reached")
    return tests


def greedy_candidates(scores, sel_idx, score_threshold: float = float("-inf")) -> int:
    """The live candidates greedy NMS reads for this output, summed over the
    images: in score order up to the K-th box kept, or every live one where
    fewer than K were kept. The boxes a bound of the kernel may count as
    read, beside every score. ``sel_idx [B, K]`` is the selection (-1 in
    empty slots) for ``scores [B, P]``."""
    scores = np.asarray(scores, np.float32)
    sel_idx = np.asarray(sel_idx)
    K_out = sel_idx.shape[1]
    reached = 0
    for b in range(scores.shape[0]):
        cand = _candidates(scores[b], score_threshold)
        kept = sel_idx[b][sel_idx[b] >= 0]
        if K_out and len(kept) == K_out:
            reached += int(np.flatnonzero(cand == kept[-1])[0]) + 1
        elif K_out:
            reached += len(cand)
    return reached


def _check_nms(boxes: torch.Tensor, scores: torch.Tensor, max_outputs: int) -> None:
    K.require(boxes.dim() == 3 and boxes.shape[-1] == 4 and scores.dim() == 2
              and boxes.shape[:2] == scores.shape,
              f"nms: boxes [B, P, 4] and scores [B, P] expected, got "
              f"{tuple(boxes.shape)} / {tuple(scores.shape)}")
    K.require(max_outputs >= 0, "nms: max_outputs must be >= 0")
    K.require(scores.device == boxes.device,
              f"nms: boxes on {boxes.device}, scores on {scores.device}")


def nms_select(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_outputs: int,
    iou_threshold: float = 0.5,
    score_threshold: float = float("-inf"),
):
    """The kernel's own outputs: ``(sel_idx [B, K] int32, sel_scores [B, K]
    float32)`` for ``boxes [B, P, 4]`` f32 and ``scores [B, P]`` f32,
    through the operator ``multibox_torch::nms_select``
    (:func:`nms_select_op`). On a CUDA tensor this launches the kernel (or
    raises); a CPU tensor takes :func:`nms_batched_plain`."""
    return nms_select_op(boxes, scores, int(max_outputs), float(iou_threshold),
                         float(score_threshold))


@torch.library.custom_op("multibox_torch::nms_select", mutates_args=())
def nms_select_op(boxes: torch.Tensor, scores: torch.Tensor, max_outputs: int,
                  iou_threshold: float, score_threshold: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The operator behind :func:`nms_select`: the launch on the plan
    :func:`nms_plan` makes (counted here, once a call, so an exported
    program counts its launches when it runs), the plain version for a CPU
    tensor."""
    _check_nms(boxes, scores, max_outputs)
    if not boxes.is_cuda:
        return nms_batched_plain(
            boxes, scores, max_outputs, iou_threshold, score_threshold)
    B, P = scores.shape
    K.require(boxes.dtype == torch.float32 and scores.dtype == torch.float32,
              f"nms: float32 only, got {boxes.dtype} / {scores.dtype}")
    K.require(boxes.is_contiguous() and scores.is_contiguous(),
              "nms: tensors must be contiguous")
    K.require(boxes.data_ptr() % 16 == 0,
              "nms: boxes must start on a 16-byte boundary (one float4 a box)")
    plan = nms_plan(B, P, max_outputs, sm_count(boxes.device))
    sel_idx = torch.empty((B, max_outputs), dtype=torch.int32, device=boxes.device)
    sel_scores = torch.empty((B, max_outputs), dtype=torch.float32,
                             device=boxes.device)
    if P == 0:
        sel_idx.fill_(-1)
        sel_scores.fill_(-1.0)
    elif B > 0 and max_outputs > 0:
        err = K.load_library().mbx_nms(
            boxes.data_ptr(), scores.data_ptr(), sel_idx.data_ptr(), sel_scores.data_ptr(),
            B, P, max_outputs, iou_threshold, *threshold_split(iou_threshold),
            score_threshold, plan.window, plan.window_max, plan.cluster, int(plan.staged),
            K.current_stream_ptr())
        K.check_launch(err, "mbx_nms")
        K.LAUNCHES["nms"] += 1
    return sel_idx, sel_scores


@nms_select_op.register_fake
def _nms_select_fake(boxes, scores, max_outputs, iou_threshold, score_threshold):
    _check_nms(boxes, scores, max_outputs)
    B = scores.shape[0]
    return (boxes.new_empty((B, max_outputs), dtype=torch.int32),
            boxes.new_empty((B, max_outputs), dtype=torch.float32))


def nms_cuda_batched(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_outputs: int,
    iou_threshold: float = 0.5,
    score_threshold: float = float("-inf"),
):
    """Batched NMS + top-k with the gather and the count done outside the
    kernel: returns ``(sel_boxes [B, K, 4], sel_scores [B, K], sel_idx
    [B, K] int32, num_valid [B] int32)``."""
    sel_idx, sel_scores = nms_select(
        boxes, scores, max_outputs, iou_threshold, score_threshold)
    num_valid = (sel_idx >= 0).sum(dim=1, dtype=torch.int32)
    return gather_selected(boxes, sel_idx), sel_scores, sel_idx, num_valid


def gather_selected(boxes: torch.Tensor, sel_idx: torch.Tensor) -> torch.Tensor:
    """``boxes[b, sel_idx[b, k]]`` with zeros in the empty (−1) slots."""
    B, Kout = sel_idx.shape
    if boxes.shape[1] == 0:
        return boxes.new_zeros((B, Kout, 4))
    safe = sel_idx.clamp_min(0).to(torch.int64)[..., None].expand(B, Kout, 4)
    picked = torch.gather(boxes, 1, safe)
    return torch.where((sel_idx >= 0)[..., None], picked, torch.zeros_like(picked))
