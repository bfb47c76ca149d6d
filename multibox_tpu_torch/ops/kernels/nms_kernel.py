"""CUDA kernel: batched hard NMS + top-k.

Replaces ``nms_pallas_batched`` / ``nms_pallas`` of the JAX package
(``multibox_tpu/ops/pallas/nms_kernel.py``). Semantics are those of that
package's ``ops.nms._nms_jnp``: select boxes in descending score order
(lowest index on ties), suppressing any box whose IoU with a selected box
exceeds ``iou_threshold``; boxes below ``score_threshold`` are never
selected; empty slots carry index −1 and score −1.

Bound on this card: neither bytes (B=32, P=256 moves about 164 KB) nor
flops, but the chain of dependent steps. The first version ran the spec's K
rounds literally, a block-wide arg-max and two barriers each, about 1 µs a
round. Only winners suppress and they come out in (score descending, index
ascending) order, so the kernel now stages the scores (and the boxes, when
they fit in shared memory) in one round trip, sorts the live boxes by that
order once (a bitonic sort of 64-bit keys: the score's order-preserving
bits with −0.0 made +0.0, then the complemented index; the strides within a
warp in registers), and walks them in chunks of 32: each candidate is tested
against the boxes kept so far and against the chunk's earlier candidates by
all the block's threads at once, then one warp resolves the chunk in order
with ballots. Two block barriers a chunk (5-6 chunks at the detect shape)
instead of two a selected box. The IoU threshold test is the plain
version's rounded division decided without dividing
(:func:`threshold_split`). It stops at K kept or at the first dead
candidate. :func:`sorted_scan_emulation` is the same algorithm step by step
in numpy, for the CPU tests. The TPU kernel's shape (8 images on the sublane
axis, 128-lane padding, masked row sums instead of indexing) answered that
compiler's limits and is not carried over.

Two routes (:func:`nms_route`): the keys in shared memory (up to
:data:`MAX_BOXES` boxes, with the kept list beside them), or, past that, in
a global scratch ``[B, npad]`` of 64-bit words that the wrapper allocates:
the block sorts them in tiles of :data:`MAX_BOXES` in shared memory and
merges the tiles over global memory (:func:`tiled_bitonic_sort` is the
network, in numpy), then scans them as before with the kept list in shared
memory. The SSD detect with flip TTA (18,936 boxes an image) takes the
second route. Both give the same result, bitwise.

The launch is the operator ``multibox_torch::nms_select``
(``torch.library.custom_op``), so that ``torch.export`` records it as one
call and an exported program counts its launches when it runs.

:func:`nms_batched_plain` is the plain PyTorch version: same arithmetic op
for op, so indices and scores agree exactly.

Source: ``csrc/nms.cu``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from multibox_tpu_torch.ops import boxes as box_ops
from multibox_tpu_torch.ops import kernels as K

# The sort keys (8 B a box, P padded to a power of two) of the shared route:
# 128 KiB at this many boxes; also the tile of the global-keys route.
MAX_BOXES = 16384
CHUNK = 32  # csrc/nms.cu kChunk
SMEM_LIMIT = 227 * 1024 - 16 * 1024  # csrc/nms.cu kSmemLimit
MAX_P = 1 << 30  # csrc/nms.cu mbx_nms: indices and the padded count stay int


def pad_keys(P: int) -> int:
    """P padded to a power of two, at least 64 (csrc/nms.cu ``pad_keys``)."""
    return max(64, 1 << (max(P, 1) - 1).bit_length())


def kept_list_fits(P: int, max_outputs: int) -> bool:
    """Do the sort keys (P padded to a power of two, at least 64) and the
    kept list (min(K, P) boxes of 16 B) fit in one block's shared memory?
    csrc/nms.cu's ``smem_bytes`` without the staged boxes."""
    return pad_keys(P) * 8 + min(max_outputs, P) * 16 <= SMEM_LIMIT


def nms_route(P: int, max_outputs: int) -> str:
    """``"shared"`` when the sort keys and the kept list fit in one block's
    shared memory beside each other, else ``"global"`` (keys in a global
    scratch, csrc/nms.cu ``nms_global_kernel``: a tile of keys, then the
    kept list, in shared memory). Raises ValueError for what neither route
    runs: a kept list larger than shared memory by itself, or more than
    :data:`MAX_P` boxes."""
    K.require(P <= MAX_P, "nms: {} boxes per image exceed the {} the kernel indexes",
              P, MAX_P)
    if P <= MAX_BOXES and kept_list_fits(P, max_outputs):
        return "shared"
    K.require(min(max_outputs, P) * 16 <= SMEM_LIMIT,
              "nms: a kept list of {} boxes does not fit in one block's shared memory "
              "({} bytes)", min(max_outputs, P), SMEM_LIMIT)
    return "global"


def tiled_bitonic_sort(keys: np.ndarray, tile: int = MAX_BOXES) -> np.ndarray:
    """The sorting network of the global-keys route, pass by pass in numpy:
    ``keys`` (uint64, a power of two long, at least 64) sorted descending
    the way ``nms_global_kernel`` does it: every tile of ``tile`` keys
    bitonic-sorted on its own, in the direction its run has in the whole
    sequence; then, for each run length k past the tile, the strides >= tile
    over the whole sequence and the strides < tile tile by tile. Each pass
    compares positions i and i ^ j and puts the larger first when
    ``(i & k) == 0``, i the position in the whole sequence."""
    a = np.array(keys, dtype=np.uint64)
    n = len(a)
    tile = min(tile, n)

    def sweep(first, size, k, j):
        pos = np.arange(first, first + size)
        lo = pos[(pos & j) == 0]
        hi = lo + j
        x, y = a[lo].copy(), a[hi].copy()
        swap = np.where((lo & k) == 0, x < y, x > y)
        a[lo[swap]], a[hi[swap]] = y[swap], x[swap]

    for t0 in range(0, n, tile):
        k = 2
        while k <= tile:
            j = k // 2
            while j >= 1:
                sweep(t0, tile, k, j)
                j //= 2
            k *= 2
    k = 2 * tile
    while k <= n:
        j = k // 2
        while j >= tile:
            sweep(0, n, k, j)
            j //= 2
        for t0 in range(0, n, tile):
            j = tile // 2
            while j >= 1:
                sweep(t0, tile, k, j)
                j //= 2
        k *= 2
    return a


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
    """The live boxes of one image in the kernel's order: its 64-bit keys
    (order-preserving score bits, -0.0 made +0.0, then the complemented
    index; 0 for a dead box) sorted descending, the dead dropped."""
    live = (s >= np.float32(score_threshold)) & (s != np.float32(-np.inf))
    bits = (s + np.float32(0)).view(np.uint32)  # -0.0 + 0.0 = +0.0
    order_bits = np.where(bits & np.uint32(0x80000000), ~bits, bits | np.uint32(0x80000000))
    key = (order_bits.astype(np.uint64) << np.uint64(32)) | \
        (~np.arange(len(s), dtype=np.uint32)).astype(np.uint64)
    key[~live] = 0
    return np.argsort(key, kind="stable")[::-1][:int(live.sum())]


def sorted_scan_emulation(boxes, scores, max_outputs: int, iou_threshold: float = 0.5,
                          score_threshold: float = float("-inf"), chunk: int = CHUNK):
    """What ``csrc/nms.cu`` does, step by step in numpy: the sort keys, the
    descending sort, then the scan in chunks: (a) each candidate against
    the kept list, (b) the chunk's suppression bits (row i: the earlier
    candidates j whose IoU with i exceeds the threshold), (c) the ballot
    iteration ``keep = F(keep)`` from "every live one" to its fixed point,
    the cut at K, the append. ``boxes [B, P, 4]``, ``scores [B, P]``
    (float32 arrays) → ``(sel_idx [B, K] int32, sel_scores [B, K] float32,
    chunks_run [B])``."""
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    B, P = scores.shape
    thr = iou_threshold
    sel_idx = np.full((B, max_outputs), -1, np.int32)
    sel_scores = np.full((B, max_outputs), -1.0, np.float32)
    chunks_run = np.zeros(B, np.int64)
    for b in range(B):
        s = scores[b]
        cand = _candidates(s, score_threshold)
        kept = []
        for c0 in range(0, len(cand), chunk):
            if len(kept) >= max_outputs:
                break
            chunks_run[b] += 1
            ch = cand[c0:c0 + chunk]
            kept_boxes = boxes[b, kept] if kept else np.zeros((0, 4), np.float32)
            dead = [bool(_suppresses(kept_boxes, boxes[b, i], thr).any()) for i in ch]  # (a)
            rows = [sum(1 << j for j in np.flatnonzero(_suppresses(boxes[b, ch[:i]],
                                                                   boxes[b, ch[i]], thr)))
                    for i in range(len(ch))]  # (b)
            keep = sum(1 << i for i in range(len(ch)) if not dead[i])  # (c)
            while True:
                nxt = sum(1 << i for i in range(len(ch)) if not dead[i] and not rows[i] & keep)
                if nxt == keep:
                    break
                keep = nxt
            order = [i for i in range(len(ch)) if keep >> i & 1]
            kept.extend(int(ch[i]) for i in order[:max_outputs - len(kept)])
        sel_idx[b, :len(kept)] = kept
        sel_scores[b, :len(kept)] = s[kept]
    return sel_idx, sel_scores, chunks_run


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


def _key_scratch(device: torch.device, stream: int, words: int) -> torch.Tensor:
    """The 64-bit key scratch of the global-keys route (``kernels.scratch``);
    raises ValueError when it cannot be allocated."""
    try:
        return K.scratch(device, stream, words, torch.int64)
    except torch.OutOfMemoryError as e:
        raise ValueError(
            f"nms: the global-keys route needs {words * 8} bytes of key scratch, "
            f"which cannot be allocated on {device}") from e


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
    """The operator behind :func:`nms_select`: the launch on the route
    :func:`nms_route` picks (counted here, so an exported program counts
    its launches when it runs), the plain version for a CPU tensor."""
    _check_nms(boxes, scores, max_outputs)
    if not boxes.is_cuda:
        return nms_batched_plain(
            boxes, scores, max_outputs, iou_threshold, score_threshold)
    B, P = scores.shape
    K.require(boxes.dtype == torch.float32 and scores.dtype == torch.float32,
              f"nms: float32 only, got {boxes.dtype} / {scores.dtype}")
    K.require(boxes.is_contiguous() and scores.is_contiguous(),
              "nms: tensors must be contiguous")
    route = nms_route(P, max_outputs)
    sel_idx = torch.empty((B, max_outputs), dtype=torch.int32, device=boxes.device)
    sel_scores = torch.empty((B, max_outputs), dtype=torch.float32,
                             device=boxes.device)
    if P == 0:
        sel_idx.fill_(-1)
        sel_scores.fill_(-1.0)
    elif B > 0 and max_outputs > 0:
        stream = K.current_stream_ptr()
        scratch = (_key_scratch(boxes.device, stream, B * pad_keys(P)).data_ptr()
                   if route == "global" else None)
        err = K.load_library().mbx_nms(
            boxes.data_ptr(), scores.data_ptr(), sel_idx.data_ptr(), sel_scores.data_ptr(),
            scratch, B, P, max_outputs, iou_threshold, *threshold_split(iou_threshold),
            score_threshold, stream)
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
