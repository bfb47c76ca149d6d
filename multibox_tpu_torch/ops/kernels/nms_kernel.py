"""CUDA kernel: batched hard NMS + top-k.

Replaces ``nms_pallas_batched`` / ``nms_pallas`` of the JAX package
(``multibox_tpu/ops/pallas/nms_kernel.py``). Semantics are those of that
package's ``ops.nms._nms_jnp``: select boxes in descending score order
(lowest index on ties), suppressing any box whose IoU with a selected box
exceeds ``iou_threshold``; boxes below ``score_threshold`` are never
selected; empty slots carry index −1 and score −1.

Bound on this card: the K dependent rounds, not bytes (B=32, P=256 moves
about 164 KB) and not flops. The design gives one thread block to each
image, keeps live scores and coordinates in shared memory for all rounds,
reduces the (max score, lowest index) pair with warp shuffles and two
barriers a round, and stops at the first round with nothing live. The TPU
kernel's shape (8 images on the sublane axis, 128-lane padding, masked row
sums instead of indexing) answered that compiler's limits and is not
carried over.

:func:`nms_batched_plain` is the plain PyTorch version: same arithmetic op
for op, so indices and scores agree exactly.

Source: ``csrc/nms.cu``.
"""

from __future__ import annotations

import torch

from multibox_tpu_torch.ops import boxes as box_ops
from multibox_tpu_torch.ops import kernels as K

# 20 B of shared memory per box, within the 227 KB a block may use.
MAX_BOXES = (227 * 1024 - 512) // 20


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


def nms_select(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_outputs: int,
    iou_threshold: float = 0.5,
    score_threshold: float = float("-inf"),
):
    """The kernel's own outputs: ``(sel_idx [B, K] int32, sel_scores [B, K]
    float32)`` for ``boxes [B, P, 4]`` f32 and ``scores [B, P]`` f32. On a
    CUDA tensor this launches the kernel (or raises); a CPU tensor takes
    :func:`nms_batched_plain`."""
    K.require(boxes.dim() == 3 and boxes.shape[-1] == 4 and scores.dim() == 2
              and boxes.shape[:2] == scores.shape,
              f"nms: boxes [B, P, 4] and scores [B, P] expected, got "
              f"{tuple(boxes.shape)} / {tuple(scores.shape)}")
    K.require(max_outputs >= 0, "nms: max_outputs must be >= 0")
    K.require(scores.device == boxes.device,
              f"nms: boxes on {boxes.device}, scores on {scores.device}")
    if not boxes.is_cuda:
        return nms_batched_plain(
            boxes, scores, max_outputs, iou_threshold, score_threshold)
    B, P = scores.shape
    K.require(boxes.dtype == torch.float32 and scores.dtype == torch.float32,
              f"nms: float32 only, got {boxes.dtype} / {scores.dtype}")
    K.require(boxes.is_contiguous() and scores.is_contiguous(),
              "nms: tensors must be contiguous")
    K.require(P <= MAX_BOXES,
              f"nms: {P} boxes per image exceed the {MAX_BOXES} that fit "
              "one block's shared memory")
    sel_idx = torch.empty((B, max_outputs), dtype=torch.int32, device=boxes.device)
    sel_scores = torch.empty((B, max_outputs), dtype=torch.float32,
                             device=boxes.device)
    if P == 0:
        sel_idx.fill_(-1)
        sel_scores.fill_(-1.0)
    elif B > 0 and max_outputs > 0:
        lib = K.load_library()
        err = lib.mbx_nms(boxes.data_ptr(), scores.data_ptr(),
                          sel_idx.data_ptr(), sel_scores.data_ptr(),
                          B, P, max_outputs, float(iou_threshold),
                          float(score_threshold), K.current_stream_ptr())
        K.check_launch(err, "mbx_nms")
        K.LAUNCHES["nms"] += 1
    return sel_idx, sel_scores


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
