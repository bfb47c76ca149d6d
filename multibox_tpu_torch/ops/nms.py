"""Non-maximum suppression + top-k, static shapes, on-device.

Semantics match TF NMS: select boxes in descending score order, suppressing
any box whose IoU with an already-selected box exceeds ``iou_threshold``;
boxes below ``score_threshold`` are never selected.

The plain PyTorch implementation (:func:`_nms_torch`) is the semantic spec;
a CUDA kernel with identical outputs lives in
``multibox_tpu_torch.ops.kernels.nms_kernel`` (selected via
``use_pallas=True``; the argument keeps the name it has in the JAX package).

Returned shapes are static (``max_outputs``); invalid slots are marked with
score ``-1`` and box ``0``, plus an explicit ``num_valid`` count — the
standard padded-detection convention.
"""

from __future__ import annotations

from typing import Optional

import torch

from multibox_tpu_torch.ops import boxes as box_ops
from multibox_tpu_torch.ops.kernels import nms_kernel

_NEG_INF = float("-inf")


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_outputs: int,
    iou_threshold: float = 0.5,
    score_threshold: float = _NEG_INF,
    use_pallas: bool = False,
):
    """Single-class NMS over one image.

    Args:
      boxes: ``[P, 4]`` normalized corner boxes.
      scores: ``[P]``.
      max_outputs: static number of output slots (k).
      iou_threshold: suppression threshold.
      score_threshold: boxes scoring below this are never selected.
      use_pallas: route to the CUDA kernel (same semantics).

    Returns:
      (sel_boxes ``[k, 4]``, sel_scores ``[k]``, sel_idx ``[k]`` int32,
      num_valid scalar int32). Empty slots: score −1, idx −1, box 0.
    """
    if use_pallas:
        sel_b, sel_s, sel_i, nv = nms_kernel.nms_cuda_batched(
            boxes[None].to(torch.float32).contiguous(),
            scores[None].to(torch.float32).contiguous(),
            max_outputs, iou_threshold, score_threshold,
        )
        # The kernel computes in f32; the score dtype follows the input so
        # both use_pallas settings are interchangeable.
        return sel_b[0], sel_s[0].to(scores.dtype), sel_i[0], nv[0]
    return _nms_torch(boxes, scores, max_outputs, iou_threshold, score_threshold)


def _nms_torch(boxes, scores, max_outputs, iou_threshold, score_threshold):
    """The plain version (B=1 case of ``nms_kernel.nms_batched_plain``)."""
    sel_b, sel_s, sel_i, nv = _batched_plain(
        boxes[None], scores[None], max_outputs, iou_threshold, score_threshold
    )
    return sel_b[0], sel_s[0], sel_i[0], nv[0]


def _batched_plain(boxes, scores, max_outputs, iou_threshold, score_threshold,
                   raw_boxes=None):
    sel_i, sel_s = nms_kernel.nms_batched_plain(
        boxes, scores, max_outputs, iou_threshold, score_threshold
    )
    sel_b = nms_kernel.gather_selected(
        boxes if raw_boxes is None else raw_boxes, sel_i)
    num_valid = (sel_i >= 0).sum(dim=1, dtype=torch.int32)
    return sel_b, sel_s.to(scores.dtype), sel_i, num_valid


def _soft_nms_batched(boxes, scores, max_outputs, sigma, score_threshold):
    """Gaussian soft-NMS over a batch; returns ``(sel_idx, sel_scores)``."""
    B, P = scores.shape
    dev = scores.device
    sel_idx = torch.full((B, max_outputs), -1, dtype=torch.int32, device=dev)
    sel_scores = torch.full((B, max_outputs), -1.0, dtype=torch.float32, device=dev)
    if P == 0:
        return sel_idx, sel_scores
    scores32 = scores.to(torch.float32)
    live = torch.where(scores32 >= score_threshold, scores32,
                       torch.full_like(scores32, _NEG_INF))
    col = torch.arange(P, device=dev)
    for k in range(max_outputs):
        best_score = live.max(dim=1).values
        best = torch.where(live == best_score[:, None], col, P).min(dim=1).values
        valid = best_score >= score_threshold
        sel_idx[:, k] = torch.where(valid, best, -1).to(torch.int32)
        sel_scores[:, k] = torch.where(valid, best_score, -1.0)
        best_box = torch.gather(boxes, 1, best[:, None, None].expand(B, 1, 4))
        ious = box_ops.iou_pairwise(best_box, boxes)
        decay = torch.exp(-(ious * ious) / sigma)
        decayed = torch.where(col[None, :] == best[:, None],
                              torch.full_like(live, _NEG_INF), live * decay)
        live = torch.where(valid[:, None], decayed, live)
    return sel_idx, sel_scores


def soft_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_outputs: int,
    sigma: float = 0.5,
    score_threshold: float = 0.001,
):
    """Gaussian soft-NMS over one image (Bodla et al., arXiv:1704.04503).

    Instead of removing boxes that overlap a selection, their scores decay
    by ``exp(-iou²/σ)`` — overlapping true positives (occlusion) survive
    with reduced confidence rather than vanishing. Selection records the
    DECAYED score (the paper's protocol); a slot is invalid once the best
    remaining decayed score falls below ``score_threshold`` (soft-NMS
    needs a floor — decayed scores never reach exactly 0). Same static
    output convention as :func:`nms`.
    """
    out = batched_soft_nms(boxes[None], scores[None], max_outputs, sigma,
                           score_threshold)
    return tuple(o[0] for o in out)


def _class_offset_boxes(boxes, class_ids):
    """Shift each class into a disjoint coordinate island (cross-class
    IoU = 0 → no suppression / decay across classes)."""
    if class_ids is None:
        return boxes
    return boxes + class_ids.to(boxes.dtype)[..., None] * 2.0


def batched_soft_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_outputs: int,
    sigma: float = 0.5,
    score_threshold: float = 0.001,
    class_ids: Optional[torch.Tensor] = None,
):
    """Soft-NMS over a batch; ``class_ids`` restricts decay to within-class
    pairs. The UN-offset boxes are gathered by selected index."""
    sel_i, sel_s = _soft_nms_batched(
        _class_offset_boxes(boxes, class_ids), scores, max_outputs, sigma,
        score_threshold,
    )
    sel_b = nms_kernel.gather_selected(boxes, sel_i)
    num_valid = (sel_i >= 0).sum(dim=1, dtype=torch.int32)
    return sel_b, sel_s.to(scores.dtype), sel_i, num_valid


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_outputs: int,
    iou_threshold: float = 0.5,
    score_threshold: float = _NEG_INF,
    class_ids: Optional[torch.Tensor] = None,
    use_pallas: bool = False,
):
    """NMS over a batch ``[B, P, 4]`` / ``[B, P]``.

    With ``class_ids`` given (``[B, P]`` int), suppression only happens
    within a class (per-class NMS) — implemented with the standard
    coordinate-offset trick so a single NMS pass handles all classes.
    """
    boxes_for_nms = _class_offset_boxes(boxes, class_ids)
    if use_pallas:
        # One thread block per image, the whole suppression loop in shared
        # memory (ops.kernels.nms_kernel).
        sel_i, sel_s = nms_kernel.nms_select(
            boxes_for_nms.to(torch.float32).contiguous(),
            scores.to(torch.float32).contiguous(),
            max_outputs, iou_threshold, score_threshold,
        )
        nv = (sel_i >= 0).sum(dim=1, dtype=torch.int32)
        out_b = nms_kernel.gather_selected(boxes, sel_i)
        return out_b, sel_s.to(scores.dtype), sel_i, nv
    return _batched_plain(
        boxes_for_nms, scores, max_outputs, iou_threshold, score_threshold,
        raw_boxes=boxes,
    )
