"""Bipartite prior ↔ ground-truth matching, on the device, batched.

Per image, gt boxes are assigned to distinct priors by maximizing a benefit
(IoU, optionally blended with the current predicted confidences — the
"hybrid" matching of Szegedy et al., arXiv:1412.1441 §2.1), then turned
into the per-prior targets the loss consumes.

* :func:`greedy_match` — G rounds of a global arg-max over the ``[G, P]``
  benefit matrix, killing the chosen row and column each round; on equal
  values the first row-major cell wins. Deterministic, and the default for
  training. Over the pure IoU benefit it is what the CUDA kernel
  ``ops.kernels.match_kernel`` computes.
* Exact (Hungarian) matching is not ported yet: ``method="hungarian"``
  raises ``NotImplementedError``.

Every function takes optional leading batch dimensions (``[..., G, 4]``
gt boxes, ``[...]`` counts) over shared ``[P, 4]`` priors, so the batch is
one set of tensor operations rather than a Python loop. All return, per
image, ``assignment [G]`` (prior index per gt, ``-1`` for padded rows) or
per-prior forms of it.
"""

from __future__ import annotations

from typing import Optional

import torch

from multibox_tpu_torch.ops import boxes as box_ops
from multibox_tpu_torch.ops.kernels import box_kernel

_NEG = -1e30  # effectively -inf, but safe in arithmetic


def compute_benefit(
    gt_boxes: torch.Tensor,
    priors: torch.Tensor,
    conf_logits: Optional[torch.Tensor] = None,
    loc_preds: Optional[torch.Tensor] = None,
    alpha: float = 1.0,
    conf_weight: float = 0.0,
) -> torch.Tensor:
    """Benefit matrix ``[..., G, P]`` for assignment (higher = better).

    Default benefit is prior↔gt IoU. With ``conf_weight > 0`` and
    predictions supplied (``conf_logits [..., P]``, ``loc_preds
    [..., P, 4]``), blends in the hybrid objective
    ``iou + w·(logit(c) − α/2·‖decode(l) − g‖²)``.
    """
    benefit = box_ops.iou_matrix(gt_boxes, priors)
    if conf_weight > 0.0 and conf_logits is not None:
        hybrid = conf_logits[..., None, :]
        if loc_preds is not None:
            decoded = box_ops.decode_boxes(loc_preds, priors, clip=False)
            diff = decoded[..., None, :, :] - gt_boxes[..., :, None, :]
            hybrid = hybrid - 0.5 * alpha * (diff ** 2).sum(-1)
        benefit = benefit + conf_weight * hybrid
    return benefit


def greedy_match(benefit: torch.Tensor, num_gt) -> torch.Tensor:
    """Greedy 1-to-1 matching: repeatedly take the global best (gt, prior).

    Args:
      benefit: ``[..., G, P]`` benefit matrices.
      num_gt: ``[...]`` ints (or one int) — rows ``>= num_gt`` are padding.

    Returns ``[..., G]`` int32 prior index per gt (``-1`` = unassigned).
    Ties go to the first row-major cell, as ``jnp.argmax`` picks it.
    """
    lead = benefit.shape[:-2]
    G, P = benefit.shape[-2:]
    dev = benefit.device
    b = benefit.reshape(-1, G, P)
    B = b.shape[0]
    n = torch.as_tensor(num_gt, device=dev).reshape(-1).expand(B)
    active = torch.arange(G, device=dev)[None, :] < n[:, None]
    masked = torch.where(active[:, :, None], b, torch.full_like(b, _NEG))
    assignment = torch.full((B, G), -1, dtype=torch.int32, device=dev)
    if G == 0 or P == 0:
        return assignment.reshape(*lead, G)
    rows = torch.arange(G, device=dev)
    cols = torch.arange(P, device=dev)
    flat_idx = torch.arange(G * P, device=dev)
    big = G * P
    batch = torch.arange(B, device=dev)
    for _ in range(G):
        flat = masked.reshape(B, G * P)
        best = flat.max(dim=1).values
        idx = torch.where(flat == best[:, None], flat_idx, big).min(dim=1).values
        idx = idx.clamp_max(big - 1)  # all-NaN rows: keep the index in range
        i, j = idx // P, idx % P
        valid = best > _NEG / 2
        assignment[batch, i] = torch.where(valid, j.to(torch.int32),
                                           assignment[batch, i])
        kill = (rows[None, :, None] == i[:, None, None]) | (
            cols[None, None, :] == j[:, None, None])
        masked = torch.where(valid[:, None, None] & kill,
                             torch.full_like(masked, _NEG), masked)
    return assignment.reshape(*lead, G)


def _scatter_to_priors(assignment: torch.Tensor, values: torch.Tensor,
                       fill, P: int) -> torch.Tensor:
    """``out[..., assignment[g]] = values[..., g]`` for ``assignment >= 0``
    (``mode="drop"`` for the rest), into a ``[..., P, *values.shape[-1:]]``
    (or ``[..., P]``) tensor filled with ``fill``."""
    lead = assignment.shape[:-1]
    G = assignment.shape[-1]
    tail = values.shape[assignment.dim():]
    out = torch.full((*lead, P + 1, *tail), fill, dtype=values.dtype,
                     device=values.device)
    idx = torch.where(assignment >= 0, assignment.to(torch.int64), P)
    idx = idx.reshape(*lead, G, *([1] * len(tail))).expand(*lead, G, *tail)
    out.scatter_(len(lead), idx, values)
    return out.narrow(len(lead), 0, P)


def matching_targets(
    assignment: torch.Tensor,
    gt_boxes: torch.Tensor,
    priors: torch.Tensor,
    encode: str = "multibox",
    gt_labels: Optional[torch.Tensor] = None,
):
    """Per-gt assignment ``[..., G]`` → per-prior targets: ``conf_targets
    [..., P]`` (1.0 matched), ``loc_targets [..., P, 4]`` (encoded, zeros
    unmatched), ``matched [..., P]`` and, with ``gt_labels``, ``cls_targets
    [..., P]`` (−1 unmatched)."""
    P = priors.shape[0]
    valid = (assignment >= 0).to(torch.float32)
    conf_targets = _scatter_to_priors(assignment, valid, 0.0, P)
    # padded rows scatter their 0 into the dropped slot only
    matched = conf_targets > 0.5
    gt_for_prior = _scatter_to_priors(assignment, gt_boxes, 0.0, P)
    offsets = _encode(gt_for_prior, priors, encode)
    loc_targets = torch.where(matched[..., None], offsets, torch.zeros_like(offsets))
    if gt_labels is None:
        return conf_targets, loc_targets, matched
    cls_targets = _scatter_to_priors(assignment, gt_labels.to(torch.int32), -1, P)
    return conf_targets, loc_targets, matched, cls_targets


def _encode(gt_for_prior, priors, encode, use_kernel: bool = False):
    if encode == "multibox":
        if use_kernel:
            return box_kernel.encode_boxes_cuda(gt_for_prior.contiguous(),
                                                priors.contiguous())
        return box_ops.encode_boxes(gt_for_prior, priors)
    if encode == "ssd":
        return box_ops.encode_boxes_ssd(gt_for_prior, priors)
    raise ValueError(f"unknown encoding: {encode}")


def dense_prior_assignment(
    assignment: torch.Tensor,
    gt_boxes: torch.Tensor,
    num_gt,
    priors: torch.Tensor,
    multi_match_iou: float = 0.0,
) -> torch.Tensor:
    """Per-PRIOR gt index ``[..., P]`` (−1 = unmatched) from a per-gt
    assignment, optionally densified SSD-style (arXiv:1512.02325 §2.2):
    with ``multi_match_iou > 0`` every still-unmatched prior whose best-gt
    IoU reaches the threshold becomes a positive for that gt."""
    G = gt_boxes.shape[-2]
    P = priors.shape[0]
    ids = torch.arange(G, dtype=torch.int32, device=gt_boxes.device)
    prior_gt = _scatter_to_priors(assignment, ids.expand(assignment.shape), -1, P)
    if multi_match_iou and multi_match_iou > 0:
        iou = box_ops.iou_matrix(gt_boxes, priors)  # [..., G, P]
        n = torch.as_tensor(num_gt, device=gt_boxes.device)
        active = torch.arange(G, device=gt_boxes.device) < n[..., None]
        iou = torch.where(active[..., None], iou, torch.full_like(iou, -1.0))
        best_iou = iou.max(dim=-2).values
        # first gt among equal maxima, as jnp.argmax picks it
        first = torch.where(iou == best_iou[..., None, :],
                            torch.arange(G, device=iou.device)[:, None], G)
        best_gt = first.min(dim=-2).values.to(torch.int32)
        extra = (best_iou >= multi_match_iou) & (prior_gt < 0)
        prior_gt = torch.where(extra, best_gt, prior_gt)
    return prior_gt


def dense_targets(
    prior_gt: torch.Tensor,
    gt_boxes: torch.Tensor,
    priors: torch.Tensor,
    encode: str = "multibox",
    gt_labels: Optional[torch.Tensor] = None,
    use_kernel: bool = False,
):
    """Per-prior targets from a per-PRIOR gt index ``[..., P]``: gathers,
    so several priors may share one gt. ``use_kernel=True`` sends the
    multibox encode through the CUDA box kernel (bitwise the plain
    ``gt − prior``)."""
    matched = prior_gt >= 0
    safe = prior_gt.clamp_min(0).to(torch.int64)
    conf_targets = matched.to(torch.float32)
    idx = safe[..., None].expand(*safe.shape, 4)
    gt_for_prior = torch.gather(gt_boxes, -2, idx)
    offsets = _encode(gt_for_prior, priors, encode, use_kernel)
    loc_targets = torch.where(matched[..., None], offsets, torch.zeros_like(offsets))
    if gt_labels is None:
        return conf_targets, loc_targets, matched
    labels = torch.gather(gt_labels.to(torch.int32), -1, safe)
    cls_targets = torch.where(matched, labels, torch.full_like(labels, -1))
    return conf_targets, loc_targets, matched, cls_targets


def assign(benefit: torch.Tensor, num_gt, method: str = "greedy") -> torch.Tensor:
    """Per-gt assignment ``[..., G]`` from a benefit ``[..., G, P]`` by
    ``method``: "greedy"; "hungarian" is not ported yet and raises."""
    if method == "greedy":
        return greedy_match(benefit, num_gt)
    if method == "hungarian":
        raise NotImplementedError(
            "method='hungarian' (exact Jonker-Volgenant matching) is not "
            "ported yet: see ROADMAP.md, queue 1, item 9a")
    raise ValueError(f"unknown matching method: {method}")


def match_priors(
    gt_boxes: torch.Tensor,
    num_gt,
    priors: torch.Tensor,
    conf_logits: Optional[torch.Tensor] = None,
    loc_preds: Optional[torch.Tensor] = None,
    method: str = "greedy",
    conf_weight: float = 0.0,
    alpha: float = 1.0,
    encode: str = "multibox",
    multi_match_iou: float = 0.0,
):
    """Full matching: benefit → assignment → per-prior targets.

    Returns ``(assignment [..., G], prior_gt [..., P], conf_t [..., P],
    loc_t [..., P, 4], matched [..., P])``."""
    benefit = compute_benefit(gt_boxes, priors, conf_logits, loc_preds,
                              alpha=alpha, conf_weight=conf_weight)
    assignment = assign(benefit, num_gt, method)
    prior_gt = dense_prior_assignment(assignment, gt_boxes, num_gt, priors,
                                      multi_match_iou)
    conf_t, loc_t, matched = dense_targets(prior_gt, gt_boxes, priors, encode)
    return assignment, prior_gt, conf_t, loc_t, matched
