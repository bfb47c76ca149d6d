"""MultiBox loss: matching + location L2 + confidence BCE + hard negatives.

The training objective of Erhan et al. (arXiv:1312.2249 eq. 1-3) with the
prior matching of Szegedy et al. (arXiv:1412.1441 §2), on the device:

  F_loc  = ½ Σ_matched ‖l_pred − l_target‖²        (l_target = g − prior)
  F_conf = − Σ_matched log σ(c) − Σ_selected-neg log(1 − σ(c))
  F      = F_conf + α · F_loc

Both terms are normalized by the number of matched priors across the batch:
inside a data-parallel step (``parallel.mesh.reducing``) the global batch,
whose count is summed over the ranks, and each rank's loss is its rows'
share of the global loss.
Hard-negative mining: per image, only the ``ratio × num_pos`` highest-loss
negatives count in F_conf, selected by rank (a stable sort and a scatter,
so equal losses rank in index order).

The matching and the targets are computed without gradient: the
assignment is integer-valued and the targets are constants with respect
to the parameters.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from multibox_tpu_torch.ops import matching as matching_ops
from multibox_tpu_torch.ops.kernels import match_kernel
from multibox_tpu_torch.parallel import mesh


def multibox_loss(
    loc_preds: torch.Tensor,
    conf_logits: torch.Tensor,
    gt_boxes: torch.Tensor,
    num_gt: torch.Tensor,
    priors: torch.Tensor,
    alpha: float = 1.0,
    matching: str = "greedy",
    hybrid_conf_weight: float = 0.0,
    hard_negative_ratio: float = 3.0,
    multi_match_iou: float = 0.0,
    encode: str = "multibox",
    gt_labels: Optional[torch.Tensor] = None,
    use_pallas: Optional[bool] = None,
    conf_loss: str = "bce",
    focal_gamma: float = 2.0,
    focal_alpha: float = 0.25,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Batched MultiBox loss.

    Args:
      loc_preds: ``[B, P, 4]`` predicted offsets.
      conf_logits: ``[B, P]`` class-agnostic logits or ``[B, P, C]``
        multi-class logits (sigmoid per class).
      gt_boxes: ``[B, G, 4]`` normalized corner boxes (padded).
      num_gt: ``[B]`` valid gt count per image.
      priors: ``[P, 4]``.
      alpha: location-loss weight.
      matching: "greedy" | "hungarian" (exact, ``ops.matching.hungarian_match``).
      hybrid_conf_weight: >0 → loss-aware matching (1412.1441 §2.1).
      hard_negative_ratio: negatives kept per positive (0 → keep all).
      multi_match_iou: >0 → SSD dense matching on top of the bipartite one.
      encode: target encoding ("multibox" residual | "ssd").
      gt_labels: ``[B, G]`` int class ids in ``[0, C)``, required for
        multi-class logits; out-of-range ids are counted in
        ``num_bad_labels``.
      use_pallas: ``True`` (the name is the JAX package's) routes pure-IoU
        greedy matching (``matching="greedy"``, no hybrid weight) through
        the CUDA matching kernel and the multibox target encode through
        the CUDA box kernel (both exact against their plain versions);
        ``None``/``False`` keep plain PyTorch.
      conf_loss: "bce" | "focal" (RetinaNet focal sigmoid CE).

    Returns ``(total_loss, metrics)``; the metrics include
    ``num_gt_dropped``, active gt boxes that received no prior. In a
    data-parallel step the metrics are the global batch's (sums over the
    ranks, detached) and ``total_loss`` this rank's share.
    """
    multiclass = conf_logits.dim() == 3
    B, P = conf_logits.shape[:2]
    kernels_on = use_pallas is True
    with torch.no_grad():
        if kernels_on and matching == "greedy" and not hybrid_conf_weight:
            assignment = match_kernel.greedy_match_cuda(gt_boxes, num_gt, priors)
        else:
            conf_agn = conf_logits.max(dim=-1).values if multiclass else conf_logits
            benefit = matching_ops.compute_benefit(
                gt_boxes, priors, conf_agn.detach(), loc_preds.detach(),
                alpha=alpha, conf_weight=hybrid_conf_weight)
            assignment = matching_ops.assign(benefit, num_gt, matching)
        prior_gt = matching_ops.dense_prior_assignment(
            assignment, gt_boxes, num_gt, priors, multi_match_iou)
        conf_t, loc_t, matched = matching_ops.dense_targets(
            prior_gt, gt_boxes, priors, encode, use_kernel=kernels_on)

    num_pos = conf_t.sum(dim=1)  # [B]
    global_batch = mesh.reducing()
    if global_batch:  # normalized by the global batch's positives
        total_pos = mesh.all_reduce_(num_pos.sum(), "loss").clamp_min(1.0)
    else:
        total_pos = num_pos.sum().clamp_min(1.0)

    sq = ((loc_preds - loc_t) ** 2).sum(dim=-1)  # [B, P]
    loc_loss = 0.5 * (sq * conf_t).sum() / total_pos

    if conf_loss == "focal":
        def conf_ce(logits, labels):
            return focal_sigmoid_bce(logits, labels, focal_gamma, focal_alpha)
    elif conf_loss == "bce":
        conf_ce = optax_sigmoid_bce
    else:
        raise ValueError(f"unknown conf_loss: {conf_loss!r}")

    num_bad_labels = torch.zeros((), dtype=torch.float32, device=conf_logits.device)
    if multiclass:
        if gt_labels is None:
            raise ValueError("gt_labels required for multi-class conf_logits")
        C = conf_logits.shape[-1]
        with torch.no_grad():
            safe_pg = prior_gt.clamp_min(0).to(torch.int64)
            labels = torch.gather(gt_labels.to(torch.int32), 1, safe_pg)
            cls_t = torch.where(prior_gt >= 0, labels, torch.full_like(labels, -1))
            classes = torch.arange(C, device=conf_logits.device)
            onehot = ((cls_t[..., None] == classes) & matched[..., None]).to(
                conf_logits.dtype)  # [B, P, C]
            G_lbl = gt_labels.shape[1]
            active = (torch.arange(G_lbl, device=gt_labels.device)[None, :]
                      < num_gt[:, None])
            num_bad_labels = (active & ((gt_labels < 0) | (gt_labels >= C))).to(
                torch.float32).sum()
        bce_full = conf_ce(conf_logits, onehot)  # [B, P, C]
        pos_loss = (bce_full * onehot).sum() / total_pos
        # per-prior negative score over the non-positive (prior, class) pairs
        bce = (bce_full * (1.0 - onehot)).sum(dim=-1)  # [B, P]
        # a matched prior's other classes are mandatory negatives
        pos_loss = pos_loss + (bce * conf_t).sum() / total_pos
    else:
        bce = conf_ce(conf_logits, conf_t)  # [B, P]
        pos_loss = (bce * conf_t).sum() / total_pos

    neg_mask = 1.0 - conf_t
    if hard_negative_ratio and hard_negative_ratio > 0:
        with torch.no_grad():
            neg_scores = bce.detach() * neg_mask
            k = torch.minimum((hard_negative_ratio * num_pos).clamp_min(1.0),
                              P - num_pos)  # [B]
            # rank by loss, descending; equal losses in index order (stable)
            order = torch.argsort(-neg_scores, dim=1, stable=True)
            ranks = torch.zeros_like(order).scatter_(
                1, order, torch.arange(P, device=order.device).expand(B, P))
            keep = (ranks < k[:, None]).to(bce.dtype) * neg_mask
    else:
        keep = neg_mask
    neg_loss = (bce * keep).sum() / total_pos

    conf_loss_val = pos_loss + neg_loss
    total = conf_loss_val + alpha * loc_loss
    G = gt_boxes.shape[1]
    with torch.no_grad():
        active_gt = torch.arange(G, device=gt_boxes.device)[None, :] < num_gt[:, None]
        num_gt_dropped = (active_gt & (assignment < 0)).to(torch.float32).sum()
    metrics = {
        "loss": total,
        "loss_conf": conf_loss_val,
        "loss_loc": loc_loss,
        "num_pos": num_pos.sum(),
        "num_neg_kept": keep.sum(),
        "num_gt_dropped": num_gt_dropped,
        "num_bad_labels": num_bad_labels,
    }
    if global_batch:  # each rank's terms are its share: the sums are global
        keys = list(metrics)
        summed = mesh.all_reduce_(torch.stack([metrics[k].detach() for k in keys]), "loss")
        metrics = dict(zip(keys, summed.unbind()))
    return total, metrics


def optax_sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Stable elementwise sigmoid BCE: max(x,0) − x·z + log(1 + e^{−|x|}).

    Gradients at x = 0 exactly follow JAX's: ½ for the maximum (as
    ``torch.maximum`` has it) and +1 for |x| (``lax.abs``; ``torch.abs``
    has 0 there), so a logit of exactly 0 gets −z in both packages."""
    abs_x = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
            + torch.log1p(torch.exp(-abs_x)))


def focal_sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor,
                      gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """Elementwise focal sigmoid CE (arXiv:1708.02002 eq. 4-5):
    α_t · (1 − p_t)^γ · BCE, with p_t = p for positives, 1 − p otherwise."""
    bce = optax_sigmoid_bce(logits, labels)
    p = torch.sigmoid(logits)
    p_t = labels * p + (1.0 - labels) * (1.0 - p)
    alpha_t = labels * alpha + (1.0 - labels) * (1.0 - alpha)
    return alpha_t * torch.pow((1.0 - p_t).clamp_min(1e-8), gamma) * bce
