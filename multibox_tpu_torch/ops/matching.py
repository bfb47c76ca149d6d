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
* :func:`hungarian_match` — exact rectangular assignment by the
  Jonker–Volgenant shortest augmenting path (the algorithm of
  ``scipy.optimize.linear_sum_assignment``), with the JAX package's tie
  rule and its bound of P settles per search. The images of a batch run in
  lock step; only the exit tests of the searches wait for the device.

Every function takes optional leading batch dimensions (``[..., G, 4]``
gt boxes, ``[...]`` counts) over shared ``[P, 4]`` priors, so the batch is
one set of tensor operations rather than a Python loop. All return, per
image, ``assignment [G]`` (prior index per gt, ``-1`` for padded rows) or
per-prior forms of it.
"""

from __future__ import annotations

from typing import Dict, Optional

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


# Exit tests of hungarian_match, counted as the kernel wrappers count their
# launches: on CUDA each test copies one flag to the host and waits for the
# device, so a run can report how many a call took.
EXIT_TESTS: Dict[str, int] = {"calls": 0, "tests": 0}


def reset_exit_tests() -> None:
    for name in EXIT_TESTS:
        EXIT_TESTS[name] = 0


def _exit_test(flag: torch.Tensor) -> bool:
    EXIT_TESTS["tests"] += 1
    return bool(flag)


def _augment_row(cost, i, active, u, v, col4row, row4col) -> None:
    """One Jonker–Volgenant phase for gt row ``i`` of every image at once:
    a Dijkstra from row ``i`` to the nearest unassigned column in the
    reduced-cost graph, the dual update, then the augmentation along the
    predecessor chain. ``u [B, G]``, ``v [B, P]``, ``col4row [B, G]`` and
    ``row4col [B, P]`` are updated in place; images whose ``active [B]``
    flag is False are left as they are.

    Per image this is the JAX package's ``_augment_one_row`` (scipy's
    ``_lsap`` with the search bounded at P settles): the same float32
    expression order, and among the columns of least tentative cost the
    first unassigned one, else the first one (its ``lexsort`` on (cost,
    assigned)). The images settle one column each per iteration; a search
    that has reached a free column idles, masked, while the others go on.
    """
    B, G, P = cost.shape
    dev = cost.device
    batch = torch.arange(B, device=dev)
    cols = torch.arange(P, device=dev)
    inf = torch.tensor(float("inf"), dtype=cost.dtype, device=dev)
    i_cur = torch.full((B,), i, dtype=torch.int64, device=dev)
    min_val = torch.zeros((B,), dtype=cost.dtype, device=dev)
    shortest = torch.full((B, P), float("inf"), dtype=cost.dtype, device=dev)
    scanned_cols = torch.zeros((B, P), dtype=torch.bool, device=dev)
    scanned_rows = torch.zeros((B, G), dtype=torch.bool, device=dev)
    pred = torch.zeros((B, P), dtype=torch.int64, device=dev)
    sink = torch.full((B,), -1, dtype=torch.int64, device=dev)
    running = active.clone()
    settled, next_test = 0, 1
    while settled < P:
        scanned_rows[batch, i_cur] |= running
        r = min_val[:, None] + cost[batch, i_cur] - u[batch, i_cur][:, None] - v
        better = (r < shortest) & ~scanned_cols & running[:, None]
        shortest = torch.where(better, r, shortest)
        pred = torch.where(better, i_cur[:, None], pred)
        cand = torch.where(scanned_cols, inf, shortest)
        lowest = cand.min(dim=1).values
        # among the least: unassigned before assigned, then the lowest index
        rank = torch.where(cand == lowest[:, None], (row4col >= 0) * P + cols, 2 * P)
        j = rank.min(dim=1).values % P
        owner = row4col[batch, j]
        is_sink = owner < 0
        scanned_cols[batch, j] |= running
        i_cur = torch.where(running & ~is_sink, owner, i_cur)
        min_val = torch.where(running, lowest, min_val)
        sink = torch.where(running & is_sink, j, sink)
        running = running & ~is_sink
        settled += 1
        # test after 1, 2, 4, … settles: at most twice the longest search
        if settled == next_test:
            if not _exit_test(running.any()):
                break
            next_test *= 2

    found = sink >= 0  # False only where the column set was exhausted
    u_new = u.clone()
    u_new[:, i] += min_val
    other = scanned_rows.clone()
    other[:, i] = False
    seen = shortest.gather(1, col4row.clamp_min(0))
    u_new = u_new + torch.where(other, min_val[:, None] - seen, 0.0)
    v_new = v - torch.where(scanned_cols, min_val[:, None] - shortest, 0.0)
    u.copy_(torch.where(found[:, None], u_new, u))
    v.copy_(torch.where(found[:, None], v_new, v))

    # The path visits each row on the tree at most once: at most i + 1 rows,
    # and no more than the settles that built the tree.
    j, done = sink, ~found
    for _ in range(min(i + 1, settled)):
        jj = j.clamp_min(0)
        row = pred[batch, jj]
        upd = ~done
        row4col[batch, jj] = torch.where(upd, row, row4col[batch, jj])
        prev = col4row[batch, row]
        col4row[batch, row] = torch.where(upd, jj, prev)
        done = done | (row == i)
        j = torch.where(upd, prev, j)


def hungarian_match(benefit: torch.Tensor, num_gt) -> torch.Tensor:
    """Exact max-benefit 1-to-1 assignment (Jonker–Volgenant).

    Solves, per image, the rectangular assignment of
    ``scipy.optimize.linear_sum_assignment(-benefit[:num_gt])`` in float32,
    with the JAX package's tie rule. Padded rows (``>= num_gt``) get
    ``-1``. When ``num_gt > P`` the first P rows are matched among
    themselves and the rest get ``-1`` (scipy raises there).

    Args:
      benefit: ``[..., G, P]`` benefit matrices.
      num_gt: ``[...]`` ints (or one int).

    Returns ``[..., G]`` int32 prior index per gt. The gt rows run in
    order, the images in lock step; exit tests (host syncs on CUDA, counted
    in ``EXIT_TESTS``) number about log2 of the longest search per row.
    """
    lead = benefit.shape[:-2]
    G, P = benefit.shape[-2:]
    dev = benefit.device
    cost = -benefit.reshape(-1, G, P).to(torch.float32)
    B = cost.shape[0]
    n = torch.as_tensor(num_gt, device=dev).reshape(-1).expand(B).clamp(max=P)
    active = torch.arange(G, device=dev)[None, :] < n[:, None]
    EXIT_TESTS["calls"] += 1
    u = torch.zeros((B, G), dtype=torch.float32, device=dev)
    v = torch.zeros((B, P), dtype=torch.float32, device=dev)
    col4row = torch.full((B, G), -1, dtype=torch.int64, device=dev)
    row4col = torch.full((B, P), -1, dtype=torch.int64, device=dev)
    rows = 0
    if B and G and P:
        EXIT_TESTS["tests"] += 1
        rows = min(int(n.max()), G)
    for i in range(rows):
        _augment_row(cost, i, active[:, i], u, v, col4row, row4col)
    out = torch.where(active, col4row, -1).to(torch.int32)
    return out.reshape(*lead, G)


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
    ``method``: "greedy" or "hungarian"."""
    if method == "greedy":
        return greedy_match(benefit, num_gt)
    if method == "hungarian":
        return hungarian_match(benefit, num_gt)
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
