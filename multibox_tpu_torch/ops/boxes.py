"""Box geometry in normalized corner coordinates ``[ymin, xmin, ymax, xmax]``.

All coordinates live in ``[0, 1]`` relative to image height/width. Plain
functions on tensors of any device; static shapes.

Two encodings are provided:

* **MultiBox residual** (``encode_boxes`` / ``decode_boxes``): the original
  DeepMultiBox parameterization, ``offset = gt − prior`` directly in
  normalized corner coordinates (Erhan et al., CVPR'14, arXiv:1312.2249).
  This is the parity-critical default.
* **SSD center/log-scale** (``encode_boxes_ssd`` / ``decode_boxes_ssd``):
  the (cy, cx, h, w) encoding with variances (Liu et al., arXiv:1512.02325
  §2.2), used by the SSD-style multi-scale extension.
"""

from __future__ import annotations

import torch

# Numerical floor for degenerate-box divisions / logs.
EPS = 1e-8


def _split4(boxes: torch.Tensor):
    return boxes[..., 0:1], boxes[..., 1:2], boxes[..., 2:3], boxes[..., 3:4]


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Box areas. ``boxes``: ``[..., 4]`` → ``[...]``. Degenerate boxes → 0."""
    ymin, xmin, ymax, xmax = _split4(boxes)
    h = (ymax - ymin).clamp_min(0.0)
    w = (xmax - xmin).clamp_min(0.0)
    return (h * w).squeeze(-1)


def intersection(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection areas. ``a``: ``[N, 4]``, ``b``: ``[M, 4]`` → ``[N, M]``."""
    ay0, ax0, ay1, ax1 = _split4(a)  # each [N, 1]
    by0, bx0, by1, bx1 = _split4(b)  # each [M, 1]
    inter_h = torch.minimum(ay1, by1.T) - torch.maximum(ay0, by0.T)
    inter_w = torch.minimum(ax1, bx1.T) - torch.maximum(ax0, bx0.T)
    return inter_h.clamp_min(0.0) * inter_w.clamp_min(0.0)


def _iou_from(inter: torch.Tensor, union: torch.Tensor) -> torch.Tensor:
    return torch.where(
        union > 0, inter / union.clamp_min(EPS), torch.zeros_like(inter)
    )


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU. ``a``: ``[N, 4]``, ``b``: ``[M, 4]`` → ``[N, M]`` in [0, 1].

    IoU with a degenerate (zero-area) box is 0, not NaN — padded gt rows
    (all-zero boxes) must stay inert through matching.
    """
    inter = intersection(a, b)
    union = area(a)[:, None] + area(b)[None, :] - inter
    return _iou_from(inter, union)


def iou_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise (aligned, broadcasting) IoU. ``a``, ``b``: ``[..., 4]`` → ``[...]``."""
    ay0, ax0, ay1, ax1 = _split4(a)
    by0, bx0, by1, bx1 = _split4(b)
    inter_h = torch.minimum(ay1, by1) - torch.maximum(ay0, by0)
    inter_w = torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0)
    inter = (inter_h.clamp_min(0.0) * inter_w.clamp_min(0.0)).squeeze(-1)
    union = area(a) + area(b) - inter
    return _iou_from(inter, union)


def clip_boxes(boxes: torch.Tensor, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """Clip box coordinates to ``[lo, hi]`` (the normalized image window)."""
    return boxes.clamp(lo, hi)


def flip_boxes_horizontal(boxes: torch.Tensor) -> torch.Tensor:
    """Mirror boxes around the vertical axis: x → 1 − x (and swap xmin/xmax)."""
    ymin, xmin, ymax, xmax = _split4(boxes)
    return torch.cat([ymin, 1.0 - xmax, ymax, 1.0 - xmin], dim=-1)


# ---------------------------------------------------------------------------
# MultiBox residual encoding (the reference's parameterization)
# ---------------------------------------------------------------------------


def encode_boxes(gt: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """MultiBox residual target: ``offset = gt − prior`` (corner coords)."""
    return gt - priors


def decode_boxes(
    offsets: torch.Tensor, priors: torch.Tensor, clip: bool = True
) -> torch.Tensor:
    """Invert :func:`encode_boxes`: ``box = prior + offset``, optionally clipped."""
    boxes = priors + offsets
    return clip_boxes(boxes) if clip else boxes


# ---------------------------------------------------------------------------
# SSD center/log-scale encoding (multi-scale extension)
# ---------------------------------------------------------------------------

# SSD paper defaults: targets are divided by these before regression.
DEFAULT_VARIANCES = (0.1, 0.1, 0.2, 0.2)


def _corners_to_center(boxes: torch.Tensor):
    ymin, xmin, ymax, xmax = _split4(boxes)
    h = ymax - ymin
    w = xmax - xmin
    cy = ymin + 0.5 * h
    cx = xmin + 0.5 * w
    return cy, cx, h, w


def encode_boxes_ssd(
    gt: torch.Tensor,
    priors: torch.Tensor,
    variances=DEFAULT_VARIANCES,
) -> torch.Tensor:
    """SSD encoding: ``(Δcy/h_p/v0, Δcx/w_p/v1, log(h/h_p)/v2, log(w/w_p)/v3)``."""
    gcy, gcx, gh, gw = _corners_to_center(gt)
    pcy, pcx, ph, pw = _corners_to_center(priors)
    ph = ph.clamp_min(EPS)
    pw = pw.clamp_min(EPS)
    ty = (gcy - pcy) / ph / variances[0]
    tx = (gcx - pcx) / pw / variances[1]
    th = torch.log(gh.clamp_min(EPS) / ph) / variances[2]
    tw = torch.log(gw.clamp_min(EPS) / pw) / variances[3]
    return torch.cat([ty, tx, th, tw], dim=-1)


def decode_boxes_ssd(
    offsets: torch.Tensor,
    priors: torch.Tensor,
    variances=DEFAULT_VARIANCES,
    clip: bool = True,
) -> torch.Tensor:
    """Invert :func:`encode_boxes_ssd` back to corner coordinates."""
    ty, tx, th, tw = _split4(offsets)
    pcy, pcx, ph, pw = _corners_to_center(priors)
    cy = ty * variances[0] * ph + pcy
    cx = tx * variances[1] * pw + pcx
    h = torch.exp(th * variances[2]) * ph
    w = torch.exp(tw * variances[3]) * pw
    boxes = torch.cat(
        [cy - 0.5 * h, cx - 0.5 * w, cy + 0.5 * h, cx + 0.5 * w], dim=-1
    )
    return clip_boxes(boxes) if clip else boxes
