"""Plain detection arithmetic: the eval preprocessing, box decoding, and the
greedy non-maximum suppression that detection's answers are judged by.

Boxes are normalized corners ``[ymin, xmin, ymax, xmax]``. Decoding is the
MultiBox residual (``prior + offset``, arXiv:1312.2249) or SSD's
centre/log-scale form with variances (0.1, 0.1, 0.2, 0.2) (arXiv:1512.02325
§2.2), clipped to the image. Imports nothing but torch and the reference.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import model as ref_model

EPS = 1e-8
SSD_VARIANCES = (0.1, 0.1, 0.2, 0.2)


def _taps(lo: torch.Tensor, hi: torch.Tensor, size: int, out: int):
    frac = (torch.arange(out, dtype=torch.float32, device=lo.device) + 0.5) / out
    coords = (lo[:, None] + frac[None, :] * (hi - lo)[:, None]) * size - 0.5
    c = coords.clamp(0.0, size - 1.0)
    low = c.floor()
    w = c - low
    low = low.to(torch.int64)
    return low, (low + 1).clamp_max(size - 1), w


def crop_and_resize(images: torch.Tensor, windows: torch.Tensor, out: int) -> torch.Tensor:
    """Bilinear crop of each image ``[B, H, W, C]`` to its window ``[B, 4]``
    and resize to ``out``², half-pixel centres (TensorFlow's
    ``ResizeBilinear(half_pixel_centers=True)``), float32."""
    B, H, W, C = images.shape
    images = images.to(torch.float32)
    y0, y1, wy = _taps(windows[:, 0], windows[:, 2], H, out)
    x0, x1, wx = _taps(windows[:, 1], windows[:, 3], W, out)

    def rows(idx):
        return torch.gather(images, 1, idx[:, :, None, None].expand(B, out, W, C))

    wy = wy[:, :, None, None]
    r = rows(y0) * (1 - wy) + rows(y1) * wy

    def cols(idx):
        return torch.gather(r, 2, idx[:, None, :, None].expand(B, out, out, C))

    wx = wx[:, None, :, None]
    return cols(x0) * (1 - wx) + cols(x1) * wx


def full_windows(batch: int, device) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 1.0, 1.0], device=device).expand(batch, 4)


def preprocess_eval(images_u8: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 canvases -> the model's input: resized, scaled to [-1, 1]."""
    x = images_u8.to(torch.float32) / 255.0
    x = crop_and_resize(x, full_windows(x.shape[0], x.device), size)
    return (x - 0.5) * 2.0


def decode(offsets: torch.Tensor, priors: torch.Tensor, encoding: str) -> torch.Tensor:
    """Offsets ``[B, P, 4]`` -> boxes ``[B, P, 4]`` clipped to [0, 1]."""
    if encoding == "multibox":
        return (priors[None] + offsets).clamp(0.0, 1.0)
    ph, pw = priors[:, 2] - priors[:, 0], priors[:, 3] - priors[:, 1]
    pcy, pcx = priors[:, 0] + 0.5 * ph, priors[:, 1] + 0.5 * pw
    v = SSD_VARIANCES
    cy = offsets[..., 0] * v[0] * ph + pcy
    cx = offsets[..., 1] * v[1] * pw + pcx
    h = torch.exp(offsets[..., 2] * v[2]) * ph
    w = torch.exp(offsets[..., 3] * v[3]) * pw
    return torch.stack([cy - 0.5 * h, cx - 0.5 * w, cy + 0.5 * h, cx + 0.5 * w],
                       -1).clamp(0.0, 1.0)


def iou_one_to_many(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of ``a [N, 4]`` with ``b [N, P, 4]`` -> ``[N, P]``; 0 where the
    union is empty."""
    a = a[:, None, :]
    ih = (torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0])).clamp_min(0)
    iw = (torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1])).clamp_min(0)
    inter = ih * iw

    def area(x):
        return (x[..., 2] - x[..., 0]).clamp_min(0) * (x[..., 3] - x[..., 1]).clamp_min(0)

    union = area(a) + area(b) - inter
    return torch.where(union > 0, inter / union.clamp_min(EPS), torch.zeros_like(inter))


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, k: int, iou_threshold: float,
               score_threshold: float) -> torch.Tensor:
    """Greedy NMS, batched: per image the highest-scoring live box (lowest
    index among equal scores), then every box overlapping it by more than
    ``iou_threshold`` is dropped, up to ``k`` boxes. ``boxes [B, P, 4]``,
    ``scores [B, P]`` -> selected indices ``[B, k]``, -1 in empty slots."""
    B, P = scores.shape
    live = torch.where(scores >= score_threshold, scores, torch.full_like(scores, -float("inf")))
    out = torch.full((B, k), -1, dtype=torch.int64, device=scores.device)
    rows = torch.arange(B, device=scores.device)
    for r in range(k):
        best = live.argmax(1)
        ok = torch.isfinite(live[rows, best])
        out[:, r] = torch.where(ok, best, -1)
        over = iou_one_to_many(boxes[rows, best], boxes) > iou_threshold
        over[rows, best] = True
        live = torch.where(ok[:, None] & over, torch.full_like(live, -float("inf")), live)
    return out


def boxes_and_logits(spec: Dict, params, stats, canvases: torch.Tensor, priors: torch.Tensor,
                     prec: "ref_model.Precision" = ref_model.FLOAT32, block: int = 32):
    """The reference's decoded boxes ``[N, P, 4]`` and logits ``[N, P]`` of
    uint8 canvases ``[N, H, W, 3]``, ``block`` images at a time."""
    boxes, logits = [], []
    with torch.no_grad():
        for lo in range(0, len(canvases), block):
            x = preprocess_eval(canvases[lo:lo + block], spec["input_size"])
            loc, conf = ref_model.forward(spec, params, stats, x, prec)
            boxes.append(decode(loc, priors, spec["box_encoding"]))
            logits.append(conf)
    return torch.cat(boxes), torch.cat(logits)
