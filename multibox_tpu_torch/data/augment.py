"""On-device preprocessing, eval half: bilinear resize + slim scaling.

The training augmentations of the JAX package (random crop, flip, color
distortion) belong to the training slice and are not here yet.
"""

from __future__ import annotations

import torch


def _axis_taps(in_size: int, out_size: int, device):
    """Source taps of a full-window resize along one axis: indices of the
    two neighbours and the weight of the upper one, half-pixel centres,
    clamped at the border."""
    frac = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) / out_size
    coords = (frac * in_size - 0.5).clamp(0.0, in_size - 1.0)
    lo = coords.floor()
    w = coords - lo
    lo = lo.to(torch.int64)
    hi = (lo + 1).clamp_max(in_size - 1)
    return lo, hi, w


def bilinear_resize(images: torch.Tensor, out_size: int) -> torch.Tensor:
    """Batched bilinear resize ``[B, H, W, C] → [B, S, S, C]`` (float32),
    matching TF's ``ResizeBilinear`` with ``half_pixel_centers=True``:
    output pixel i samples source coordinate ``(i + 0.5) / S · size − 0.5``.
    Rows first, then columns, in float32."""
    B, H, W, C = images.shape
    images = images.to(torch.float32)
    lo, hi, w = _axis_taps(H, out_size, images.device)
    w = w[None, :, None, None]
    rows = images.index_select(1, lo) * (1 - w) + images.index_select(1, hi) * w
    lo, hi, w = _axis_taps(W, out_size, images.device)
    w = w[None, None, :, None]
    return rows.index_select(2, lo) * (1 - w) + rows.index_select(2, hi) * w


def preprocess_eval(images: torch.Tensor, out_size: int) -> torch.Tensor:
    """Eval-mode preprocessing: resize + scale to [-1, 1] (no augmentation)."""
    images = images.to(torch.float32) / 255.0
    images = bilinear_resize(images, out_size)
    return (images - 0.5) * 2.0
