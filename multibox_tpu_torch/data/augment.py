"""On-device preprocessing and train-time augmentation, batched.

Eval half: :func:`bilinear_resize` and :func:`preprocess_eval` (half-pixel
bilinear resize, then slim scaling to [-1, 1]).

Train half: bbox-constrained random crop (slim's
``distorted_bounding_box_crop`` by K-candidate rejection sampling), crop +
resize in one two-tap interpolation, horizontal flip with the boxes,
brightness / contrast / saturation / hue jitter, then slim scaling. All of
it is tensor code on the device the batch lives on.

Every random function is split in two: ``draw_*`` takes an explicit
``torch.Generator`` and returns the random parameters as tensors, and the
function of the same name without ``draw_`` applies given parameters. The
split lets a caller replay parameters drawn elsewhere (the parity tests
replay the JAX package's ``jax.random`` draws, which torch cannot
reproduce) and keeps the arithmetic independent of how the numbers were
drawn.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from multibox_tpu_torch.ops import boxes as box_ops


def _full_window(device) -> torch.Tensor:
    """The whole image as a window, ``[0, 0, 1, 1]``, made on ``device``
    (a copy from the host would wait for it, which a CUDA graph's capture
    refuses)."""
    return (torch.arange(4, device=device) // 2).to(torch.float32)


def bilinear_resize(images: torch.Tensor, out_size: int) -> torch.Tensor:
    """Batched bilinear resize ``[B, H, W, C] → [B, S, S, C]`` (float32),
    matching TF's ``ResizeBilinear`` with ``half_pixel_centers=True``:
    output pixel i samples source coordinate ``(i + 0.5) / S · size − 0.5``.
    Rows first, then columns, in float32: :func:`crop_and_resize` over the
    full window."""
    full = _full_window(images.device)
    return crop_and_resize(images, full.expand(images.shape[0], 4), out_size)


def preprocess_eval(images: torch.Tensor, out_size: int) -> torch.Tensor:
    """Eval-mode preprocessing: resize + scale to [-1, 1] (no augmentation)."""
    images = images.to(torch.float32) / 255.0
    images = bilinear_resize(images, out_size)
    return (images - 0.5) * 2.0


# ---------------------------------------------------------------------------
# crop + resize
# ---------------------------------------------------------------------------


def _window_taps(lo: torch.Tensor, hi: torch.Tensor, size: int, out: int):
    """Per-image two-tap interpolation along one axis of a crop window:
    ``[B, out]`` lower and upper source indices and the upper weight.
    Output pixel i samples ``(lo + (i + 0.5)/out · (hi − lo)) · size − 0.5``,
    clamped to the image."""
    frac = (torch.arange(out, dtype=torch.float32, device=lo.device) + 0.5) / out
    coords = (lo[:, None] + frac[None, :] * (hi - lo)[:, None]) * size - 0.5
    c = coords.clamp(0.0, size - 1.0)
    low = c.floor()
    w = c - low
    low = low.to(torch.int64)
    return low, (low + 1).clamp_max(size - 1), w


def crop_and_resize(images: torch.Tensor, windows: torch.Tensor,
                    out_size: int) -> torch.Tensor:
    """Crop each image to its normalized window ``[B, 4]`` (ymin, xmin,
    ymax, xmax) and resize to ``out_size²``, half-pixel centres; float32
    out. The JAX package writes this as two products with two-tap
    interpolation matrices at full f32 precision; with two nonzeros per
    row that is ``(1 − w)·a + w·b`` of the two source pixels, which is what
    this computes, by gathering them."""
    B, H, W, C = images.shape
    S = out_size
    images = images.to(torch.float32)
    windows = windows.to(torch.float32)
    y0, y1, wy = _window_taps(windows[:, 0], windows[:, 2], H, S)
    x0, x1, wx = _window_taps(windows[:, 1], windows[:, 3], W, S)

    def rows(idx):
        return torch.gather(images, 1, idx[:, :, None, None].expand(B, S, W, C))

    wy = wy[:, :, None, None]
    r = rows(y0) * (1 - wy) + rows(y1) * wy  # [B, S, W, C]

    def cols(idx):
        return torch.gather(r, 2, idx[:, None, :, None].expand(B, S, S, C))

    wx = wx[:, None, :, None]
    return cols(x0) * (1 - wx) + cols(x1) * wx


# ---------------------------------------------------------------------------
# boxes under a crop
# ---------------------------------------------------------------------------


def _intersect(boxes: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Boxes ``[..., G, 4]`` cut to windows ``[..., 4]``."""
    w = window[..., None, :]
    return torch.stack([
        torch.maximum(boxes[..., 0], w[..., 0]),
        torch.maximum(boxes[..., 1], w[..., 1]),
        torch.minimum(boxes[..., 2], w[..., 2]),
        torch.minimum(boxes[..., 3], w[..., 3]),
    ], dim=-1)


def _coverage(boxes: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Share of each box's area inside the window, 0 for a degenerate box."""
    orig = box_ops.area(boxes)
    inter = box_ops.area(_intersect(boxes, window))
    return torch.where(orig > 0, inter / orig.clamp_min(1e-12),
                       torch.zeros_like(orig))


def transform_boxes_to_window(
    boxes: torch.Tensor, num_boxes: torch.Tensor, window: torch.Tensor,
    min_coverage: float = 0.25,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Re-express boxes ``[..., G, 4]`` in a crop window's frame and drop
    those with less than ``min_coverage`` of their area inside.

    Returns ``(new_boxes [..., G, 4]`` compacted to the front and zero
    after, ``new_num [...]`` int32, ``order [..., G]`` int64 — the
    compaction permutation, for per-box labels)."""
    G = boxes.shape[-2]
    dev = boxes.device
    w = window[..., None, :]
    h = (w[..., 2] - w[..., 0]).clamp_min(1e-8)
    wd = (w[..., 3] - w[..., 1]).clamp_min(1e-8)
    inter = _intersect(boxes, window)
    coverage = _coverage(boxes, window)
    new_boxes = torch.stack([
        (inter[..., 0] - w[..., 0]) / h,
        (inter[..., 1] - w[..., 1]) / wd,
        (inter[..., 2] - w[..., 0]) / h,
        (inter[..., 3] - w[..., 1]) / wd,
    ], dim=-1).clamp(0.0, 1.0)
    ar = torch.arange(G, device=dev)
    valid_in = ar < torch.as_tensor(num_boxes, device=dev)[..., None]
    keep = valid_in & (coverage >= min_coverage)
    order = torch.argsort(torch.where(keep, ar, G + ar), dim=-1, stable=True)
    compacted = torch.gather(new_boxes, -2, order[..., None].expand_as(new_boxes))
    new_num = keep.sum(-1).to(torch.int32)
    compacted = torch.where((ar < new_num[..., None])[..., None], compacted,
                            torch.zeros_like(compacted))
    return compacted, new_num, order


# ---------------------------------------------------------------------------
# random crop window
# ---------------------------------------------------------------------------


def _uniform(gen: torch.Generator, shape, lo, hi) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return u * (hi - lo) + lo


def draw_crop_params(gen: torch.Generator, batch: int,
                     area_range=(0.5, 1.0), aspect_range=(0.75, 1.33),
                     num_candidates: int = 16) -> Dict[str, torch.Tensor]:
    """K candidate windows per image: ``area [B, K]``, ``log_aspect [B, K]``
    and the position ``uv [B, K, 2]`` in [0, 1)."""
    K = num_candidates
    return {
        "area": _uniform(gen, (batch, K), area_range[0], area_range[1]),
        "log_aspect": _uniform(gen, (batch, K), math.log(aspect_range[0]),
                               math.log(aspect_range[1])),
        "uv": torch.rand((batch, K, 2), generator=gen, device=gen.device),
    }


def sample_crop_window(params: Dict[str, torch.Tensor], boxes: torch.Tensor,
                       num_boxes: torch.Tensor,
                       min_object_covered: float = 0.7) -> torch.Tensor:
    """slim-style distorted-bbox crop from drawn candidates: per image the
    first candidate that keeps ≥ ``min_object_covered`` of some gt box's
    area (any candidate when the image has no box), else the full image.
    ``boxes [B, G, 4]``, ``num_boxes [B]`` → windows ``[B, 4]``."""
    ar = torch.exp(params["log_aspect"])
    h = torch.sqrt(params["area"] * ar).clamp_max(1.0)
    w = torch.sqrt(params["area"] / ar).clamp_max(1.0)
    y0 = params["uv"][..., 0] * (1.0 - h)
    x0 = params["uv"][..., 1] * (1.0 - w)
    windows = torch.stack([y0, x0, y0 + h, x0 + w], dim=-1)  # [B, K, 4]
    G = boxes.shape[-2]
    n = num_boxes.to(boxes.device)
    valid_box = torch.arange(G, device=boxes.device) < n[:, None]  # [B, G]
    cov = _coverage(boxes[:, None], windows)  # [B, K, G]
    ok = ((cov >= min_object_covered) & valid_box[:, None, :]).any(-1)
    ok = ok | (n <= 0)[:, None]
    K = ok.shape[1]
    first = torch.where(ok, torch.arange(K, device=ok.device), K).min(-1).values
    picked = torch.gather(windows, 1, first.clamp_max(K - 1)[:, None, None]
                          .expand(-1, 1, 4))[:, 0]
    return torch.where(ok.any(-1)[:, None], picked, _full_window(boxes.device))


# ---------------------------------------------------------------------------
# color
# ---------------------------------------------------------------------------

# RGB↔YIQ (NTSC): hue rotation is a rotation of the IQ chroma plane. The
# inverse is the exact one, so that a zero rotation is the identity.
_RGB_TO_YIQ = np.array(
    [[0.299, 0.587, 0.114],
     [0.596, -0.274, -0.322],
     [0.211, -0.523, 0.312]], np.float32
)
_YIQ_TO_RGB = np.linalg.inv(_RGB_TO_YIQ).astype(np.float32)
# the two matrices on each device, copied there once: a copy from the host
# inside a CUDA graph's capture would wait for it, which the capture refuses
_YIQ_ON: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _yiq_matrices(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    mats = _YIQ_ON.get(device)
    if mats is None:
        mats = (torch.from_numpy(_RGB_TO_YIQ).to(device),
                torch.from_numpy(_YIQ_TO_RGB).to(device))
        _YIQ_ON[device] = mats
    return mats


def _rotate_hue(images: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotate hue by a per-image angle ``theta [B]`` (radians); images
    ``[B, H, W, 3]``."""
    to_yiq, to_rgb = _yiq_matrices(images.device)
    cos = torch.cos(theta)[:, None, None]
    sin = torch.sin(theta)[:, None, None]
    yiq = images @ to_yiq.T
    y = yiq[..., 0]
    i = yiq[..., 1] * cos - yiq[..., 2] * sin
    q = yiq[..., 1] * sin + yiq[..., 2] * cos
    return torch.stack([y, i, q], dim=-1) @ to_rgb.T


def draw_color_params(gen: torch.Generator, batch: int,
                      cfg) -> Dict[str, torch.Tensor]:
    """Per-image brightness delta, contrast and saturation factors and hue
    angle (radians), each ``[B]``."""
    d = cfg.brightness_max_delta
    return {
        "brightness": _uniform(gen, (batch,), -d, d),
        "contrast": _uniform(gen, (batch,), cfg.contrast_range[0],
                             cfg.contrast_range[1]),
        "saturation": _uniform(gen, (batch,), 0.5, 1.5),
        "hue": _uniform(gen, (batch,), -cfg.hue_max_delta, cfg.hue_max_delta)
        * (2.0 * math.pi),
    }


def color_distort(params: Dict[str, torch.Tensor], images: torch.Tensor,
                  cfg) -> torch.Tensor:
    """Brightness / contrast / saturation / hue jitter on floats in [0, 1],
    then a clip to [0, 1]. Hue uses the YIQ rotation (a 3×3 product per
    pixel), skipped when ``cfg.hue_max_delta`` is 0."""
    images = images + params["brightness"][:, None, None, None]
    c = params["contrast"][:, None, None, None]
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    images = (images - mean) * c + mean
    s = params["saturation"][:, None, None, None]
    gray = images.mean(dim=-1, keepdim=True)
    images = gray + (images - gray) * s
    if cfg.hue_max_delta > 0:
        images = _rotate_hue(images, params["hue"])
    return images.clamp(0.0, 1.0)


# ---------------------------------------------------------------------------
# the whole train-time augmentation
# ---------------------------------------------------------------------------


def draw_augment_params(gen: torch.Generator, batch: int, cfg) -> Dict:
    """Everything :func:`augment_batch` draws, in one dictionary: ``crop``
    (:func:`draw_crop_params`), ``flip [B]`` bool, ``color``
    (:func:`draw_color_params`)."""
    params = {}
    if cfg.random_crop:
        params["crop"] = draw_crop_params(
            gen, batch, area_range=(cfg.crop_min_area, cfg.crop_max_area))
    if cfg.random_flip:
        params["flip"] = torch.rand((batch,), generator=gen,
                                    device=gen.device) < 0.5
    if cfg.color_distort:
        params["color"] = draw_color_params(gen, batch, cfg)
    return params


def apply_augment(params: Dict, images: torch.Tensor, boxes: torch.Tensor,
                  num_boxes: torch.Tensor, cfg,
                  labels: Optional[torch.Tensor] = None):
    """Apply drawn augmentation parameters. ``images [B, H, W, 3]`` uint8
    canvases, ``boxes [B, G, 4]``, ``num_boxes [B]``, optional ``labels
    [B, G]`` (permuted with the boxes the crop keeps). Returns ``(images
    [B, S, S, 3]`` float32 in [-1, 1], boxes, num_boxes``)``, plus labels
    when given."""
    B = images.shape[0]
    images = images.to(torch.float32) / 255.0
    if cfg.random_crop:
        windows = sample_crop_window(
            params["crop"], boxes, num_boxes,
            min_object_covered=cfg.crop_min_object_covered)
        boxes, num_boxes, order = transform_boxes_to_window(boxes, num_boxes, windows)
        if labels is not None:
            labels = torch.gather(labels, 1, order)
            lvalid = torch.arange(labels.shape[1], device=labels.device) < num_boxes[:, None]
            labels = torch.where(lvalid, labels, torch.zeros_like(labels))
    else:
        windows = _full_window(images.device).expand(B, 4)
    images = crop_and_resize(images, windows, cfg.input_size)
    if cfg.random_flip:
        flip = params["flip"]
        images = torch.where(flip[:, None, None, None], images.flip(2), images)
        boxes = torch.where(flip[:, None, None], box_ops.flip_boxes_horizontal(boxes),
                            boxes)
        # padded rows are zeros; flipping maps them to (0, 1, 0, 1): re-mask
        valid = torch.arange(boxes.shape[1], device=boxes.device) < num_boxes[:, None]
        boxes = torch.where(valid[:, :, None], boxes, torch.zeros_like(boxes))
    if cfg.color_distort:
        images = color_distort(params["color"], images, cfg)
    images = (images - 0.5) * 2.0  # slim scaling to [-1, 1]
    if labels is not None:
        return images, boxes, num_boxes, labels
    return images, boxes, num_boxes


def take_rows(params: Dict, start: int, stop: int) -> Dict:
    """Rows ``[start, stop)`` of every tensor of drawn parameters."""
    return {k: take_rows(v, start, stop) if isinstance(v, dict) else v[start:stop]
            for k, v in params.items()}


def augment_batch(gen: torch.Generator, images: torch.Tensor, boxes: torch.Tensor,
                  num_boxes: torch.Tensor, cfg,
                  labels: Optional[torch.Tensor] = None,
                  rows: Optional[Tuple[int, int]] = None):
    """Full train-time augmentation: :func:`draw_augment_params` from
    ``gen`` (a generator on the batch's device), then
    :func:`apply_augment`. ``rows=(first, global_batch)``: the batch is
    rows ``first…`` of a global batch (a data-parallel rank's share);
    the parameters are drawn for the whole global batch and the batch's
    rows kept, so that each image is augmented as it would be in one
    process."""
    B = images.shape[0]
    if rows is None:
        params = draw_augment_params(gen, B, cfg)
    else:
        first, total = rows
        params = take_rows(draw_augment_params(gen, total, cfg), first, first + B)
    return apply_augment(params, images, boxes, num_boxes, cfg, labels)
