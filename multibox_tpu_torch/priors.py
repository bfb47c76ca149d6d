"""Prior-box generation and I/O.

* :func:`generate_priors_kmeans` — cluster the normalized ground-truth
  boxes of a dataset into ``P`` priors (arXiv:1412.1441 §2: every gt has a
  nearby prior): k-means++ seeding, then a fixed number of Lloyd
  iterations, in torch on a named device.
* :func:`generate_priors_multiscale` — SSD-style grid priors: for each
  feature-map resolution, a regular grid of centers × (scale, aspect-ratio)
  shapes (Liu et al., arXiv:1512.02325 §2.2).
* :func:`save_priors` / :func:`load_priors` — priors are ``[P, 4]`` float32
  normalized corner boxes, saved/loaded as pickles (the ``--priors`` flag
  of the CLIs).

The seeding draws from a ``torch.Generator``, not ``jax.random``, so the
JAX package's priors for a seed are not reproduced; the Lloyd updates
from given centers are the same computation.
"""

from __future__ import annotations

import math
import pickle
from typing import Sequence

import numpy as np
import torch

from multibox_tpu_torch.device import resolve_device


def generate_priors_kmeans(
    gt_boxes: np.ndarray,
    num_priors: int,
    num_iters: int = 50,
    seed: int = 0,
    device=None,
) -> np.ndarray:
    """K-means clustering of gt boxes in (ymin, xmin, ymax, xmax) space.

    Args:
      gt_boxes: ``[N, 4]`` normalized corner boxes from the training set.
      num_priors: number of clusters P.
      num_iters: fixed Lloyd iterations (deterministic).
      seed: seed of the k-means++ generator.
      device: where to cluster (``None`` = CUDA, raises without one).

    Returns ``[P, 4]`` float32 priors, rows sorted lexicographically so the
    result does not depend on the clusters' order.
    """
    device = resolve_device(device)
    boxes = torch.as_tensor(np.asarray(gt_boxes, np.float32), device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    centers = _kmeans_pp_init(gen, boxes, num_priors)
    out = _lloyd(boxes, centers, num_iters).cpu().numpy()
    order = np.lexsort((out[:, 3], out[:, 2], out[:, 1], out[:, 0]))
    return out[order]


def _kmeans_pp_init(gen: torch.Generator, points: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ seeding (D² sampling): each next center is drawn with
    probability ∝ squared distance to the nearest chosen one, by inverse
    CDF as ``jax.random.choice`` draws (all-zero distances pick index 0)."""
    n = points.shape[0]
    first = int(torch.randint(n, (), generator=gen, device=points.device))
    centers = torch.zeros((k, 4), dtype=points.dtype, device=points.device)
    centers[0] = points[first]
    d2 = ((points - points[first]) ** 2).sum(-1)
    for c in range(1, k):
        cdf = torch.cumsum(d2 / d2.sum().clamp_min(1e-12), 0)
        r = cdf[-1] * (1.0 - torch.rand((1,), generator=gen, device=points.device))
        idx = torch.searchsorted(cdf, r).clamp_max(n - 1)
        nxt = points[idx[0]]
        centers[c] = nxt
        d2 = torch.minimum(d2, ((points - nxt) ** 2).sum(-1))
    return centers


def _lloyd(points: torch.Tensor, centers: torch.Tensor, num_iters: int) -> torch.Tensor:
    """Fixed-iteration Lloyd updates, as the JAX package's ``_lloyd``: each
    point goes to its nearest center (the first one on equal distances),
    each center moves to its points' mean, and an empty cluster keeps its
    center."""
    k = centers.shape[0]
    ids = torch.arange(k, device=points.device)
    for _ in range(num_iters):
        d2 = ((points[:, None, :] - centers[None, :, :]) ** 2).sum(-1)  # [N, K]
        nearest = d2 == d2.min(dim=1, keepdim=True).values
        assign = torch.where(nearest, ids, k).min(dim=1).values
        one_hot = (assign[:, None] == ids).to(points.dtype)  # [N, K]
        counts = one_hot.sum(0)
        sums = one_hot.T @ points
        centers = torch.where((counts > 0)[:, None],
                              sums / counts.clamp_min(1.0)[:, None], centers)
    return centers


def generate_priors_multiscale(
    feature_map_sizes: Sequence[int],
    scales: Sequence[float] | None = None,
    aspect_ratios: Sequence[float] = (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
    s_min: float = 0.2,
    s_max: float = 0.9,
    add_interp_scale: bool = True,
    clip: bool = True,
) -> np.ndarray:
    """SSD-style multi-resolution grid priors (arXiv:1512.02325 §2.2).

    For feature map m of size f×f, centers are ((i+.5)/f, (j+.5)/f); shapes
    are (s_m·√ar, s_m/√ar) per aspect ratio, plus the √(s_m·s_{m+1})
    square prior when ``add_interp_scale``.

    Returns ``[P, 4]`` float32 normalized corner boxes.
    """
    m = len(feature_map_sizes)
    if scales is None:
        if m == 1:
            scales = [s_min]
        else:
            scales = [s_min + (s_max - s_min) * k / (m - 1) for k in range(m)]
    scales = list(scales) + [1.0]  # s_{m+1} for the interpolated scale

    priors = []
    for level, f in enumerate(feature_map_sizes):
        s = scales[level]
        shapes = [(s * math.sqrt(ar), s / math.sqrt(ar)) for ar in aspect_ratios]
        if add_interp_scale:
            s_prime = math.sqrt(s * scales[level + 1])
            shapes.append((s_prime, s_prime))
        for i in range(f):
            for j in range(f):
                cy = (i + 0.5) / f
                cx = (j + 0.5) / f
                for h, w in shapes:
                    priors.append((cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2))
    out = np.asarray(priors, dtype=np.float32)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    return out


def save_priors(priors: np.ndarray, path: str) -> None:
    """Pickle priors — format-compatible with the reference's --priors flag."""
    with open(path, "wb") as f:
        pickle.dump(np.asarray(priors, dtype=np.float32), f)


def load_priors(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        priors = pickle.load(f)
    try:
        priors = np.asarray(priors, dtype=np.float32)
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"{path}: not a priors pickle (expected a [P, 4] float array, "
            f"got {type(priors).__name__})"
        ) from e
    if priors.ndim != 2 or priors.shape[1] != 4:
        raise ValueError(f"priors must be [P, 4], got {priors.shape}")
    return priors
