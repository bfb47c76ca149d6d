"""Prior-box generation and I/O (numpy only).

* :func:`generate_priors_multiscale` — SSD-style grid priors: for each
  feature-map resolution, a regular grid of centers × (scale, aspect-ratio)
  shapes (Liu et al., arXiv:1512.02325 §2.2).
* :func:`save_priors` / :func:`load_priors` — priors are ``[P, 4]`` float32
  normalized corner boxes, saved/loaded as pickles (the ``--priors`` flag
  of the CLIs).

The k-means generator that clusters a dataset's ground-truth boxes arrives
with the training slice.
"""

from __future__ import annotations

import math
import pickle
from typing import Sequence

import numpy as np


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
