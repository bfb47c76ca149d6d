"""Everything a run feeds both sides, made from ``--seed``: the weights (on
the device, in one draw), the priors, and the pools of host batches that
the traffic cycles through (drawn on the device, copied to the host once).

The same seed gives the same numbers on the same kind of device. Each kind
of input has its own stream, ``sub_seed(seed, kind)``, so that a change to
one leaves the others as they were.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference import model as ref_model

WEIGHTS, POOL, PRIORS, SAMPLE = range(4)


def sub_seed(seed: int, kind: int) -> int:
    return int(np.random.SeedSequence([int(seed), kind]).generate_state(1, np.uint64)[0] >> 1)


def generator(seed: int, kind: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, kind))


def make_priors(model: Dict, seed: int) -> np.ndarray:
    """``[P, 4]`` float32 priors. ``model["priors"]["kind"]``: "seeded"
    (P boxes drawn from the seed, standing in for a dataset's k-means
    priors) or "multiscale" (SSD's grid, arXiv:1512.02325 §2.2: scales
    spaced from ``s_min`` to ``s_max`` over the maps, one box an aspect
    ratio and the interpolated square, centres on each cell, clipped)."""
    spec = model["priors"]
    if spec["kind"] == "seeded":
        rng = np.random.default_rng(sub_seed(seed, PRIORS))
        P = model["num_priors"]
        cy, cx = rng.uniform(0.1, 0.9, P), rng.uniform(0.1, 0.9, P)
        h, w = rng.uniform(*spec["size"], P), rng.uniform(*spec["size"], P)
        boxes = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)
        return np.clip(boxes, 0.0, 1.0).astype(np.float32)
    if spec["kind"] != "multiscale":
        raise ValueError(f"unknown priors kind {spec['kind']!r}")
    sizes = spec["feature_map_sizes"]
    m = len(sizes)
    lo, hi = spec["s_min"], spec["s_max"]
    scales = [lo + (hi - lo) * k / (m - 1) for k in range(m)] + [1.0]
    out = []
    for level, f in enumerate(sizes):
        s = scales[level]
        shapes = [(s * math.sqrt(ar), s / math.sqrt(ar)) for ar in spec["aspect_ratios"]]
        shapes.append((math.sqrt(s * scales[level + 1]),) * 2)
        for i in range(f):
            for j in range(f):
                cy, cx = (i + 0.5) / f, (j + 0.5) / f
                out.extend((cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2) for h, w in shapes)
    return np.clip(np.asarray(out, np.float32), 0.0, 1.0)


def make_weights(model: Dict, seed: int, device) -> Tuple[Dict, Dict]:
    """``(params, batch_stats)`` on ``device``, float32, from one draw of
    normal numbers: convolutions He-normal, the head's layers with the
    standard deviations of ``model["weights"]``, BatchNorm biases N(0,
    0.1²), running means 0 and variances 1 (the statistics of a fresh
    model)."""
    shapes, stat_shapes = ref_model.parameter_shapes(model)
    std = model["weights"]
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator(seed, WEIGHTS, device), device=device)
    params, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        w = flat[at:at + n].view(shape)
        at += n
        fan_in = math.prod(shape[1:]) if len(shape) == 4 else shape[0]
        if name.endswith("BatchNorm.bias"):
            scale = 0.1
        elif name.endswith(".bias"):
            scale = 0.0
        elif name.startswith(("MultiBoxHead.Locations", "SSDHead.Loc_")):
            scale = std["location_std"] / math.sqrt(fan_in)
        elif name.startswith(("MultiBoxHead.Confidences", "SSDHead.Conf_")):
            scale = std["confidence_std"] / math.sqrt(fan_in)
        else:  # He-normal, ReLU follows
            scale = math.sqrt(2.0 / fan_in)
        params[name] = w * scale
    stats = {name: (torch.ones if name.endswith(".var") else torch.zeros)(shape, device=device)
             for name, shape in stat_shapes.items()}
    return params, stats


def _canvases(gen, shape, device) -> torch.Tensor:
    return torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8)


def make_detect_pool(traffic: Dict, seed: int, device) -> List[np.ndarray]:
    """``pool_batches`` host batches of uint8 canvases ``[B, S, S, 3]``."""
    B, S, N = traffic["batch"], traffic["canvas"], traffic["pool_batches"]
    pool = _canvases(generator(seed, POOL, device), (N, B, S, S, 3), device).cpu().numpy()
    return list(pool)


def make_train_pool(traffic: Dict, seed: int, device) -> List[Dict[str, np.ndarray]]:
    """``pool_batches`` host batches: uint8 canvases ``[B, S, S, 3]``,
    ``boxes [B, G, 4]`` (rows past ``num_boxes`` zero) and ``num_boxes
    [B]`` int32, from ``boxes_per_image`` [lo, hi] boxes an image with
    sides in ``box_size``, centres inside [0.1, 0.9]."""
    B, S, N, G = traffic["batch"], traffic["canvas"], traffic["pool_batches"], traffic["max_boxes"]
    gen = generator(seed, POOL, device)
    images = _canvases(gen, (N, B, S, S, 3), device)
    lo, hi = traffic["boxes_per_image"]
    num = torch.randint(lo, hi + 1, (N, B), generator=gen, device=device, dtype=torch.int32)
    u = torch.rand((N, B, G, 4), generator=gen, device=device)
    smin, smax = traffic["box_size"]
    cy, cx = 0.1 + 0.8 * u[..., 0], 0.1 + 0.8 * u[..., 1]
    h, w = smin + (smax - smin) * u[..., 2], smin + (smax - smin) * u[..., 3]
    boxes = torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1).clamp(0.0, 1.0)
    live = torch.arange(G, device=device) < num[..., None]
    boxes = torch.where(live[..., None], boxes, torch.zeros_like(boxes))
    images, boxes, num = images.cpu().numpy(), boxes.cpu().numpy(), num.cpu().numpy()
    return [{"images": images[n], "boxes": boxes[n], "num_boxes": num[n]} for n in range(N)]
