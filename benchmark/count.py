"""The yardstick's arithmetic: the chip's published peaks, the model's
operations, and the least time each kernel's function needs on its inputs.

Every count is of the work the function needs on these inputs, whatever
implements it: a redesigned kernel that skips work the function still needs
gains share, one that does work the function does not need loses it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from benchmark.reference import model as ref_model

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the 700 W limit.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def bound_s(nbytes: float, flops: float, dtype: str = "float32") -> float:
    """The least time the chip could take: the larger of the bytes over the
    memory's rate and the operations over the peak of ``dtype``."""
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dtype])


# ---------------------------------------------------------------------------
# the model's operations (multiply-adds count 2)
# ---------------------------------------------------------------------------


def _unit_flops(n: int, unit) -> Tuple[float, int]:
    cin, cout, kh, kw, stride, pad = unit
    out = (n - kh) // stride + 1 if pad == "VALID" else -(-n // stride)  # VALID: square
    return 2.0 * cout * cin * kh * kw * out * out, out


def forward_flops(model: Dict) -> Tuple[float, float]:
    """``(flops, first_conv_flops)`` of one image's forward pass: every
    convolution and product of the backbone and the head."""
    n, total, first = model["input_size"], 0.0, None
    for name, kind, units, _ in ref_model.blocks():
        if kind == "pool":
            n = (n - 3) // 2 + 1
            continue
        outs = []
        for unit in units.values():
            f, out = _unit_flops(n, unit)
            total += f
            first = f if first is None else first
            outs.append(out)
        n = min(outs) if kind.startswith("reduction") else outs[0]
    C = model.get("num_classes", 1)
    if model.get("head_type", "multibox") == "multibox":
        g = ref_model.grid_size(model["input_size"], "Mixed_7c")
        bn = model.get("bottleneck_features", 96)
        flat = g * g * bn
        total += 2.0 * g * g * 2048 * bn + 2.0 * flat * model["num_priors"] * (4 + C)
    else:
        K = model.get("ssd_priors_per_cell", 6)
        channels = ref_model.endpoint_channels()
        for ep in model["ssd_endpoints"]:
            g = ref_model.grid_size(model["input_size"], ep)
            total += 2.0 * K * (4 + C) * channels[ep] * 9 * g * g
    return total, first


def model_flops(model: Dict, train: bool = False) -> float:
    """One image's operations: the forward pass, or for a train step the
    forward and the backward (the weights' gradients of every layer, the
    inputs' gradients of every layer but the first). Recomputation is not
    counted; BatchNorm, pooling and elementwise work are not counted."""
    fwd, first = forward_flops(model)
    return 3.0 * fwd - first if train else fwd


# ---------------------------------------------------------------------------
# kernels' bounds
# ---------------------------------------------------------------------------


def matmul_bound_s(M: int, K: int, N: int) -> float:
    """B2 (matmul + bias + optional ReLU) in float32: each input, the bias
    and the output once; 2·M·K·N operations."""
    return bound_s((M * K + K * N + M * N) * 4 + N * 4, 2.0 * M * K * N, "float32")


def head_matmuls(model: Dict, batch: int) -> List[Tuple[int, int, int]]:
    """``(M, K, N)`` of the MultiBox head's three products."""
    g = ref_model.grid_size(model["input_size"], "Mixed_7c")
    bn = model.get("bottleneck_features", 96)
    P, C = model["num_priors"], model.get("num_classes", 1)
    return [(batch * g * g, 2048, bn), (batch, g * g * bn, P * 4), (batch, g * g * bn, P * C)]


def _iou_many(box, others):
    ih = np.maximum(np.minimum(box[2], others[:, 2]) - np.maximum(box[0], others[:, 0]), 0)
    iw = np.maximum(np.minimum(box[3], others[:, 3]) - np.maximum(box[1], others[:, 1]), 0)
    inter = ih * iw

    def area(b):
        return np.maximum(b[..., 2] - b[..., 0], 0) * np.maximum(b[..., 3] - b[..., 1], 0)

    union = area(others) + area(box) - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-8), 0.0)


def nms_work(boxes: np.ndarray, scores: np.ndarray, k: int, iou_threshold: float,
             score_threshold: float) -> Tuple[int, int]:
    """``(candidates reached, IoU tests)`` that greedy NMS needs on ``boxes
    [B, P, 4]`` and ``scores [B, P]``, summed over the images: the live
    boxes in score order (equal scores by index) up to the k-th kept, or
    all of them; each tested against the boxes kept before it up to the
    first that suppresses it."""
    reached = tests = 0
    for b in range(scores.shape[0]):
        s = scores[b]
        live = np.flatnonzero(s >= score_threshold)
        order = live[np.lexsort((live, -s[live]))]
        kept: List[int] = []
        for c in order:
            if len(kept) == k:
                break
            reached += 1
            if kept:
                over = np.flatnonzero(_iou_many(boxes[b, c], boxes[b, kept]) > iou_threshold)
                if len(over):
                    tests += int(over[0]) + 1
                    continue
                tests += len(kept)
            kept.append(int(c))
    return reached, tests


def nms_bound_s(boxes: np.ndarray, scores: np.ndarray, k: int, iou_threshold: float,
                score_threshold: float) -> float:
    """B1 (NMS + top-k): every score read, the box of each candidate
    reached, index and score of each output slot written; 25 float32
    operations an IoU test."""
    B, P = scores.shape
    reached, tests = nms_work(boxes, scores, k, iou_threshold, score_threshold)
    return bound_s(B * P * 4 + reached * 16 + B * k * 8, 25.0 * tests, "float32")


IOU_FLOPS = 13  # intersection 9, union 2, the division, a compare to select


def match_bound_s(live_boxes: np.ndarray, max_boxes: int, num_priors: int) -> float:
    """B4 (greedy matching) on one batch: the IoU of every live ground-truth
    box (``live_boxes [B]``) with every prior, read once; the priors, the
    padded boxes and counts read and the assignment written once."""
    B = len(live_boxes)
    nbytes = num_priors * 16 + B * max_boxes * 16 + B * 4 + B * max_boxes * 4
    return bound_s(nbytes, float(IOU_FLOPS * int(np.sum(live_boxes)) * num_priors), "float32")
