"""Plain MultiBox training steps: augmentation, matching, loss, gradients,
RMSProp, the parameters' moving average and BatchNorm's running statistics.

What a step computes (Erhan et al., arXiv:1312.2249 eq. 1-3; Szegedy et
al., arXiv:1412.1441 §2; SSD's dense matching, arXiv:1512.02325 §2.2):

- augmentation: slim's distorted-bbox crop chosen among 16 drawn windows,
  a horizontal flip, brightness / contrast / saturation / hue jitter, and
  a bilinear resize to the input size; the random numbers are drawn from
  a generator seeded with the step's seed, in a fixed order, so that the
  same seed on the same device draws the same numbers as any other
  implementation that draws them in that order;
- greedy matching: per image, G rounds of the global best (gt, prior) IoU,
  the first in row-major order among equals, killing its row and column;
  then, with ``multi_match_iou``, every unmatched prior whose best IoU
  reaches it is matched to that gt;
- the loss: ½ Σ‖l − t‖² over matched priors, sigmoid cross-entropy on the
  matched and on the ``ratio × positives`` hardest negatives of each image
  (ranked by loss, equal losses in index order), both over the batch's
  positives;
- RMSProp as optax's ``scale_by_rms`` (ε inside the square root) with a
  momentum trace, the learning rate from slim's staircase decay;
- the moving average with decay ``min(d, (1 + t) / (10 + t))``.

Float32 throughout (the caller turns TF32 off); imports nothing but numpy
and torch.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import detect as ref_detect
from benchmark.reference import model as ref_model

Tensors = Dict[str, torch.Tensor]


def step_seed(seed: int, step: int) -> int:
    """The augmentation seed of one step, from ``(seed, step)``."""
    return int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0])


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32) * (hi - lo) + lo


def draw_augment(gen: torch.Generator, B: int, aug: Dict) -> Dict:
    """The step's random numbers, in the order they are drawn."""
    out = {}
    if aug["random_crop"]:
        out["area"] = _uniform(gen, (B, 16), aug["crop_min_area"], aug["crop_max_area"])
        out["log_aspect"] = _uniform(gen, (B, 16), math.log(0.75), math.log(1.33))
        out["uv"] = torch.rand((B, 16, 2), generator=gen, device=gen.device)
    if aug["random_flip"]:
        out["flip"] = torch.rand((B,), generator=gen, device=gen.device) < 0.5
    if aug["color_distort"]:
        d = aug["brightness_max_delta"]
        out["brightness"] = _uniform(gen, (B,), -d, d)
        out["contrast"] = _uniform(gen, (B,), *aug["contrast_range"])
        out["saturation"] = _uniform(gen, (B,), 0.5, 1.5)
        out["hue"] = _uniform(gen, (B,), -aug["hue_max_delta"], aug["hue_max_delta"]) \
            * (2.0 * math.pi)
    return out


def _area(b):
    return (b[..., 2] - b[..., 0]).clamp_min(0.0) * (b[..., 3] - b[..., 1]).clamp_min(0.0)


def _cut(boxes, window):
    w = window[..., None, :]
    return torch.stack([torch.maximum(boxes[..., 0], w[..., 0]),
                        torch.maximum(boxes[..., 1], w[..., 1]),
                        torch.minimum(boxes[..., 2], w[..., 2]),
                        torch.minimum(boxes[..., 3], w[..., 3])], -1)


def _coverage(boxes, window):
    orig = _area(boxes)
    return torch.where(orig > 0, _area(_cut(boxes, window)) / orig.clamp_min(1e-12),
                       torch.zeros_like(orig))


def _crop_window(d, boxes, num, min_covered):
    ar = torch.exp(d["log_aspect"])
    h = torch.sqrt(d["area"] * ar).clamp_max(1.0)
    w = torch.sqrt(d["area"] / ar).clamp_max(1.0)
    y0 = d["uv"][..., 0] * (1.0 - h)
    x0 = d["uv"][..., 1] * (1.0 - w)
    windows = torch.stack([y0, x0, y0 + h, x0 + w], -1)
    G = boxes.shape[1]
    valid = torch.arange(G, device=boxes.device) < num[:, None]
    ok = ((_coverage(boxes[:, None], windows) >= min_covered) & valid[:, None, :]).any(-1)
    ok = ok | (num <= 0)[:, None]
    K = ok.shape[1]
    first = torch.where(ok, torch.arange(K, device=ok.device), K).min(-1).values
    picked = torch.gather(windows, 1, first.clamp_max(K - 1)[:, None, None].expand(-1, 1, 4))[:, 0]
    full = torch.tensor([0.0, 0.0, 1.0, 1.0], device=boxes.device)
    return torch.where(ok.any(-1)[:, None], picked, full)


def _boxes_in_window(boxes, num, window, min_coverage=0.25):
    G = boxes.shape[1]
    w = window[:, None, :]
    h = (w[..., 2] - w[..., 0]).clamp_min(1e-8)
    wd = (w[..., 3] - w[..., 1]).clamp_min(1e-8)
    inter = _cut(boxes, window)
    new = torch.stack([(inter[..., 0] - w[..., 0]) / h, (inter[..., 1] - w[..., 1]) / wd,
                       (inter[..., 2] - w[..., 0]) / h, (inter[..., 3] - w[..., 1]) / wd],
                      -1).clamp(0.0, 1.0)
    ar = torch.arange(G, device=boxes.device)
    keep = (ar < num[:, None]) & (_coverage(boxes, window) >= min_coverage)
    order = torch.argsort(torch.where(keep, ar, G + ar), dim=-1, stable=True)
    new = torch.gather(new, 1, order[..., None].expand_as(new))
    new_num = keep.sum(-1).to(torch.int32)
    new = torch.where((ar < new_num[:, None])[..., None], new, torch.zeros_like(new))
    return new, new_num


_RGB_TO_YIQ = np.array([[0.299, 0.587, 0.114], [0.596, -0.274, -0.322],
                        [0.211, -0.523, 0.312]], np.float32)
_YIQ_TO_RGB = np.linalg.inv(_RGB_TO_YIQ).astype(np.float32)


def _color(d, images, aug):
    images = images + d["brightness"][:, None, None, None]
    c = d["contrast"][:, None, None, None]
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    images = (images - mean) * c + mean
    s = d["saturation"][:, None, None, None]
    gray = images.mean(dim=-1, keepdim=True)
    images = gray + (images - gray) * s
    if aug["hue_max_delta"] > 0:
        to_yiq = torch.from_numpy(_RGB_TO_YIQ).to(images.device)
        to_rgb = torch.from_numpy(_YIQ_TO_RGB).to(images.device)
        cos = torch.cos(d["hue"])[:, None, None]
        sin = torch.sin(d["hue"])[:, None, None]
        yiq = images @ to_yiq.T
        i = yiq[..., 1] * cos - yiq[..., 2] * sin
        q = yiq[..., 1] * sin + yiq[..., 2] * cos
        images = torch.stack([yiq[..., 0], i, q], -1) @ to_rgb.T
    return images.clamp(0.0, 1.0)


def augment(gen: torch.Generator, images_u8, boxes, num, aug: Dict, size: int):
    """One step's augmentation of uint8 canvases ``[B, H, W, 3]`` with
    ``boxes [B, G, 4]`` and counts ``num [B]`` -> ``(images [B, S, S, 3]
    in [-1, 1], boxes, num)``."""
    B = images_u8.shape[0]
    d = draw_augment(gen, B, aug)
    images = images_u8.to(torch.float32) / 255.0
    num = num.to(torch.int64)
    if aug["random_crop"]:
        windows = _crop_window(d, boxes, num, aug["crop_min_object_covered"])
        boxes, num = _boxes_in_window(boxes, num, windows)
    else:
        windows = ref_detect.full_windows(B, images.device)
    images = ref_detect.crop_and_resize(images, windows, size)
    if aug["random_flip"]:
        flip = d["flip"]
        images = torch.where(flip[:, None, None, None], images.flip(2), images)
        flipped = torch.stack([boxes[..., 0], 1.0 - boxes[..., 3], boxes[..., 2],
                               1.0 - boxes[..., 1]], -1)
        boxes = torch.where(flip[:, None, None], flipped, boxes)
        valid = torch.arange(boxes.shape[1], device=boxes.device) < num[:, None]
        boxes = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    if aug["color_distort"]:
        images = _color(d, images, aug)
    return (images - 0.5) * 2.0, boxes, num


# ---------------------------------------------------------------------------
# matching and loss
# ---------------------------------------------------------------------------


def iou_matrix(gt: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """``gt [B, G, 4]`` x ``priors [P, 4]`` -> ``[B, G, P]``."""
    a, b = gt[..., :, None, :], priors
    ih = (torch.minimum(a[..., 2], b[:, 2]) - torch.maximum(a[..., 0], b[:, 0])).clamp_min(0.0)
    iw = (torch.minimum(a[..., 3], b[:, 3]) - torch.maximum(a[..., 1], b[:, 1])).clamp_min(0.0)
    inter = ih * iw
    union = _area(gt)[..., :, None] + _area(priors) - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-8), torch.zeros_like(inter))


def greedy_match(iou: torch.Tensor, num: torch.Tensor) -> torch.Tensor:
    """Per gt row the prior it is matched to (-1 for padded rows)."""
    B, G, P = iou.shape
    dev = iou.device
    neg = -1e30
    active = torch.arange(G, device=dev)[None, :] < num[:, None]
    masked = torch.where(active[..., None], iou, torch.full_like(iou, neg))
    out = torch.full((B, G), -1, dtype=torch.int64, device=dev)
    rows, cols, batch = torch.arange(G, device=dev), torch.arange(P, device=dev), \
        torch.arange(B, device=dev)
    for _ in range(G):
        flat = masked.reshape(B, G * P)
        best = flat.max(1).values
        cells = torch.arange(G * P, device=dev)
        idx = torch.where(flat == best[:, None], cells, G * P).min(1).values.clamp_max(G * P - 1)
        i, j = idx // P, idx % P  # the row-major first cell among equal maxima
        valid = best > neg / 2
        out[batch, i] = torch.where(valid, j, out[batch, i])
        kill = (rows[None, :, None] == i[:, None, None]) | (cols[None, None, :] == j[:, None, None])
        masked = torch.where(valid[:, None, None] & kill, torch.full_like(masked, neg), masked)
    return out


def prior_targets(assign, gt, num, priors, multi_match_iou: float):
    """Per prior, the gt it is matched to (-1 unmatched)."""
    B, G = assign.shape
    P = priors.shape[0]
    prior_gt = torch.full((B, P + 1), -1, dtype=torch.int64, device=gt.device)
    ids = torch.arange(G, device=gt.device).expand(B, G)
    prior_gt.scatter_(1, torch.where(assign >= 0, assign, P), ids)
    prior_gt = prior_gt[:, :P]
    if multi_match_iou > 0:
        iou = iou_matrix(gt, priors)
        active = torch.arange(G, device=gt.device)[None, :] < num[:, None]
        iou = torch.where(active[..., None], iou, torch.full_like(iou, -1.0))
        best_iou = iou.max(1).values
        first = torch.where(iou == best_iou[:, None, :],
                            torch.arange(G, device=gt.device)[:, None], G)
        best_gt = first.min(1).values  # the first gt among equal maxima
        extra = (best_iou >= multi_match_iou) & (prior_gt < 0)
        prior_gt = torch.where(extra, best_gt, prior_gt)
    return prior_gt


def encode(gt_for_prior, priors, encoding: str):
    if encoding == "multibox":
        return gt_for_prior - priors
    eps, v = 1e-8, ref_detect.SSD_VARIANCES

    def centre(b):
        h, w = b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]
        return b[..., 0] + 0.5 * h, b[..., 1] + 0.5 * w, h, w

    gcy, gcx, gh, gw = centre(gt_for_prior)
    pcy, pcx, ph, pw = centre(priors)
    ph, pw = ph.clamp_min(eps), pw.clamp_min(eps)
    return torch.stack([(gcy - pcy) / ph / v[0], (gcx - pcx) / pw / v[1],
                        torch.log(gh.clamp_min(eps) / ph) / v[2],
                        torch.log(gw.clamp_min(eps) / pw) / v[3]], -1)


def multibox_loss(loc, conf, gt, num, priors, tc: Dict) -> torch.Tensor:
    """The batch's loss (class-agnostic confidences ``[B, P]``)."""
    with torch.no_grad():
        assign = greedy_match(iou_matrix(gt, priors), num)
        prior_gt = prior_targets(assign, gt, num, priors, tc["multi_match_iou"])
        matched = prior_gt >= 0
        conf_t = matched.to(torch.float32)
        gt_for_prior = torch.gather(gt, 1, prior_gt.clamp_min(0)[..., None].expand(-1, -1, 4))
        loc_t = torch.where(matched[..., None], encode(gt_for_prior, priors, tc["box_encoding"]),
                            torch.zeros_like(gt_for_prior))
    B, P = conf.shape
    num_pos = conf_t.sum(1)
    total_pos = num_pos.sum().clamp_min(1.0)
    loc_loss = 0.5 * (((loc - loc_t) ** 2).sum(-1) * conf_t).sum() / total_pos
    bce = torch.clamp_min(conf, 0.0) - conf * conf_t + torch.log1p(torch.exp(-conf.abs()))
    pos_loss = (bce * conf_t).sum() / total_pos
    neg_mask = 1.0 - conf_t
    ratio = tc["hard_negative_ratio"]
    if ratio > 0:
        with torch.no_grad():
            k = torch.minimum((ratio * num_pos).clamp_min(1.0), P - num_pos)
            order = torch.argsort(-(bce.detach() * neg_mask), dim=1, stable=True)
            ranks = torch.empty_like(order).scatter_(
                1, order, torch.arange(P, device=order.device).expand(B, P))
            keep = (ranks < k[:, None]).to(bce.dtype) * neg_mask
    else:
        keep = neg_mask
    neg_loss = (bce * keep).sum() / total_pos
    return pos_loss + neg_loss + tc["location_loss_alpha"] * loc_loss


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


def learning_rate(tc: Dict, count: int) -> float:
    """slim's staircase exponential decay, floored at ``min_learning_rate``."""
    decay_steps = max(int(tc["num_epochs_per_decay"] * tc["num_train_examples"]
                          / tc["batch_size"]), 1)
    lr = tc["initial_learning_rate"] * tc["learning_rate_decay_factor"] ** (count // decay_steps)
    return max(lr, tc.get("min_learning_rate", 0.0))


def train_steps(mc: Dict, tc: Dict, params0: Tensors, stats0: Tensors, priors: torch.Tensor,
                batches: List[Dict], seed: int, prec: ref_model.Precision = ref_model.FLOAT32,
                rows: int = None) -> Dict:
    """``len(batches)`` steps from ``params0`` / ``stats0`` (not changed).
    Each batch: ``images`` uint8 ``[B, H, W, 3]``, ``boxes [B, G, 4]``,
    ``num_boxes [B]`` on the device; step ``s`` augments with the generator
    seeded by ``step_seed(seed, s)``. ``rows``: keep only the first rows of
    each augmented batch (a fault of the benchmark's check). Returns the
    losses, step 1's gradients and the state after the steps."""
    if tc["optimizer"] != "rmsprop" or tc.get("clip_gradient_norm", 0) > 0 \
            or tc.get("grad_accum_steps", 1) != 1 or tc.get("lr_schedule") != "exponential":
        raise ValueError("the reference trains with RMSProp, no clipping, one microbatch "
                         "and the exponential schedule")
    device = priors.device
    keys = list(params0)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    stats = {k: v.detach().clone() for k, v in stats0.items()}
    ema = {k: v.detach().clone() for k, v in params0.items()}
    nu = {k: torch.zeros_like(v) for k, v in params0.items()}
    trace = {k: torch.zeros_like(v) for k, v in params0.items()}
    rho, eps, mom = tc["rmsprop_decay"], tc["rmsprop_epsilon"], tc["rmsprop_momentum"]
    losses, first_grads = [], None
    for step, batch in enumerate(batches):
        gen = torch.Generator(device=device).manual_seed(step_seed(seed, step))
        images, boxes, num = augment(gen, batch["images"], batch["boxes"],
                                     batch["num_boxes"], tc, mc["input_size"])
        if rows is not None:
            images, boxes, num = images[:rows], boxes[:rows], num[:rows]
        new_stats: Tensors = {}
        loc, conf = ref_model.forward(mc, params, stats, images, prec, train=True,
                                      new_stats=new_stats)
        loss = multibox_loss(loc, conf, boxes, num, priors, tc)
        grads = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=True,
                                    materialize_grads=True)
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in zip(keys, grads)}
        lr = learning_rate(tc, step)
        t = float(step)
        d = min(tc["moving_average_decay"], (1.0 + t) / (10.0 + t))
        with torch.no_grad():
            for k, g in zip(keys, grads):
                nu[k].mul_(rho).add_(g * g * (1 - rho))
                u = g * torch.rsqrt(nu[k] + eps) * (-lr)
                trace[k].mul_(mom).add_(u)
                params[k].add_(trace[k])
                ema[k].mul_(d).add_(params[k] * (1 - d))
        stats = new_stats
    return {"losses": losses, "first_grads": first_grads,
            "params": {k: v.detach() for k, v in params.items()}, "ema": ema,
            "batch_stats": stats}
