"""The comparisons that decide ``correct``: what the timed path produced,
judged against the plain reference.

Detect (each sampled image's detections, as the program returned them):

- ``missing``: images the window dispatched whose detections never came;
- each detection is the reference's box and score nearest to it: the
  max-norm over the four corners and ``LOGIT_BOX`` times the logit, both
  logits clipped to ±10 (priors whose boxes nearly coincide are told apart
  by their logits; probabilities near 1 cannot tell them apart);
- ``box_gap``: the distance of the detection's box from that box, the widest
  over the detections;
- ``score_gap``: the distance of the detection's logit from that logit,
  both clipped to ±10 (beyond, float32's sigmoid cannot tell logits apart);
- ``choice_gap``: whether each detection is the one greedy NMS takes next,
  given the detections the program returned before it (the reference is
  led by the program's own choices, so a near-tie costs a gap of the size
  of the rounding, not a cascade). A competitor is a box of the reference
  above the score threshold that no earlier detection suppresses; its
  evidence is the smaller of how far its logit exceeds the detection's and
  ``IOU_LOGITS`` times how far its overlap with the earlier detections stays
  below the IoU threshold. A detection that an earlier one suppresses gives
  ``IOU_LOGITS`` times the excess overlap. After the last detection, a
  competitor above the score threshold shows a detection missed. The
  widest evidence over the detections.

Train (the first three steps of the window's own step, against the
reference's three steps from the same weights, batches and draws), norms
judged leaf by leaf: a leaf's gap is the distance between the program's
norm and the reference's, over the larger of the reference's norm of that
leaf and of the median leaf.

- ``loss_gap``: step 1's loss, relative to the reference's (steps 2 and 3
  amplify rounding: the program in float32 already reads up to 2 % there);
- ``grad_gap``: the worst leaf's gap of step 1's gradient, from the
  optimizer's state after it (RMSProp's ν = (1 − ρ)·g² after one step);
- ``change_gap``, ``ema_gap``: the worst leaf's gap of the change of the
  parameters and of their moving average over the three steps;
- ``grad_median_gap``, ``change_median_gap``, ``stats_median_gap``: the
  median leaf's gap of step 1's gradient, of the parameters' change and of
  the change of BatchNorm's running statistics: steady from seed to seed,
  where the worst leaf swings (it sits in a few BatchNorm biases, whose
  gradients are sums that cancel, and steps 2 and 3 amplify rounding).

Leaves whose reference gradient is under a thousandth of the median leaf's
move by round-off alone and are left out of the changes.

A cell compares the numbers its limits file names (a number that no
control or fault reads far enough from the program's own readings has no
limit that could hold, and is left out there).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import detect as ref_detect

IOU_LOGITS = 10.0  # logits that one unit of IoU margin is worth
LOGIT_CLIP = 10.0
LOGIT_BOX = 0.05  # box distance that one logit is worth when telling priors apart
NEGLIGIBLE_GRADIENT = 1e-3


def _logit(p: torch.Tensor) -> torch.Tensor:
    return (torch.log(p) - torch.log1p(-p)).clamp(-LOGIT_CLIP, LOGIT_CLIP)


def detect_numbers(answers: List[Dict], ref_boxes: torch.Tensor, ref_logits: torch.Tensor,
                   k: int, iou_threshold: float, score_threshold: float) -> Dict[str, float]:
    """``answers``: per sampled image, the program's ``boxes [n, 4]`` and
    ``scores [n]`` (n <= k, in the order returned); ``ref_boxes [N, P, 4]``
    and ``ref_logits [N, P]`` the reference's for the same images."""
    N, P = ref_logits.shape
    dev = ref_logits.device
    boxes = torch.zeros((N, k, 4), device=dev)
    scores = torch.full((N, k), 0.5, device=dev)
    n = torch.zeros(N, dtype=torch.int64, device=dev)
    for i, a in enumerate(answers):
        m = len(a["scores"])
        if m > k:
            raise ValueError(f"{m} detections for at most {k}")
        boxes[i, :m] = torch.as_tensor(np.asarray(a["boxes"], np.float32), device=dev)
        scores[i, :m] = torch.as_tensor(np.asarray(a["scores"], np.float32), device=dev)
        n[i] = m
    slot = torch.arange(k, device=dev)[None, :]
    valid = slot < n[:, None]
    # each detection: the reference's nearest box and logit, by max-norm
    logits, ref_clipped = _logit(scores), ref_logits.clamp(-LOGIT_CLIP, LOGIT_CLIP)
    prior = torch.empty((N, k), dtype=torch.int64, device=dev)
    for i in range(N):
        d = torch.maximum((boxes[i][:, None, :] - ref_boxes[i][None]).abs().amax(-1),
                          LOGIT_BOX * (logits[i][:, None] - ref_clipped[i][None]).abs())  # [k, P]
        prior[i] = d.argmin(1)
    rows = torch.arange(N, device=dev)[:, None]
    ref_at = ref_logits[rows, prior]
    box_gap = torch.where(valid, (boxes - ref_boxes[rows, prior]).abs().amax(-1), 0.0).amax()
    score_gap = torch.where(valid, (logits - ref_clipped[rows, prior]).abs(), 0.0).amax()
    # the reference led by the program's choices
    floor = math.log(score_threshold) - math.log1p(-score_threshold) \
        if 0 < score_threshold < 1 else -math.inf
    live = ref_logits >= floor
    overlap = torch.zeros((N, P), device=dev)  # with the detections so far
    choice = torch.zeros(N, device=dev)
    idx = torch.arange(N, device=dev)
    no_slot = torch.zeros(N, dtype=torch.bool, device=dev)
    for r in range(k + 1):
        at_slot = r < n if r < k else no_slot  # the detection in slot r
        at_stop = (n == r) & (n < k)  # after the last detection
        base = ref_at[:, r] if r < k else torch.full_like(choice, floor)
        base = torch.where(at_slot, base, torch.full_like(choice, floor))
        slack = iou_threshold - overlap
        ev = torch.minimum(ref_logits - base[:, None], IOU_LOGITS * slack)
        ev = torch.where(live & (slack > 0), ev, -math.inf).amax(1)
        if r < k:
            own = IOU_LOGITS * (overlap[idx, prior[:, r]] - iou_threshold)
            ev = torch.where(at_slot, torch.maximum(ev, own), ev)
            chosen = ref_boxes[idx, prior[:, r]]
            iou = ref_detect.iou_one_to_many(chosen, ref_boxes)
            iou[idx, prior[:, r]] = 1.0
            overlap = torch.where(at_slot[:, None], torch.maximum(overlap, iou), overlap)
        choice = torch.where(at_slot | at_stop, torch.maximum(choice, ev), choice)
    return {"box_gap": float(box_gap), "score_gap": float(score_gap),
            "choice_gap": float(choice.clamp_min(0).amax())}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> Dict[str, float]:
    """Each leaf's gap of norms, over the larger of its reference norm and
    the median leaf's."""
    keys = list(keys)
    median = float(np.median([ref[k] for k in keys]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in keys}


def _worst_and_median(prog, ref, keys):
    gaps = list(leaf_gaps(prog, ref, keys).values())
    return max(gaps), float(np.median(gaps))


def _norms(tree: Dict[str, torch.Tensor], base: Dict[str, torch.Tensor] = None):
    if base is None:
        return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}
    return {k: float(torch.linalg.vector_norm(v.double() - base[k].double()))
            for k, v in tree.items()}


def train_numbers(prog: Dict, ref: Dict, params0: Dict, stats0: Dict,
                  rmsprop_decay: float) -> Dict[str, float]:
    """``prog``: the ``losses`` of the first steps, ``nu`` (RMSProp's state
    after step 1), and ``params``, ``ema``, ``batch_stats`` after the last
    of them; ``ref``: :func:`benchmark.reference.train.train_steps`."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the program and the reference ran different numbers of steps")
    grad_prog = {k: math.sqrt(float(v.double().sum()) / (1.0 - rmsprop_decay))
                 for k, v in prog["nu"].items()}
    grad_ref = _norms(ref["first_grads"])
    median = float(np.median(list(grad_ref.values())))
    moving = [k for k, g in grad_ref.items() if g >= NEGLIGIBLE_GRADIENT * median]
    out = {"loss_gap": abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])}
    out["grad_gap"], out["grad_median_gap"] = _worst_and_median(grad_prog, grad_ref, grad_ref)
    out["change_gap"], out["change_median_gap"] = _worst_and_median(
        _norms(prog["params"], params0), _norms(ref["params"], params0), moving)
    out["ema_gap"], _ = _worst_and_median(_norms(prog["ema"], params0),
                                          _norms(ref["ema"], params0), moving)
    _, out["stats_median_gap"] = _worst_and_median(
        _norms(prog["batch_stats"], stats0), _norms(ref["batch_stats"], stats0), stats0)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, Dict]) -> Dict[str, Dict]:
    """``{name: {"value", "limit"}}`` for every number the cell's limits
    name; a limit of a number the check does not compute is an error of the
    limits file."""
    unknown = sorted(set(limits) - set(numbers))
    if unknown:
        raise KeyError(f"limits of numbers the check does not compute: {unknown}")
    return {k: {"value": numbers[k], "limit": limits[k]["limit"]} for k in limits}


def passed(checks: Dict[str, Dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
