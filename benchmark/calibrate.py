"""Readings that set the correctness limits' upper ends: the control (the
reference in the next precision below the configuration's: the backbone
computed in fp8 as the program computes it in bfloat16, the head in TF32)
and the faults a cell can have, each put in
the program's place and judged by the same comparison as a run's outputs,
at the cell's own sizes, one seed after another in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 13
    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... 12 --program

prints one JSON line a seed: ``{"seed", "control": {number: value},
"fp8_products": {number: value}, "faults": {fault: {number: value}}}``
(``fp8_products``: the program's precision but for the convolutions'
operands, read in fp8, the shortcut nearest to the program's); with ``--program``, the program's
own readings, which set the limits' lower ends: ``{"seed", "program":
{number: value}, "correct"}``, each seed's set-up and check as a run makes
them (a detect cell after a window of ``--seconds``, a train cell after its
first three steps). Detect's faults: one detection's box
moved (``box_moved``), one detection's score changed (``score_changed``);
a missing image is caught by the exact ``missing``. Train's: the batch's
second half left out, the mean over the rest (``half_batch``), and a step
that returns its state unchanged (``state_unchanged``, no run needed).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import check, harness, inputs  # noqa: E402
from benchmark.reference import detect as ref_detect  # noqa: E402
from benchmark.reference import model as ref_model  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402


def _answers(boxes, logits, det):
    """What the program's detect loop returns for these boxes and logits:
    greedy NMS's top-k, then the host's score filter."""
    scores = torch.sigmoid(logits)
    sel = ref_detect.greedy_nms(boxes, scores, det["max_detections"], det["nms_iou_threshold"],
                                det["detect_score_threshold"])
    out = []
    for i in range(len(sel)):
        idx = sel[i][sel[i] >= 0]
        s = scores[i, idx]
        keep = s >= det["detect_score_threshold"]
        out.append({"boxes": boxes[i, idx][keep].cpu().numpy(),
                    "scores": s[keep].cpu().numpy()})
    return out


def detect_readings(cell, seed, device):
    spec, det, traffic = harness.model_spec(cell.config), cell.config["detect"], cell.traffic
    priors = torch.as_tensor(inputs.make_priors(spec, seed), device=device)
    params, stats = inputs.make_weights(spec, seed, device)
    pool = inputs.make_detect_pool(traffic, seed, device)
    B = traffic["batch"]
    rng = np.random.default_rng(inputs.sub_seed(seed, inputs.SAMPLE))
    n = min(traffic["check_images"], len(pool) * B)
    ids = sorted(int(i) for i in rng.choice(len(pool) * B, n, replace=False))
    canvases = torch.as_tensor(np.stack([pool[i // B][i % B] for i in ids]), device=device)
    ref_boxes, ref_logits = ref_detect.boxes_and_logits(spec, params, stats, canvases, priors,
                                                        block=B)
    ctl_boxes, ctl_logits = ref_detect.boxes_and_logits(spec, params, stats, canvases, priors,
                                                        ref_model.CONTROL, B)

    def judge(answers):  # every image answered: none missing
        return {**check.detect_numbers(answers, ref_boxes, ref_logits, det["max_detections"],
                                       det["nms_iou_threshold"], det["detect_score_threshold"]),
                "missing": 0.0}

    own = _answers(ref_boxes, ref_logits, det)
    moved = [dict(a) for a in own]
    moved[0] = {"boxes": own[0]["boxes"].copy(), "scores": own[0]["scores"]}
    moved[0]["boxes"][0] = (moved[0]["boxes"][0] + 0.1) % 1.0
    changed = [dict(a) for a in own]
    changed[0] = {"boxes": own[0]["boxes"], "scores": own[0]["scores"].copy()}
    changed[0]["scores"][0] = 0.5 * changed[0]["scores"][0]
    fp8_boxes, fp8_logits = ref_detect.boxes_and_logits(spec, params, stats, canvases, priors,
                                                        ref_model.FP8_PRODUCTS, B)
    return {"control": judge(_answers(ctl_boxes, ctl_logits, det)),
            "fp8_products": judge(_answers(fp8_boxes, fp8_logits, det)),
            "faults": {"reference_itself": judge(own), "box_moved": judge(moved),
                       "score_changed": judge(changed)}}


def train_readings(cell, seed, device):
    spec, traffic = harness.model_spec(cell.config), cell.traffic
    tc = {**cell.config["train"], "batch_size": traffic["batch"],
          "box_encoding": spec["box_encoding"]}
    priors = torch.as_tensor(inputs.make_priors(spec, seed), device=device)
    params, stats = inputs.make_weights(spec, seed, device)
    pool = inputs.make_train_pool(traffic, seed, device)
    batches = [{k: torch.as_tensor(v, device=device) for k, v in pool[n].items()}
               for n in range(3)]
    rho = tc["rmsprop_decay"]

    def steps(**kw):
        out = ref_train.train_steps(spec, tc, params, stats, priors, batches, seed, **kw)
        out["nu"] = {k: (1 - rho) * g * g for k, g in out.pop("first_grads").items()}
        return out

    ref = ref_train.train_steps(spec, tc, params, stats, priors, batches, seed)

    def judge(prog):
        return check.train_numbers(prog, ref, params, stats, rho)

    unchanged = {"losses": ref["losses"], "params": params, "ema": params,
                 "batch_stats": stats, "nu": {k: torch.zeros_like(v) for k, v in params.items()}}
    return {"control": judge(steps(prec=ref_model.CONTROL)),
            "fp8_products": judge(steps(prec=ref_model.FP8_PRODUCTS)),
            "faults": {"half_batch": judge(steps(rows=traffic["batch"] // 2)),
                       "state_unchanged": judge(unchanged)}}


def program_readings(cell, seed, device, seconds):
    runner = harness.KINDS[cell.traffic["kind"]](cell, seed, device, time.perf_counter)
    runner.setup()
    if cell.traffic["kind"] == "detect":
        runner.window(seconds)
    numbers = runner.check()
    return {"program": numbers, "correct": check.passed(check.judge(numbers, cell.limits))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.program:
        def read(cell, seed, device):
            return program_readings(cell, seed, device, args.seconds)
    else:
        read = detect_readings if cell.traffic["kind"] == "detect" else train_readings
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **read(cell, seed, device)}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
