"""Measure the port's train step across batch sizes, remat and gradient
accumulation, with the peak device memory of each arm.

The same arms, names and synthetic batch as ``scripts/train_batch_sweep.py``
(the JAX package's): a 343-px uint8 canvas, 4 boxes an image, priors drawn
from seed 0. Each arm runs ``train.loop.make_augmented_train_step`` (host
batch → device, augmentation, forward, loss with matching, backward,
optimizer, EMA) for a few warm-up steps, then times ``--iters`` steps back
to back with CUDA events (the host batch is copied to the device in each
step, as in the train loop). A local card has no per-execution relay cost
to cancel, so the JAX script's slope protocol is not needed.

FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` over one
step; ``mfu`` is taken against a dense bfloat16 peak, 989 TFLOP/s (one H100
SXM at 700 W, NVIDIA's data sheet), or ``BENCH_PEAK_TFLOPS`` when set. The
card's name and power limit are printed to stderr beside it.

Usage:
  python scripts/torch_train_batch_sweep.py [--arms b128 b128_remat b256 ...]
      [--iters 8] [--config configs/coco_dp.yaml] [--device cuda]

Prints one JSON line per arm: {"arm", "batch", "ms_per_step", "img_s",
"tflops", "mfu", "peak_memory_bytes"}; an arm that raises prints {"arm",
"error"} instead, with its peak memory when the error is an out-of-memory.
With ``--device cpu`` the times are the host clock's and ``mfu`` and the
peak memory are null (a CPU run says nothing of the card).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multibox_tpu_torch.config import Config, parse_config_file  # noqa: E402
from multibox_tpu_torch.device import resolve_device  # noqa: E402
from multibox_tpu_torch.inference import build_model  # noqa: E402
from multibox_tpu_torch.train.loop import make_augmented_train_step  # noqa: E402
from multibox_tpu_torch.train.state import create_train_state  # noqa: E402

# dense bfloat16 peak of one H100 SXM at 700 W (NVIDIA's data sheet)
PEAK_TFLOPS = float(os.environ.get("BENCH_PEAK_TFLOPS", 989.0))

ARMS = {
    # name: (batch, overrides)
    "b32": (32, {}),
    "b128": (128, {}),
    "b128_remat": (128, {"remat": True}),
    "b256": (256, {}),
    "b256_remat": (256, {"remat": True}),
    "b256_accum2": (256, {"grad_accum_steps": 2}),
    "b512_remat_accum2": (512, {"remat": True, "grad_accum_steps": 2}),
}
WARMUP = 2


def synthetic_batch(rng, cfg: Config, canvas: int):
    """The JAX script's batch: random uint8 canvases, G sorted boxes of
    which the first 4 count; labels in [0, C) when the head has classes."""
    B, G = cfg.batch_size, cfg.max_num_bboxes
    batch = {
        "images": rng.integers(0, 255, (B, canvas, canvas, 3)).astype(np.uint8),
        "boxes": np.sort(rng.uniform(0.1, 0.9, (B, G, 2, 2)).astype(np.float32),
                         axis=2).reshape(B, G, 4),
        "num_boxes": np.full((B,), 4, np.int32),
    }
    if cfg.num_classes > 1:
        batch["labels"] = rng.integers(0, cfg.num_classes, (B, G)).astype(np.int32)
    return batch


def count_flops(step, state, batch) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        step(state, batch)
    return float(counter.get_total_flops())


def bench_arm(name: str, iters: int, base: Config, device) -> dict:
    batch_size, overrides = ARMS[name]
    cfg = dataclasses.replace(base, batch_size=batch_size, **overrides)
    P = cfg.num_priors
    canvas = max(int(cfg.input_size * 1.15), cfg.input_size)
    rng = np.random.default_rng(0)
    priors = np.sort(rng.uniform(0, 1, (P, 2, 2)).astype(np.float32), axis=1).reshape(P, 4)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    try:
        model = build_model(cfg, P, device=device)
        state = create_train_state(cfg, model, 0, P, device=device)
        step = make_augmented_train_step(cfg, model, priors, device=device)
        batch = synthetic_batch(rng, cfg, canvas)
        for _ in range(WARMUP):
            state, metrics = step(state, batch)
        float(metrics["loss"])
        if cuda:
            torch.cuda.synchronize(device)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(iters):
                state, metrics = step(state, batch)
            end.record()
            end.synchronize()
            per = start.elapsed_time(end) / 1e3 / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                state, metrics = step(state, batch)
            float(metrics["loss"])
            per = (time.perf_counter() - t0) / iters
        if not np.isfinite(float(metrics["loss"])):
            raise FloatingPointError(f"loss {float(metrics['loss'])}")
        flops = count_flops(step, state, batch)
        peak = torch.cuda.max_memory_allocated(device) if cuda else None
    except torch.cuda.OutOfMemoryError as e:
        row = {"arm": name, "error": f"{type(e).__name__}: {str(e)[:300]}",
               "peak_memory_bytes": torch.cuda.max_memory_allocated(device)}
        print(json.dumps(row), flush=True)
        return row
    finally:
        model = state = step = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    tflops = flops / per / 1e12
    row = {
        "arm": name,
        "batch": batch_size,
        "ms_per_step": per * 1e3,
        "img_s": batch_size / per,
        "tflops": tflops,
        "mfu": tflops / PEAK_TFLOPS if cuda else None,
        "peak_memory_bytes": peak,
    }
    print(json.dumps(row), flush=True)
    return row


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arms", nargs="+", default=["b128", "b128_remat", "b256", "b256_accum2"],
                    choices=sorted(ARMS))
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--config", default=None,
                    help="YAML config whose model is swept (default: Config(), "
                         "configs/voc_train.yaml's model)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device, an error without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    base = parse_config_file(args.config) if args.config else Config()
    if device.type == "cuda":
        print(f"# device: {card_line()} ({torch.cuda.get_device_name(device)}); mfu against "
              f"{PEAK_TFLOPS:g} TFLOP/s dense bf16", file=sys.stderr, flush=True)
    else:
        print(f"# device: {device}; times on the host clock, no mfu", file=sys.stderr)
    for arm in args.arms:
        try:
            bench_arm(arm, args.iters, base, device)
        except Exception as e:  # one arm's failure is its line, the sweep goes on
            print(json.dumps({"arm": arm, "error": f"{type(e).__name__}: {e}"}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
