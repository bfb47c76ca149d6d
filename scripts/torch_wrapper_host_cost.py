#!/usr/bin/env python3
"""Host time of one call of the B1 and B3 wrappers, on one NVIDIA GPU.

    python3 scripts/torch_wrapper_host_cost.py [--root TREE]

Times, on the host clock, back-to-back calls of ``nms_kernel.nms_select``
(B=32 P=256 K=100), ``box_kernel.decode_boxes_cuda`` and
``encode_boxes_cuda`` (B=32 P=256) at the detect and train paths' shapes,
with no synchronisation between them: the Python checks, the output
allocation and the launch, not the kernel (200 calls queue less device
work than the card runs in the time they take). The three wrappers take
turns, one pass of 200 calls each, 31 times, so that a drift of the host
clock falls on all three alike. Prints one JSON line: per wrapper, the
least, median and largest microseconds a call over the passes (the least
is the cost with the fewest interruptions from other work on the host).
``--root`` imports ``multibox_tpu_torch`` from another checkout (an older
tree, to compare wrappers on the same card in one run); its kernels are
built into that tree's ``.work/``. Exits with code 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

CALLS, PASSES = 200, 31


def host_us(fns):
    """{name: {min_us, median_us, max_us}} for the wrappers ``fns``."""
    for fn in fns.values():
        for _ in range(20):
            fn()
    torch.cuda.synchronize()
    per_call = {name: [] for name in fns}
    for _ in range(PASSES):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            per_call[name].append((time.perf_counter() - t0) / CALLS * 1e6)
            torch.cuda.synchronize()
    return {name: {"min_us": min(t), "median_us": float(np.median(t)), "max_us": max(t)}
            for name, t in per_call.items()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose multibox_tpu_torch to import")
    root = os.path.abspath(parser.parse_args().root)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from multibox_tpu_torch.ops import kernels
    from multibox_tpu_torch.ops.kernels import box_kernel, nms_kernel
    if not kernels.__file__.startswith(root):
        raise RuntimeError(f"imported {kernels.__file__}, not the tree under {root}")
    kernels.load_library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    cy, cx, h, w = (rng.uniform(lo, hi, (32, 256)) for lo, hi in
                    ((0.1, 0.9), (0.1, 0.9), (0.02, 0.6), (0.02, 0.6)))
    boxes = torch.from_numpy(np.clip(np.stack([cy - h / 2, cx - w / 2, cy + h / 2,
                                               cx + w / 2], -1), 0, 1)
                             .astype(np.float32)).to(dev)
    scores = torch.from_numpy(rng.uniform(0, 1, (32, 256)).astype(np.float32)).to(dev)
    off = torch.from_numpy(rng.normal(0, 0.3, (32, 256, 4)).astype(np.float32)).to(dev)
    pri = boxes[0].contiguous()
    wrappers = {
        "nms_select": lambda: nms_kernel.nms_select(boxes, scores, 100, 0.5, 0.01),
        "decode_boxes_cuda": lambda: box_kernel.decode_boxes_cuda(off, pri, True),
        "encode_boxes_cuda": lambda: box_kernel.encode_boxes_cuda(off, pri),
    }
    print(json.dumps({"host_cost": root, "card": card, "calls": CALLS, "passes": PASSES,
                      **host_us(wrappers)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
