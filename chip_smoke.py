#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py [--out FILE.json] [--profile]

Builds the CUDA kernels from ``multibox_tpu_torch/csrc`` with ``nvcc``,
holds each against its plain PyTorch version on the card, then drives the
port's paths with random weights from a seed and checks that each
went through its kernels (launch counts, zeroed just before the path and
read just after) and that what comes out is right, stage by stage:

- detect: batched Inception-v3 MultiBox detect through
  ``inference.run_detect_loop`` at full width (299×299, 256 priors, batch
  32, bf16 backbone, f32 head), then a BatchNorm-folded pass and the
  folded loop's ms a batch with the 1×1 units on the kernel, as plain
  products and unfolded on cuDNN; then the same model at batch 128 (the
  head's three matmuls at 128 rows on the f32_tile route, 3 a batch) held
  stage by stage against ``use_pallas=False``;
- train: ``train.loop.train`` at ``Config(use_pallas=True)`` (the same
  model, G = 16 boxes, greedy matching through the matching kernel, the
  head through the matmul kernel forward and backward, RMSProp, EMA,
  augmentation), 12 steps, then resumed from its checkpoint to 16; one
  batch overfitted for 40 steps; stage times of a step;
- graphs: the CUDA-graph steps (``multibox_tpu_torch.graphs``) against the
  eager path: configs/cub_detect.yaml with use_pallas=True through
  ``run_detect_loop`` at steps_per_host_transfer K = 1 and 4 over 9
  batches, and its int8 program at K = 1; configs/voc_train.yaml with
  greedy matching and use_pallas=True through ``train_from_batches`` for
  12 steps at K = 1 and 4; ms a batch and a step of each path. Since this
  phase every ``run_detect_loop`` and one-process ``train_from_batches``
  of the script runs graphed unless its rule keeps it eager (Hungarian
  matching, a data-parallel step over several ranks);
- data: the data-to-training path at configs/voc_train.yaml's width, host
  code around one kernel: 64 JPEG files at VOC's sizes and a COCO file of
  their boxes from the seed → ``cli.dataset.main`` (JPEG records; raw
  canvases at the train canvas, 343 px, in 2 shards), every record parsed
  back to its annotation → the native tfrecord reader (``data._native``,
  built with g++ at first use) byte-equal to the Python reader, each
  reader's MB/s alone, ``DetectionDataset``'s ms a batch of 32 with the
  native reader and, in turns with it, with the Python reader put in its
  place → the native JPEG decoder against PIL (where libjpeg's
  headers are) → ``cli.doctor.main(["--json"])``, every check ok →
  ``cli.visualize`` (detect from a checkpoint: B1 once a batch) and
  ``cli.visualize_inputs`` where matplotlib is; what did not run is named
  on the phase line with its reason (the decoder, the visualize CLIs, the
  checkpoint import without TensorFlow);
- cli: the command-line path a user runs, through each CLI's ``main``:
  tfrecords written from the seed (``image/raw`` canvases, plus 8 JPEG
  records where PIL is installed), ``cli.priors`` (k-means, 256 priors),
  ``cli.train`` with configs/voc_train.yaml as shipped (Hungarian
  matching, use_pallas unset, so B1 in the periodic evals is its only
  kernel) for 4 steps with an eval every 3, resumed to 6, then
  ``cli.detect`` (configs/cub_detect.yaml) and ``cli.evaluate``; Hungarian
  matching of one batch (B=32, G=16, P=256) on the card against the CPU
  and scipy, its ms and exit tests a call;
- parallel: data parallelism at configs/voc_train.yaml's full width with
  use_pallas: true and greedy matching (Inception-v3 299, P = 256, global
  batch 32, G = 16, augmentation on, no shuffling), on the cli phase's
  records: each kernel first against its plain version at the shapes a
  rank gives it (16 train rows, 8 detect rows); (a) ``train.loop.train``
  in one process, 3 steps; (b) the same call in two ranks of 16 rows,
  reading a copy of the records in rank order (so that their global
  batches are (a)'s), spawned with torchrun's environment (two
  processes sharing one card over gloo where there is one card, a card
  each over NCCL where there are two), then step 1 again with a float32
  backbone; (c) one rank in an NCCL group for 2 steps, then each
  collective of ``parallel.mesh`` once over NCCL; (d) the 2-rank run
  stopped at step 2 and resumed to 3; (e) ``run_detect_loop`` over 37
  records sharded 19 / 18 at 8 a batch on each rank against one process;
  (f) ``cli.detect`` under ``torch.distributed.run`` against the
  one-process CLI; on one card, NCCL with two ranks on it, its error
  recorded; ms a step of (a) and (b), the collectives' count and ms a step
  (CUDA events on rank 0);
- coco_dp: configs/coco_dp.yaml as shipped (Inception-v3 299, 80 classes
  with per-class NMS, P = 512, G = 64, Hungarian matching with dense
  matching at 0.5, label_offset 1, global batch 256, use_pallas unset)
  through the CLIs: COCO files with COCO 2017's 80 gapped category ids
  (8 training images with 64 boxes, crowd regions) → ``cli.dataset
  --coco --remap_categories`` → ``cli.priors`` (k-means, 512) →
  ``cli.train`` at the global batch of 256 in one process (as shipped;
  grad_accum_steps 2, then remat, only where it does not fit; the peak
  memory of each try), 3 steps resumed to 4, held bitwise to 4 straight
  steps on the same batches; stage times; Hungarian on the card at the
  step's boxes (B=256, G=64, P=512) against the CPU and scipy →
  ``cli.detect`` and ``cli.evaluate`` (the NMS kernel exact at the
  80-class sweep's 1,024 candidates with class offsets); the matmul kernel
  forward and backward at the head's 256- and 32-row shapes against the
  plain version and ``torch.addmm``; two ranks of 32 sharing the card
  over gloo against one process at the reduced global batch of 64
  (losses, replicas bitwise, the 1.1 GB gradient all-reduce's ms);
- batch_sweep (after train): scripts/torch_train_batch_sweep.py's default
  arms (b128, b128_remat, b256, b256_accum2) at configs/voc_train.yaml's
  model: ms a step, images/s, TFLOP/s, MFU, peak memory;
- ssd: configs/ssd_multiscale.yaml at full width (Inception-v3 299, the
  SSD head over Mixed_5d / Mixed_6e / Mixed_7c, 35² / 17² / 8² grids, 6
  priors a cell from ``cli.priors --mode multiscale``: P = 9,468; batch
  32, G = 16, dense matching at 0.5, center/log-scale encoding):
  ``train_from_batches`` with use_pallas=True for 6 steps (the matching
  kernel on a cluster of blocks an image, held exactly against its plain
  version on the step's own boxes and timed), one batch overfitted,
  detect as shipped over 3 batches (the NMS kernel at P = 9,468, K = 100,
  exact at the path's own inputs), the same model at 20 classes (2 steps,
  one detect batch: the per-class sweep to 1,024 candidates, NMS with
  class offsets, exact), and ``cli.train.main --config
  configs/ssd_multiscale.yaml`` as shipped (no kernel) for 2 steps on the
  cli phase's records;
- mobilenet: configs/mobilenet_edge.yaml at full width (MobileNetV2 1.0 at
  224, the MultiBox head over Final 7² × 1,280, P = 128, batch 64, K =
  20): detect as shipped (NMS kernel) and with use_pallas=True (NMS, the
  head's three matmuls, decode) over 3 batches each, the kernel head and
  postprocess against the plain ones, the BN-folded model (γ folded)
  against the unfolded one, then ``train_from_batches`` with
  use_pallas=True for 6 steps (the matmul kernel forward and backward,
  encode, matching at P = 128), with the head's gradients and one step
  against the plain path; the head's three matmuls timed forward and
  backward;
- serve: the deployment path at configs/cub_detect.yaml's full width with
  use_pallas: true, through the entry points a user calls: a checkpoint →
  ``cli.export.main`` (``torch.export`` programs at batch sizes 1 and 32,
  ``--fold_bn`` at 32, ``--quantize int8`` at 32 calibrated on
  quant_calib_batches batches of tfrecords written from the seed) →
  ``serving.load_exported`` → warmup; each program bitwise against the
  live ``apply_and_postprocess`` on the same images, with the NMS, matmul
  and decode kernels counted inside the programs' calls (the kernels are
  ``multibox_torch::`` custom operators); ms a batch of 32 of each program
  and of the live function, in turns; int8's scores against float32's;
  each int8 convolution route exact against an int64 reference at a real
  shape; the HTTP daemon (``serve.make_server``) in-process on 127.0.0.1
  under 8 and 32 concurrent JPEG ``/detect`` clients and one
  ``/detect_batch`` at the 40 ms batch window (requests/s, p50, p99,
  device batches; readings only), and one request alone equal to the
  program called directly; scripts/torch_serve_bench.py over the same
  export (1, 8, 32 and 64 clients at the 2, 5 and 40 ms windows and with
  ``--max_batch 1``, then 64 clients against a queue of 16, which sheds
  with 429s); then configs/ssd_multiscale.yaml with flip_tta:
  true at batch 32 (2 × 9,468 = 18,936 boxes an image into the NMS kernel,
  window by window, exact at the path's own inputs, timed).

Every phase prints one JSON line; any failure raises and the process exits
non-zero. Needs one CUDA device; without one it exits with code 2 and
prints no result.

Times are CUDA-event medians after a warm-up, each launch preceded by a
write that evicts the L2 cache, taken on the card whose name and power
limit are printed beside them; loop times are on the host clock, ending in
a synchronize. Tolerances: NMS indices, counts and scores exact; box
kernels bitwise; matching assignments exact; matmul float32 rtol 1e-4 /
atol 1e-4 (a sum over K = 6144 in another order), bfloat16 output rtol
2e-2 / atol 2e-2, on every route of the matmul (skinny, f32_tile,
wgmma_bf16, general) at its ragged edges, the head at 128 rows and
coco_dp's head at 256 rows, and a second launch on the same inputs
bit-equal (the split along K is summed in a fixed order); the wgmma
kernels' SASS must hold HGMMA and TMA loads, B1's window kernel bulk
copies, mbarrier waits, the cluster barrier, generic atomics and MATCH,
and B4's kernels bulk copies, mbarrier waits and the cluster barrier
(cuobjdump); the
matmul's backward float32 rtol 1e-4 / atol 1e-4; Hungarian assignments
on the card equal to the CPU's and to scipy's (after a check that they
are optimal: total benefit within 1e-6 of scipy's);
the head's gradients through the kernel against the plain head rtol 1e-3
/ atol 1e-4 of the largest entry (forward sums in another order, then
products over up to 6144 terms); one train step with kernels against one
without, loss rtol 1e-4 and head parameters rtol 1e-4 / atol 1e-5 (one
update of at most lr·√10). Phases ssd and mobilenet: the NMS kernel's
indices, counts and scores exact and the matching kernel's assignments
exact at the inputs their paths gave them; the MobileNet head through
the kernels against the plain head rtol 1e-4 / atol 1e-4 and its
detections exact on the same logits; the folded MobileNet against the
unfolded one in float32 within 1e-3 of the largest output (in bfloat16,
as shipped, the gap is reported); launch counts exact per path. Phase
serve: the exported programs bitwise equal to the live function; the int8
routes exactly the int64 reference; the NMS kernel exact at P = 18,936 and
40,000, window by window (kernels phase and SSD with flip TTA).
Phase parallel: the replicas bitwise equal after the 2-rank run; each
rank's launches a step those of one process (1 match, 3 fused_matmul, 3
fused_matmul_backward, 1 box_encode); the 2-rank losses against one
process's within PAR_TOL (relative; its comment gives what was measured),
step 2's tolerance under half of what a halved gradient does; the resumed
2-rank run's final state bitwise the unsegmented one's; the sharded
detect's and the torchrun CLI's results: the same image ids, counts exact,
boxes and scores within 1e-4; metrics.jsonl once a step, the output file
written by rank 0 alone.
Phase graphs: the packed detections of every batch, and the train
states (params, EMA, optimizer state, BatchNorm statistics), bit-equal to
the eager path's; launch counts a batch and a step equal to the eager
path's; one graph launch and one input copy a group.
Phase data: records equal to their annotations (boxes within 1e-6, the
COCO file's float64 pixels back to float32), the two readers' records
byte-equal, the native JPEG decode within a mean absolute difference of
1.0 of PIL's (the JAX package's bound), launch counts exact.
Phase coco_dp: records equal to their annotations (boxes within 1e-6,
labels the 80 ids renumbered 1..80 in id order, crowd regions skipped);
the resumed run's losses and checkpoint bitwise the straight run's;
Hungarian on the card bitwise the CPU's and optimal on every image (total
benefit within 1e-6 of scipy's); the detections' classes in [0, 80); the
NMS kernel exact; the matmul kernel float32 rtol 1e-4 / atol 1e-4 forward
and backward (as the head's rows); the two ranks' losses within
COCO_DP_TOL of one process's (its comment gives what was measured), step
2's tolerance under half of what a halved gradient does, their states
bitwise equal, the gradient
all-reduce the model's parameter bytes; no kernel but the NMS in the
detect CLI launched (use_pallas unset). Phase batch_sweep: every arm runs.
Phase serve's bench: no request fails, each answered or shed, the bounded
queue sheds.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import math
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke.py: no CUDA device, nothing to run\n")
    sys.exit(2)

from multibox_tpu_torch.config import Config  # noqa: E402
from multibox_tpu_torch.data.augment import preprocess_eval  # noqa: E402
from multibox_tpu_torch.device import resolve_device  # noqa: E402
from multibox_tpu_torch import inference  # noqa: E402
from multibox_tpu_torch.data import augment  # noqa: E402
from multibox_tpu_torch.models import detector as detector_mod  # noqa: E402
from multibox_tpu_torch.models import mobilenet  # noqa: E402
from multibox_tpu_torch.models.inception_v3 import (  # noqa: E402
    ConvBN,
    feature_grid,
    fold_batch_norms,
    fused_unit_shapes,
)
from multibox_tpu_torch.ops import kernels, matching  # noqa: E402
from multibox_tpu_torch.ops.kernels import (  # noqa: E402
    box_kernel,
    fused_matmul,
    match_kernel,
    nms_kernel,
)
from multibox_tpu_torch.parallel import shard_batch  # noqa: E402
from multibox_tpu_torch.train import loop as train_loop  # noqa: E402
from multibox_tpu_torch.train import loss as train_loss  # noqa: E402
from multibox_tpu_torch.train import state as train_state  # noqa: E402
from multibox_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: E402
from torch.func import functional_call  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

SEED = 0
DEV = resolve_device(None)


# SASS of what B1's window kernel uses of Hopper: UBLKCP (cp.async.bulk), SYNCS
# (mbarrier arrive and wait), UCGABAR (the cluster barrier), ATOM.E.ADD (the
# compaction's atomic on the first block's counter, through a generic
# address that may be a peer block's shared memory), MATCH (__match_any_sync)
B1_SASS = ("UBLKCP", "SYNCS", "UCGABAR", "ATOM.E.ADD", "MATCH")
# and B4's match_kernel<R, W> (one kernel for every P and plan, by rows a
# lane and window): the prior
# tiles' bulk copies, their mbarrier waits, the cluster barrier of the
# clustered plan
B4_SASS = ("UBLKCP", "SYNCS", "UCGABAR")


def sass_counts(lib_path):
    """From ``cuobjdump -sass`` of the built library: HGMMA (wgmma), UTMALDG
    and UTMASTG (TMA load and store) in each of B2's wgmma kernels, the
    B1_SASS instructions in B1's window kernel (its staged-whole kernel
    stages by plain loads) and the B4_SASS ones in each of B4's kernels.
    Fails if a wgmma kernel lacks HGMMA or TMA loads, B1's window kernel one
    of B1_SASS or a B4 kernel one of B4_SASS."""
    tool = os.path.join(os.path.dirname(kernels.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    counts, b1, b4, name = {}, {}, {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            found = re.search(r"wgmma_kernelILi(\d+)E", line)
            name = f"wgmma_kernel<{found.group(1)}>" if found else None
            if name:
                counts[name] = {"HGMMA": 0, "UTMALDG": 0, "UTMASTG": 0}
            if "nms_window_kernel" in line:
                name = "nms_window_kernel"
                b1[name] = dict.fromkeys(B1_SASS, 0)
            found = re.search(r"match_kernelILi(\d+)ELi(\d+)E", line)
            if found:
                name = f"match_kernel<{found.group(1)}, {found.group(2)}>"
                b4[name] = dict.fromkeys(B4_SASS, 0)
        elif name in counts:
            for op in counts[name]:
                counts[name][op] += op in line
        elif name in b1:
            for op in B1_SASS:
                b1[name][op] += op in line
        elif name in b4:
            for op in B4_SASS:
                b4[name][op] += op in line
    if len(counts) != 4 or any(not c["HGMMA"] or not c["UTMALDG"] for c in counts.values()):
        raise AssertionError(f"B2's wgmma kernels lack HGMMA or TMA loads: {counts}")
    window = b1.get("nms_window_kernel", {})
    if not all(window.get(op) for op in B1_SASS):
        raise AssertionError(f"B1's kernels lack bulk copies, mbarriers or clusters: {b1}")
    if len(b4) != 6 or not all(all(c.values()) for c in b4.values()):
        raise AssertionError(f"B4's kernels lack bulk copies, mbarriers or clusters: {b4}")
    return counts, b1, b4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


_flush_buf = None


def time_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn()`` in ms. Before each, a 512 MB write
    evicts the 50 MB L2 cache; it also keeps the device busy while the host
    enqueues ``fn``, so a short kernel's time is not the host's enqueue."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(512 * 1024 * 1024, dtype=torch.uint8, device=DEV)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        _flush_buf.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls: int = 300) -> float:
    """Host time a call of ``fn`` takes to enqueue its work, in µs: the host
    clock over ``calls`` calls that the device keeps up with, no sync
    between them (the loops that call these are host-bound)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / calls


def bound(nbytes: float, flops: float, dtype: str):
    """Least time in ms the card could take, and which limit sets it."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dev(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
    return t if dtype is None else t.to(dtype)


def random_boxes(rng, shape, min_size=0.02, max_size=0.6):
    cy, cx = rng.uniform(0.1, 0.9, shape), rng.uniform(0.1, 0.9, shape)
    h, w = rng.uniform(min_size, max_size, shape), rng.uniform(min_size, max_size, shape)
    b = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)
    return np.clip(b, 0.0, 1.0).astype(np.float32)


# --------------------------------------------------------------------------
# kernels against their plain versions
# --------------------------------------------------------------------------


def nms_cases(rng):
    """(name, boxes [B, P, 4], scores [B, P], K, iou threshold, score
    threshold) for B1: ten random and degenerate cases, then the sorted scan's
    edges."""
    cases = []
    for name, B, P, Kout in (("p16", 3, 16, 32), ("main", 32, 256, 100),
                             ("p1024", 8, 1024, 100), ("p9468", 4, 9468, 200)):
        cases.append((name, random_boxes(rng, (B, P)),
                      rng.uniform(0, 1, (B, P)).astype(np.float32), Kout, 0.5, 0.01))
    boxes = random_boxes(rng, (4, 256))
    scores = rng.uniform(0, 1, (4, 256)).astype(np.float32)
    cases.append(("all_under_threshold", boxes, scores, 50, 0.5, 2.0))
    cases.append(("no_threshold", boxes, scores, 100, 0.3, float("-inf")))
    cases.append(("k_above_live", boxes[:, :40], scores[:, :40], 100, 0.5, 0.5))
    dup = np.round(scores * 8) / 8  # many exactly equal scores
    cases.append(("duplicate_scores", boxes, dup.astype(np.float32), 100, 0.5, 0.1))
    flat = boxes.copy()
    flat[:, ::3, 2] = flat[:, ::3, 0]  # zero-area boxes
    flat[:, 1::7] = flat[:, 0:1]  # identical boxes
    cases.append(("zero_area_and_identical", flat, scores, 100, 0.5, 0.0))
    # near-duplicates: IoUs that sit close to the threshold
    jit = boxes + rng.normal(0, 1e-3, boxes.shape).astype(np.float32)
    near = np.concatenate([boxes, np.clip(jit, 0, 1)], axis=1)
    cases.append(("near_threshold", near, rng.uniform(0, 1, near.shape[:2]).astype(np.float32),
                  100, 0.9, 0.0))
    # the sorted scan's edges: +0.0 and -0.0 tie and break by index
    zeros = rng.choice(np.array([0.0, -0.0, 0.25, -0.25], np.float32), (4, 256))
    cases.append(("signed_zeros", boxes, zeros, 100, 0.5, float("-inf")))
    cases.append(("signed_zeros_at_threshold", boxes, zeros, 100, 0.5, 0.0))
    odd = scores.copy()
    odd[:, ::5], odd[:, 1::7], odd[:, 2::11] = np.nan, np.inf, -np.inf
    cases.append(("nan_and_inf", boxes, odd, 100, 0.5, float("-inf")))
    cases.append(("nan_and_inf_thresholded", boxes, odd, 100, 0.5, 0.5))
    cases.append(("all_equal", boxes, np.full((4, 256), 0.5, np.float32), 100, 0.5, 0.0))
    cases.append(("p1", boxes[:, :1], scores[:, :1], 5, 0.5, float("-inf")))
    cases.append(("k_equals_p", boxes, scores, 256, 0.5, float("-inf")))
    cases.append(("k_above_p", boxes, scores, 300, 0.7, float("-inf")))
    cases.append(("p33", boxes[:, :33], scores[:, :33], 100, 0.5, 0.0))
    cases.append(("p257", random_boxes(rng, (4, 257)), rng.uniform(0, 1, (4, 257))
                  .astype(np.float32), 100, 0.5, 0.0))
    # a dense cluster: most candidates suppressed, many chunks before K kept
    centre = random_boxes(rng, (4, 1), min_size=0.3, max_size=0.5)
    cluster = np.clip(centre + rng.normal(0, 0.01, (4, 1024, 4)), 0, 1).astype(np.float32)
    cases.append(("dense_cluster", cluster, rng.uniform(0, 1, (4, 1024)).astype(np.float32),
                  100, 0.5, 0.0))
    return cases


def nms_entry(name, b, s, Kout, iou, thr, plain=False):
    """Time B1 on one case; the work its data needs (the chunks, windows
    and digit passes of the kernel's algorithm in numpy, checked against the
    kernel's output, and the IoU tests greedy NMS needs for this output,
    from which the bound), and the launch's plan (window, cluster)."""
    tb, ts = dev(b), dev(s)
    ms = time_ms(lambda: nms_kernel.nms_select(tb, ts, Kout, iou, thr))
    sel_idx, _ = nms_kernel.nms_select(tb, ts, Kout, iou, thr)
    emu_idx, _, work = nms_kernel.sorted_scan_emulation(b, s, Kout, iou, thr)
    chunks = work.chunks
    if not np.array_equal(emu_idx, sel_idx.cpu().numpy()):
        raise AssertionError(f"nms[{name}]: the numpy emulation differs from the kernel")
    B, P = s.shape
    # the bound counts what the function needs: every score read, the box of each
    # live candidate up to the last one the selection reaches, the outputs written;
    # each such candidate against the boxes kept before it, up to the first that
    # suppresses it, ~25 f32 operations a test
    reached = nms_kernel.greedy_candidates(s, sel_idx.cpu().numpy(), thr)
    nbytes = B * P * 4 + reached * 16 + B * Kout * 8
    tests = nms_kernel.greedy_iou_tests(b, s, sel_idx.cpu().numpy(), iou, thr)
    bound_ms, bound_by = bound(nbytes, tests * 25, "float32")
    # the rounds model, for comparison: the spec's rounds (one per selected box, +1
    # that finds nothing unless all K slots fill), each reading and testing every box
    rounds = int(torch.clamp((sel_idx >= 0).sum(1) + 1, max=Kout).sum())
    entry = {"shape": f"B={B} P={P} K={Kout}", "ms": ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "share_of_bound": bound_ms / ms, "iou_tests": tests,
             "candidates_reached": reached,
             "bound_ms_rounds_model": bound(B * P * 20 + B * Kout * 8, rounds * P * 25,
                                            "float32")[0],
             "rounds_run": rounds, "chunks_run": int(chunks.sum()),
             "chunks_slowest_image": int(chunks.max()),
             "windows_slowest_image": int(work.windows.max()),
             "passes_slowest_image": int(work.passes.max()),
             "plan": nms_kernel.nms_plan(B, P, Kout, nms_kernel.sm_count(DEV))._asdict()}
    if plain:
        entry["plain_ms"] = time_ms(
            lambda: nms_kernel.nms_batched_plain(tb, ts, Kout, iou, thr), reps=5, warmup=1)
    return entry


def nms_exact(name, tb, ts, Kout, iou, thr) -> float:
    """B1 against its plain version: indices, scores and counts exact.
    Returns the largest score difference (0)."""
    got = nms_kernel.nms_cuda_batched(tb, ts, Kout, iou, thr)
    torch.cuda.synchronize()
    want_idx, want_scores = nms_kernel.nms_batched_plain(tb, ts, Kout, iou, thr)
    if not torch.equal(got[2], want_idx):
        bad = (got[2] != want_idx).nonzero()[:5].tolist()
        raise AssertionError(f"nms[{name}]: indices differ at {bad}")
    if not torch.equal(got[1], want_scores):
        raise AssertionError(f"nms[{name}]: scores differ")
    if not torch.equal(got[3].to(torch.int64), (want_idx >= 0).sum(1)):
        raise AssertionError(f"nms[{name}]: counts differ")
    return float((got[1] - want_scores).abs().max())


def check_nms(rng):
    """Indices, counts and scores exact on every case, those staged whole
    and those window by window (P = 18,936 and 40,000, a kept list of
    9,468, all-equal scores, a refill that uses up window after window,
    scores near 0.5 at 40,000, and scores read from L2 at every pass: B=64
    P=50,000 and a kept list of 11,968 at P=40,000). Returns the entry of the contract line,
    timed at the main path's shape (B=32, P=256, K=100), with the design
    shapes P = 1,024 (B=8) and P = 9,468 (B=4, K=200) and the window-by-window
    cases' rows (windows and digit passes of the slowest image, the plan)."""
    cases = nms_cases(rng)
    worst = 0.0
    for name, b, s, Kout, iou, thr in cases:
        worst = max(worst, nms_exact(name, dev(b), dev(s), Kout, iou, thr))
    # a kept list larger than shared memory by itself is refused, not launched
    try:
        nms_kernel.nms_select(torch.zeros(1, 20000, 4, device=DEV),
                              torch.zeros(1, 20000, device=DEV), 20000)
    except ValueError:
        pass
    else:
        raise AssertionError("nms: a kept list past shared memory was taken")

    by_name = {c[0]: c for c in cases}
    main = nms_entry(*by_name["main"], plain=True)
    # window by window: past the window, a kept list of P boxes, equal scores
    # (the index digits decide), scores near 0.5 (random weights' SSD), and a
    # refill: K large, suppression heavy, so the scan uses up window after window
    large_rows = {}
    centre = random_boxes(rng, (2, 1), min_size=0.3, max_size=0.5)
    large = [("p18936_b32", random_boxes(rng, (32, 18936)),
              rng.uniform(0, 1, (32, 18936)), 100, 0.5, 0.01),
             ("p40000_b4", random_boxes(rng, (4, 40000)), rng.uniform(0, 1, (4, 40000)),
              200, 0.5, 0.01),
             ("p9468_k9468", random_boxes(rng, (2, 9468)), rng.uniform(0, 1, (2, 9468)),
              9468, 0.5, 0.01),
             ("p9468_all_equal", random_boxes(rng, (4, 9468)), np.full((4, 9468), 0.5),
              200, 0.5, 0.0),
             ("p9468_refill", np.clip(centre + rng.normal(0, 0.05, (2, 9468, 4)), 0, 1),
              rng.uniform(0, 1, (2, 9468)), 3000, 0.3, 0.0),
             ("p40000_concentrated", random_boxes(rng, (4, 40000)),
              0.5 + rng.normal(0, 1e-3, (4, 40000)), 200, 0.5, 0.0),
             # scores read from global memory at every pass, past what a block
             # stages: B=64 P=50,000 (one block an image), and a kept list at
             # nms_fits' limit beside a cluster's slices (small boxes, so that
             # K fills window after window)
             ("p50000_b64_unstaged", random_boxes(rng, (64, 50000)),
              rng.uniform(0, 1, (64, 50000)), 100, 0.5, 0.01),
             ("p40000_k11968_unstaged", random_boxes(rng, (1, 40000), 0.002, 0.02),
              rng.uniform(0, 1, (1, 40000)), 11968, 0.5, 0.0)]
    for name, b, s, Kout, iou, thr in large:
        b, s = b.astype(np.float32), s.astype(np.float32)
        if not nms_kernel.nms_fits(s.shape[1], Kout):
            raise AssertionError(f"nms[{name}]: refused")
        plan = nms_kernel.nms_plan(*s.shape, Kout, nms_kernel.sm_count(DEV))
        if plan.staged == name.endswith("_unstaged"):
            raise AssertionError(f"nms[{name}]: planned {plan}")
        worst = max(worst, nms_exact(name, dev(b), dev(s), Kout, iou, thr))
        if name not in ("p9468_k9468", "p40000_k11968_unstaged"):
            large_rows[name] = nms_entry(name, b, s, Kout, iou, thr,
                                         plain=name in ("p18936_b32", "p40000_b4"))
    if large_rows["p9468_refill"]["windows_slowest_image"] < 2:
        raise AssertionError("nms[p9468_refill]: the window was not used up")
    return {
        "name": "nms", "route": "cuda",
        "source": "multibox_tpu_torch/csrc/nms.cu",
        "replaces": "multibox_tpu/ops/pallas/nms_kernel.py:109",
        "max_abs_err": worst, "library_ms": None,
        "tolerance": "indices, counts and scores exact", **main,
        "p1024": nms_entry(*by_name["p1024"], plain=True),
        "p9468": nms_entry(*by_name["p9468"], plain=True), **large_rows,
        "cases": [c[0] for c in cases] + [c[0] for c in large],
    }


def matmul_inputs(rng, M, Kd, N, dtype):
    """chip_smoke's data for B2: x = max(N(0, 1), 0), w = N(0, 1)/√K, b = N(0, 0.1)."""
    x = dev(np.maximum(rng.normal(0, 1, (M, Kd)), 0).astype(np.float32), dtype)
    w = dev((rng.normal(0, 1, (Kd, N)) / np.sqrt(Kd)).astype(np.float32), dtype)
    b = dev(rng.normal(0, 0.1, N).astype(np.float32))
    return x, w, b


def backward_inputs(rng, M, Kd, N):
    """B2' data: :func:`matmul_inputs` in float32, then the output's gradient N(0, 1)."""
    return (*matmul_inputs(rng, M, Kd, N, torch.float32),
            dev(rng.normal(0, 1, (M, N)).astype(np.float32)))


def matmul_bound(M, Kd, N, dtype):
    item = 4 if dtype == torch.float32 else 2
    return bound((M * Kd + Kd * N + M * N) * item + N * 4, 2.0 * M * Kd * N,
                 "float32" if dtype == torch.float32 else "bfloat16")


def time_matmul(x, w, b, relu, plain=True):
    """(kernel ms, plain ms or None, library ms): the library call is
    ``torch.addmm`` (+ ``relu_``), timed here and used nowhere in the port."""
    ms = time_ms(lambda: fused_matmul.fused_matmul_bias_relu(x, w, b, relu))
    plain_ms = time_ms(lambda: fused_matmul.fused_matmul_plain(x, w, b, relu)) if plain else None
    bias = b.to(x.dtype)
    if relu:
        library_ms = time_ms(lambda: torch.addmm(bias, x, w).relu_())
    else:
        library_ms = time_ms(lambda: torch.addmm(bias, x, w))
    return ms, plain_ms, library_ms


def forward_entry(name, x, w, b, relu, host=False):
    """B2 on one shape: against the plain version (f32 rtol 1e-4 / atol
    1e-4, bf16 2e-2), a second launch bit-equal, then timed beside the
    plain version and ``torch.addmm``."""
    (M, Kd), N, dtype = x.shape, w.shape[1], x.dtype
    got = fused_matmul.fused_matmul_bias_relu(x, w, b, relu)
    again = fused_matmul.fused_matmul_bias_relu(x, w, b, relu)
    torch.cuda.synchronize()
    want = fused_matmul.fused_matmul_plain(x, w, b, relu)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    if got.dtype != x.dtype or got.shape != (M, N):
        raise AssertionError(f"fused_matmul[{name}]: wrong dtype or shape")
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"fused_matmul[{name}]: {m}")
    if not torch.equal(got, again):
        raise AssertionError(f"fused_matmul[{name}]: two launches differ")
    plan = fused_matmul._plan(M, Kd, N, dtype)
    bound_ms, bound_by = matmul_bound(M, Kd, N, dtype)
    entry = {"name": name, "M": M, "K": Kd, "N": N, "relu": relu,
             "dtype": str(dtype).replace("torch.", ""), "route": plan.route,
             "split_k": plan.split_k, "tile_n": plan.tile[1], "blocks": plan.blocks,
             "max_abs_err": float((got.float() - want.float()).abs().max()),
             "bit_equal_relaunch": True, "bound_ms": bound_ms, "bound_by": bound_by}
    entry["ms"], entry["plain_ms"], entry["library_ms"] = time_matmul(x, w, b, relu)
    entry["share_of_bound"] = bound_ms / entry["ms"]
    if host:
        bias = b.to(dtype)
        entry["host_us_per_call"] = {
            "kernel": host_us(lambda: fused_matmul.fused_matmul_bias_relu(x, w, b, relu)),
            "torch.addmm": host_us(lambda: torch.addmm(bias, x, w).relu_()),
        }
    return entry


def check_fused_matmul(rng):
    """f32 rtol 1e-4 / atol 1e-4 (sums over up to K = 6144 in another order
    than the plain version's), bf16 output rtol 2e-2 / atol 2e-2. Every
    case is also launched twice and must give the same bits (the split
    along K is summed in a fixed order). The entry of the contract line
    sums the three head shapes of one batch of 32; the shapes list holds
    each route's cases at its ragged edges, and ``folded_1x1_bf16_all`` the
    distinct folded 1×1 units of a batch of 32."""
    f32, bf16 = torch.float32, torch.bfloat16
    head = (("Bottleneck", 2048, 2048, 96, True, f32), ("Locations", 32, 6144, 1024, False, f32),
            ("Confidences", 32, 6144, 256, False, f32))
    main = {"Bottleneck", "Locations", "Confidences", "folded_1x1_bf16"}
    other = (("folded_1x1_bf16", 39200, 288, 64, True, bf16),
             # skinny: one row, the boundary at 64, uneven slices, N off the tile
             ("skinny_m1", 1, 256, 128, True, f32),
             ("skinny_m64_uneven_slices", 64, 1000, 200, True, f32),
             ("skinny_n_ragged", 32, 6144, 1000, False, f32),
             # f32_tile: the head at 128 rows, the 65 and 511 edges, M and N
             # off the tile with a short last slice
             ("Locations_rows128", 128, 6144, 1024, False, f32),
             ("Confidences_rows128", 128, 6144, 256, False, f32),
             ("f32_tile_m65", 65, 256, 128, True, f32),
             ("f32_tile_m511", 511, 6144, 1024, False, f32),
             ("f32_tile_ragged", 2050, 2052, 100, True, f32),
             # wgmma_bf16: a ragged M tile with K off the 64 step and N below
             # one 64-column block (w resident), N = 448 in two tiles, K = 288
             # with more tiles than SMs (the persistent walk), N = 448 in
             # 64-column tiles at 2,049 rows, splits with a short last slice
             ("wgmma_ragged", 1000, 72, 40, True, bf16),
             ("wgmma_n448", 9248, 768, 448, True, bf16),
             ("wgmma_k288_persistent", 39201, 288, 64, True, bf16),
             ("wgmma_n448_rows2049", 2049, 2048, 448, True, bf16),
             ("wgmma_split_ragged", 500, 1288, 200, True, bf16),
             ("wgmma_split_k2048", 512, 2048, 384, True, bf16),
             # general: K = 17 and other rows that are not 16 bytes
             ("ragged", 33, 130, 70, True, f32),
             ("ragged_norelu", 33, 130, 70, False, f32),
             ("ragged_bf16", 65, 17, 129, False, bf16),
             ("one_row", 1, 5, 3, True, f32))
    shapes, worst = [], 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound": []}
    for name, M, Kd, N, relu, dtype in head + other:
        entry = forward_entry(name, *matmul_inputs(rng, M, Kd, N, dtype), relu,
                              host=name in main)
        if name in ("Bottleneck", "Locations", "Confidences"):
            worst = max(worst, entry["max_abs_err"])
            for key in ("ms", "plain_ms", "library_ms"):
                totals[key] += entry[key]
            totals["bound"].append((entry["bound_ms"], entry["bound_by"]))
        shapes.append(entry)
    # coco_dp's head at 256 rows (inputs drawn on the card: the
    # Confidences weight is 1 GB)
    draw = torch.Generator(device=DEV).manual_seed(SEED + 12)
    for name, N in (("coco_Locations_rows256", 2048), ("coco_Confidences_rows256", 40960)):
        x, w, b, _ = head_inputs_on_card(draw, 256, 6144, N)
        shapes.append(forward_entry(name, x, w, b, False))
        del x, w, b
        torch.cuda.empty_cache()
    shapes.append(check_folded_units(rng))
    routes = {e["route"] for e in shapes if "route" in e}
    if routes != set(fused_matmul.ROUTES):
        raise AssertionError(f"fused_matmul: routes exercised {routes}")
    bound_sum = sum(t for t, _ in totals["bound"])
    return {
        "name": "fused_matmul", "route": "cuda",
        "source": "multibox_tpu_torch/csrc/fused_matmul.cu",
        "replaces": "multibox_tpu/ops/pallas/fused_matmul.py:162",
        "max_abs_err": worst, "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": bound_sum, "bound_by": max(totals["bound"])[1],
        "library_ms": totals["library_ms"], "share_of_bound": bound_sum / totals["ms"],
        "tolerance": "float32 rtol 1e-4 atol 1e-4, bfloat16 rtol 2e-2 atol 2e-2; "
                     "a second launch bit-equal",
        "shape": "sum of the head's three layers at batch 32 (float32)",
        "shapes": shapes,
    }


def check_folded_units(rng, batch=32):
    """Every distinct 1×1 unit of the BatchNorm-folded backbone at batch 32
    (bf16, ReLU), enumerated from the model: each against the plain version
    and timed with its library call; the entry sums the distinct shapes."""
    units = fused_unit_shapes(batch)
    count = {}
    for _, M, Kd, N in units:
        count[(M, Kd, N)] = count.get((M, Kd, N), 0) + 1
    parts, tot = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for (M, Kd, N), units_of_shape in sorted(count.items()):
        x, w, b = matmul_inputs(rng, M, Kd, N, torch.bfloat16)
        got = fused_matmul.fused_matmul_bias_relu(x, w, b, True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), fused_matmul.fused_matmul_plain(x, w, b).float(),
                                   rtol=2e-2, atol=2e-2,
                                   msg=lambda m: f"fused_matmul[folded {M}x{Kd}x{N}]: {m}")
        ms, plain_ms, library_ms = time_matmul(x, w, b, True)
        bound_ms, bound_by = matmul_bound(M, Kd, N, torch.bfloat16)
        plan = fused_matmul._plan(M, Kd, N, torch.bfloat16)
        if plan.route != "wgmma_bf16":
            raise AssertionError(f"folded unit {M}x{Kd}x{N} planned on {plan.route}")
        parts.append({"M": M, "K": Kd, "N": N, "units": units_of_shape, "route": plan.route,
                      "split_k": plan.split_k, "tile_n": plan.tile[1], "blocks": plan.blocks,
                      "ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / ms})
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["library_ms"] += library_ms
        tot["bound_ms"] += bound_ms
    return {"name": "folded_1x1_bf16_all", "dtype": "bfloat16", "relu": True,
            "route": "wgmma_bf16", "split_k": max(p["split_k"] for p in parts),
            "distinct_shapes": len(parts), "units": len(units), **tot,
            "share_of_bound": tot["bound_ms"] / tot["ms"],
            "note": "sums over the distinct shapes, each once", "parts": parts}


def box_bound(kind, B, P):
    n = B * P * 4
    return bound(2 * n * 4 + P * 16, n * (3 if kind == "box_decode" else 1), "float32")


def check_boxes(rng):
    """Bitwise: add-then-clip and subtract are exact in f32. A view that
    does not start on a 16-byte boundary is refused. Timed at the main
    paths' shape (B=32, P=256) and at the SSD prior count (B=32, P=9,468)."""
    out = []
    for kind in ("box_decode", "box_encode"):
        worst = 0.0
        for B, P, prior_shape in ((32, 256, (256, 4)), (3, 77, (1, 77, 4)),
                                  (2, 9468, (9468, 4)), (32, 9468, (9468, 4)),
                                  (1, 1, (1, 4)), (70000, 1, (1, 4))):
            a = dev(rng.normal(0, 0.3, (B, P, 4)).astype(np.float32))
            pri = dev(random_boxes(rng, (P,)).reshape(prior_shape))
            if kind == "box_decode":
                for clip in (True, False):
                    got = box_kernel.decode_boxes_cuda(a, pri, clip)
                    want = box_kernel.decode_boxes_plain(a, pri.reshape(-1, 4)[None], clip)
                    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                        raise AssertionError(f"box_decode B={B} P={P} clip={clip} differs")
            else:
                got = box_kernel.encode_boxes_cuda(a, pri)
                want = box_kernel.encode_boxes_plain(a, pri.reshape(-1, 4)[None])
                if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                    raise AssertionError(f"box_encode B={B} P={P} differs")
            worst = max(worst, float((got - want).abs().max()))
        fn = box_kernel.decode_boxes_cuda if kind == "box_decode" else box_kernel.encode_boxes_cuda
        shifted = torch.zeros(2 * 8 * 4 + 1, device=DEV)[1:].view(2, 8, 4)
        try:
            fn(shifted, torch.zeros(8, 4, device=DEV))
        except ValueError:
            pass
        else:
            raise AssertionError(f"{kind}: a view off the 16-byte boundary was taken")

        timed = {}
        for B, P in ((32, 256), (32, 9468)):
            a = dev(rng.normal(0, 0.3, (B, P, 4)).astype(np.float32))
            pri = dev(random_boxes(rng, (P,)))
            if kind == "box_decode":
                ms = time_ms(lambda: box_kernel.decode_boxes_cuda(a, pri, True))
                plain_ms = time_ms(lambda: box_kernel.decode_boxes_plain(a, pri[None], True))
                library_ms = None  # add then clamp: no single call
            else:
                ms = time_ms(lambda: box_kernel.encode_boxes_cuda(a, pri))
                plain_ms = time_ms(lambda: box_kernel.encode_boxes_plain(a, pri[None]))
                library_ms = time_ms(lambda: torch.sub(a, pri[None]))
            bound_ms, bound_by = box_bound(kind, B, P)
            timed[P] = {"shape": f"B={B} P={P}", "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "share_of_bound": bound_ms / ms}
        line = "multibox_tpu/ops/pallas/box_kernel.py:" + ("64" if kind == "box_decode" else "75")
        out.append({
            "name": kind, "route": "cuda",
            "source": "multibox_tpu_torch/csrc/box.cu", "replaces": line,
            "max_abs_err": worst, **timed[256], "p9468": timed[9468],
            "tolerance": "bitwise; a misaligned view refused",
        })
    return out


def match_cases(rng):
    """(name, gt [B, G, 4], num_gt [B], priors [P, 4]) for B4."""
    def world(B, G, P, lo=1):
        return (random_boxes(rng, (B, G)), rng.integers(lo, G + 1, B).astype(np.int32),
                random_boxes(rng, (P,)))

    cases = [("slice", *world(32, 16, 256)), ("coco_dp", *world(8, 64, 512)),
             ("ssd", *world(32, 16, 9468)), ("rank_b16", *world(16, 16, 256)),
             ("rank_b16_ssd", *world(16, 16, 9468))]
    gt, num, pri = world(2, 128, 9468)
    num[:] = 128  # the largest lists: 128 rows of 128 keys
    cases.append(("g128_p9468", gt, num, pri))
    gt, num, pri = world(4, 16, 9468)
    pri[:] = pri[0]  # every prior the same box: all IoUs of a row equal
    num[:] = 16
    cases.append(("all_equal_p9468", gt, num, pri))
    cases.append(("p40000", *world(4, 16, 40000)))  # many prior tiles a block
    cases.append(("p1", *world(4, 16, 1, lo=0)))
    gt, num, pri = world(4, 16, 256)
    gt[:, 1] = gt[:, 0]  # duplicated gt boxes: equal IoU rows
    gt[:, 5] = 0.5  # zero-area box: a row of zero IoU everywhere
    pri[3] = pri[2]  # duplicated priors: equal IoU columns
    num[:] = 16
    cases.append(("ties", gt, num, pri))
    gt, num, pri = world(4, 16, 256)
    num[:3] = 0
    cases.append(("num_gt_0", gt, num, pri))
    gt, num, pri = world(3, 24, 10)
    num[:] = 24
    cases.append(("g_above_p", gt, num, pri))
    # a batch past two blocks an SM: several images share a block
    cases.append(("packed_images", *world(600, 16, 256)))
    return cases


def match_work(num, G, P):
    """Operations greedy matching needs on this data, as csrc/match.cu does
    it: the IoU of each live cell (19 f32 operations), one compare a cell to
    select the rows' lists, and n − k compares in round k (the arg-max over
    the live rows' heads)."""
    ops = 0
    for n in np.clip(num, 0, G):
        n = int(n)
        ops += n * P * 20 + sum(n - k for k in range(min(n, P)))
    return ops


def match_work_scan(num, G, P):
    """The naive scan's work (``bound_ms_scan_model``, the model of the
    kernel that kept the whole IoU matrix): each live cell's IoU, then a
    compare and a select for every live cell of every round."""
    ops = 0
    for n in np.clip(num, 0, G):
        n = int(n)
        ops += n * P * 19 + sum(2 * (n - k) * (P - k) for k in range(min(n, P)))
    return ops


def match_timed(gt, num, pri):
    """B4 on these inputs (on the card, already held exact): its plan, ms,
    bound (:func:`match_work`, and :func:`match_work_scan` beside it),
    the plain version's ms and the rounds."""
    B, G = gt.shape[:2]
    P = pri.shape[0]
    n = num.cpu().numpy()
    plan = match_kernel.device_plan(B, G, P, DEV)
    nbytes = B * G * 16 + B * 4 + P * 16 + B * G * 4
    bound_ms, bound_by = bound(nbytes, match_work(n, G, P), "float32")
    ms = time_ms(lambda: match_kernel.greedy_match_cuda(gt, num, pri))
    return {"shape": f"B={B} G={G} P={P}",
            "plan": {"cluster": plan.cluster, "images_a_block": plan.images,
                     "tile": plan.tile,
                     "tiles_a_block": -(-match_kernel.slice_cols(P, plan.cluster) // plan.tile),
                     "smem": plan.smem},
            "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms,
            "bound_ms_scan_model": bound(nbytes, match_work_scan(n, G, P), "float32")[0],
            "library_ms": None,
            "plain_ms": time_ms(lambda: match_kernel.greedy_match_plain(gt, num, pri),
                                reps=5, warmup=1),
            "rounds_run": int(np.minimum(n, P).sum()),
            "rounds_slowest_image": int(np.minimum(n, P).max())}


def check_match(rng):
    """B4: assignments exact against the plain version on every case. The
    entry is timed at the train slice's shape (B=32, G=16, P=256), and
    beside it B=8 G=64 P=512, SSD's P = 9,468 at B=32 G=16 and the largest
    lists (G = n = 128 at P = 9,468)."""
    cases = match_cases(rng)
    for name, gt, num, pri in cases:
        tg, tn, tp = dev(gt), dev(num), dev(pri)
        got = match_kernel.greedy_match_cuda(tg, tn, tp)
        torch.cuda.synchronize()
        want = match_kernel.greedy_match_plain(tg, tn, tp)
        if not torch.equal(got, want):
            bad = (got != want).nonzero()[:5].tolist()
            raise AssertionError(f"match[{name}]: assignments differ at {bad}")
    by_name = {c[0]: [dev(a) for a in c[1:]] for c in cases}
    main = match_timed(*by_name["slice"])
    return {
        "name": "match", "route": "cuda",
        "source": "multibox_tpu_torch/csrc/match.cu",
        "replaces": "multibox_tpu/ops/pallas/match_kernel.py:101",
        "max_abs_err": 0.0, **main, "tolerance": "assignments exact",
        "g64_p512": match_timed(*by_name["coco_dp"]),
        "p9468_random": match_timed(*by_name["ssd"]),
        "g128_p9468": match_timed(*by_name["g128_p9468"]),
        "cases": [c[0] for c in cases],
    }


def backward_entry(name, x, w, b, g, relu):
    """B2' on one shape (see :func:`check_fused_backward`)."""
    (M, Kd), N = x.shape, w.shape[1]
    leaves = [a.clone().requires_grad_(True) for a in (x, w, b)]
    y = fused_matmul.fused_matmul_bias_relu(*leaves, relu)
    got = torch.autograd.grad(y, leaves, g, retain_graph=True)
    torch.cuda.synchronize()
    mask = (y.detach() > 0) if relu else torch.ones_like(g, dtype=torch.bool)
    y_plain = fused_matmul.fused_matmul_plain(*leaves, False)
    want = torch.autograd.grad(y_plain, leaves, torch.where(mask, g, 0.0),
                               retain_graph=True)
    flips = int(((fused_matmul.fused_matmul_plain(x, w, b, relu) > 0) != mask).sum()) \
        if relu else 0
    worst = 0.0
    for part, a, c in zip(("dx", "dw", "db"), got, want):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"fused_backward[{name}.{part}]: {m}")
        worst = max(worst, float((a - c).abs().max()))
    yd = y.detach()
    ms = time_ms(lambda: fused_matmul.fused_matmul_backward(x, w, b, yd, g, relu))
    y_ref = fused_matmul.fused_matmul_plain(*leaves, relu)
    plain_ms = time_ms(lambda: torch.autograd.grad(y_ref, leaves, g, retain_graph=True))
    library_ms = time_ms(lambda: (g @ w.T, x.T @ g, g.sum(0)))
    nbytes = (2 * M * Kd + Kd * N + (2 if relu else 1) * M * N + Kd * N + N) * 4
    bound_ms, bound_by = bound(nbytes, 4.0 * M * Kd * N + M * N, "float32")
    return {"name": name, "M": M, "K": Kd, "N": N, "relu": relu, "max_abs_err": worst,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / ms,
            "mask_flips_between_forwards": flips}


def check_fused_backward(rng):
    """B2': the autograd backward of the fused layer (kernel forward, the
    JAX package's backward in torch.matmul) against autograd through the
    plain version, float32, at the head's three shapes. The ReLU mask is
    the kernel output's on both sides (a pre-activation within rounding
    of 0 may fall on either side in two forwards); how many outputs the
    two forwards put on different sides is reported. Tolerance rtol 1e-4
    atol 1e-4: the same products, inputs equal."""
    shapes, worst = [], 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound": []}
    for name, M, Kd, N, relu in (("Bottleneck", 2048, 2048, 96, True),
                                 ("Locations", 32, 6144, 1024, False),
                                 ("Confidences", 32, 6144, 256, False)):
        entry = backward_entry(name, *backward_inputs(rng, M, Kd, N), relu)
        worst = max(worst, entry["max_abs_err"])
        for key in ("ms", "plain_ms", "library_ms"):
            totals[key] += entry[key]
        totals["bound"].append((entry["bound_ms"], entry["bound_by"]))
        shapes.append(entry)
    return {
        "name": "fused_matmul_backward", "route": "torch.matmul (the JAX package's "
        "backward is plain products too), around the CUDA forward",
        "source": "multibox_tpu_torch/ops/kernels/fused_matmul.py",
        "replaces": "multibox_tpu/ops/pallas/fused_matmul.py:175",
        "max_abs_err": worst, "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": sum(t for t, _ in totals["bound"]),
        "bound_by": max(totals["bound"])[1], "library_ms": totals["library_ms"],
        "tolerance": "float32 rtol 1e-4 atol 1e-4",
        "shape": "sum of the head's three layers at batch 32 (float32)",
        "shapes": shapes,
    }


# --------------------------------------------------------------------------
# the main path
# --------------------------------------------------------------------------


def make_variables(model, gen):
    """Seeded random weights with non-trivial BatchNorm statistics."""
    variables = model.init_variables(gen)

    def rand(shape):
        return torch.randn(shape, generator=gen).to(DEV)

    for name in list(variables["params"]):
        if name.endswith("BatchNorm.bias"):
            variables["params"][name] = 0.1 * rand(variables["params"][name].shape)
        elif name.endswith("BatchNorm.scale"):  # MobileNetV2's γ, so the fold uses it
            variables["params"][name] = 0.75 + 0.5 * torch.rand(
                variables["params"][name].shape, generator=gen).to(DEV)
    for name, value in list(variables["batch_stats"].items()):
        if name.endswith(".mean"):
            variables["batch_stats"][name] = 0.1 * rand(value.shape)
        else:
            variables["batch_stats"][name] = 0.75 + 0.5 * torch.rand(
                value.shape, generator=gen).to(DEV)
    return variables


def sub_vars(variables, prefix):
    out = {}
    for coll in ("params", "batch_stats"):
        for name, value in variables.get(coll, {}).items():
            if name.startswith(prefix + "."):
                out[name[len(prefix) + 1:]] = value
    return out


def make_dataset(rng, batches, batch, valid_last, canvas=320):
    data = []
    for i in range(batches):
        valid = valid_last if i == batches - 1 else batch
        data.append({
            "images": rng.integers(0, 256, (batch, canvas, canvas, 3), dtype=np.uint8),
            "image_ids": [f"img{i}_{j}" if j < valid else "" for j in range(batch)],
            "batch_valid": np.int32(valid),
        })
    return data


def check_results(results, expected_images, max_det):
    if len(results) != expected_images:
        raise AssertionError(f"{len(results)} results for {expected_images} images")
    for r in results:
        n = len(r["scores"])
        if not (0 <= n <= max_det) or r["boxes"].shape != (n, 4):
            raise AssertionError(f"bad result shape for {r['image_id']}")
        if not (np.isfinite(r["boxes"]).all() and np.isfinite(r["scores"]).all()):
            raise AssertionError(f"non-finite output for {r['image_id']}")
        if n and (r["boxes"].min() < 0 or r["boxes"].max() > 1):
            raise AssertionError(f"box outside [0, 1] for {r['image_id']}")
        if n and (r["scores"].min() < 0 or r["scores"].max() > 1):
            raise AssertionError(f"score outside [0, 1] for {r['image_id']}")


def head_against_plain(cfg, model, variables, priors, images_u8):
    """Head outputs through the kernel against the plain head on the same
    endpoint features, then the final detections against the plain
    decode → select_detections applied to the kernel path's own outputs."""
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    plain_model = inference.build_model(plain_cfg, model.num_priors, device=DEV)
    with torch.no_grad():
        images = preprocess_eval(dev(images_u8), cfg.input_size)
        endpoints = functional_call(
            model.backbone, sub_vars(variables, model.backbone_scope), (images,))
        head_vars = sub_vars(variables, model.head_scope)
        loc_k, conf_k = functional_call(model.head, head_vars, (endpoints,))
        loc_p, conf_p = functional_call(plain_model.head, head_vars, (endpoints,))
        torch.testing.assert_close(loc_k, loc_p, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(conf_k, conf_p, rtol=1e-4, atol=1e-4)
        priors = dev(priors)
        got = inference.postprocess(loc_k, conf_k, priors, cfg)
        want = inference.postprocess(loc_k, conf_k, priors, plain_cfg)
        for key in ("boxes", "scores", "classes", "num"):
            if not torch.equal(got[key], want[key]):
                raise AssertionError(f"detections differ from the plain postprocess: {key}")
        if not torch.isfinite(loc_k).all() or not torch.isfinite(conf_k).all():
            raise AssertionError("non-finite head output")
    return {
        "head_loc_max_abs_err": float((loc_k - loc_p).abs().max()),
        "head_conf_max_abs_err": float((conf_k - conf_p).abs().max()),
        "logit_abs_max": float(conf_k.abs().max()),
        "num_min": int(got["num"].min()), "num_max": int(got["num"].max()),
    }


def stage_times(cfg, model, variables, priors, images_u8):
    """CUDA-event medians of the four stages of one batch, each timed alone
    on the outputs of the one before."""
    with torch.no_grad():
        u8 = dev(images_u8)
        images = preprocess_eval(u8, cfg.input_size)
        backbone_vars = sub_vars(variables, model.backbone_scope)
        head_vars = sub_vars(variables, model.head_scope)
        endpoints = functional_call(model.backbone, backbone_vars, (images,))
        loc, conf = functional_call(model.head, head_vars, (endpoints,))
        tpriors = dev(priors)

        def timed(fn):
            def run():
                with torch.no_grad():
                    fn()
            return time_ms(run, reps=7, warmup=2)

        return {
            "preprocess_ms": timed(lambda: preprocess_eval(u8, cfg.input_size)),
            "backbone_ms": timed(lambda: functional_call(
                model.backbone, backbone_vars, (images,))),
            "head_ms": timed(lambda: functional_call(
                model.head, head_vars, (endpoints,))),
            "postprocess_ms": timed(lambda: inference._pack_dets(
                inference.postprocess(loc, conf, tpriors, cfg))),
        }


def device_profile(fn):
    """``fn()`` under torch.profiler. From the device's own events (kernels
    and copies): the share of the window between the first and the last of
    them in which nothing ran, and the kernels that took most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted(
        ((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
         if e.device_type == DeviceType.CUDA),
        key=lambda e: e[0])
    if not events:
        raise AssertionError("the profiler recorded no device event")
    busy_us, covered_to, by_name = 0.0, events[0][0], {}
    for start, end, name in events:
        if end > covered_to:  # union of the intervals
            busy_us += end - max(start, covered_to)
            covered_to = end
        total, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (total + end - start, calls + 1)
    window_us = covered_to - events[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"window_ms": window_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / window_us,
            "device_events": len(events),
            "top": [{"name": k[:70], "ms": v[0] / 1e3, "calls": v[1]} for k, v in top]}


def profile_detect(cfg, variables, data, priors, fns):
    """One detect loop under torch.profiler (:func:`device_profile`)."""
    emit({"phase": "profile", "batches": len(data), **device_profile(
        lambda: inference.run_detect_loop(cfg, variables, data, priors, fns=fns,
                                          device=DEV))})


def phase_detect(rng, gen, card_line, profile_it=False):
    cfg = Config(use_pallas=True)  # 299, P=256, batch 32, bf16 backbone, f32 head
    P, B = cfg.num_priors, cfg.batch_size
    priors = np.sort(rng.uniform(0.05, 0.95, (P, 2, 2)).astype(np.float32), axis=1).reshape(P, 4)
    model = inference.build_model(cfg, P, device=DEV)
    variables = make_variables(model, gen)
    data = make_dataset(rng, batches=4, batch=B, valid_last=20)
    stages = head_against_plain(cfg, model, variables, priors, data[0]["images"])

    fns = inference.make_detect_loop_fns(cfg, priors, device=DEV)
    inference.run_detect_loop(cfg, variables, data, priors, fns=fns, device=DEV)  # warm-up
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    results = inference.run_detect_loop(cfg, variables, data, priors, fns=fns, device=DEV)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()

    images = sum(int(b["batch_valid"]) for b in data)
    check_results(results, images, cfg.max_detections)
    want = {"nms": len(data), "fused_matmul": 3 * len(data), "box_decode": len(data),
            "box_encode": 0, "match": 0, "fused_matmul_backward": 0}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    stages.update(stage_times(cfg, model, variables, priors, data[0]["images"]))
    if profile_it:
        profile_detect(cfg, variables, data, priors, fns)
    emit({"phase": "detect", "ok": True, "card": card_line,
          "config": "Config(use_pallas=True): inception_v3 299x299, P=256, batch 32, "
                    "bfloat16 backbone, float32 head, K=100",
          "batches": len(data), "images": images,
          "ms_per_batch": seconds * 1e3 / len(data),
          "images_per_s": len(data) * B / seconds,
          "launches": counts, **stages})
    return counts, variables, priors


def detect_ms_per_batch(model, variables, data, tpriors, cfg):
    """ms a batch of preprocess → detector → postprocess → packed copy to
    the host, on the host clock around the batches, ending in a
    synchronize; one warm-up batch first."""
    def one(batch):
        with torch.no_grad():
            images = preprocess_eval(dev(batch["images"]), cfg.input_size)
            loc, conf = inference.detector_mod.apply(model, variables, images)
            return inference._pack_dets(inference.postprocess(loc, conf, tpriors, cfg)).cpu()

    one(data[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in data:
        one(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(data)


def phase_detect_folded(rng, variables, priors):
    """BN folded into the convolutions: the bf16 1×1 units run through the
    matmul kernel. Logits against the unfolded model's, atol 0.1 (bf16
    backbone; the fold moves where values are rounded). Then ms a batch
    over 4 batches of 32: folded with the units on the kernel
    (``use_pallas=True``), folded with the units as plain ``torch``
    products (``use_pallas=None``: NMS kernel only), and unfolded (the
    units as cuDNN convolutions and BatchNorm, ``use_pallas=True``)."""
    cfg = Config(use_pallas=True, batch_size=8)
    P = cfg.num_priors
    folded_model = inference.build_model(cfg, P, folded=True, device=DEV)
    plain_model = inference.build_model(cfg, P, device=DEV)
    folded_vars = fold_batch_norms(variables)
    tpriors = dev(priors)
    fused_units = sum(1 for m in folded_model.modules() if isinstance(m, ConvBN) and m.fused)
    data = make_dataset(rng, batches=2, batch=8, valid_last=8)
    kernels.reset_launch_counts()
    worst, scale = 0.0, 0.0
    with torch.no_grad():
        for batch in data:
            images = preprocess_eval(dev(batch["images"]), cfg.input_size)
            loc_f, conf_f = inference.detector_mod.apply(folded_model, folded_vars, images)
            det = inference.postprocess(loc_f, conf_f, tpriors, cfg)
            torch.cuda.synchronize()
            loc_u, conf_u = inference.detector_mod.apply(plain_model, variables, images)
            if not (torch.isfinite(loc_f).all() and torch.isfinite(conf_f).all()):
                raise AssertionError("non-finite output of the folded model")
            if int(det["num"].min()) < 0 or int(det["num"].max()) > cfg.max_detections:
                raise AssertionError("detection count out of range")
            worst = max(worst, float((conf_f - conf_u).abs().max()),
                        float((loc_f - loc_u).abs().max()))
            scale = max(scale, float(conf_u.abs().max()), float(loc_u.abs().max()))
    counts = kernels.launch_counts()
    # the unfolded comparison model also ran its head through the kernel
    want = {"nms": 2, "fused_matmul": 2 * (fused_units + 3) + 2 * 3, "box_decode": 2,
            "box_encode": 0, "match": 0, "fused_matmul_backward": 0}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    if worst > 0.1 or worst > 0.2 * scale:
        raise AssertionError(f"folded vs unfolded outputs differ by {worst} (scale {scale})")

    data32 = make_dataset(rng, batches=4, batch=32, valid_last=32)
    cfg32 = Config(use_pallas=True)
    cfg32_plain_units = Config(use_pallas=None)
    plain_units_model = inference.build_model(cfg32_plain_units, P, folded=True, device=DEV)
    runs = {"folded_units_on_kernel": (folded_model, folded_vars, cfg32),
            "folded_units_plain_torch": (plain_units_model, folded_vars, cfg32_plain_units),
            "unfolded_units_on_cudnn": (plain_model, variables, cfg32)}
    loops = {name: [] for name in runs}
    for name in list(runs) + list(reversed(runs)):  # A B C C B A: the host drifts
        m, v, c = runs[name]
        loops[name].append(detect_ms_per_batch(m, v, data32, tpriors, c))
    emit({"phase": "detect_folded", "ok": True, "fused_1x1_units": fused_units,
          "max_abs_err_vs_unfolded": worst, "output_abs_max": scale, "launches": counts,
          "ms_per_batch_of_32": loops, "batches": len(data32)})


def phase_detect_b128(rng, variables, priors, batches=2):
    """The detect path at batch 128 (configs/cub_detect.yaml's model,
    Inception-v3 299, P = 256) with ``use_pallas=True``: the head's three
    matmuls at 128 rows, which ``_plan`` must put on the f32_tile route, 3
    launches a batch. Held stage by stage against ``use_pallas=False`` (the
    detect phase's tolerances: head outputs rtol/atol 1e-4, then the
    postprocess exact on the same logits), then both loops over the same
    batches: the same images, and ms a batch of each."""
    cfg = Config(use_pallas=True, batch_size=128)
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    P, B = cfg.num_priors, cfg.batch_size
    model = inference.build_model(cfg, P, device=DEV)
    data = make_dataset(rng, batches=batches, batch=B, valid_last=100)
    stages = head_against_plain(cfg, model, variables, priors, data[0]["images"])
    runs = {}
    for name, run_cfg in (("kernels", cfg), ("plain", plain_cfg)):
        seen, plan_of = {}, fused_matmul._plan

        def spy(M, K, N, dtype, aligned=True):
            plan = plan_of(M, K, N, dtype, aligned)
            seen[f"{M}x{K}x{N}"] = plan.route
            return plan

        # the plans are made where the detect graph is captured: in the
        # first loop over these fns
        fused_matmul._plan = spy
        try:
            fns = inference.make_detect_loop_fns(run_cfg, priors, device=DEV)
            inference.run_detect_loop(run_cfg, variables, data[:1], priors, fns=fns,
                                      device=DEV)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            results = inference.run_detect_loop(run_cfg, variables, data, priors, fns=fns,
                                                device=DEV)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            fused_matmul._plan = plan_of
        check_results(results, sum(int(b["batch_valid"]) for b in data), cfg.max_detections)
        runs[name] = {"results": results, "launches": kernels.launch_counts(), "routes": seen,
                      "ms_per_batch": seconds * 1e3 / batches}
    want = {"nms": batches, "fused_matmul": 3 * batches, "box_decode": batches,
            "box_encode": 0, "match": 0, "fused_matmul_backward": 0}
    if runs["kernels"]["launches"] != want:
        raise AssertionError(f"batch 128: launch counts {runs['kernels']['launches']}, "
                             f"expected {want}")
    routes = runs["kernels"]["routes"]
    if len(routes) != 3 or set(routes.values()) != {"f32_tile"}:
        raise AssertionError(f"batch 128: the head's matmuls planned as {routes}")
    if runs["plain"]["launches"]["fused_matmul"] != 0:
        raise AssertionError("batch 128: use_pallas=False launched the matmul kernel")
    ids = [[r["image_id"] for r in runs[k]["results"]] for k in ("kernels", "plain")]
    if ids[0] != ids[1]:
        raise AssertionError("batch 128: the two passes detected different images")
    same = sum(int(np.array_equal(a["boxes"], b["boxes"]) and np.array_equal(a["scores"], b["scores"]))
               for a, b in zip(runs["kernels"]["results"], runs["plain"]["results"]))
    emit({"phase": "detect_b128", "ok": True,
          "config": "Config(use_pallas=True, batch_size=128): inception_v3 299x299, P=256, "
                    "bfloat16 backbone, float32 head",
          "batches": batches, "images": len(ids[0]), "head_routes": routes,
          "launches": runs["kernels"]["launches"],
          "ms_per_batch": {k: v["ms_per_batch"] for k, v in runs.items()},
          "images_with_identical_detections": same, **stages})
    return runs["kernels"]["launches"]


# --------------------------------------------------------------------------
# the train path
# --------------------------------------------------------------------------


def make_train_data(rng, batches, cfg, canvas):
    """Host batches: uint8 canvases and 1..G random boxes per image."""
    B, G = cfg.batch_size, cfg.max_num_bboxes
    data = []
    for _ in range(batches):
        num = rng.integers(1, G + 1, B).astype(np.int32)
        boxes = random_boxes(rng, (B, G), min_size=0.1)
        boxes[np.arange(G)[None, :] >= num[:, None]] = 0.0
        data.append({"images": rng.integers(0, 256, (B, canvas, canvas, 3), dtype=np.uint8),
                     "boxes": boxes, "num_boxes": num})
    return data


def train_stage_checks(cfg, model, state, priors, batch):
    """Stage by stage on one augmented batch: B4 against its plain version
    (exact, then timed: :func:`match_at_step_boxes`); the head's gradients
    through the kernel (B2 forward and backward) against the plain head on
    the same endpoints and targets; one whole step with use_pallas=True
    against use_pallas=False from the same state, batch and generator."""
    tpriors = dev(priors)
    images, boxes, num = augmented(cfg, state, batch)
    b4 = match_at_step_boxes("train", boxes, num, tpriors)

    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    plain_model = inference.build_model(plain_cfg, model.num_priors, device=DEV)
    scope, endpoint = model.backbone_scope, model.head.endpoint
    with torch.no_grad():
        endpoints = functional_call(
            model.backbone, sub_vars({"params": state.params,
                                      "batch_stats": state.batch_stats}, scope),
            (images,), {"train": True})
    grads = {}
    for tag, m in (("kernel", model), ("plain", plain_model)):
        # in float32, as the head takes it: the gradient is compared before
        # its cast to the backbone's bfloat16
        feat = endpoints[endpoint].detach().float().requires_grad_(True)
        head = {k: v.detach().clone().requires_grad_(True)
                for k, v in sub_vars({"params": state.params}, "MultiBoxHead").items()}
        loc, conf = functional_call(m.MultiBoxHead, head, ({endpoint: feat},))
        total, _ = train_loss.multibox_loss(loc, conf, boxes, num, tpriors, use_pallas=False)
        keys = sorted(head)
        out = torch.autograd.grad(total, [head[k] for k in keys] + [feat])
        grads[tag] = dict(zip(keys + [endpoint], out))
    worst = {}
    for k, want in grads["plain"].items():
        scale = float(want.abs().max())
        torch.testing.assert_close(grads["kernel"][k], want, rtol=1e-3, atol=1e-4 * scale,
                                   msg=lambda m: f"head gradient {k}: {m}")
        worst[k] = float((grads["kernel"][k] - want).abs().max()) / max(scale, 1e-30)

    results = {}
    for tag, c, m in (("kernel", cfg, model), ("plain", plain_cfg, plain_model)):
        s = state.clone()
        step = train_loop.make_augmented_train_step(c, m, priors, device=DEV)
        s, metrics = step(s, batch)
        results[tag] = (s, float(metrics["loss"]))
    loss_k, loss_p = results["kernel"][1], results["plain"][1]
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-4 * abs(loss_p)):
        raise AssertionError(f"step loss {loss_k} (kernels) vs {loss_p} (plain)")
    head_err = 0.0
    for k, v in results["plain"][0].params.items():
        if k.startswith("MultiBoxHead."):
            torch.testing.assert_close(results["kernel"][0].params[k], v, rtol=1e-4, atol=1e-5,
                                       msg=lambda m: f"head param {k} after one step: {m}")
            head_err = max(head_err, float((results["kernel"][0].params[k] - v).detach()
                                           .abs().max()))
    return {"b4_on_step_boxes": b4, "head_grad_rel_err": worst,
            "step_loss_kernels": loss_k, "step_loss_plain": loss_p,
            "step_head_param_max_abs_err": head_err}


def step_loss(cfg, loc, conf, boxes, num, tpriors, labels=None):
    """The step's loss as ``train.state.make_train_step`` calls it."""
    return train_loss.multibox_loss(
        loc, conf, boxes, num, tpriors, alpha=cfg.location_loss_alpha, matching=cfg.matching,
        hybrid_conf_weight=cfg.hybrid_conf_weight, hard_negative_ratio=cfg.hard_negative_ratio,
        multi_match_iou=cfg.multi_match_iou, encode=cfg.box_encoding, gt_labels=labels,
        use_pallas=cfg.use_pallas, conf_loss=cfg.conf_loss, focal_gamma=cfg.focal_gamma,
        focal_alpha=cfg.focal_alpha)


def train_stage_times(cfg, model, state, priors, batch, reps=5):
    """Device time of each stage of a step (CUDA events between the
    stages of hand-run steps; median of ``reps``): augment, forward, loss
    with matching, backward, optimizer + EMA."""
    tpriors = dev(priors)
    optimizer = train_state.make_optimizer(cfg)
    s = state.clone()
    names = ("augment_ms", "forward_ms", "loss_ms", "backward_ms", "optimizer_ema_ms")
    samples = {n: [] for n in names}
    for r in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        db = shard_batch(batch, DEV)
        ev[0].record()
        images, boxes, num, *labels = augment.augment_batch(
            train_loop.step_generator(cfg.seed, s.step, DEV), db["images"], db["boxes"],
            db["num_boxes"], cfg, labels=db.get("labels"))
        ev[1].record()
        (loc, conf), new_stats = detector_mod.apply(
            model, {"params": s.params, "batch_stats": s.batch_stats}, images, train=True)
        ev[2].record()
        total, _ = step_loss(cfg, loc, conf, boxes, num, tpriors, *labels)
        ev[3].record()
        keys = list(s.params)
        g = dict(zip(keys, torch.autograd.grad(total, [s.params[k] for k in keys])))
        ev[4].record()
        optimizer.apply(s.params, g, s.opt_state)
        train_state.ema_update(s.ema_params, s.params, s.step, cfg.moving_average_decay)
        ev[5].record()
        s.batch_stats, s.step = new_stats, s.step + 1
        torch.cuda.synchronize()
        if r:  # the first is a warm-up
            for i, n in enumerate(names):
                samples[n].append(ev[i].elapsed_time(ev[i + 1]))
    return {n: statistics.median(v) for n, v in samples.items()}


def profile_train(step_fn, state, data):
    """Steps under torch.profiler (:func:`device_profile`)."""
    box = [state]

    def steps():
        for b in data:
            box[0], _ = step_fn(box[0], b)

    prof = device_profile(steps)
    return box[0], {"steps": len(data), **prof}


def phase_train(rng, card_line, profile_it=False, loop_steps=12, overfit_steps=40):
    """The train path at Config(use_pallas=True): Inception-v3 299, P=256,
    batch 32, G=16, greedy matching, bf16 backbone, f32 head, RMSProp,
    augmentation on a 343-px canvas. Returns the launch counts of the
    train() run."""
    cfg = Config(use_pallas=True, log_every_steps=1)
    P, B = cfg.num_priors, cfg.batch_size
    canvas = int(cfg.input_size * 1.15)
    priors = np.sort(rng.uniform(0.05, 0.95, (P, 2, 2)).astype(np.float32), axis=1).reshape(P, 4)
    model = inference.build_model(cfg, P, device=DEV)
    state = train_state.create_train_state(cfg, model, SEED, P, device=DEV)
    data = make_train_data(rng, loop_steps + 4, cfg, canvas)
    out = {"phase": "train", "card": card_line,
           "config": "Config(use_pallas=True): inception_v3 299x299, P=256, batch 32, G=16, "
                     "greedy matching, bfloat16 backbone, float32 head, RMSProp "
                     "(decay 0.9, eps 1.0, momentum 0.9), lr 0.01, augmentation on a "
                     f"{canvas}-px canvas"}
    out.update(train_stage_checks(cfg, model, state, priors, data[0]))
    out.update(train_stage_times(cfg, model, state, priors, data[0]))

    # the loop: N steps into a fresh logdir, then resume to N + 4
    logdir = os.path.join(".work", "chip_smoke_train")
    shutil.rmtree(logdir, ignore_errors=True)
    stream = lambda start: iter(data[start:])  # noqa: E731
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = train_loop.train_from_batches(cfg, stream, priors, logdir, max_steps=loop_steps,
                                      device=DEV)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = {"nms": 0, "fused_matmul": 3 * loop_steps, "fused_matmul_backward": 3 * loop_steps,
            "box_decode": 0, "box_encode": loop_steps, "match": loop_steps}
    if counts != want:
        raise AssertionError(f"train launch counts {counts}, expected {want}")
    first = train_loop.train_from_batches(cfg, stream, priors, logdir,
                                          max_steps=loop_steps + 4, device=DEV)
    latest = CheckpointManager(logdir).latest_step()
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    losses = [r["loss"] for r in logged]
    if s.step != loop_steps or first.step != loop_steps + 4 or latest != loop_steps + 4:
        raise AssertionError(f"resume: steps {s.step}, {first.step}, latest {latest}")
    if [r["step"] for r in logged] != list(range(1, loop_steps + 5)):
        raise AssertionError("the resumed run did not continue from its checkpoint")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss in the train loop: {losses}")
    steady = [r["images_per_sec"] for r in logged[2:loop_steps]]
    shutil.rmtree(logdir, ignore_errors=True)
    del s, first

    # steady steps on the host clock, then overfit one fixed batch
    step_fn = train_loop.make_augmented_train_step(cfg, model, priors, device=DEV)
    ms_step, st = timed_steps(step_fn, state, data[:6])
    if profile_it:
        st, prof = profile_train(step_fn, st, data[6:9])
        out["profile"] = prof
    del st
    overfit = overfit_one_batch(cfg, model, state, priors, data[0], overfit_steps)
    del state
    torch.cuda.empty_cache()

    out.update({
        "ok": True, "launches": counts, "loop_steps": loop_steps,
        "loop_seconds": seconds, "resumed_from": loop_steps, "latest_checkpoint": latest,
        "loop_images_per_s_logged": steady, "loss_first_last": [losses[0], losses[-1]],
        "ms_per_step": ms_step, "images_per_s": B * 1e3 / ms_step,
        "overfit_steps": overfit_steps, "overfit_loss_first": overfit[0],
        "overfit_loss_last": overfit[-1]})
    emit(out)
    return counts


# --------------------------------------------------------------------------
# CUDA graphs against the eager path
# --------------------------------------------------------------------------


def state_gaps(a, b):
    """``{leaf: max |a − b|}`` of the leaves of two train states that are
    not equal bit for bit (an empty dict: the states are the same)."""
    gaps = {}

    def walk(x, y, path):
        if isinstance(x, dict):
            if set(x) != set(y):
                gaps[path] = "different keys"
            for k in x:
                if k in y:
                    walk(x[k], y[k], f"{path}.{k}" if path else k)
        elif isinstance(x, torch.Tensor):
            if x.shape != y.shape or x.dtype != y.dtype:
                gaps[path] = "different shape or dtype"
            elif not torch.equal(x.detach().view(-1).view(torch.uint8),
                                 y.detach().view(-1).view(torch.uint8)):
                gaps[path] = float((x.detach().double() - y.detach().double()).abs().max())
        elif x != y:
            gaps[path] = f"{x} != {y}"

    walk({"step": a.step, "params": a.params, "batch_stats": a.batch_stats,
          "opt_state": a.opt_state, "ema_params": a.ema_params},
         {"step": b.step, "params": b.params, "batch_stats": b.batch_stats,
          "opt_state": b.opt_state, "ema_params": b.ema_params}, "")
    return gaps


@contextlib.contextmanager
def graph_calls():
    """Within the block, counts of CUDA graph replays and of staged input
    copies (``graphs.CapturedGraph.replay``, ``graphs.StagedInputs.put``)."""
    from multibox_tpu_torch import graphs

    calls = {"replays": 0, "input_copies": 0}
    replay, put = graphs.CapturedGraph.replay, graphs.StagedInputs.put

    def counted_replay(self):
        calls["replays"] += 1
        return replay(self)

    def counted_put(self, fields):
        calls["input_copies"] += 1
        return put(self, fields)

    graphs.CapturedGraph.replay, graphs.StagedInputs.put = counted_replay, counted_put
    try:
        yield calls
    finally:
        graphs.CapturedGraph.replay, graphs.StagedInputs.put = replay, put


@contextlib.contextmanager
def packed_results():
    """Within the block, a copy of every packed ``[B, D, 7]`` detection
    array the detect loop unpacks."""
    seen, real = [], inference._unpack_dets

    def spy(arr):
        seen.append(np.array(arr, copy=True))
        return real(arr)

    inference._unpack_dets = spy
    try:
        yield seen
    finally:
        inference._unpack_dets = real


def phase_graphs(rng, gen, card_line, profile_it=False, batches=9, steps=12):
    """CUDA graphs (``multibox_tpu_torch.graphs``) against the eager path.
    Detect: configs/cub_detect.yaml with use_pallas=True (Inception-v3
    299, P = 256, batch 32, bf16 backbone), ``run_detect_loop`` at
    steps_per_host_transfer K = 1 and 4 over 9 batches (at K = 4 two full
    groups and one batch alone, the last batch 20 images of 32): the packed
    detections of every batch bit-equal, the launch counts a batch those of
    the eager path, one graph launch and one input copy a group; ms a batch
    of each path. Train: configs/voc_train.yaml with greedy matching and
    use_pallas=True, ``train_from_batches`` for 12 steps from one start
    state at K = 1 and 4, each path: params, EMA, optimizer state and
    BatchNorm statistics bit-equal, launch counts a step the eager path's,
    one graph launch a group; ms a step of each path."""
    from multibox_tpu_torch import graphs
    from multibox_tpu_torch.config import parse_config_file

    out = {"phase": "graphs", "card": card_line}
    total = {}
    cfg = dataclasses.replace(parse_config_file("configs/cub_detect.yaml"), use_pallas=True)
    P, B = cfg.num_priors, cfg.batch_size
    priors = np.sort(rng.uniform(0.05, 0.95, (P, 2, 2)).astype(np.float32), axis=1).reshape(P, 4)
    variables = make_variables(inference.build_model(cfg, P, device=DEV), gen)
    data = make_dataset(rng, batches=batches, batch=B, valid_last=20)
    images = sum(int(b["batch_valid"]) for b in data)
    per_batch = {"nms": 1, "fused_matmul": 3, "box_decode": 1}
    detect = {}
    for K in (1, 4):
        kcfg = dataclasses.replace(cfg, steps_per_host_transfer=K)
        packed = {}
        for path in ("eager", "graphs"):
            fns = inference.make_detect_loop_fns(kcfg, priors, device=DEV, eager=path == "eager")
            graphed = isinstance(fns["groups"], inference._GraphedGroups)
            if graphed != (path == "graphs"):
                raise AssertionError(f"graphs: detect took the wrong path ({path})")
            t0 = time.perf_counter()
            inference.run_detect_loop(kcfg, variables, data, priors, fns=fns, device=DEV)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0  # the graphs' capture included
            with packed_results() as seen, graph_calls() as calls:
                t0 = time.perf_counter()
                results, counts = counted(lambda: inference.run_detect_loop(
                    kcfg, variables, data, priors, fns=fns, device=DEV),
                    {k: v * batches for k, v in per_batch.items()},
                    f"graphs: detect ({path}, K={K})")
                seconds = time.perf_counter() - t0
            add_counts(total, counts)
            check_results(results, images, cfg.max_detections)
            full = batches // K
            want_calls = {"replays": full + (batches - full * K), "input_copies":
                          full + (batches - full * K)} if graphed else {"replays": 0,
                                                                        "input_copies": 0}
            if calls != want_calls:
                raise AssertionError(f"graphs: detect ({path}, K={K}) made {calls}, "
                                     f"expected {want_calls}")
            packed[path] = np.stack(seen)
            row = {"ms_per_batch": seconds * 1e3 / batches, "first_loop_s": first_s,
                   "groups": -(-batches // K), **calls}
            if profile_it:
                row["profile"] = device_profile(lambda: inference.run_detect_loop(
                    kcfg, variables, data, priors, fns=fns, device=DEV))
            detect[f"K{K}_{path}"] = row
            del fns
        if packed["eager"].shape != (batches, B, cfg.max_detections, 7) or \
                packed["eager"].tobytes() != packed["graphs"].tobytes():
            raise AssertionError(f"graphs: detect K={K}: packed detections differ from eager")
        detect[f"K{K}_bit_equal"] = True
    # the int8 program (quantize: int8, calibrated on one batch), K = 1
    from multibox_tpu_torch.quantize import prepare_quantized_variables

    qcfg = dataclasses.replace(cfg, quantize="int8")
    qvars = prepare_quantized_variables(qcfg, variables, [data[0]["images"]], device=DEV)
    qdata = data[:3]
    packed = {}
    for path in ("eager", "graphs"):
        fns = inference.make_detect_loop_fns(qcfg, priors, device=DEV, eager=path == "eager")
        inference.run_detect_loop(qcfg, qvars, qdata, priors, fns=fns, device=DEV)
        with packed_results() as seen:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            inference.run_detect_loop(qcfg, qvars, qdata, priors, fns=fns, device=DEV)
            torch.cuda.synchronize()
            detect[f"int8_{path}"] = {"ms_per_batch": (time.perf_counter() - t0) * 1e3
                                      / len(qdata), "launches": kernels.launch_counts()}
            add_counts(total, detect[f"int8_{path}"]["launches"])
        packed[path] = np.stack(seen)
        del fns
    if detect["int8_eager"]["launches"] != detect["int8_graphs"]["launches"] or \
            detect["int8_eager"]["launches"]["nms"] != len(qdata):
        raise AssertionError(f"graphs: int8 detect launches {detect['int8_eager']['launches']}"
                             f" (eager) and {detect['int8_graphs']['launches']} (graphs)")
    if packed["eager"].tobytes() != packed["graphs"].tobytes():
        raise AssertionError("graphs: int8 detect: packed detections differ from eager")
    detect["int8_bit_equal"] = True
    out["detect"] = detect
    del variables, qvars
    torch.cuda.empty_cache()

    tcfg = dataclasses.replace(parse_config_file("configs/voc_train.yaml"), matching="greedy",
                               use_pallas=True, log_every_steps=steps, keep_checkpoints=1)
    P = tcfg.num_priors
    tpriors = np.sort(rng.uniform(0.05, 0.95, (P, 2, 2)).astype(np.float32),
                      axis=1).reshape(P, 4)
    tdata = make_train_data(rng, steps, tcfg, int(tcfg.input_size * 1.15))
    stream = lambda start: iter(tdata[start:])  # noqa: E731
    want = {"match": steps, "fused_matmul": 3 * steps, "fused_matmul_backward": 3 * steps,
            "box_encode": steps}
    train = {}
    root = os.path.join(".work", "chip_smoke_graphs")
    for K in (1, 4):
        kcfg = dataclasses.replace(tcfg, steps_per_host_transfer=K)
        final = {}
        for path in ("eager", "graphs"):
            logdir = os.path.join(root, f"K{K}_{path}")
            shutil.rmtree(logdir, ignore_errors=True)
            with graph_calls() as calls:
                t0 = time.perf_counter()
                final[path], counts = counted(lambda: train_loop.train_from_batches(
                    kcfg, stream, tpriors, logdir, max_steps=steps, device=DEV,
                    eager=path == "eager"), want, f"graphs: train ({path}, K={K})")
                seconds = time.perf_counter() - t0
            add_counts(total, counts)
            shutil.rmtree(logdir, ignore_errors=True)
            want_replays = steps // K if path == "graphs" else 0
            if calls["replays"] != want_replays:
                raise AssertionError(f"graphs: train ({path}, K={K}): {calls['replays']} "
                                     f"graph launches, expected {want_replays}")
            train[f"K{K}_{path}"] = {"loop_seconds": seconds, **calls}
        gaps = state_gaps(final["eager"], final["graphs"])
        train[f"K{K}_bit_equal"] = not gaps
        if gaps:
            train[f"K{K}_gaps"] = dict(list(gaps.items())[:20])
            raise AssertionError(f"graphs: train K={K}: the graphed state differs from the "
                                 f"eager one at {len(gaps)} leaves: {dict(list(gaps.items())[:5])}")
        del final
    shutil.rmtree(root, ignore_errors=True)

    # ms a step on the host clock, from one start state: eager, then one-step
    # graphs, then graphs of four steps
    model = inference.build_model(tcfg, P, device=DEV)
    state = train_state.create_train_state(tcfg, model, SEED, P, device=DEV)
    step_fn = train_loop.make_augmented_train_step(tcfg, model, tpriors, device=DEV)
    ms = {"eager": timed_steps(step_fn, state, tdata[:6])[0]}
    one = train_loop.GraphedTrainStep(step_fn)
    ms["graphs_K1"], st1 = timed_steps(lambda s, b: one(s, [b]), state, tdata[:6])
    four = train_loop.GraphedTrainStep(step_fn)
    st4 = state.clone()
    four(st4, tdata[:4])  # captures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for g in range(1, steps // 4):
        four(st4, tdata[4 * g:4 * g + 4])
    torch.cuda.synchronize()
    ms["graphs_K4"] = (time.perf_counter() - t0) * 1e3 / (steps - 4)
    train["ms_per_step"] = ms
    if profile_it:
        st = state.clone()
        train["profile_eager"] = profile_train(step_fn, st, tdata[:3])[1]
        train["profile_graphs_K1"] = profile_train(lambda s, b: one(s, [b]), st1, tdata[:3])[1]
        train["profile_graphs_K4"] = device_profile(lambda: four(st4, tdata[:4]))
    del state, st1, st4, one, four, step_fn, model
    torch.cuda.empty_cache()
    out.update({"ok": True, "train": train, "launches": total,
                "config": "detect: configs/cub_detect.yaml + use_pallas (inception_v3 299, "
                          "P=256, batch 32, K=10 detections); train: configs/voc_train.yaml + "
                          "greedy matching + use_pallas (batch 32, G=16, RMSProp, EMA, "
                          "augmentation)"})
    emit(out)
    return total


# --------------------------------------------------------------------------
# the data path: images → records → the native reader → the tools
# --------------------------------------------------------------------------


def photo(rng, h, w, n=None, min_size=0.1, max_size=0.6):
    """A photo-like uint8 image (gradients, blocks, noise) and its ``n``
    boxes (default 1-16, drawn): the rectangles' corners, normalized."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([200 * y / h, 200 * x / w, 110 + 80 * np.sin(x / 9.0 + y / 13.0)], -1)
    n = int(rng.integers(1, 17)) if n is None else n
    boxes = random_boxes(rng, (n,), min_size=min_size, max_size=max_size)
    for y0, x0, y1, x1 in boxes:
        img[int(y0 * h):int(y1 * h), int(x0 * w):int(x1 * w)] = rng.integers(60, 256, 3)
    img += rng.normal(0, 5, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8), boxes


def read_all(paths, use_native):
    from multibox_tpu_torch.data.tfrecord import read_records

    return list(read_records(paths, use_native=use_native))


def phase_data(rng, card_line, num_images=64):
    """The data-to-training path at configs/voc_train.yaml's width: JPEG
    files and a COCO file → ``cli.dataset.main`` (JPEG records; raw canvases
    at the train canvas in 2 shards) → the native reader against the Python
    one → ``DetectionDataset`` → the native JPEG decoder → ``cli.doctor`` →
    ``cli.visualize`` (B1 once a batch) and ``cli.visualize_inputs``.
    Returns the kernels' launch counts of the phase."""
    import io
    from importlib.util import find_spec

    from PIL import Image

    from multibox_tpu_torch.cli import dataset as cli_dataset
    from multibox_tpu_torch.cli import doctor as cli_doctor
    from multibox_tpu_torch.config import parse_config_file
    from multibox_tpu_torch.data import _native
    from multibox_tpu_torch.data.example_proto import parse_detection_example
    from multibox_tpu_torch.data.jpeg import decode_jpeg
    from multibox_tpu_torch.data.pipeline import DetectionDataset
    from multibox_tpu_torch.data.tfrecord import read_records
    from multibox_tpu_torch.priors import save_priors

    root = os.path.join(".work", "chip_smoke_data")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "images"))
    cfg = parse_config_file("configs/voc_train.yaml")
    canvas = max(int(cfg.input_size * 1.15), cfg.input_size)
    out = {"phase": "data", "card": card_line, "machine": _native.machine(),
           "config": f"configs/voc_train.yaml (inception_v3 {cfg.input_size}, "
                     f"batch {cfg.batch_size}, G={cfg.max_num_bboxes}, a {canvas}-px canvas)"}
    quiet = contextlib.redirect_stdout(sys.stderr)  # the CLIs' own prints

    # 1. JPEG files at VOC's sizes and a COCO file of their boxes
    coco = {"images": [], "annotations": [], "categories": [{"id": 1}]}
    want = {}
    for i in range(num_images):
        h, w = (375, 500) if i % 2 else (500, 375)
        img, boxes = photo(rng, h, w)
        Image.fromarray(img).save(os.path.join(root, "images", f"im{i}.jpg"), quality=90)
        coco["images"].append({"id": i, "file_name": f"im{i}.jpg", "height": h, "width": w})
        for y0, x0, y1, x1 in boxes.astype(np.float64):
            coco["annotations"].append({"image_id": i, "category_id": 1, "iscrowd": 0,
                                        "bbox": [x0 * w, y0 * h, (x1 - x0) * w, (y1 - y0) * h]})
        want[str(i)] = boxes
    with open(os.path.join(root, "coco.json"), "w") as f:
        json.dump(coco, f)

    # 2. records through the dataset CLI, parsed back to their annotations
    runs = {"jpeg": [], "raw": ["--store_raw_canvas", str(canvas), "--num_shards", "2"]}
    paths, seconds = {}, {}
    for name, extra in runs.items():
        t0 = time.perf_counter()
        with quiet:
            if cli_dataset.main(["--annotations", os.path.join(root, "coco.json"), "--coco",
                                 "--image_root", os.path.join(root, "images"),
                                 "--output_prefix", os.path.join(root, name, "train")] + extra):
                raise AssertionError(f"dataset CLI failed ({name})")
        seconds[name] = time.perf_counter() - t0
        paths[name] = sorted(os.path.join(root, name, f) for f in os.listdir(
            os.path.join(root, name)))
        parsed = {}
        for rec in read_all(paths[name], None):
            ex = parse_detection_example(rec)
            parsed[ex["image_id"]] = ex
        if sorted(parsed) != sorted(want):
            raise AssertionError(f"dataset CLI ({name}): ids {sorted(parsed)[:4]}")
        for image_id, ex in parsed.items():
            with open(os.path.join(root, "images", f"im{image_id}.jpg"), "rb") as f:
                jpeg = f.read()
            if (ex["image_bytes"] != jpeg or list(ex["labels"]) != [1] * len(want[image_id])
                    or not np.allclose(ex["boxes"], want[image_id], rtol=0, atol=1e-6)
                    or (name == "raw") != ("raw" in ex)
                    or (name == "raw" and ex["raw"].shape != (canvas, canvas, 3))):
                raise AssertionError(f"dataset CLI ({name}): record {image_id} differs "
                                     "from its annotation")
    out.update({"images": {"count": num_images, "sizes": "500x375 and 375x500, JPEG q90",
                           "boxes": len(coco["annotations"])},
                "dataset_cli_seconds": seconds,
                "record_files": {k: len(v) for k, v in paths.items()},
                "record_bytes": {k: sum(os.path.getsize(p) for p in v) for k, v in paths.items()},
                "records_parse_back": True})

    # 3. the native reader: byte-equal to the Python reader, then each alone
    for name in paths:
        if read_all(paths[name], None) != read_all(paths[name], False):
            raise AssertionError(f"native reader differs from the Python reader ({name})")
    data_mb = sum(map(len, read_all(paths["raw"], False))) / 1e6
    rates = {}
    for label, use_native, reps in (("native", None, 3), ("python", False, 1)):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            read_all(paths["raw"], use_native)
            times.append(time.perf_counter() - t0)
        rates[label] = data_mb / statistics.median(times)
    def dataset_times():
        """First batch (s) and ms a batch after it, as the train CLI reads."""
        stream = iter(DetectionDataset(paths["raw"], batch_size=cfg.batch_size,
                                       canvas_size=canvas, max_num_bboxes=cfg.max_num_bboxes,
                                       shuffle=True, repeat=True, seed=cfg.seed))
        t0 = time.perf_counter()
        next(stream)
        t1 = time.perf_counter()
        for _ in range(6):
            next(stream)
        ms = (time.perf_counter() - t1) * 1e3 / 6
        stream.close()
        return t1 - t0, ms

    # the default (native) reader, and the Python one put in its place for
    # the comparison only, in turns: native, Python, Python, native
    from multibox_tpu_torch.data import pipeline

    times = {"native": [], "python": []}
    for label in ("native", "python", "python", "native"):
        if label == "python":
            pipeline.read_records = functools.partial(read_records, use_native=False)
        try:
            times[label].append(dataset_times())
        finally:
            pipeline.read_records = read_records
    out.update({"readers_byte_equal": True, "reader_mb": data_mb,
                "native_reader_MB_s": rates["native"], "python_reader_MB_s": rates["python"],
                "detection_dataset_first_batch_s": {k: [t[0] for t in v]
                                                    for k, v in times.items()},
                "detection_dataset_ms_per_batch": {k: [t[1] for t in v]
                                                   for k, v in times.items()}})

    # 4. the native JPEG decoder (opt-in) against PIL, where libjpeg's headers are
    if _native.jpeg_headers_present():
        jpegs = []
        for i in range(num_images):
            with open(os.path.join(root, "images", f"im{i}.jpg"), "rb") as f:
                jpegs.append(f.read())
        diffs = [float(np.abs(decode_jpeg(d, backend="native").astype(int)
                              - decode_jpeg(d).astype(int)).mean()) for d in jpegs]
        if max(diffs) >= 1.0:
            raise AssertionError(f"native JPEG decode differs from PIL's: {max(diffs)}")
        ms = {}
        for backend in ("native", "pil"):
            for label, size in (("full", None), (f"canvas_{canvas}", canvas)):
                t0 = time.perf_counter()
                for d in jpegs:
                    decode_jpeg(d, canvas=size, backend=backend)
                ms[f"{backend}_{label}"] = (time.perf_counter() - t0) * 1e3 / len(jpegs)
        out["jpeg_decoder"] = {"built": True, "max_mean_abs_diff_vs_pil": max(diffs),
                               "ms_per_image": ms}
    else:
        out["jpeg_decoder"] = ("not run: jpeglib.h is absent on this machine, so the "
                               "native JPEG decoder was not built")

    # 5. the doctor, every check on the card
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_doctor.main(["--json"])
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or not all(c["status"] == "ok" for c in report["checks"]):
        raise AssertionError(f"doctor: {report}")
    out["doctor"] = {c["name"]: c["detail"] for c in report["checks"]}

    # 6. the visualize CLIs (B1 once a detect batch) where matplotlib is
    kernels.reset_launch_counts()
    if find_spec("matplotlib") is not None:
        from multibox_tpu_torch.cli import visualize as cli_visualize
        from multibox_tpu_torch.cli import visualize_inputs as cli_visualize_inputs
        from multibox_tpu_torch.inference import build_model

        priors_path = os.path.join(root, "priors.pkl")
        save_priors(random_boxes(rng, (cfg.num_priors,), min_size=0.05), priors_path)
        logdir = os.path.join(root, "logdir")
        model = build_model(cfg, cfg.num_priors, device=DEV)
        CheckpointManager(logdir).save(1, train_state.create_train_state(
            cfg, model, 0, cfg.num_priors, device=DEV), force=True)
        del model
        t0 = time.perf_counter()
        with quiet:
            if cli_visualize.main(["--tfrecords", *paths["jpeg"], "--priors", priors_path,
                                   "--checkpoint_path", logdir, "--output_dir",
                                   os.path.join(root, "pred"), "--max_images", "8",
                                   "--config", "configs/voc_train.yaml"]):
                raise AssertionError("visualize CLI failed")
        t1 = time.perf_counter()
        counts = kernels.launch_counts()
        with quiet:
            if cli_visualize_inputs.main(["--tfrecords", *paths["raw"], "--output_dir",
                                          os.path.join(root, "inputs"), "--priors",
                                          priors_path, "--config", "configs/voc_train.yaml"]):
                raise AssertionError("visualize_inputs CLI failed")
        t2 = time.perf_counter()
        pngs = {d: len(os.listdir(os.path.join(root, d))) for d in ("pred", "inputs")}
        if pngs != {"pred": 8, "inputs": cfg.batch_size}:
            raise AssertionError(f"visualize PNGs {pngs}")
        out["visualize"] = {"pngs": pngs, "visualize_seconds": t1 - t0,
                            "visualize_inputs_seconds": t2 - t1}
    else:
        counts = kernels.launch_counts()
        out["visualize"] = "not run: matplotlib is absent on this machine"
    batches = -(-num_images // cfg.batch_size) if isinstance(out["visualize"], dict) else 0
    want_counts = {"nms": batches, "fused_matmul": 0, "fused_matmul_backward": 0,
                   "box_decode": 0, "box_encode": 0, "match": 0}
    if counts != want_counts:
        raise AssertionError(f"data launch counts {counts}, expected {want_counts}")

    # 7. the checkpoint import needs TensorFlow
    if find_spec("tensorflow") is None:
        out["tf_import"] = "not run: TensorFlow is absent on this machine"
    else:
        import tensorflow as tf

        from multibox_tpu_torch.models import tf_import

        from multibox_tpu_torch.inference import build_model

        variables = build_model(cfg, cfg.num_priors, device="cpu").init_variables(
            torch.Generator().manual_seed(0))
        keras_model = tf.keras.applications.InceptionV3(
            weights=None, include_top=False, input_shape=(cfg.input_size, cfg.input_size, 3))
        tf_import.import_keras_inception_v3(keras_model, variables)
        out["tf_import"] = "keras Inception-v3 (random weights) imported"
    shutil.rmtree(root, ignore_errors=True)  # a 350 MB checkpoint among it
    out.update({"ok": True, "launches": counts})
    emit(out)
    return counts


def phase_batch_sweep(card_line, iters=4):
    """``scripts/torch_train_batch_sweep.py``'s default arms (b128,
    b128_remat, b256, b256_accum2) at configs/voc_train.yaml's model
    (``Config()``: Inception-v3 299, P = 256, G = 16, greedy matching,
    use_pallas unset, so no kernel) on its synthetic batch: ms a step
    (CUDA events over ``iters`` steps), images/s, TFLOP/s, MFU and the peak
    device memory of each. Every arm must run: none is caught."""
    sweep = load_script("torch_train_batch_sweep")
    t0 = time.perf_counter()
    rows = []
    with contextlib.redirect_stdout(sys.stderr):
        _, counts = counted(lambda: [rows.append(sweep.bench_arm(
            arm, iters, Config(), DEV)) for arm in ("b128", "b128_remat", "b256", "b256_accum2")],
            {}, "batch sweep")
    if any("error" in r for r in rows):
        raise AssertionError(f"batch sweep: {[r for r in rows if 'error' in r]}")
    emit({"phase": "batch_sweep", "card": card_line,
          "config": "Config() = configs/voc_train.yaml's model (inception_v3 299, P=256, G=16, "
                    "greedy matching, bfloat16 backbone), the JAX script's synthetic batch "
                    "(343-px canvas, 4 boxes an image)",
          "timing": f"CUDA events over {iters} steps after {sweep.WARMUP}",
          "mfu_peak_tflops": sweep.PEAK_TFLOPS, "arms": rows, "ok": True, "launches": counts,
          "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------
# the command-line path: priors → train → detect → evaluate
# --------------------------------------------------------------------------


def write_records(rng, path, n, canvas, first_id, jpeg=0):
    """``n`` records of bright rectangles on a dark uint8 canvas, 1-16 boxes
    each (label 1): ``image/raw`` canvases of ``canvas`` px, so the data
    layer decodes no JPEG, then ``jpeg`` JPEG records (PIL encodes them)."""
    from multibox_tpu_torch.data.example_proto import build_detection_example
    from multibox_tpu_torch.data.tfrecord import TFRecordWriter

    with TFRecordWriter(path) as w:
        for i in range(n + jpeg):
            boxes = random_boxes(rng, (int(rng.integers(1, 17)),), min_size=0.1)
            img = np.full((canvas, canvas, 3), 30, np.uint8)
            for y0, x0, y1, x1 in (boxes * canvas).astype(int):
                img[y0:y1, x0:x1] = rng.integers(120, 256, 3)
            if i < n:
                rec = build_detection_example(b"", f"im{first_id + i}", boxes,
                                              labels=[1] * len(boxes), raw_canvas=img)
            else:
                from multibox_tpu_torch.data.jpeg import encode_jpeg

                rec = build_detection_example(encode_jpeg(img), f"im{first_id + i}", boxes,
                                              labels=[1] * len(boxes),
                                              height=canvas, width=canvas)
            w.write(rec)


def hungarian_on_the_card(gt, num, priors, all_index_equal=True):
    """Hungarian matching of one batch on the card (phase cli: B=32, G=16,
    P=256; phase coco_dp: B=256, G=64, P=512): bitwise the port on the CPU,
    every image an optimal assignment (as scipy's ``linear_sum_assignment``
    checks it: total benefit within 1e-6 of scipy's, so that a tie scipy
    breaks otherwise reads as such), and the images index-equal to scipy's
    counted (with ``all_index_equal``, every one: phase cli's boxes leave no
    tie; a gt box that overlaps no prior is a tie scipy may break
    otherwise); ms a call (CUDA events, L2 evicted) and exit tests (host
    syncs) a call."""
    from scipy.optimize import linear_sum_assignment

    gt, tnum = torch.as_tensor(gt).to(DEV), torch.as_tensor(num).to(DEV)
    benefit = matching.compute_benefit(gt, dev(priors))
    got = matching.hungarian_match(benefit, tnum).cpu().numpy()
    num = tnum.cpu().numpy()
    cpu = matching.hungarian_match(benefit.cpu(), torch.from_numpy(num)).numpy()
    if not np.array_equal(got, cpu):
        raise AssertionError("Hungarian on the card differs from the CPU")
    b64 = benefit.cpu().numpy().astype(np.float64)
    index_exact = 0
    for b in range(len(num)):
        rows, cols = linear_sum_assignment(b64[b, :num[b]], maximize=True)
        want = np.full(gt.shape[1], -1)
        want[rows] = cols
        act = got[b, :num[b]]
        mine = sum(b64[b, i, j] for i, j in enumerate(act))
        if (act < 0).any() or len(set(act.tolist())) != len(act) or \
                (got[b, num[b]:] != -1).any() or mine < b64[b][rows, cols].sum() - 1e-6:
            raise AssertionError(f"Hungarian image {b} is not an optimal assignment")
        index_exact += int(np.array_equal(got[b], want))
    if all_index_equal and index_exact != len(num):
        raise AssertionError(f"Hungarian: {index_exact} of {len(num)} images equal scipy's")
    matching.reset_exit_tests()
    ms = time_ms(lambda: matching.hungarian_match(benefit, tnum), reps=10, warmup=2)
    calls = matching.EXIT_TESTS["calls"]
    return {"hungarian_shape": f"B={len(num)} G={gt.shape[1]} P={len(priors)}",
            "hungarian_ms": ms, "hungarian_exit_tests_per_call":
            matching.EXIT_TESTS["tests"] / calls, "hungarian_scipy_index_exact_images":
            index_exact, "hungarian_images": len(num), "hungarian_equals_cpu": True}


def phase_cli(rng, card_line):
    """The command-line path at voc_train's full width: k-means priors,
    ``cli.train.main --config configs/voc_train.yaml`` (Hungarian matching,
    use_pallas unset, periodic eval) for 4 steps and resumed to 6,
    ``cli.detect.main`` with configs/cub_detect.yaml, ``cli.evaluate.main``.
    Returns the kernels' launch counts of the phase and the path of its
    train records (phase ``ssd`` trains on them and removes them)."""
    from importlib.util import find_spec

    from multibox_tpu_torch.cli import detect as cli_detect
    from multibox_tpu_torch.cli import evaluate as cli_evaluate
    from multibox_tpu_torch.cli import priors as cli_priors
    from multibox_tpu_torch.cli import train as cli_train
    from multibox_tpu_torch.config import parse_config_file
    from multibox_tpu_torch.data.pipeline import DetectionDataset
    from multibox_tpu_torch.priors import load_priors

    root = os.path.join(".work", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    train_cfg = parse_config_file("configs/voc_train.yaml")
    det_cfg = parse_config_file("configs/cub_detect.yaml")
    canvas = max(int(train_cfg.input_size * 1.15), train_cfg.input_size)
    jpeg = 8 if find_spec("PIL") is not None else 0
    train_rec, eval_rec = os.path.join(root, "train.tfrecord"), os.path.join(root, "eval.tfrecord")
    t0 = time.perf_counter()
    write_records(rng, train_rec, 64, canvas, 0)
    write_records(rng, eval_rec, 32, train_cfg.input_size, 64, jpeg=jpeg)
    out = {"phase": "cli", "card": card_line,
           "config": f"configs/voc_train.yaml as shipped (inception_v3 {train_cfg.input_size}, "
                     f"P={train_cfg.num_priors}, batch {train_cfg.batch_size}, "
                     f"G={train_cfg.max_num_bboxes}, matching {train_cfg.matching}, "
                     f"use_pallas {train_cfg.use_pallas}, {train_cfg.compute_dtype} backbone, "
                     f"augmentation on a {canvas}-px canvas); detect with "
                     "configs/cub_detect.yaml",
           "records": {"train_raw": 64, "eval_raw": 32, "eval_jpeg": jpeg},
           "decoders": ["image/raw"] + (["jpeg (PIL)"] if jpeg else []),
           "write_seconds": time.perf_counter() - t0}
    quiet = contextlib.redirect_stdout(sys.stderr)  # the CLIs' own prints

    kernels.reset_launch_counts()
    priors_path = os.path.join(root, "priors.pkl")
    with quiet:
        if cli_priors.main(["--tfrecords", train_rec, "--output", priors_path,
                            "--mode", "kmeans", "--num_priors", str(train_cfg.num_priors)]):
            raise AssertionError("priors CLI failed")
    priors = load_priors(priors_path)
    if priors.shape != (train_cfg.num_priors, 4) or not np.isfinite(priors).all():
        raise AssertionError(f"k-means priors {priors.shape}")

    logdir = os.path.join(root, "logdir")
    args = ["--tfrecords", train_rec, "--priors", priors_path, "--logdir", logdir,
            "--config", "configs/voc_train.yaml", "--eval_tfrecords", eval_rec,
            "--eval_every_steps", "3"]
    runs = []
    for steps in (4, 6):
        matching.reset_exit_tests()
        t0 = time.perf_counter()
        with quiet:
            if cli_train.main(args + ["--max_number_of_steps", str(steps)]):
                raise AssertionError("train CLI failed")
        torch.cuda.synchronize()
        runs.append({"seconds": time.perf_counter() - t0,
                     "hungarian_calls": matching.EXIT_TESTS["calls"],
                     "hungarian_exit_tests": matching.EXIT_TESTS["tests"],
                     "checkpoints": CheckpointManager(logdir).all_steps()})
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    steps_logged = [r for r in logged if "loss" in r]
    evals = [r for r in logged if "eval/AP@0.5" in r]
    # the resumed run matched 2 batches, not 6: it went on from step 4
    if [r["hungarian_calls"] for r in runs] != [4, 2] or runs[0]["checkpoints"] != [4] \
            or runs[1]["checkpoints"] != [4, 6]:
        raise AssertionError(f"train CLI runs {runs}")
    if [r["step"] for r in steps_logged] != [4, 6] or [r["step"] for r in evals] != [3, 6]:
        raise AssertionError(f"logged {[(r['step'], sorted(r)[:2]) for r in logged]}")
    if not all(math.isfinite(v) for r in logged for v in r.values()):
        raise AssertionError(f"non-finite metrics: {logged}")

    det_path = os.path.join(root, "detections.pkl")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with quiet:
        if cli_detect.main(["--tfrecords", eval_rec, "--priors", priors_path,
                            "--checkpoint_path", logdir, "--output", det_path,
                            "--config", "configs/cub_detect.yaml"]):
            raise AssertionError("detect CLI failed")
    detect_seconds = time.perf_counter() - t0
    with quiet:
        if cli_evaluate.main(["--tfrecords", eval_rec, "--detections", det_path,
                              "--config", "configs/cub_detect.yaml"]):
            raise AssertionError("evaluate CLI failed")
    counts = kernels.launch_counts()
    with open(det_path, "rb") as f:
        results = pickle.load(f)
    metrics = cli_evaluate.evaluate(results, [eval_rec], det_cfg)
    images = 32 + jpeg
    batches = -(-images // det_cfg.batch_size)
    if len(results) != images or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"detections {len(results)}, metrics {metrics}")
    # B1 once a batch in each of the two periodic evals and in detect; the
    # config leaves use_pallas unset: no other kernel runs on this path
    want = {"nms": 3 * batches, "fused_matmul": 0, "fused_matmul_backward": 0,
            "box_decode": 0, "box_encode": 0, "match": 0}
    if counts != want:
        raise AssertionError(f"cli launch counts {counts}, expected {want}")

    # the data layer alone, as the train CLI reads (shuffled, repeated): the
    # first batch waits for the 512-record shuffle buffer
    stream = iter(DetectionDataset([train_rec], batch_size=train_cfg.batch_size,
                                   canvas_size=canvas, max_num_bboxes=train_cfg.max_num_bboxes,
                                   shuffle=True, repeat=True, seed=train_cfg.seed))
    t0 = time.perf_counter()
    batch = next(stream)
    t1 = time.perf_counter()
    for _ in range(6):
        next(stream)
    out.update({"data_reader": "native (read_records' default)",
                "data_first_batch_s": t1 - t0,
                "data_ms_per_batch": (time.perf_counter() - t1) * 1e3 / 6})
    stream.close()
    out.update(hungarian_on_the_card(batch["boxes"], batch["num_boxes"], priors))
    # each checkpoint is some 350 MB; the train records stay for phase ssd
    shutil.rmtree(logdir, ignore_errors=True)

    ips = [r["images_per_sec"] for r in steps_logged]
    out.update({
        "ok": True, "launches": counts, "train_runs": runs,
        "train_loop_images_per_s_logged": ips,
        "train_loop_ms_per_step": [train_cfg.batch_size * 1e3 / x for x in ips],
        "hungarian_exit_tests_per_step": [r["hungarian_exit_tests"] / r["hungarian_calls"]
                                          for r in runs],
        "loss_at": {r["step"]: r["loss"] for r in steps_logged},
        "eval_at": {r["step"]: {k[5:]: r[k] for k in ("eval/AP@0.5", "eval/recall@0.5",
                                                      "eval/num_images")} for r in evals},
        "detect_cli_seconds": detect_seconds, "detect_images": images,
        "detect_cli_images_per_s": images / detect_seconds,
        "eval_metrics": metrics})
    emit(out)
    return counts, train_rec


# --------------------------------------------------------------------------
# data parallelism: two ranks, an NCCL group, the sharded detect and its CLI
# --------------------------------------------------------------------------

PAR_STEPS = 3
# The parallel phase's tolerances against the one-process run, relative,
# as measured on an H100 (PERF.md, section 6): step 1's loss,
# one forward whose BatchNorm statistics sum in another order, with the
# bf16 backbone as shipped (measured 1.6e-3: bf16 roundings that flip) and
# with a float32 one (measured 1.1e-6); step 2's, one update in (measured
# 3.1e-3; a halved gradient moves it by 7.1e-2, and the phase checks that it
# moves it by more than twice the tolerance); steps 3-4 (measured up to
# 6.8e-3); the sharded detect's boxes and scores (absolute; the JAX package's multi-host
# detect test's; measured 0) and the detect CLI's file under torchrun
# (exactly the one-process file's, as measured: the same convolutions on
# batches of the same shape).
PAR_TOL = {"step1": 5e-3, "step1_f32": 1e-4, "step2": 2e-2, "band": 3e-2,
           "detect": 1e-4, "detect_cli": 0.0}
DETECT_RECORDS, DETECT_BATCH = 37, 8


def parallel_config():
    """configs/voc_train.yaml at full width with greedy matching and
    use_pallas: true, so that B4, B2, B2' and B3b run; every step logged."""
    from multibox_tpu_torch.config import parse_config_file

    return dataclasses.replace(parse_config_file("configs/voc_train.yaml"), use_pallas=True,
                               matching="greedy", log_every_steps=1)


def tree_digest(tree) -> str:
    """sha256 over every tensor's bytes (and every other leaf's repr) in
    key order."""
    h = hashlib.sha256()
    for k in sorted(tree):
        v = tree[k]
        h.update(str(k).encode())
        if isinstance(v, dict):
            h.update(tree_digest(v).encode())
        elif isinstance(v, torch.Tensor):
            h.update(v.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(v).encode())
    return h.hexdigest()


def logged_steps(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if "loss" in line]


def local_records(n, rank, world):
    return len(range(rank, n, world))


def parallel_worker(spec_path) -> int:
    """One rank of the phase ``parallel`` (``--parallel_worker SPEC``):
    joins the process group the environment describes and runs the runs
    ``spec["kind"]`` names; writes its results to ``<spec["out"]>.rank<r>``."""
    import torch.distributed as dist

    from multibox_tpu_torch.data.pipeline import DetectionDataset
    from multibox_tpu_torch.parallel import init_data_parallel, mesh
    from multibox_tpu_torch.priors import load_priors

    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    out = {"rank": rank}
    path = f"{spec['out']}.rank{rank}"

    def write():
        with open(path, "w") as f:
            json.dump(out, f)

    if spec["kind"] == "probe":  # NCCL with two ranks on one card
        try:
            init_data_parallel(backend="nccl", device="cuda:0", timeout_s=30)
            t = torch.ones(1, device="cuda:0")
            dist.all_reduce(t)
            torch.cuda.synchronize()
            out["result"] = f"all_reduce ran: {t.item()}"
        except Exception as e:  # the finding itself: recorded, then reported
            out["result"] = f"{type(e).__name__}: {e}"[:600]
        write()
        os._exit(0)  # no teardown of a failed communicator

    init_data_parallel(backend=spec["backend"], device=spec["device"], timeout_s=300)
    device = resolve_device(spec["device"])
    out.update(world=mesh.world_size(), backend=dist.get_backend(), device=str(device))
    if spec["kind"] == "coco2":  # phase coco_dp (e): coco_dp's step over the global batch
        from multibox_tpu_torch.config import parse_config_file

        cfg = dataclasses.replace(parse_config_file(spec["config"]), batch_size=spec["batch"])
        priors = load_priors(spec["priors"])
        cfg.num_priors = priors.shape[0]
        mesh.time_collectives(True)
        mesh.reset_collective_counts()
        kernels.reset_launch_counts()
        state = train_loop.train(cfg, [spec["records"]], priors, spec["logdir"],
                                 max_steps=spec["steps"], schedule_total=spec["steps"],
                                 shuffle=False, device=spec["device"])
        torch.cuda.synchronize()
        out["coco"] = {"launches": kernels.launch_counts(), "collectives": dict(mesh.COLLECTIVES),
                       "collective_ms": mesh.collective_ms(),
                       "digest": tree_digest(state.to_dict()),
                       "gradient_bytes": sum(v.numel() * v.element_size()
                                             for v in state.params.values())}
        write()
        return 0
    cfg = parallel_config()
    priors = load_priors(spec["priors"])
    steps = spec["steps"]

    def run(logdir, max_steps, run_cfg=cfg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = train_loop.train(run_cfg, [spec["records"]], priors, logdir,
                                 max_steps=max_steps, schedule_total=steps, shuffle=False,
                                 device=spec["device"])
        torch.cuda.synchronize()
        return state, time.perf_counter() - t0

    if spec["kind"] == "nccl1":  # (c): one rank in an NCCL group
        kernels.reset_launch_counts()
        state, seconds = run(spec["logdir_c"], 2)
        out["c"] = {"launches": kernels.launch_counts(), "seconds": seconds,
                    "device_resolved": str(resolve_device(None))}
        del state
        # each collective of parallel.mesh once on the card over NCCL (with one
        # rank the step itself issues none)
        g = [torch.randn(1000, device=device), torch.randn(10, 10, device=device)]
        want = [x.clone() for x in g]
        mesh.all_reduce_tensors(g, "gradients")
        x = torch.randn(5, device=device, requires_grad=True)
        mesh.all_reduce_sum(x, "batch_norm").mul(3.0).sum().backward()
        b = torch.arange(4.0, device=device)
        dist.broadcast(b, 0)
        parts = [torch.empty(3, device=device)]
        dist.all_gather(parts, torch.full((3,), 7.0, device=device))
        dist.barrier(device_ids=[device.index])
        torch.cuda.synchronize()
        ok = (all(torch.equal(a, w) for a, w in zip(g, want)) and torch.equal(
            x.grad, torch.full_like(x, 3.0)) and torch.equal(parts[0], torch.full_like(
                parts[0], 7.0)) and torch.equal(b, torch.arange(4.0, device=device)))
        if not ok:
            raise AssertionError("an NCCL collective of parallel.mesh gave a wrong result")
        out["c"]["nccl_ops"] = ("all_reduce of a flat buffer, the differentiable sum forward "
                                "and backward, broadcast, all_gather, barrier")
        write()
        return 0

    # (b): the 2-rank run
    mesh.time_collectives(True)
    mesh.reset_collective_counts()
    kernels.reset_launch_counts()
    state_b, seconds = run(spec["logdir_b"], steps)
    out["b"] = {"launches": kernels.launch_counts(), "seconds": seconds,
                "collectives": dict(mesh.COLLECTIVES), "collective_ms": mesh.collective_ms(),
                "digest": tree_digest(state_b.to_dict()),
                "gradient_bytes": sum(v.numel() * v.element_size()
                                      for v in state_b.params.values())}
    mesh.time_collectives(False)
    # step 1 again with a float32 backbone
    run(spec["logdir_b"] + "_f32", 1, dataclasses.replace(cfg, compute_dtype="float32"))
    # (d): stopped at step 2, resumed to the end
    kernels.reset_launch_counts()
    run(spec["logdir_d"], 2)
    state_d, _ = run(spec["logdir_d"], steps)
    out["d"] = {"launches": kernels.launch_counts(), "digest": tree_digest(state_d.to_dict()),
                "params_max_abs_diff_vs_b": max(
                    float((state_d.params[k] - v).detach().abs().max())
                    for k, v in state_b.params.items())}
    del state_d
    # (e): the sharded detect over (b)'s final state
    dcfg = dataclasses.replace(cfg, batch_size=DETECT_BATCH)
    dataset = DetectionDataset([spec["detect_records"]], batch_size=DETECT_BATCH,
                               canvas_size=dcfg.input_size, max_num_bboxes=dcfg.max_num_bboxes,
                               shard_index=rank, shard_count=mesh.world_size())
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    results = inference.run_detect_loop(dcfg, state_b.detect_variables(), dataset, priors,
                                        device=device)
    torch.cuda.synchronize()
    local = local_records(DETECT_RECORDS, rank, mesh.world_size())
    out["e"] = {"launches": kernels.launch_counts(), "local_images": local,
                "local_batches": -(-local // DETECT_BATCH), "results": len(results)}
    if rank == 0:
        with open(spec["detect_out"], "wb") as f:
            pickle.dump(results, f)
    write()
    return 0


def run_ranks(root, name, spec, world, timeout):
    """``world`` processes of ``chip_smoke.py --parallel_worker`` with the
    environment torchrun gives its ranks; their logs under ``root``. Raises
    (with the logs' ends) unless each exits 0; returns their results."""
    spec = dict(spec, out=os.path.join(root, name))
    spec_path = os.path.join(root, f"{name}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    port = free_port()
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(root, f"{name}.rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel_worker", spec_path],
            env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
            stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    results = []
    for r in range(world):
        path = f"{spec['out']}.rank{r}"
        results.append(json.load(open(path)) if os.path.exists(path) else None)
    return codes, results


def require_ranks(root, name, codes, results):
    if codes != [0] * len(codes) or None in results:
        tails = []
        for r in range(len(codes)):
            with open(os.path.join(root, f"{name}.rank{r}.log")) as f:
                tails.append(f"rank {r} (exit {codes[r]}):\n" + f.read()[-3000:])
        raise AssertionError(f"parallel {name}: " + "\n".join(tails))
    return results


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def compare_detections(got, want, what, atol):
    """The same image ids, no duplicate, counts exact, boxes and scores
    within ``atol``; returns the largest difference."""
    ids = [r["image_id"] for r in got]
    if len(set(ids)) != len(ids) or set(ids) != {r["image_id"] for r in want}:
        raise AssertionError(f"{what}: image ids {sorted(ids)[:5]}... differ or repeat")
    ref, worst = {r["image_id"]: r for r in want}, 0.0
    for g in got:
        w = ref[g["image_id"]]
        if len(g["scores"]) != len(w["scores"]) or not np.array_equal(g["classes"],
                                                                      w["classes"]):
            raise AssertionError(f"{what}: {g['image_id']} has {len(g['scores'])} "
                                 f"detections against {len(w['scores'])}")
        if len(g["scores"]):
            worst = max(worst, float(np.abs(g["boxes"] - w["boxes"]).max()),
                        float(np.abs(g["scores"] - w["scores"]).max()))
    if worst > atol:
        raise AssertionError(f"{what}: boxes or scores {worst} apart (tolerance {atol})")
    return worst


def check_rank_shapes(rng, cfg, train_rows, detect_rows):
    """Each kernel of the phase against its plain version at the shapes
    one rank gives it, which no other phase reaches: a train rank's head
    (B2 forward, B2' backward), matching (B4) and encoding (B3b) at
    ``train_rows`` images; a detect rank's head (B2), decoding (B3a) and
    NMS (B1) at ``detect_rows``. Tolerances as in the kernels phase: B2 and
    B2' float32 rtol 1e-4 / atol 1e-4, B1 and B4 exact, B3 bitwise."""
    P, G = cfg.num_priors, cfg.max_num_bboxes
    out = {}

    def head(n):  # the head's three layers at n images (an 8×8 grid, P priors)
        return (("Bottleneck", 64 * n, 2048, 96, True), ("Locations", n, 6144, 4 * P, False),
                ("Confidences", n, 6144, P, False))

    for what, n in (("train", train_rows), ("detect", detect_rows)):
        for name, M, Kd, N, relu in head(n):
            e = forward_entry(f"{name}_rows{n}", *matmul_inputs(rng, M, Kd, N, torch.float32),
                              relu)
            out[f"fused_matmul_{what}_{name}"] = {k: e[k] for k in (
                "M", "K", "N", "route", "split_k", "max_abs_err", "ms", "plain_ms")}
    for name, M, Kd, N, relu in head(train_rows):
        e = backward_entry(f"{name}_rows{train_rows}", *backward_inputs(rng, M, Kd, N), relu)
        out[f"fused_matmul_backward_train_{name}"] = {k: e[k] for k in (
            "M", "K", "N", "max_abs_err", "ms", "plain_ms")}

    tg = dev(random_boxes(rng, (train_rows, G)))
    tn = dev(rng.integers(1, G + 1, train_rows).astype(np.int32))
    tp = dev(random_boxes(rng, (P,)))
    got = match_kernel.greedy_match_cuda(tg, tn, tp)
    if not torch.equal(got, match_kernel.greedy_match_plain(tg, tn, tp)):
        raise AssertionError(f"match at a train rank's B={train_rows}: assignments differ")
    out["match_train"] = f"B={train_rows} G={G} P={P}: exact"
    for kind, n in (("box_encode", train_rows), ("box_decode", detect_rows)):
        a = dev(rng.normal(0, 0.3, (n, P, 4)).astype(np.float32))
        if kind == "box_encode":
            pairs = [(box_kernel.encode_boxes_cuda(a, tp), box_kernel.encode_boxes_plain(
                a, tp[None]))]
        else:
            pairs = [(box_kernel.decode_boxes_cuda(a, tp, clip), box_kernel.decode_boxes_plain(
                a, tp[None], clip)) for clip in (True, False)]
        if not all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in pairs):
            raise AssertionError(f"{kind} at B={n} P={P} differs")
        out[kind] = f"B={n} P={P}: bitwise"
    b, sc = random_boxes(rng, (detect_rows, P)), rng.uniform(0, 1, (detect_rows, P))
    nms_exact(f"detect_rank_b{detect_rows}", dev(b), dev(sc.astype(np.float32)),
              cfg.max_detections, cfg.nms_iou_threshold, cfg.detect_score_threshold)
    out["nms_detect"] = f"B={detect_rows} P={P} K={cfg.max_detections}: exact"
    torch.cuda.synchronize()
    return out


def rank_ordered_records(src, dst, world, local):
    """A copy of the records at ``src`` laid out so that ``world`` ranks,
    each reading ``local`` rows a step from its round-robin shard
    (``DetectionDataset``'s rule, the JAX package's), read in rank order the
    batches one process reads from ``src`` (no shuffling): record
    ``world·(s·local + j) + r`` is ``src``'s ``(s·world + r)·local + j``."""
    from multibox_tpu_torch.data.tfrecord import TFRecordWriter, read_records

    recs = list(read_records([src]))
    if len(recs) % (world * local):
        raise ValueError(f"{len(recs)} records are not whole global batches of "
                         f"{world * local}")
    out = [None] * len(recs)
    for i, rec in enumerate(recs):
        step, g = divmod(i, world * local)
        r, j = divmod(g, local)
        out[world * (step * local + j) + r] = rec
    with TFRecordWriter(dst) as w:
        for rec in out:
            w.write(rec)


def phase_parallel(rng, card_line, records, priors_path):
    """Data parallelism at configs/voc_train.yaml's full width (Inception-v3
    299, P = 256, global batch 32, G = 16; use_pallas=True and greedy
    matching, so B4, B2, B2' and B3b run; augmentation on, no shuffling) on
    the cli phase's records: (a) ``train.loop.train`` in one process; (b)
    the same call in two ranks of 16 rows each, on a copy of the records in
    rank order (``rank_ordered_records``: the ranks' global batches are
    (a)'s, so every image is augmented alike) (two processes sharing one
    card over gloo, or a card each over NCCL where there are two); (c) one
    rank in an NCCL group; (d) the 2-rank run stopped at step 2 and resumed;
    (e) ``run_detect_loop`` over a 2-way sharded dataset against one
    process; (f) ``cli.detect`` under torchrun against one process. Where
    one card is all there is, NCCL with two ranks on it is tried and its
    error recorded. Returns the launch counts of the phase."""
    from multibox_tpu_torch.cli import detect as cli_detect
    from multibox_tpu_torch.data import _native
    from multibox_tpu_torch.priors import load_priors

    root = os.path.abspath(os.path.join(".work", "chip_smoke_parallel"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_phase = time.perf_counter()
    cfg = parallel_config()
    det_rec = os.path.join(root, "detect.tfrecord")
    write_records(rng, det_rec, DETECT_RECORDS, cfg.input_size, 1000)
    priors = load_priors(priors_path)
    # the libraries are built before anything is spawned
    _native.reader_library()
    kernels.load_library()
    cards = torch.cuda.device_count()
    two = "nccl" if cards >= 2 else "gloo"
    rank_shapes = check_rank_shapes(rng, cfg, cfg.batch_size // 2, DETECT_BATCH)
    # the two ranks read the records in rank order: their global batches are (a)'s
    records_b = os.path.join(root, "train_rank_order.tfrecord")
    rank_ordered_records(records, records_b, 2, cfg.batch_size // 2)
    out = {"phase": "parallel", "card": card_line, "cards": cards,
           "config": "configs/voc_train.yaml with use_pallas: true and matching: greedy "
                     f"(inception_v3 {cfg.input_size}, P={cfg.num_priors}, global batch "
                     f"{cfg.batch_size}, G={cfg.max_num_bboxes}, {cfg.compute_dtype} backbone, "
                     "augmentation on, no shuffling)",
           "two_ranks": ("two processes sharing one card (gloo, CUDA tensors); times not a "
                         "scaling figure") if two == "gloo" else "two cards, one a rank (NCCL)",
           "tolerances": PAR_TOL, "kernels_at_rank_shapes": rank_shapes}
    total = {}
    want_step = {"match": 1, "fused_matmul": 3, "fused_matmul_backward": 3, "box_encode": 1}

    # (a) one process, no group
    logdir_a = os.path.join(root, "a")
    state_a, counts = counted(lambda: train_loop.train(
        cfg, [records], priors, logdir_a, max_steps=PAR_STEPS, schedule_total=PAR_STEPS,
        shuffle=False, device=DEV),
        {k: v * PAR_STEPS for k, v in want_step.items()}, "parallel (a)")
    add_counts(total, counts)
    del state_a
    logged_a = logged_steps(logdir_a)
    loss_a = [r["loss"] for r in logged_a]
    # what the tolerances are held against: step 1 with a float32 backbone,
    # and step 2 after an update with half the gradient (RMSProp with
    # epsilon 1.0 inside the root is linear in small gradients: half the
    # learning rate stands for it)
    kernels.reset_launch_counts()
    for name, steps, run_cfg in (
            ("a_f32", 1, dataclasses.replace(cfg, compute_dtype="float32")),
            ("a_half", 2, dataclasses.replace(
                cfg, initial_learning_rate=cfg.initial_learning_rate / 2))):
        train_loop.train(run_cfg, [records], priors, os.path.join(root, name),
                         max_steps=steps, schedule_total=PAR_STEPS, shuffle=False, device=DEV)
    add_counts(total, kernels.launch_counts())
    torch.cuda.empty_cache()
    loss_a32 = logged_steps(os.path.join(root, "a_f32"))[0]["loss"]
    half = rel(logged_steps(os.path.join(root, "a_half"))[1]["loss"], loss_a[1])
    if not PAR_TOL["step2"] < half / 2:
        raise AssertionError(f"a halved gradient moves step 2's loss by {half}: the "
                             f"tolerance {PAR_TOL['step2']} would not see it")

    # (b), (d), (e): two ranks
    spec = {"kind": "train2", "backend": None if two == "nccl" else "gloo",
            "device": None if two == "nccl" else "cuda:0", "priors": priors_path,
            "records": records_b, "steps": PAR_STEPS, "detect_records": det_rec,
            "logdir_b": os.path.join(root, "b"), "logdir_d": os.path.join(root, "d"),
            "detect_out": os.path.join(root, "detect_2ranks.pkl")}
    t0 = time.perf_counter()
    ranks = require_ranks(root, "train2", *run_ranks(root, "train2", spec, 2, timeout=600))
    seconds_ranks = time.perf_counter() - t0
    logged_b = logged_steps(spec["logdir_b"])
    loss_b = [r["loss"] for r in logged_b]
    if [r["step"] for r in logged_b] != list(range(1, PAR_STEPS + 1)):
        raise AssertionError(f"(b) metrics.jsonl steps {[r['step'] for r in logged_b]}")
    if ranks[0]["b"]["digest"] != ranks[1]["b"]["digest"]:
        raise AssertionError("(b): the two ranks' states differ after the run")
    for r in ranks:
        if r["b"]["launches"] != counts or r["d"]["launches"] != counts:
            raise AssertionError(f"rank {r['rank']} launches {r['b']['launches']} / "
                                 f"{r['d']['launches']}, one process {counts}")
        add_counts(total, r["b"]["launches"])
        add_counts(total, r["d"]["launches"])
    diffs = [rel(b, a) for a, b in zip(loss_a, loss_b)]
    diff32 = rel(logged_steps(spec["logdir_b"] + "_f32")[0]["loss"], loss_a32)
    if not (diffs[0] <= PAR_TOL["step1"] and diffs[1] <= PAR_TOL["step2"]
            and max(diffs) <= PAR_TOL["band"] and diff32 <= PAR_TOL["step1_f32"]):
        raise AssertionError(f"(b) losses {loss_b} against (a) {loss_a}: {diffs}; "
                             f"step 1 in float32 {diff32}")
    logged_d = logged_steps(spec["logdir_d"])
    loss_d = [r["loss"] for r in logged_d]
    resume = [rel(d, b) for b, d in zip(loss_b, loss_d)]
    if [r["step"] for r in logged_d] != list(range(1, PAR_STEPS + 1)) or \
            CheckpointManager(spec["logdir_d"]).all_steps() != [2, PAR_STEPS] or \
            any(r["d"]["digest"] != r["b"]["digest"] for r in ranks):
        raise AssertionError(f"(d) resumed run: {loss_d} against {loss_b}; the final "
                             "state must be (b)'s bit for bit")
    rank0 = ranks[0]["b"]
    ms_a = [cfg.batch_size * 1e3 / r["images_per_sec"] for r in logged_a[1:]]
    ms_b = [cfg.batch_size * 1e3 / r["images_per_sec"] for r in logged_b[1:]]
    out.update({
        "a": {"loss": loss_a, "ms_per_step": ms_a, "launches": counts},
        "b": {"loss": loss_b, "rel_diff_vs_a": diffs, "ms_per_step": ms_b,
              "step1_f32_rel_diff_vs_a": diff32, "step2_rel_diff_of_a_halved_gradient": half,
              "replicas_bitwise_equal": True, "backend": ranks[0]["backend"],
              "devices": [r["device"] for r in ranks],
              "launches_per_rank": rank0["launches"],
              "collectives_per_step": {k: v / PAR_STEPS for k, v in rank0["collectives"].items()},
              "gradient_all_reduce_bytes": rank0["gradient_bytes"],
              "collective_ms_per_step_rank0": {k: v / PAR_STEPS
                                               for k, v in rank0["collective_ms"].items()},
              "metrics_jsonl_steps": [r["step"] for r in logged_b]},
        "d": {"loss": loss_d, "rel_diff_vs_b": resume,
              "params_max_abs_diff_vs_b": ranks[0]["d"]["params_max_abs_diff_vs_b"],
              "state_bitwise_equal_to_b": True, "checkpoints": [2, PAR_STEPS]},
        "ranks_seconds": seconds_ranks})

    # (e) the sharded detect against one process, on (b)'s final state
    dcfg = dataclasses.replace(cfg, batch_size=DETECT_BATCH)
    model = inference.build_model(dcfg, priors.shape[0], device=DEV)
    state = CheckpointManager(spec["logdir_b"]).restore(
        train_state.create_train_state(dcfg, model, SEED, priors.shape[0], device=DEV),
        device=DEV)
    from multibox_tpu_torch.data.pipeline import DetectionDataset

    batches = -(-DETECT_RECORDS // DETECT_BATCH)
    want, counts_e = counted(lambda: inference.run_detect_loop(
        dcfg, state.detect_variables(), DetectionDataset(
            [det_rec], batch_size=DETECT_BATCH, canvas_size=dcfg.input_size,
            max_num_bboxes=dcfg.max_num_bboxes), priors, device=DEV),
        {"nms": batches, "fused_matmul": 3 * batches, "box_decode": batches}, "(e) one process")
    add_counts(total, counts_e)
    del model, state
    with open(spec["detect_out"], "rb") as f:
        got = pickle.load(f)
    check_results(got, DETECT_RECORDS, dcfg.max_detections)
    worst_e = compare_detections(got, want, "(e) sharded detect", PAR_TOL["detect"])
    for r in ranks:
        n = r["e"]["local_batches"]
        if r["e"]["launches"] != {**{k: 0 for k in counts_e}, "nms": n, "fused_matmul": 3 * n,
                                  "box_decode": n} or r["e"]["results"] != DETECT_RECORDS:
            raise AssertionError(f"(e) rank {r['rank']}: {r['e']}")
        add_counts(total, r["e"]["launches"])
    out["e"] = {"images": DETECT_RECORDS, "batch_a_rank": DETECT_BATCH,
                "local_images": [r["e"]["local_images"] for r in ranks],
                "launches_per_rank": [r["e"]["launches"] for r in ranks],
                "max_abs_diff_vs_one_process": worst_e}

    # (c) one rank in an NCCL group on cuda:0
    (c,) = require_ranks(root, "nccl1", *run_ranks(
        root, "nccl1", dict(spec, kind="nccl1", backend=None, device=None, records=records,
                            logdir_c=os.path.join(root, "c")), 1, timeout=300))
    loss_c = [r["loss"] for r in logged_steps(os.path.join(root, "c"))]
    if c["backend"] != "nccl" or c["c"]["launches"] != {
            k: want_step.get(k, 0) * 2 for k in counts}:
        raise AssertionError(f"(c): {c}")
    add_counts(total, c["c"]["launches"])
    out["c"] = {"backend": c["backend"], "device": c["c"]["device_resolved"], "loss": loss_c,
                "rel_diff_vs_a": [rel(x, a) for x, a in zip(loss_c, loss_a)],
                "launches": c["c"]["launches"], "nccl_ops": c["c"]["nccl_ops"]}

    # (f) the detect CLI under torchrun against the one-process CLI
    f1, f2 = os.path.join(root, "detect_cli_1.pkl"), os.path.join(root, "detect_cli_2.pkl")
    args = ["--tfrecords", det_rec, "--priors", priors_path, "--checkpoint_path",
            spec["logdir_b"], "--config", "configs/voc_train.yaml"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "multibox_tpu_torch.cli.detect", *args, "--output", f2]
    if two == "gloo":
        cmd += ["--device", "cuda:0", "--dist_backend", "gloo"]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    seconds_f = time.perf_counter() - t0
    if done.returncode != 0:
        raise AssertionError(f"(f) torchrun detect CLI exit {done.returncode}:\n"
                             f"{done.stderr[-3000:]}")
    writes = done.stdout.count("image results to")
    with contextlib.redirect_stdout(sys.stderr):
        _, counts_f = counted(lambda: cli_detect.main(args + ["--output", f1]),
                              {"nms": -(-DETECT_RECORDS // cfg.batch_size)}, "(f) one process")
    add_counts(total, counts_f)
    with open(f1, "rb") as f:
        want_f = pickle.load(f)
    with open(f2, "rb") as f:
        got_f = pickle.load(f)
    worst_f = compare_detections(got_f, want_f, "(f) detect CLI", PAR_TOL["detect_cli"])
    if writes != 1:
        raise AssertionError(f"(f): {writes} ranks wrote the output")
    out["f"] = {"command": "python3 -m torch.distributed.run --standalone --nproc_per_node 2 "
                           "-m multibox_tpu_torch.cli.detect ..." + (
                               " --device cuda:0 --dist_backend gloo" if two == "gloo" else ""),
                "seconds": seconds_f, "writers": writes, "images": len(got_f),
                "max_abs_diff_vs_one_process": worst_f}

    if cards == 1:  # NCCL with two ranks on one card: the finding, as the card gives it
        codes, probe = run_ranks(root, "probe", {"kind": "probe"}, 2, timeout=60)
        out["nccl_two_ranks_one_card"] = [p["result"] if p else f"exit {c}, no result"
                                          for c, p in zip(codes, probe)]
    shutil.rmtree(root, ignore_errors=True)  # checkpoints of some 350 MB each
    out.update({"ok": True, "launches": total, "seconds": time.perf_counter() - t_phase})
    emit(out)
    return total


# --------------------------------------------------------------------------
# configs/coco_dp.yaml: 80 classes, Hungarian at G=64 P=512, global batch 256
# --------------------------------------------------------------------------

# COCO 2017's 80 category ids: 1-90 with its gaps
COCO_IDS = (*range(1, 12), *range(13, 26), 27, 28, *range(31, 45), *range(46, 66), 67, 70,
            *range(72, 83), *range(84, 91))
# records: train, eval, and train images that hold MAX_NUM_BBOXES = 64 boxes
COCO_TRAIN, COCO_EVAL, COCO_FULL = 256, 64, 8
COCO_STEPS = 4  # COCO_STEPS - 1 steps, then resumed to COCO_STEPS, against it straight
# the two ranks' global batch (reduced from 256) and steps
COCO_DP_BATCH, COCO_DP_STEPS = 64, 2
# (e)'s tolerances against one process, relative, about ten times what the
# H100 gave (PERF.md, section 6): step 1's loss (measured 3.7e-5) and step
# 2's (7.4e-5; the phase checks that a halved gradient moves it by more
# than twice this)
COCO_DP_TOL = {"step1": 4e-4, "step2": 8e-4}


def coco_records(rng, root, canvas):
    """Seeded JPEGs at COCO-like sizes (500 × 375 and 375 × 500) and a COCO
    instances file for each split, whose categories are COCO 2017's 80 ids
    with their gaps: 1-20 boxes an image, 64 in ``COCO_FULL`` training
    images, a crowd region in a few (skipped, as the dataset CLI does by
    default) → ``cli.dataset.main --coco --remap_categories`` (the train
    split with raw canvases of ``canvas`` px) → every record parsed back to
    its annotation, labels renumbered 1..80. Returns the splits' record
    files and what was written."""
    from PIL import Image

    from multibox_tpu_torch.cli import dataset as cli_dataset
    from multibox_tpu_torch.data.example_proto import parse_detection_example
    from multibox_tpu_torch.data.tfrecord import read_records

    images = os.path.join(root, "images")
    os.makedirs(images)
    cats = [{"id": c, "name": f"category {c}"} for c in COCO_IDS]
    remap = {c: i + 1 for i, c in enumerate(COCO_IDS)}
    files, info = {}, {"boxes": 0, "crowd_skipped": 0, "images_with_64_boxes": 0}
    for split, first, n in (("train", 0, COCO_TRAIN), ("eval", COCO_TRAIN, COCO_EVAL)):
        coco = {"images": [], "annotations": [], "categories": cats}
        want = {}
        for i in range(first, first + n):
            h, w = (375, 500) if i % 2 else (500, 375)
            full = split == "train" and i % (COCO_TRAIN // COCO_FULL) == 0
            img, boxes = photo(rng, h, w, n=64 if full else int(rng.integers(1, 21)),
                               min_size=0.04, max_size=0.4)
            ids = rng.choice(COCO_IDS, len(boxes))
            Image.fromarray(img).save(os.path.join(images, f"im{i}.jpg"), quality=90)
            coco["images"].append({"id": i, "file_name": f"im{i}.jpg", "height": h, "width": w})
            for (y0, x0, y1, x1), c in zip(boxes.astype(np.float64), ids):
                coco["annotations"].append({"image_id": i, "category_id": int(c), "iscrowd": 0,
                                            "bbox": [x0 * w, y0 * h, (x1 - x0) * w,
                                                     (y1 - y0) * h]})
            if i % 40 == 7:
                coco["annotations"].append({"image_id": i, "category_id": int(ids[0]),
                                            "iscrowd": 1, "bbox": [0.0, 0.0, w / 2, h / 2]})
                info["crowd_skipped"] += 1
            want[str(i)] = (boxes, [remap[int(c)] for c in ids])
            info["boxes"] += len(boxes)
            info["images_with_64_boxes"] += full
        path = os.path.join(root, f"coco_{split}.json")
        with open(path, "w") as f:
            json.dump(coco, f)
        extra = ["--store_raw_canvas", str(canvas)] if split == "train" else []
        with contextlib.redirect_stdout(sys.stderr):
            run_cli(cli_dataset.main, ["--annotations", path, "--coco", "--remap_categories",
                                       "--image_root", images, "--output_prefix",
                                       os.path.join(root, split, split)] + extra)
        with open(os.path.join(root, split, "label_map.json")) as f:
            if json.load(f) != {str(k): v for k, v in remap.items()}:
                raise AssertionError("dataset CLI: the category remap is not 1..80 in id order")
        files[split] = sorted(os.path.join(root, split, f)
                              for f in os.listdir(os.path.join(root, split))
                              if f.endswith(".tfrecord"))
        parsed = {}
        for rec in read_records(files[split]):
            ex = parse_detection_example(rec)
            parsed[ex["image_id"]] = ex
        if sorted(parsed) != sorted(want):
            raise AssertionError(f"dataset CLI ({split}): ids {sorted(parsed)[:4]}")
        for image_id, ex in parsed.items():
            boxes, labels = want[image_id]
            if (list(ex["labels"]) != labels
                    or not np.allclose(ex["boxes"], boxes, rtol=0, atol=1e-6)
                    or ("raw" in ex) != (split == "train")):
                raise AssertionError(f"dataset CLI ({split}): record {image_id} differs "
                                     "from its annotation")
    shutil.rmtree(images)
    return files, info


def coco_config_file(root):
    """configs/coco_dp.yaml as shipped plus the run's own settings (every
    step logged, one checkpoint kept), written to a copy in ``root``: the
    shipped file is not edited."""
    with open("configs/coco_dp.yaml") as f:
        text = f.read()
    path = os.path.join(root, "coco_dp_run.yaml")
    with open(path, "w") as f:
        f.write(text + "\n# the smoke run's settings\nlog_every_steps: 1\nkeep_checkpoints: 1\n")
    return path


@contextlib.contextmanager
def stream_resumed_at(step):
    """Within the block, each ``DetectionDataset`` that ``train.loop.train``
    makes yields ``step`` batches of its stream, then the stream a run
    resumed at ``step`` reads (the same records, shuffled with the seed
    ``cfg.seed + step``): one process then trains on the batches that a
    run stopped at ``step`` and resumed trains on."""
    real = train_loop.DetectionDataset

    def spliced(*args, **kwargs):
        def batches():
            with contextlib.closing(iter(real(*args, **kwargs))) as first:
                for _ in range(step):
                    yield next(first)
            with contextlib.closing(iter(real(*args, **dict(
                    kwargs, seed=kwargs["seed"] + step)))) as rest:
                yield from rest
        return batches()

    train_loop.DetectionDataset = spliced
    try:
        yield
    finally:
        train_loop.DetectionDataset = real


def run_cli(main, args):
    if main(args):
        raise AssertionError(f"{main.__module__} {' '.join(args)} failed")


def checkpoint_digest(logdir):
    return tree_digest(CheckpointManager(logdir).restore_raw(device="cpu"))


def head_inputs_on_card(gen, M, Kd, N):
    """:func:`backward_inputs`' distributions, drawn on the card from the
    CUDA generator ``gen`` (the Confidences weight is 1 GB)."""
    x = torch.randn(M, Kd, generator=gen, device=DEV).clamp_min_(0)
    w = torch.randn(Kd, N, generator=gen, device=DEV) / math.sqrt(Kd)
    b = torch.randn(N, generator=gen, device=DEV) * 0.1
    return x, w, b, torch.randn(M, N, generator=gen, device=DEV)


def phase_coco_dp(rng, card_line):
    """configs/coco_dp.yaml as shipped (Inception-v3 299, 80 classes with
    per-class NMS, P = 512 k-means priors, G = 64, Hungarian matching with
    dense matching at 0.5, label_offset 1, global batch 256, bf16 backbone,
    f32 head, use_pallas unset: B1 is its one kernel) through the entry
    points a user calls: (a) COCO-format files with the 80 gapped ids →
    ``cli.dataset.main --remap_categories``; (b) ``cli.priors.main``
    (k-means, 512); (c) ``cli.train.main`` at the global batch of 256 in one
    process for 3 steps (its peak memory), resumed to 4, against 4 straight steps
    in one process on the same batches (losses and checkpoint bitwise);
    stage times of a step, and Hungarian matching on the card at the step's
    own boxes (B=256, G=64, P=512); (d) ``cli.detect.main`` and
    ``cli.evaluate.main`` on the eval records, B1 exact at the path's
    inputs; B2 and B2' at the head's shapes (the route a user with
    use_pallas: true takes); (e) two ranks of 32 sharing the card over gloo
    (the global batch reduced to 64) against one process. Returns the launch
    counts and the kernel rows."""
    from multibox_tpu_torch.cli import detect as cli_detect
    from multibox_tpu_torch.cli import evaluate as cli_evaluate
    from multibox_tpu_torch.cli import priors as cli_priors
    from multibox_tpu_torch.cli import train as cli_train
    from multibox_tpu_torch.config import parse_config_file
    from multibox_tpu_torch.data.pipeline import DetectionDataset
    from multibox_tpu_torch.priors import load_priors

    root = os.path.abspath(os.path.join(".work", "chip_smoke_coco_dp"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_phase = time.perf_counter()
    quiet = contextlib.redirect_stdout(sys.stderr)  # the CLIs' own prints
    shipped = parse_config_file("configs/coco_dp.yaml")
    P, C, G = shipped.num_priors, shipped.num_classes, shipped.max_num_bboxes
    canvas = max(int(shipped.input_size * 1.15), shipped.input_size)
    out = {"phase": "coco_dp", "card": card_line,
           "config": f"configs/coco_dp.yaml as shipped (inception_v3 {shipped.input_size}, "
                     f"C={C}, P={P}, G={G}, global batch {shipped.batch_size}, matching "
                     f"{shipped.matching}, multi_match_iou {shipped.multi_match_iou}, "
                     f"label_offset {shipped.label_offset}, use_pallas {shipped.use_pallas}, "
                     f"{shipped.compute_dtype} backbone, float32 head, augmentation on a "
                     f"{canvas}-px canvas)",
           "reduced": [f"steps: {COCO_STEPS - 1} resumed to {COCO_STEPS}", f"records: {COCO_TRAIN} train, "
                       f"{COCO_EVAL} eval", f"(e): global batch {COCO_DP_BATCH} (2 x "
                       f"{COCO_DP_BATCH // 2}), {COCO_DP_STEPS} steps"]}
    total = {}

    # (a) records, (b) priors
    t0 = time.perf_counter()
    files, info = coco_records(rng, root, canvas)
    out["records"] = dict(info, train=COCO_TRAIN, eval=COCO_EVAL, seconds=time.perf_counter() - t0,
                          categories="COCO 2017's 80 ids, remapped to 1..80")
    priors_path = os.path.join(root, "priors.pkl")
    t0 = time.perf_counter()
    with quiet:
        run_cli(cli_priors.main, ["--tfrecords", *files["train"], "--output", priors_path,
                                  "--mode", "kmeans", "--num_priors", str(P)])
    priors = load_priors(priors_path)
    if priors.shape != (P, 4) or not np.isfinite(priors).all():
        raise AssertionError(f"k-means priors {priors.shape}")
    out["priors_seconds"] = time.perf_counter() - t0

    # (c) the train CLI at the global batch of 256 in one process
    logdir = os.path.join(root, "logdir")
    cfg_path = coco_config_file(root)
    args = ["--tfrecords", *files["train"], "--priors", priors_path, "--logdir", logdir,
            "--config", cfg_path, "--schedule_total_steps", str(COCO_STEPS)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    matching.reset_exit_tests()
    t0 = time.perf_counter()
    with quiet:
        counted(lambda: run_cli(cli_train.main, args + [
            "--max_number_of_steps", str(COCO_STEPS - 1)]), {}, "coco_dp train CLI")
    train_seconds, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    cfg = parse_config_file(cfg_path)
    cfg.num_priors = P
    hung_calls, hung_tests = matching.EXIT_TESTS["calls"], matching.EXIT_TESTS["tests"]
    if hung_calls != (COCO_STEPS - 1) * cfg.grad_accum_steps:
        raise AssertionError(f"{hung_calls} Hungarian calls in {COCO_STEPS - 1} steps")
    with quiet:
        counted(lambda: run_cli(cli_train.main, args + ["--max_number_of_steps",
                                                        str(COCO_STEPS)]),
                {}, "coco_dp train CLI resumed")
    logged = logged_steps(logdir)
    if [r["step"] for r in logged] != list(range(1, COCO_STEPS + 1)) or \
            CheckpointManager(logdir).all_steps() != [COCO_STEPS]:
        raise AssertionError(f"train CLI: logged {[r['step'] for r in logged]}, checkpoints "
                             f"{CheckpointManager(logdir).all_steps()}")
    # 4 straight steps in one process, on the batches the stopped and resumed
    # run read: the same losses and, bit for bit, the same checkpoint
    straight = os.path.join(root, "straight")
    with stream_resumed_at(COCO_STEPS - 1), quiet:
        counted(lambda: train_loop.train(cfg, files["train"], priors, straight,
                                         max_steps=COCO_STEPS, schedule_total=COCO_STEPS,
                                         device=DEV), {}, "coco_dp straight run")
    gc.collect()
    torch.cuda.empty_cache()
    loss_cli = [r["loss"] for r in logged]
    loss_straight = [r["loss"] for r in logged_steps(straight)]
    if loss_cli != loss_straight or not all(map(math.isfinite, loss_cli)):
        raise AssertionError(f"resumed run's losses {loss_cli}, straight {loss_straight}")
    if checkpoint_digest(logdir) != checkpoint_digest(straight):
        raise AssertionError("the resumed run's checkpoint differs from the straight run's")
    shutil.rmtree(straight)
    ms_logged = [cfg.batch_size * 1e3 / r["images_per_sec"] for r in logged]
    out["train"] = {
        "setting": "as shipped", "peak_memory_bytes": peak, "seconds_3_steps": train_seconds,
        "loss": loss_cli, "resumed_equals_straight": "losses and checkpoint bitwise",
        "ms_per_step_logged": ms_logged,
        "hungarian_calls_per_step": hung_calls / (COCO_STEPS - 1),
        "hungarian_exit_tests_per_call": hung_tests / hung_calls,
        "metrics_at_4": {k: v for k, v in logged[-1].items() if k not in ("step", "time")}}

    # a step's stages, and Hungarian on the card at the step's own boxes
    model = inference.build_model(cfg, P, device=DEV)
    state = train_state.create_train_state(cfg, model, SEED, P, device=DEV)
    stream = iter(DetectionDataset(files["train"], batch_size=cfg.batch_size, canvas_size=canvas,
                                   max_num_bboxes=G, label_offset=cfg.label_offset,
                                   num_classes=C))
    host = next(stream)
    stream.close()
    host = {k: host[k] for k in ("images", "boxes", "num_boxes", "labels")}
    if int(host["num_boxes"].max()) != G or not (0 <= host["labels"].min() and
                                                  host["labels"].max() < C):
        raise AssertionError(f"the batch holds {host['num_boxes'].max()} boxes at most, "
                             f"labels {host['labels'].min()}..{host['labels'].max()}")
    rows = cfg.batch_size // cfg.grad_accum_steps
    out["stage_ms"] = dict(train_stage_times(cfg, model, state, priors, {
        k: v[:rows] for k, v in host.items()}, reps=3), rows=rows)
    del model, state
    db = shard_batch(host, DEV)
    _, boxes, num, _ = augment.augment_batch(
        train_loop.step_generator(cfg.seed, 0, DEV), db["images"], db["boxes"],
        db["num_boxes"], cfg, labels=db["labels"])
    del db
    out["hungarian"] = hungarian_on_the_card(boxes, num, priors, all_index_equal=False)
    out["hungarian"]["boxes_after_augmentation_max"] = int(num.max())
    gc.collect()
    torch.cuda.empty_cache()

    # (d) detect and evaluate with the checkpoint: B1 at the path's inputs
    det_path = os.path.join(root, "detections.pkl")
    batches = -(-COCO_EVAL // cfg.batch_size)
    t0 = time.perf_counter()
    with nms_inputs_seen() as seen, quiet:
        _, counts = counted(lambda: run_cli(cli_detect.main, [
            "--tfrecords", *files["eval"], "--priors", priors_path, "--checkpoint_path", logdir,
            "--output", det_path, "--config", cfg_path]), {"nms": batches}, "coco_dp detect CLI")
    detect_seconds = time.perf_counter() - t0
    add_counts(total, counts)
    with quiet:
        run_cli(cli_evaluate.main, ["--tfrecords", *files["eval"], "--detections", det_path,
                                    "--config", cfg_path])
    with open(det_path, "rb") as f:
        results = pickle.load(f)
    check_results(results, COCO_EVAL, cfg.max_detections)
    classes = np.concatenate([r["classes"] for r in results])
    metrics = cli_evaluate.evaluate(results, files["eval"], cfg)
    if not (len(classes) and 0 <= classes.min() and classes.max() < C) or \
            not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"detections' classes {classes.min()}..{classes.max()}, "
                             f"metrics {metrics}")
    shape = tuple(seen[0][0].shape)
    if shape[1:] != (min(cfg.detect_candidates, P * C), 4):
        raise AssertionError(f"the per-class sweep gave B1 {shape}")
    nms_row = nms_at_path_inputs("coco_dp", seen)
    nms_row["max_coordinate_with_class_offsets"] = float(seen[0][0].max())
    out["detect"] = {"seconds": detect_seconds, "images": len(results),
                     "detections": len(classes), "classes_seen": int(len(set(classes.tolist()))),
                     "eval_metrics": metrics, "nms": nms_row, "launches": counts}
    shutil.rmtree(logdir)  # a checkpoint of some 3.4 GB
    del seen

    # B2 and B2' at the head's shapes: 256 rows (the step's batch) and 32 (a rank's)
    head, head_bwd = {}, {}
    draw = torch.Generator(device=DEV).manual_seed(SEED)
    for M in (cfg.batch_size, COCO_DP_BATCH // 2):
        for name, Kd, N in (("Locations", 6144, 4 * P), ("Confidences", 6144, P * C)):
            x, w, bias, g = head_inputs_on_card(draw, M, Kd, N)
            e = forward_entry(f"coco_dp_{name}_rows{M}", x, w, bias, False)
            head[f"{name}_rows{M}"] = {k: e[k] for k in (
                "M", "K", "N", "route", "split_k", "blocks", "max_abs_err", "ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by", "share_of_bound")}
            b = backward_entry(f"coco_dp_{name}_rows{M}", x, w, bias, g, False)
            head_bwd[f"{name}_rows{M}"] = {k: b[k] for k in (
                "M", "K", "N", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "share_of_bound")}
            del x, w, bias, g
            torch.cuda.empty_cache()
    out.update({"fused_matmul_head": head, "fused_matmul_backward_head": head_bwd})

    # (e) two ranks of 32 sharing the card over gloo against one process at 64
    cards = torch.cuda.device_count()
    dp_cfg = dataclasses.replace(cfg, batch_size=COCO_DP_BATCH)
    records_b = os.path.join(root, "train_rank_order.tfrecord")
    rank_ordered_records(files["train"][0], records_b, 2, COCO_DP_BATCH // 2)
    # one process, and what step 2's tolerance is held against: the same
    # run with half the gradient (half the learning rate, as in phase parallel)
    loss_a = {}
    for name, run_cfg in (("one_process", dp_cfg), ("halved_gradient", dataclasses.replace(
            dp_cfg, initial_learning_rate=dp_cfg.initial_learning_rate / 2))):
        logdir_a = os.path.join(root, "dp_a")
        counted(lambda: train_loop.train(run_cfg, files["train"], priors, logdir_a,
                                         max_steps=COCO_DP_STEPS, schedule_total=COCO_DP_STEPS,
                                         shuffle=False, device=DEV), {}, f"coco_dp (e) {name}")
        loss_a[name] = [r["loss"] for r in logged_steps(logdir_a)]
        shutil.rmtree(logdir_a)
        gc.collect()
        torch.cuda.empty_cache()
    loss_a, half = loss_a["one_process"], rel(loss_a["halved_gradient"][1],
                                              loss_a["one_process"][1])
    if not COCO_DP_TOL["step2"] < half / 2:
        raise AssertionError(f"(e): a halved gradient moves step 2's loss by {half}: the "
                             f"tolerance {COCO_DP_TOL['step2']} would not see it")
    spec = {"kind": "coco2", "backend": "gloo" if cards < 2 else None,
            "device": "cuda:0" if cards < 2 else None, "priors": priors_path,
            "records": records_b, "config": cfg_path, "batch": COCO_DP_BATCH,
            "steps": COCO_DP_STEPS, "logdir": os.path.join(root, "dp_b")}
    t0 = time.perf_counter()
    ranks = require_ranks(root, "coco2", *run_ranks(root, "coco2", spec, 2, timeout=600))
    seconds_ranks = time.perf_counter() - t0
    logged_b = logged_steps(spec["logdir"])
    loss_b = [r["loss"] for r in logged_b]
    diffs = [rel(b, a) for a, b in zip(loss_a, loss_b)]
    if len(loss_b) != COCO_DP_STEPS or not (diffs[0] <= COCO_DP_TOL["step1"] and
                                             diffs[1] <= COCO_DP_TOL["step2"]):
        raise AssertionError(f"(e) losses {loss_b} against one process {loss_a}: {diffs}")
    if ranks[0]["coco"]["digest"] != ranks[1]["coco"]["digest"]:
        raise AssertionError("(e): the two ranks' states differ after the run")
    zero = {k: 0 for k in counts}
    if any(r["coco"]["launches"] != zero for r in ranks):
        raise AssertionError(f"(e) launches {[r['coco']['launches'] for r in ranks]}")
    params = sum(p.numel() for p in inference.build_model(cfg, P, device="cpu").parameters())
    rank0 = ranks[0]["coco"]
    if rank0["gradient_bytes"] != 4 * params:
        raise AssertionError(f"gradient all-reduce {rank0['gradient_bytes']} bytes, the model "
                             f"has {params} float32 parameters")
    out["two_ranks"] = {
        "ranks": "two processes sharing one card (gloo, CUDA tensors); times not a scaling "
                 "figure" if cards < 2 else "two cards, one a rank (NCCL)",
        "backend": ranks[0]["backend"], "loss_one_process": loss_a, "loss": loss_b,
        "rel_diff_vs_one_process": diffs, "tolerance": COCO_DP_TOL,
        "step2_rel_diff_of_a_halved_gradient": half, "replicas_bitwise_equal": True,
        "ms_per_step": [COCO_DP_BATCH * 1e3 / r["images_per_sec"] for r in logged_b],
        "parameters": params, "gradient_all_reduce_bytes": rank0["gradient_bytes"],
        "collectives_per_step": {k: v / COCO_DP_STEPS for k, v in rank0["collectives"].items()},
        "collective_ms_per_step_rank0": {k: v / COCO_DP_STEPS
                                         for k, v in rank0["collective_ms"].items()},
        "seconds": seconds_ranks}
    shutil.rmtree(root, ignore_errors=True)  # the ranks' checkpoint, the records
    out.update({"ok": True, "launches": total, "seconds": time.perf_counter() - t_phase})
    emit(out)
    return total, {"nms_coco_dp": nms_row, "fused_matmul_coco_dp": head,
                   "fused_matmul_backward_coco_dp": head_bwd}


# --------------------------------------------------------------------------
# the SSD multi-scale and MobileNetV2 configurations
# --------------------------------------------------------------------------


@contextlib.contextmanager
def nms_inputs_seen():
    """Within the block, each ``nms_kernel.nms_select`` call of the path
    (``ops.nms.batched_nms`` calls it through the module) also records a
    copy of its boxes and scores and its arguments, so B1 can be held
    against its plain version at exactly the inputs the path gave it. A
    graphed detect loop calls the wrapper where its graph is made: the
    first entry is the eager warm-up's, the path's first batch."""
    seen, real = [], nms_kernel.nms_select

    def spy(boxes, scores, *args):
        seen.append((boxes.clone(), scores.clone(), args))
        return real(boxes, scores, *args)

    nms_kernel.nms_select = spy
    try:
        yield seen
    finally:
        nms_kernel.nms_select = real


def nms_at_path_inputs(name, seen):
    """B1 on the first input a path gave it: indices, scores and counts
    exact against the plain version, then timed (``nms_entry``)."""
    boxes, scores, (Kout, iou, thr) = seen[0]
    nms_exact(f"{name} at the path's inputs", boxes, scores, Kout, iou, thr)
    return nms_entry(name, boxes.cpu().numpy(), scores.cpu().numpy(), Kout, iou, thr, plain=True)


def augmented(cfg, state, batch):
    """The step's own augmented ``(images, boxes, num)`` of one host batch."""
    gen = train_loop.step_generator(cfg.seed, state.step, DEV)
    db = shard_batch(batch, DEV)
    return augment.augment_batch(gen, db["images"], db["boxes"], db["num_boxes"], cfg)


# B4's inputs at the paths' own step boxes, one file a path, for
# scripts/torch_kernel_design.py --match_inputs (which times an older kernel
# on them)
MATCH_INPUTS = os.path.join(".work", "chip_smoke_match")


def match_at_step_boxes(name, boxes, num, tpriors):
    """B4 on one augmented batch of the path (the step's own boxes):
    assignments exact against the plain version, then timed on its plan
    (:func:`match_timed`), with the bound from what this data needs. The
    inputs are kept in MATCH_INPUTS/<name>_B<B>_G<G>_P<P>.pt."""
    os.makedirs(MATCH_INPUTS, exist_ok=True)
    torch.save({"gt": boxes.cpu(), "num_gt": num.cpu(), "priors": tpriors.cpu()},
               os.path.join(MATCH_INPUTS, f"{name}_B{boxes.shape[0]}_G{boxes.shape[1]}"
                                          f"_P{tpriors.shape[0]}.pt"))
    got = match_kernel.greedy_match_cuda(boxes, num, tpriors)
    torch.cuda.synchronize()
    if not torch.equal(got, match_kernel.greedy_match_plain(boxes, num, tpriors)):
        raise AssertionError(f"match[{name}]: differs from the plain version on the step's boxes")
    return match_timed(boxes, num, tpriors)


def timed_steps(step_fn, state, data):
    """ms a step on the host clock over ``data[1:]``, after ``data[0]``,
    from a copy of ``state``; returns the ms and the stepped copy."""
    st = state.clone()
    st, _ = step_fn(st, data[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in data[1:]:
        st, _ = step_fn(st, b)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (len(data) - 1), st


def counted(fn, want, what):
    """Run ``fn`` with every launch count set to 0 just before; the counts
    just after must equal ``want`` (names left out: 0)."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    full = {k: want.get(k, 0) for k in counts}
    if counts != full:
        raise AssertionError(f"{what}: launch counts {counts}, expected {full}")
    return out, counts


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def overfit_one_batch(cfg, model, state, priors, batch, steps):
    ocfg = dataclasses.replace(cfg, augment=False)
    ostep = train_loop.make_augmented_train_step(ocfg, model, priors, device=DEV)
    so, losses = state.clone(), []
    for _ in range(steps):
        so, m = ostep(so, batch)
        losses.append(float(m["loss"]))
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"overfit one batch: loss {losses[0]} -> {losses[-1]}")
    return losses


def logged_losses(logdir, steps):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    losses = [r["loss"] for r in logged if "loss" in r]
    if [r["step"] for r in logged if "loss" in r][-1:] != [steps] or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train log {logged}")
    return logged


def phase_ssd(rng, gen, card_line, records, train_steps=6, overfit_steps=12):
    """configs/ssd_multiscale.yaml at full width: Inception-v3 299, the SSD
    head over Mixed_5d / Mixed_6e / Mixed_7c (35², 17², 8²), 6 priors a
    cell from ``cli.priors --mode multiscale`` (P = 9,468), batch 32, G =
    16, dense matching at 0.5, center/log-scale encoding, bf16 backbone,
    f32 head. Train with use_pallas=True (greedy matching on B4, an
    image's priors split over a cluster), overfit one batch, detect as shipped (B1 at P =
    9,468), the same model at 20 classes (train, then the per-class sweep
    into B1 at P = 1,024), and ``cli.train.main`` as shipped for 2 steps.
    Returns the launch counts of the phase and its kernel rows."""
    from multibox_tpu_torch.cli import priors as cli_priors
    from multibox_tpu_torch.cli import train as cli_train
    from multibox_tpu_torch.config import parse_config_file
    from multibox_tpu_torch.priors import load_priors

    root = os.path.join(".work", "chip_smoke_ssd")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    quiet = contextlib.redirect_stdout(sys.stderr)
    shipped = parse_config_file("configs/ssd_multiscale.yaml")
    # 35 17 8 at 299 px, as the config's header says
    sizes = [feature_grid(shipped.input_size, e) for e in shipped.ssd_endpoints]
    priors_path = os.path.join(root, "priors_ms.pkl")
    with quiet:
        if cli_priors.main(["--output", priors_path, "--mode", "multiscale",
                            "--feature_map_sizes", *map(str, sizes), "--aspect_ratios",
                            "1.0", "2.0", "0.5", "3.0", "0.333"]):
            raise AssertionError("priors CLI failed")
    priors = load_priors(priors_path)
    P = priors.shape[0]
    if P != sum(n * n for n in sizes) * shipped.ssd_priors_per_cell:
        raise AssertionError(f"multiscale priors: {P} for grids {sizes}")
    B, G = shipped.batch_size, shipped.max_num_bboxes
    cfg = dataclasses.replace(shipped, num_priors=P, use_pallas=True, log_every_steps=1)
    model = inference.build_model(cfg, P, device=DEV)
    state = train_state.create_train_state(cfg, model, SEED, P, device=DEV)
    canvas = int(cfg.input_size * 1.15)
    data = make_train_data(rng, train_steps + 1, cfg, canvas)
    total, rows = {}, {}
    out = {"phase": "ssd", "card": card_line,
           "config": f"configs/ssd_multiscale.yaml (inception_v3 {cfg.input_size}, SSD head over "
                     f"{list(cfg.ssd_endpoints)} ({sizes}), {cfg.ssd_priors_per_cell} priors a "
                     f"cell, P={P}, "
                     f"batch {B}, G={G}, multi_match_iou {cfg.multi_match_iou}, box_encoding "
                     f"{cfg.box_encoding}, {cfg.compute_dtype} backbone, float32 head); train "
                     "with use_pallas=True, detect and the CLI as shipped"}

    _, boxes, num = augmented(cfg, state, data[0])
    rows["match_ssd"] = match_at_step_boxes("ssd", boxes, num, dev(priors))
    del boxes, num
    logdir = os.path.join(root, "train")
    stream = lambda start: iter(data[start:])  # noqa: E731
    t0 = time.perf_counter()
    s, counts = counted(lambda: train_loop.train_from_batches(
        cfg, stream, priors, logdir, max_steps=train_steps, device=DEV),
        {"match": train_steps}, "ssd train")
    seconds = time.perf_counter() - t0
    add_counts(total, counts)
    logged = logged_losses(logdir, train_steps)
    shutil.rmtree(logdir, ignore_errors=True)
    del s
    step_fn = train_loop.make_augmented_train_step(cfg, model, priors, device=DEV)
    ms_step, _ = timed_steps(step_fn, state, data[:4])
    overfit = overfit_one_batch(cfg, model, state, priors, data[0], overfit_steps)
    del state, step_fn
    torch.cuda.empty_cache()
    out.update({"train_launches": counts, "train_steps": train_steps,
                "train_loop_seconds": seconds,
                "train_loss_first_last": [logged[0]["loss"], logged[-1]["loss"]],
                "train_num_pos_per_step": [r["num_pos"] for r in logged],
                "ms_per_step": ms_step, "overfit_steps": overfit_steps,
                "overfit_loss_first_last": [overfit[0], overfit[-1]]})

    # detect as shipped: B1 is the only kernel
    dcfg = dataclasses.replace(shipped, num_priors=P)
    variables = make_variables(model, gen)
    ddata = make_dataset(rng, batches=3, batch=B, valid_last=B)
    fns = inference.make_detect_loop_fns(dcfg, priors, device=DEV)
    with nms_inputs_seen() as seen:
        inference.run_detect_loop(dcfg, variables, ddata[:1], priors, fns=fns, device=DEV)
        t0 = time.perf_counter()
        results, counts = counted(lambda: inference.run_detect_loop(
            dcfg, variables, ddata, priors, fns=fns, device=DEV), {"nms": len(ddata)},
            "ssd detect")
    seconds = time.perf_counter() - t0
    add_counts(total, counts)
    check_results(results, B * len(ddata), dcfg.max_detections)
    rows["nms_ssd"] = nms_at_path_inputs("ssd", seen)
    out.update({"detect_launches": counts, "detect_batches": len(ddata),
                "detect_ms_per_batch": seconds * 1e3 / len(ddata),
                "detect_images_per_s": B * len(ddata) / seconds,
                "detections_per_image": float(np.mean([len(r["scores"]) for r in results]))})
    del variables, fns, model
    torch.cuda.empty_cache()

    # multi-class: 20 classes, 2 train steps, one detect batch
    C = 20
    mcfg = dataclasses.replace(cfg, num_classes=C)
    mmodel = inference.build_model(mcfg, P, device=DEV)
    mstate = train_state.create_train_state(mcfg, mmodel, SEED, P, device=DEV)
    mdata = make_train_data(rng, 2, mcfg, canvas)
    for b in mdata:
        b["labels"] = rng.integers(0, C, (B, G)).astype(np.int32)
    mstep = train_loop.make_augmented_train_step(mcfg, mmodel, priors, device=DEV)

    def two_steps():
        st, losses = mstate, []
        for b in mdata:
            st, m = mstep(st, b)
            losses.append(float(m["loss"]))
            if m["num_bad_labels"] != 0:
                raise AssertionError("multi-class labels out of range")
        return losses

    mlosses, counts = counted(two_steps, {"match": len(mdata)}, "ssd multi-class train")
    add_counts(total, counts)
    if not all(math.isfinite(x) for x in mlosses):
        raise AssertionError(f"multi-class loss {mlosses}")
    del mstate, mstep
    mdcfg = dataclasses.replace(dcfg, num_classes=C)
    mvars = make_variables(mmodel, gen)
    mfns = inference.make_detect_loop_fns(mdcfg, priors, device=DEV)
    one = make_dataset(rng, batches=1, batch=B, valid_last=B)
    with nms_inputs_seen() as seen:
        mresults, counts = counted(lambda: inference.run_detect_loop(
            mdcfg, mvars, one, priors, fns=mfns, device=DEV), {"nms": 1}, "ssd multi-class detect")
    add_counts(total, counts)
    check_results(mresults, B, mdcfg.max_detections)
    if seen[0][0].shape[1] != mdcfg.detect_candidates:
        raise AssertionError(f"per-class sweep gave {tuple(seen[0][0].shape)}")
    rows["nms_ssd_multiclass"] = nms_at_path_inputs("ssd_multiclass", seen)
    classes = sorted({int(c) for r in mresults for c in r["classes"]})
    out.update({"multiclass": {"classes": C, "train_losses": mlosses, "train_launches": counts,
                               "detect_candidates": mdcfg.detect_candidates,
                               "classes_detected": len(classes)}})
    del mvars, mfns, mmodel
    torch.cuda.empty_cache()

    # the user's command: configs/ssd_multiscale.yaml as shipped (B4 off)
    cli_logdir = os.path.join(root, "cli_train")
    args = ["--tfrecords", records, "--priors", priors_path, "--logdir", cli_logdir,
            "--config", "configs/ssd_multiscale.yaml", "--max_number_of_steps", "2"]
    t0 = time.perf_counter()
    with quiet:
        rc, counts = counted(lambda: cli_train.main(args), {}, "ssd train CLI")
    if rc or CheckpointManager(cli_logdir).latest_step() != 2:
        raise AssertionError(f"ssd train CLI: rc {rc}")
    logged = logged_losses(cli_logdir, 2)
    out.update({"cli_train_seconds": time.perf_counter() - t0, "cli_train_launches": counts,
                "cli_train_loss": logged[-1]["loss"]})
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(os.path.dirname(records), ignore_errors=True)
    torch.cuda.empty_cache()
    out.update({"ok": True, "launches": total, "kernels": rows})
    emit(out)
    return total, rows


def phase_mobilenet(rng, gen, card_line, train_steps=6):
    """configs/mobilenet_edge.yaml at full width: MobileNetV2 1.0 at 224,
    the MultiBox head over Final (7² × 1,280), P = 128 seeded priors,
    batch 64, K = 20, bf16 backbone, f32 head. Detect as shipped (B1) and
    with use_pallas=True (B1, B2 on the head, B3a), the head and the
    postprocess against the plain path, the BN-folded model (γ folded)
    against the unfolded one, then training with use_pallas=True (B2
    forward and backward, B3b, B4 at P = 128). Returns the launch counts
    of the phase and its kernel rows."""
    from multibox_tpu_torch.config import parse_config_file

    shipped = parse_config_file("configs/mobilenet_edge.yaml")
    P, B = shipped.num_priors, shipped.batch_size
    priors = np.sort(rng.uniform(0.05, 0.95, (P, 2, 2)).astype(np.float32), axis=1).reshape(P, 4)
    kcfg = dataclasses.replace(shipped, use_pallas=True)
    model = inference.build_model(shipped, P, device=DEV)
    kmodel = inference.build_model(kcfg, P, device=DEV)
    variables = make_variables(model, gen)
    data = make_dataset(rng, batches=3, batch=B, valid_last=B * 3 // 4, canvas=256)
    images = sum(int(b["batch_valid"]) for b in data)
    total, rows = {}, {}
    out = {"phase": "mobilenet", "card": card_line,
           "config": f"configs/mobilenet_edge.yaml (mobilenet_v2 width {shipped.mobilenet_width} "
                     f"at {shipped.input_size}, MultiBox head over Final, P={P}, batch {B}, "
                     f"K={shipped.max_detections}, bn_momentum {shipped.bn_momentum}, "
                     f"{shipped.compute_dtype} backbone, float32 head)"}
    out.update(head_against_plain(kcfg, kmodel, variables, priors, data[0]["images"]))

    per_batch = {}
    for tag, c, want in (("shipped", shipped, {"nms": 1}),
                         ("use_pallas", kcfg, {"nms": 1, "fused_matmul": 3, "box_decode": 1})):
        fns = inference.make_detect_loop_fns(c, priors, device=DEV)
        with nms_inputs_seen() as seen:
            inference.run_detect_loop(c, variables, data[:1], priors, fns=fns, device=DEV)
            t0 = time.perf_counter()
            results, counts = counted(lambda: inference.run_detect_loop(
                c, variables, data, priors, fns=fns, device=DEV),
                {k: v * len(data) for k, v in want.items()}, f"mobilenet detect ({tag})")
        per_batch[tag] = (time.perf_counter() - t0) * 1e3 / len(data)
        add_counts(total, counts)
        check_results(results, images, c.max_detections)
    rows["nms_mobilenet"] = nms_at_path_inputs("mobilenet", seen)
    out.update({"detect_batches": len(data), "detect_ms_per_batch": per_batch,
                "detect_images_per_s": {k: B / (v / 1e3) for k, v in per_batch.items()}})

    # BatchNorm (with γ) folded into the convolutions, against the unfolded
    # model: in float32 within 1e-3 of the largest output (the same
    # products in another order); in bfloat16, as shipped, the gap is
    # rounding moved through 52 units and is reported, not held
    folded_vars = fold_batch_norms(variables)
    scales = sum(1 for k in variables["params"] if k.endswith("BatchNorm.scale"))
    if any("BatchNorm" in k for k in folded_vars["params"]) or scales != 52:
        raise AssertionError(f"fold: {scales} γ, a BatchNorm leaf left "
                             f"{any('BatchNorm' in k for k in folded_vars['params'])}")
    fold = {}
    x = preprocess_eval(dev(data[0]["images"]), shipped.input_size)
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(shipped, compute_dtype=dtype)
        folded_model = inference.build_model(c, P, folded=True, device=DEV)
        with torch.no_grad():
            loc_f, conf_f = detector_mod.apply(folded_model, folded_vars, x)
            loc_u, conf_u = detector_mod.apply(inference.build_model(c, P, device=DEV),
                                               variables, x)
        if not (torch.isfinite(loc_f).all() and torch.isfinite(conf_f).all()):
            raise AssertionError(f"non-finite output of the folded model ({dtype})")
        fold[dtype] = {"max_abs_err_vs_unfolded": max(float((loc_f - loc_u).abs().max()),
                                                      float((conf_f - conf_u).abs().max())),
                       "output_abs_max": max(float(loc_u.abs().max()),
                                             float(conf_u.abs().max()))}
    if fold["float32"]["max_abs_err_vs_unfolded"] > 1e-3 * fold["float32"]["output_abs_max"]:
        raise AssertionError(f"folded vs unfolded (float32): {fold['float32']}")
    out.update({"folded_bn_with_scale": scales, "folded_vs_unfolded": fold})
    del variables, folded_vars, folded_model
    torch.cuda.empty_cache()

    # training through B2 forward and backward, B3b, B4 (shared route)
    tcfg = dataclasses.replace(kcfg, log_every_steps=1)
    state = train_state.create_train_state(tcfg, kmodel, SEED, P, device=DEV)
    tdata = make_train_data(rng, train_steps + 1, tcfg, int(tcfg.input_size * 1.15))
    out.update(train_stage_checks(tcfg, kmodel, state, priors, tdata[0]))
    rows["match_mobilenet"] = out["b4_on_step_boxes"]
    logdir = os.path.join(".work", "chip_smoke_mobilenet")
    shutil.rmtree(logdir, ignore_errors=True)
    stream = lambda start: iter(tdata[start:])  # noqa: E731
    n = train_steps
    t0 = time.perf_counter()
    _, counts = counted(lambda: train_loop.train_from_batches(
        tcfg, stream, priors, logdir, max_steps=n, device=DEV),
        {"match": n, "fused_matmul": 3 * n, "fused_matmul_backward": 3 * n, "box_encode": n},
        "mobilenet train")
    seconds = time.perf_counter() - t0
    add_counts(total, counts)
    logged = logged_losses(logdir, n)
    shutil.rmtree(logdir, ignore_errors=True)
    step_fn = train_loop.make_augmented_train_step(tcfg, kmodel, priors, device=DEV)
    out.update({"train_launches": counts, "train_steps": n, "train_loop_seconds": seconds,
                "train_loss_first_last": [logged[0]["loss"], logged[-1]["loss"]],
                "ms_per_step": timed_steps(step_fn, state, tdata[:4])[0]})
    del state, step_fn
    torch.cuda.empty_cache()

    # B2 at the head's three layers (M, K, N as the path gives them), forward
    # and backward: 3,136×1,280×96, 64×4,704×512, 64×4,704×128
    g = mobilenet.feature_grid(shipped.input_size)
    flat = g * g * shipped.bottleneck_features
    head = (("Bottleneck", B * g * g, kmodel.backbone.endpoint_features["Final"],
             shipped.bottleneck_features, True),
            ("Locations", B, flat, P * 4, False),
            ("Confidences", B, flat, P * shipped.num_classes, False))
    rows["fused_matmul_mobilenet"] = [
        forward_entry(name, *matmul_inputs(rng, M, Kd, N, torch.float32), relu)
        for name, M, Kd, N, relu in head]
    rows["fused_matmul_backward_mobilenet"] = [
        backward_entry(name, *backward_inputs(rng, M, Kd, N), relu)
        for name, M, Kd, N, relu in head]
    for entry in rows["fused_matmul_mobilenet"]:
        if entry["name"] in ("Locations", "Confidences") and entry["route"] != "skinny":
            raise AssertionError(f"mobilenet {entry['name']} took route {entry['route']}")
    out.update({"ok": True, "launches": total, "kernels": rows})
    emit(out)
    return total, rows


# --------------------------------------------------------------------------
# the deployment path: export, the exported detector, the HTTP service, int8
# --------------------------------------------------------------------------


def equal_outputs(got, want, what):
    """Every output of a detect program bitwise equal, dtype included."""
    for key in ("boxes", "scores", "classes", "num"):
        if got[key].dtype != want[key].dtype or not torch.equal(got[key].cpu(), want[key].cpu()):
            raise AssertionError(f"{what}: {key} differs")


def program_ms(call, x, reps=5):
    """ms a call of one exported program (or live function) on ``x``,
    outputs copied to the host, host clock, after one warm-up."""
    def once():
        with torch.no_grad():
            out = call(x)
        for v in out.values():
            v.cpu()

    once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        once()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def int8_route_checks(rng):
    """Each route of ``models.quant.int8_conv`` at one of its real shapes,
    exact against an int64 reference (a float64 convolution of the same
    integers: every sum is below 2**53), timed beside the bf16 cuDNN
    convolution of the same shape (CUDA events, L2 evicted)."""
    from multibox_tpu_torch.models import quant

    shapes = (  # (unit, B, H, W, Cin, Cout, kernel, stride, padding, groups)
        ("Mixed_5b/Branch_0/Conv2d_0a_1x1", 32, 35, 35, 192, 64, (1, 1), 1, "SAME", 1),
        ("Mixed_6b/Branch_1/Conv2d_0b_1x7", 32, 17, 17, 128, 128, (1, 7), 1, "SAME", 1),
        ("Mixed_7a/Branch_0/Conv2d_1a_3x3", 32, 17, 17, 192, 320, (3, 3), 2, "VALID", 1),
        ("Conv2d_1a_3x3 (K = 27, padded to 32)", 32, 299, 299, 3, 32, (3, 3), 2, "VALID", 1),
        ("MobileNetV2 Stage_2 Depthwise", 64, 28, 28, 192, 192, (3, 3), 1, "SAME", 192),
    )
    rows = []
    for name, B, H, W, C, O, kernel, s, pad, groups in shapes:
        x = dev(rng.integers(-127, 128, (B, C, H, W)).astype(np.int8)).contiguous(
            memory_format=torch.channels_last)
        w = dev(rng.integers(-127, 128, (O, C // groups) + kernel).astype(np.int8))
        got = quant.int8_conv(x, w, (s, s), pad, groups)
        ref = quant._conv_exact_float(x, w, (s, s), pad, groups, torch.float64)
        torch.cuda.synchronize()
        if got.dtype != torch.int32 or not torch.equal(got.to(torch.int64), ref.to(torch.int64)):
            raise AssertionError(f"int8 conv [{name}] differs from the int64 reference")
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        rows.append({
            "unit": name, "shape": f"B={B} {H}x{W}x{C} -> {O}, kernel {kernel}, stride {s}, "
                                   f"groups {groups}",
            "route": quant.int8_conv_route(kernel, (s, s), groups, C), "exact": True,
            "ms": time_ms(lambda: quant.int8_conv(x, w, (s, s), pad, groups), reps=7, warmup=2),
            "bf16_cudnn_ms": time_ms(lambda: quant._conv_exact_float(
                xb, wb, (s, s), pad, groups, torch.bfloat16), reps=7, warmup=2)})
    return rows


def http_run(base, jpegs, clients, per_client):
    """``clients`` threads, each with one keep-alive connection, each
    sending ``per_client`` JPEG ``/detect`` requests back to back. Returns
    requests/s over the run, p50 and p99 of the requests' latency (ms) and
    the responses' status codes."""
    import http.client
    import threading
    from urllib.parse import urlparse

    host, port = urlparse(base).hostname, urlparse(base).port
    lat, codes, bodies = [], [], []
    lock = threading.Lock()
    start = threading.Barrier(clients + 1)

    def client(i):
        conn = http.client.HTTPConnection(host, port, timeout=120)
        start.wait()
        for r in range(per_client):
            data = jpegs[(i * per_client + r) % len(jpegs)]
            t0 = time.perf_counter()
            conn.request("POST", "/detect?threshold=0.0", body=data,
                         headers={"Content-Type": "image/jpeg"})
            resp = conn.getresponse()
            body = resp.read()
            dt = time.perf_counter() - t0
            with lock:
                lat.append(dt * 1e3)
                codes.append(resp.status)
                bodies.append(body)
        conn.close()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    seconds = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("an HTTP client did not finish")
    lat.sort()
    return {"clients": clients, "requests": len(lat), "seconds": seconds,
            "requests_per_s": len(lat) / seconds,
            "p50_ms": lat[len(lat) // 2], "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            "codes": sorted(set(codes))}, bodies


def http_phase(export_dir, rng, windows=(40.0,)):
    """The daemon in-process on 127.0.0.1 over the batch-1/32 export: 8 and
    32 concurrent JPEG ``/detect`` clients and one ``/detect_batch``, at
    each window (the serve bench sweeps windows and clients after it);
    ``/stats``' device batches; one request alone against the exported
    program called directly (the same batch-1 program: equal)."""
    import base64
    import threading
    import urllib.request

    from multibox_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
    from multibox_tpu_torch.serve import make_server
    from multibox_tpu_torch.serving import load_exported

    srv = make_server(export_dir, port=0, batch_window_ms=windows[0])
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    out = {"windows": {}}
    try:
        if not srv.service.ready.wait(600):
            raise AssertionError("the daemon did not finish its warmup")
        jpegs = [encode_jpeg(rng.integers(0, 256, (299, 299, 3), dtype=np.uint8))
                 for _ in range(64)]

        def get(path):
            with urllib.request.urlopen(base + path, timeout=60) as r:
                return json.loads(r.read())

        if get("/healthz")["status"] != "ok":
            raise AssertionError("healthz is not ok after warmup")
        for window in windows:
            srv.service.batch_window_s = window / 1e3
            row = {}
            for clients, per_client in ((8, 6), (32, 3)):
                before = get("/stats")
                stats, bodies = http_run(base, jpegs, clients, per_client)
                after = get("/stats")
                if stats["codes"] != [200]:
                    raise AssertionError(f"HTTP codes {stats['codes']}")
                for body in bodies:
                    res = json.loads(body)
                    if not (np.isfinite(res["scores"]).all() and
                            all(0.0 <= v <= 1.0 for b in res["boxes"] for v in b)):
                        raise AssertionError("bad detection in a response")
                stats["device_batches"] = after["device_batches"] - before["device_batches"]
                stats["images_per_device_batch"] = (
                    (after["images"] - before["images"]) / stats["device_batches"])
                row[f"c{clients}"] = stats
            payload = json.dumps({"images": [base64.b64encode(j).decode()
                                             for j in jpegs[:32]]}).encode()
            before = get("/stats")
            t0 = time.perf_counter()
            req = urllib.request.Request(base + "/detect_batch?threshold=0.0", data=payload)
            with urllib.request.urlopen(req, timeout=120) as r:
                res = json.loads(r.read())
            row["detect_batch_32_ms"] = (time.perf_counter() - t0) * 1e3
            after = get("/stats")
            row["detect_batch_device_batches"] = after["device_batches"] - before["device_batches"]
            if len(res["results"]) != 32:
                raise AssertionError("detect_batch answered the wrong count")
            out["windows"][f"{window:g}ms"] = row
        # one request alone: the batch-1 program, as called directly
        srv.service.batch_window_s = windows[0] / 1e3
        req = urllib.request.Request(base + "/detect?threshold=0.0", data=jpegs[0])
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        img = decode_jpeg(jpegs[0], canvas=299)
        direct = srv.service.detector((img.astype(np.float32) / 255.0 - 0.5)[None] * 2.0)
        n = int(direct["num"][0])
        if not np.array_equal(np.asarray(body["scores"], np.float32), direct["scores"][0, :n]):
            raise AssertionError("the daemon's answer differs from the program called directly")
        out["stats"] = get("/stats")
    finally:
        srv.shutdown()
        srv.service.close()
        srv.server_close()
    return out


def load_script(name):
    """``scripts/<name>.py`` of this checkout, imported as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# scripts/torch_serve_bench.py's sweep in phase serve: clients, windows (ms),
# requests a client, and the admission depth of the arm that overloads
BENCH_CLIENTS, BENCH_WINDOWS, BENCH_REQUESTS, BENCH_DEPTH = (1, 8, 32, 64), (2, 5, 40), 3, 16


def serve_bench(export_dir):
    """``scripts/torch_serve_bench.py`` on the batch-1/32 export: the
    micro-batching daemon at each window and the ``--max_batch 1`` control
    arm under 1-64 clients, then 64 clients against a queue of
    ``BENCH_DEPTH``, which must shed with 429s. Its rows: no request
    failed, each one answered or shed (the control arm's queue holds 2
    requests by default, so it sheds too)."""
    bench = load_script("torch_serve_bench")
    clients = [str(c) for c in BENCH_CLIENTS]
    with contextlib.redirect_stdout(sys.stderr):
        rows = bench.main(["--export_dir", export_dir, "--concurrency", *clients,
                           "--requests", str(BENCH_REQUESTS),
                           "--windows", *map(str, BENCH_WINDOWS)])
        overload = bench.main(["--export_dir", export_dir, "--concurrency", clients[-1],
                               "--requests", str(BENCH_REQUESTS), "--windows", "40",
                               "--max_queue_depths", str(BENCH_DEPTH), "--skip_unbatched"])
    configs = len(BENCH_WINDOWS) + 1
    if len(rows) != configs * len(BENCH_CLIENTS) or len(overload) != 1 or any(
            r["errors"] or r["requests"] + r["shed_429"] != r["concurrency"] * BENCH_REQUESTS
            for r in rows + overload):
        raise AssertionError(f"serve bench rows {rows + overload}")
    if overload[0]["errors"] or overload[0]["shed_429"] < 1:
        raise AssertionError(f"serve bench at a queue of {BENCH_DEPTH}: {overload}")
    return rows + overload


def phase_serve(rng, gen, card_line):
    """The deployment path at configs/cub_detect.yaml's full width with
    use_pallas=True (Inception-v3 299, P = 256, batch 32, K = 10, bf16
    backbone, f32 head), random weights from the seed, through the entry
    points a user calls: a checkpoint → ``cli.export.main`` at batch sizes 1
    and 32, ``--fold_bn`` at 32, ``--quantize int8`` at 32 (calibrated on
    tfrecords written from the seed) → ``serving.load_exported`` on the card
    → warmup → each program bitwise against the live
    ``apply_and_postprocess`` on the same images, with B1, B2 and B3a
    counted inside the programs' calls → int8's routes exact against
    int64 → the HTTP daemon (``serve.make_server``) under 8 and 32 clients
    at the 40 ms window → the serve bench (:func:`serve_bench`). Then
    configs/ssd_multiscale.yaml with flip_tta: true at batch 32 (B1 at 2 ×
    9,468 = 18,936 boxes an image, window by window, exact at the path's own
    inputs). Returns the launch counts and the kernel rows."""
    from multibox_tpu_torch.cli import export as cli_export
    from multibox_tpu_torch.cli import priors as cli_priors
    from multibox_tpu_torch.config import parse_config_file
    from multibox_tpu_torch.priors import load_priors, save_priors
    from multibox_tpu_torch.serving import load_exported
    import yaml

    root = os.path.join(".work", "chip_smoke_serve")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    quiet = contextlib.redirect_stdout(sys.stderr)
    cfg_path = os.path.join(root, "cub_detect_pallas.yaml")
    with open("configs/cub_detect.yaml") as f:
        raw = yaml.safe_load(f)
    raw["use_pallas"] = True
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    cfg = parse_config_file(cfg_path)
    P, B = cfg.num_priors, cfg.batch_size
    priors = np.sort(rng.uniform(0.05, 0.95, (P, 2, 2)).astype(np.float32), axis=1).reshape(P, 4)
    priors_path = os.path.join(root, "priors.pkl")
    save_priors(priors, priors_path)
    model = inference.build_model(cfg, P, device=DEV)
    state = train_state.create_train_state(cfg, model, SEED, P, device=DEV,
                                           variables=make_variables(model, gen))
    logdir = os.path.join(root, "logdir")
    CheckpointManager(logdir).save(1, state, force=True)
    calib = os.path.join(root, "calib.tfrecord")
    write_records(rng, calib, cfg.quant_calib_batches * B, cfg.input_size, 0)
    out = {"phase": "serve", "card": card_line,
           "config": f"configs/cub_detect.yaml with use_pallas: true (inception_v3 "
                     f"{cfg.input_size}, P={P}, batch {B}, K={cfg.max_detections}, "
                     f"{cfg.compute_dtype} backbone, float32 head), random weights from seed 0"}
    base = ["--checkpoint_path", logdir, "--priors", priors_path, "--config", cfg_path]
    exports = {"f32": ["--batch_sizes", "1", "32"],
               "folded": ["--fold_bn", "--batch_size", "32"],
               "int8": ["--quantize", "int8", "--calib_tfrecords", calib, "--batch_size", "32"]}
    export_s = {}
    for name, extra in exports.items():
        t0 = time.perf_counter()
        with quiet:
            if cli_export.main(base + ["--output_dir", os.path.join(root, name)] + extra):
                raise AssertionError(f"export CLI failed ({name})")
        export_s[name] = time.perf_counter() - t0
    shutil.rmtree(logdir, ignore_errors=True)  # some 350 MB
    t0 = time.perf_counter()
    dets = {name: load_exported(os.path.join(root, name)) for name in exports}
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for det in dets.values():
        det.warmup()
    warmup_s = time.perf_counter() - t0
    if sorted(dets["f32"].calls) != [1, 32] or dets["f32"].batch_size != 32:
        raise AssertionError(f"programs {sorted(dets['f32'].calls)}")

    # each program against the live function on the same images, bitwise,
    # with the kernels counted inside the program's call
    x = dev(rng.uniform(-1, 1, (B, cfg.input_size, cfg.input_size, 3)).astype(np.float32))
    tpriors = dev(priors)
    live_vars = {"params": state.ema_params, "batch_stats": state.batch_stats}
    folded_model = inference.build_model(cfg, P, folded=True, device=DEV)
    folded_vars = fold_batch_norms(live_vars)
    fused_units = sum(1 for m in folded_model.modules() if isinstance(m, ConvBN) and m.fused)
    with np.load(os.path.join(root, "int8", "params.npz")) as z:
        q_vars = {}
        for key in z.files:
            coll, name = key.split("/", 1)
            q_vars.setdefault(coll, {})[name] = dev(z[key])
    int8_cfg = dataclasses.replace(cfg, quantize="int8")
    int8_model = inference.build_model(int8_cfg, P, folded=True, quantize="int8", device=DEV)
    lives = {
        ("f32", 32): lambda t: inference.apply_and_postprocess(model, live_vars, t, tpriors, cfg),
        ("f32", 1): lambda t: inference.apply_and_postprocess(model, live_vars, t, tpriors, cfg),
        ("folded", 32): lambda t: inference.apply_and_postprocess(
            folded_model, folded_vars, t, tpriors, cfg),
        ("int8", 32): lambda t: inference.apply_and_postprocess(
            int8_model, q_vars, t, tpriors, int8_cfg),
    }
    want_counts = {"f32": {"nms": 1, "fused_matmul": 3, "box_decode": 1},
                   "folded": {"nms": 1, "fused_matmul": fused_units + 3, "box_decode": 1},
                   "int8": {"nms": 1, "fused_matmul": 3, "box_decode": 1}}
    total, outs, launches = {}, {}, {}
    for (name, size), live in lives.items():
        xs = x[:size]
        call = dets[name].calls[size]
        with torch.no_grad():
            got, counts = counted(lambda: {k: v.cpu() for k, v in call(xs).items()},
                                  want_counts[name], f"exported {name} b{size}")
            add_counts(total, counts)
            launches[f"{name}_b{size}"] = counts
            want = live(xs)
        equal_outputs(got, want, f"exported {name} b{size} against live")
        outs[(name, size)] = got
    # int8 against f32 on the same images: the sorted score lists
    gap = float((outs[("int8", 32)]["scores"] - outs[("f32", 32)]["scores"]).abs().max())
    check_results([{"image_id": i, "boxes": outs[("int8", 32)]["boxes"][i].numpy(),
                    "scores": outs[("int8", 32)]["scores"][i].numpy()} for i in range(B)],
                  B, cfg.max_detections)
    # ms a batch of 32: each program and the live f32 function, in turns
    order = ["f32", "folded", "int8"]
    ms = {n: [] for n in order + ["live_f32"]}
    for n in order + ["live_f32"] + list(reversed(order)):
        call = lives[("f32", 32)] if n == "live_f32" else dets[n].calls[32]
        ms[n].append(program_ms(call, x))
    del folded_vars, q_vars, int8_model, folded_model
    torch.cuda.empty_cache()

    out.update({"exports": {n: sorted(os.listdir(os.path.join(root, n))) for n in exports},
                "export_cli_seconds": export_s, "load_seconds": load_s,
                "warmup_seconds": warmup_s, "exported_equals_live_bitwise": True,
                "program_launches": launches, "fused_1x1_units": fused_units,
                "ms_per_batch_of_32": ms, "int8_scores_max_abs_gap_vs_f32": gap,
                "int8_routes": int8_route_checks(rng)})
    del dets
    torch.cuda.empty_cache()

    # the HTTP daemon over the batch-1/32 export; its calls go through the
    # same programs, counted
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    http = http_phase(os.path.join(root, "f32"), rng)
    counts = kernels.launch_counts()
    if counts["nms"] < 1 or counts["fused_matmul"] < 3 or counts["box_decode"] < 1 or \
            counts["nms"] * 3 != counts["fused_matmul"] or counts["nms"] != counts["box_decode"]:
        raise AssertionError(f"HTTP run launch counts {counts}")
    add_counts(total, counts)
    out.update({"http": http, "http_launches": counts})
    kernels.reset_launch_counts()
    out["serve_bench"] = serve_bench(os.path.join(root, "f32"))
    counts = kernels.launch_counts()
    if counts["nms"] < 1 or counts["nms"] * 3 != counts["fused_matmul"] or \
            counts["nms"] != counts["box_decode"]:
        raise AssertionError(f"serve bench launch counts {counts}")
    add_counts(total, counts)
    out["serve_bench_launches"] = counts
    shutil.rmtree(root, ignore_errors=True)

    # SSD with flip TTA: 2 x 9,468 candidates an image into B1
    ssd_root = os.path.join(".work", "chip_smoke_serve_ssd")
    shutil.rmtree(ssd_root, ignore_errors=True)
    os.makedirs(ssd_root)
    shipped = parse_config_file("configs/ssd_multiscale.yaml")
    sizes = [feature_grid(shipped.input_size, e) for e in shipped.ssd_endpoints]
    ssd_priors_path = os.path.join(ssd_root, "priors_ms.pkl")
    with quiet:
        if cli_priors.main(["--output", ssd_priors_path, "--mode", "multiscale",
                            "--feature_map_sizes", *map(str, sizes), "--aspect_ratios",
                            "1.0", "2.0", "0.5", "3.0", "0.333"]):
            raise AssertionError("priors CLI failed")
    ssd_priors = load_priors(ssd_priors_path)
    shutil.rmtree(ssd_root, ignore_errors=True)
    Pssd = ssd_priors.shape[0]
    tcfg = dataclasses.replace(shipped, num_priors=Pssd, flip_tta=True)
    smodel = inference.build_model(tcfg, Pssd, device=DEV)
    svars = make_variables(smodel, gen)
    sdata = make_dataset(rng, batches=2, batch=tcfg.batch_size, valid_last=tcfg.batch_size)
    fns = inference.make_detect_loop_fns(tcfg, ssd_priors, device=DEV)
    with nms_inputs_seen() as seen:
        inference.run_detect_loop(tcfg, svars, sdata[:1], ssd_priors, fns=fns, device=DEV)
        t0 = time.perf_counter()
        results, counts = counted(lambda: inference.run_detect_loop(
            tcfg, svars, sdata, ssd_priors, fns=fns, device=DEV), {"nms": len(sdata)},
            "ssd flip-TTA detect")
    seconds = time.perf_counter() - t0
    add_counts(total, counts)
    check_results(results, tcfg.batch_size * len(sdata), tcfg.max_detections)
    if seen[0][0].shape[1] != 2 * Pssd or not nms_kernel.nms_fits(2 * Pssd, tcfg.max_detections):
        raise AssertionError(f"flip TTA gave B1 {tuple(seen[0][0].shape)}")
    row = nms_at_path_inputs("ssd_flip_tta", seen)
    out.update({"ssd_flip_tta": {"P_to_nms": 2 * Pssd, "batches": len(sdata),
                                 "ms_per_batch": seconds * 1e3 / len(sdata),
                                 "launches": counts, "nms": row}})
    del smodel, svars, fns
    torch.cuda.empty_cache()
    out.update({"ok": True, "launches": total})
    emit(out)
    return total, {"nms_ssd_flip_tta": row}


def only_phases(names, profile_it) -> int:
    """Some phases alone (a quick check while working on one of them)."""
    phases = {"detect": lambda: phase_detect(np.random.default_rng(SEED),
                                             torch.Generator().manual_seed(SEED), card(),
                                             profile_it),
              "train": lambda: phase_train(np.random.default_rng(SEED), card(), profile_it),
              "graphs": lambda: phase_graphs(np.random.default_rng(SEED + 13),
                                             torch.Generator().manual_seed(SEED + 13), card(),
                                             profile_it),
              "mobilenet": lambda: phase_mobilenet(np.random.default_rng(SEED),
                                                   torch.Generator().manual_seed(SEED), card())}
    unknown = set(names) - set(phases)
    if unknown:
        raise SystemExit(f"--only: unknown phase(s) {sorted(unknown)}; choose from "
                         f"{sorted(phases)}")
    kernels.load_library()
    for name in names:
        t0 = time.perf_counter()
        phases[name]()
        emit({"phase": "timing", "only": name, "seconds": time.perf_counter() - t0})
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None,
                        help="also write the kernels' full table (every shape) "
                             "to this JSON file")
    parser.add_argument("--profile", action="store_true",
                        help="also run one detect loop under torch.profiler and "
                             "print the device's idle share and top kernels")
    parser.add_argument("--only", default=None,
                        help="run only these phases of detect, train, graphs, mobilenet "
                             "(comma separated; no kernels phase and no result line)")
    parser.add_argument("--parallel_worker", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.parallel_worker:  # a rank spawned by phase parallel
        return parallel_worker(args.parallel_worker)
    if args.only:
        return only_phases(args.only.split(","), args.profile)
    t_start = time.perf_counter()
    card_line = card()
    emit({"phase": "device", "card": card_line, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    path, log = kernels.build_library(ptxas_verbose=True)
    kernels.load_library()
    sass_b2, sass_b1, sass_b4 = sass_counts(path)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(path),
          "ptxas": [ln for ln in log.splitlines() if "registers" in ln or "spill" in ln],
          "sass_b2_wgmma": sass_b2, "sass_b1": sass_b1, "sass_b4": sass_b4})

    rng = np.random.default_rng(SEED)
    entries = [check_nms(rng), check_fused_matmul(rng), *check_boxes(rng), check_match(rng)]
    backward = check_fused_backward(rng)
    torch.cuda.synchronize()
    emit({"phase": "kernels", "ok": True, "card": card_line, "kernels": entries,
          "fused_matmul_backward": backward})

    gen = torch.Generator().manual_seed(SEED)
    seconds = {"build_and_kernels": time.perf_counter() - t_start}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        result = fn(*a)
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t0
        return result

    counts, variables, priors = timed("detect", phase_detect, rng, gen, card_line,
                                      args.profile)
    timed("detect_folded", phase_detect_folded, rng, variables, priors)
    b128_counts = timed("detect_b128", phase_detect_b128, np.random.default_rng(SEED + 12),
                        variables, priors)
    del variables
    train_counts = timed("train", phase_train, rng, card_line, args.profile)
    graphs_counts = timed("graphs", phase_graphs, np.random.default_rng(SEED + 13),
                          torch.Generator().manual_seed(SEED + 13), card_line, args.profile)
    sweep_counts = timed("batch_sweep", phase_batch_sweep, card_line)
    data_counts = timed("data", phase_data, rng, card_line)
    cli_counts, records = timed("cli", phase_cli, rng, card_line)
    # their own generators: the later phases' draws stay as they were
    parallel_counts = timed("parallel", phase_parallel, np.random.default_rng(SEED + 10),
                            card_line, records,
                            os.path.join(os.path.dirname(records), "priors.pkl"))
    coco_counts, coco_rows = timed("coco_dp", phase_coco_dp, np.random.default_rng(SEED + 11),
                                   card_line)
    ssd_counts, ssd_rows = timed("ssd", phase_ssd, rng, gen, card_line, records)
    mobilenet_counts, mobilenet_rows = timed("mobilenet", phase_mobilenet, rng, gen, card_line)
    serve_counts, serve_rows = timed("serve", phase_serve, rng, gen, card_line)

    contract_keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
                     "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # launches on the twelve paths: detect (B1, B2, B3a), detect at batch
    # 128 (B1, B2, B3a), train (B2, B3b, B4), graphs (B1, B2, B3a in detect
    # and int8 detect; B2, B3b, B4 in train; eager and graphed),
    # batch_sweep (none: use_pallas unset), data (B1 in visualize), cli
    # (B1), parallel (B2, B3b, B4 on every rank; B1, B2, B3a in the sharded
    # detect; B1 in the one-process detect CLI), coco_dp (B1 in the detect
    # CLI), ssd (B1, B4), mobilenet (B1, B2, B3a, B3b, B4) and serve (B1, B2,
    # B3a inside the exported programs; B1 with flip TTA)
    paths = (counts, b128_counts, train_counts, graphs_counts, sweep_counts, data_counts,
             cli_counts,
             parallel_counts, coco_counts, ssd_counts, mobilenet_counts, serve_counts)
    for e in entries + [backward]:
        e["launches"] = sum(c.get(e["name"], 0) for c in paths)
    # the new paths' shapes beside each kernel's main row
    by_name = {e["name"]: e for e in entries + [backward]}
    by_name["nms"].update(ssd_p9468_b32=ssd_rows["nms_ssd"],
                          ssd_multiclass_p1024=ssd_rows["nms_ssd_multiclass"],
                          mobilenet_p128_b64=mobilenet_rows["nms_mobilenet"],
                          ssd_flip_tta_p18936_b32=serve_rows["nms_ssd_flip_tta"],
                          coco_dp_p1024_c80=coco_rows["nms_coco_dp"])
    by_name["match"].update(ssd_step_boxes=ssd_rows["match_ssd"],
                            mobilenet_p128=mobilenet_rows["match_mobilenet"])
    by_name["fused_matmul"]["mobilenet_head"] = mobilenet_rows["fused_matmul_mobilenet"]
    by_name["fused_matmul"]["coco_dp_head"] = coco_rows["fused_matmul_coco_dp"]
    backward["mobilenet_head"] = mobilenet_rows["fused_matmul_backward_mobilenet"]
    backward["coco_dp_head"] = coco_rows["fused_matmul_backward_coco_dp"]
    on_path = {"nms", "fused_matmul", "box_decode", "box_encode", "match"}
    for e in entries:
        if e["name"] in on_path and e["launches"] < 1:
            raise AssertionError(f"{e['name']} was not launched on the main path")

    emit({"phase": "timing", "seconds": seconds, "total": time.perf_counter() - t_start})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card_line, "kernels": entries,
                       "fused_matmul_backward": backward,
                       "seconds": time.perf_counter() - t_start}, f, indent=1)

    emit({"kernels": [{k: e[k] for k in contract_keys} for e in entries]})
    print(card_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
