#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py [--out FILE.json] [--profile]

Builds the CUDA kernels from ``multibox_tpu_torch/csrc`` with ``nvcc``,
holds each against its plain PyTorch version on the card, then drives the
main path — batched Inception-v3 MultiBox detect through
``inference.run_detect_loop`` at full width (299×299, 256 priors, batch 32,
bf16 backbone, f32 head) with random weights from a seed — and checks that
the path went through the kernels (launch counts) and that what comes out
is right, stage by stage. Every phase prints one JSON line; any failure
raises and the process exits non-zero. Needs one CUDA device; without one
it exits with code 2 and prints no result.

Times are CUDA-event medians after a warm-up, each launch preceded by a
write that evicts the L2 cache, taken on the card whose name and power
limit are printed beside them. Tolerances: NMS indices, counts and scores
exact; box kernels bitwise; matmul float32 rtol 1e-4 / atol 1e-4 (a sum
over K = 6144 in another order), bfloat16 output rtol 2e-2 / atol 2e-2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
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
from multibox_tpu_torch.models.inception_v3 import ConvBN, fold_batch_norms  # noqa: E402
from multibox_tpu_torch.ops import kernels  # noqa: E402
from multibox_tpu_torch.ops.kernels import box_kernel, fused_matmul, nms_kernel  # noqa: E402
from torch.func import functional_call  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

SEED = 0
DEV = resolve_device(None)


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


def check_nms(rng):
    """Indices, counts and scores exact. Returns the entry of the contract
    line, timed at the main path's shape (B=32, P=256, K=100)."""
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

    worst = 0.0
    for name, b, s, Kout, iou, thr in cases:
        tb, ts = dev(b), dev(s)
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
        worst = max(worst, float((got[1] - want_scores).abs().max()))

    _, b, s, Kout, iou, thr = cases[1]
    tb, ts = dev(b), dev(s)
    ms = time_ms(lambda: nms_kernel.nms_select(tb, ts, Kout, iou, thr))
    plain_ms = time_ms(lambda: nms_kernel.nms_batched_plain(tb, ts, Kout, iou, thr), reps=5, warmup=1)
    sel_idx, _ = nms_kernel.nms_select(tb, ts, Kout, iou, thr)
    B, P = s.shape
    # work this data needs: one round per selected box (+1 that finds
    # nothing, unless all K slots fill), each ~25 f32 operations per box
    rounds = int(torch.clamp((sel_idx >= 0).sum(1) + 1, max=Kout).sum())
    bound_ms, bound_by = bound(B * P * 20 + B * Kout * 8, rounds * P * 25, "float32")
    return {
        "name": "nms", "route": "cuda",
        "source": "multibox_tpu_torch/csrc/nms.cu",
        "replaces": "multibox_tpu/ops/pallas/nms_kernel.py:109",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "tolerance": "indices, counts and scores exact",
        "shape": f"B={B} P={P} K={Kout}", "rounds_run": rounds,
        "cases": [c[0] for c in cases],
    }


def check_fused_matmul(rng):
    """f32 rtol 1e-4 / atol 1e-4 (K = 6144 sums in another order than the
    plain version's), bf16 output rtol 2e-2 / atol 2e-2. The entry of the
    contract line sums the three head shapes of one batch of 32."""
    head = (("Bottleneck", 2048, 2048, 96, True), ("Locations", 32, 6144, 1024, False),
            ("Confidences", 32, 6144, 256, False))
    other = (("folded_1x1_bf16", 39200, 288, 64, True, torch.bfloat16),
             ("ragged", 33, 130, 70, True, torch.float32),
             ("ragged_norelu", 33, 130, 70, False, torch.float32),
             ("ragged_bf16", 65, 17, 129, False, torch.bfloat16),
             ("one_row", 1, 5, 3, True, torch.float32))
    shapes, worst = [], 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound": []}
    for case in tuple(h + (torch.float32,) for h in head) + other:
        name, M, Kd, N, relu, dtype = case
        x = dev(np.maximum(rng.normal(0, 1, (M, Kd)), 0).astype(np.float32), dtype)
        w = dev((rng.normal(0, 1, (Kd, N)) / np.sqrt(Kd)).astype(np.float32), dtype)
        b = dev(rng.normal(0, 0.1, N).astype(np.float32))
        got = fused_matmul.fused_matmul_bias_relu(x, w, b, relu)
        torch.cuda.synchronize()
        want = fused_matmul.fused_matmul_plain(x, w, b, relu)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        if got.dtype != x.dtype or got.shape != (M, N):
            raise AssertionError(f"fused_matmul[{name}]: wrong dtype or shape")
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"fused_matmul[{name}]: {m}")
        err = float((got.float() - want.float()).abs().max())
        item = x.element_size()
        dname = "float32" if dtype == torch.float32 else "bfloat16"
        bound_ms, bound_by = bound((M * Kd + Kd * N + M * N) * item + N * 4,
                                   2.0 * M * Kd * N, dname)
        entry = {"name": name, "M": M, "K": Kd, "N": N, "relu": relu,
                 "dtype": dname, "max_abs_err": err,
                 "bound_ms": bound_ms, "bound_by": bound_by}
        if name in ("Bottleneck", "Locations", "Confidences", "folded_1x1_bf16"):
            entry["ms"] = time_ms(lambda: fused_matmul.fused_matmul_bias_relu(x, w, b, relu))
            entry["plain_ms"] = time_ms(lambda: fused_matmul.fused_matmul_plain(x, w, b, relu))
            bias = b.to(dtype)
            if relu:
                entry["library_ms"] = time_ms(lambda: torch.addmm(bias, x, w).relu_())
            else:
                entry["library_ms"] = time_ms(lambda: torch.addmm(bias, x, w))
        if name in ("Bottleneck", "Locations", "Confidences"):
            worst = max(worst, err)
            for key in ("ms", "plain_ms", "library_ms"):
                totals[key] += entry[key]
            totals["bound"].append((bound_ms, bound_by))
        shapes.append(entry)
    return {
        "name": "fused_matmul", "route": "cuda",
        "source": "multibox_tpu_torch/csrc/fused_matmul.cu",
        "replaces": "multibox_tpu/ops/pallas/fused_matmul.py:162",
        "max_abs_err": worst, "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": sum(t for t, _ in totals["bound"]),
        "bound_by": max(totals["bound"])[1],
        "library_ms": totals["library_ms"],
        "tolerance": "float32 rtol 1e-4 atol 1e-4, bfloat16 rtol 2e-2 atol 2e-2",
        "shape": "sum of the head's three layers at batch 32 (float32)",
        "shapes": shapes,
    }


def check_boxes(rng):
    """Bitwise: add-then-clip and subtract are exact in f32."""
    out = []
    for kind in ("box_decode", "box_encode"):
        worst = 0.0
        for B, P, prior_shape in ((32, 256, (256, 4)), (3, 77, (1, 77, 4)),
                                  (2, 9468, (9468, 4)), (1, 1, (1, 4))):
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
        B, P = 32, 256
        a = dev(rng.normal(0, 0.3, (B, P, 4)).astype(np.float32))
        pri = dev(random_boxes(rng, (P,)))
        if kind == "box_decode":
            ms = time_ms(lambda: box_kernel.decode_boxes_cuda(a, pri, True))
            plain_ms = time_ms(lambda: box_kernel.decode_boxes_plain(a, pri[None], True))
            library_ms = None  # add then clamp: no single call
            line = "multibox_tpu/ops/pallas/box_kernel.py:64"
        else:
            ms = time_ms(lambda: box_kernel.encode_boxes_cuda(a, pri))
            plain_ms = time_ms(lambda: box_kernel.encode_boxes_plain(a, pri[None]))
            library_ms = time_ms(lambda: torch.sub(a, pri[None]))
            line = "multibox_tpu/ops/pallas/box_kernel.py:75"
        n = B * P * 4
        bound_ms, bound_by = bound(2 * n * 4 + P * 16, n * (3 if kind == "box_decode" else 1), "float32")
        out.append({
            "name": kind, "route": "cuda",
            "source": "multibox_tpu_torch/csrc/box.cu", "replaces": line,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "tolerance": "bitwise", "shape": f"B={B} P={P}",
        })
    return out


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
            model.InceptionV3, sub_vars(variables, "InceptionV3"), (images,))
        head_vars = sub_vars(variables, "MultiBoxHead")
        loc_k, conf_k = functional_call(model.MultiBoxHead, head_vars, (endpoints,))
        loc_p, conf_p = functional_call(plain_model.MultiBoxHead, head_vars, (endpoints,))
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
        backbone_vars = sub_vars(variables, "InceptionV3")
        head_vars = sub_vars(variables, "MultiBoxHead")
        endpoints = functional_call(model.InceptionV3, backbone_vars, (images,))
        loc, conf = functional_call(model.MultiBoxHead, head_vars, (endpoints,))
        tpriors = dev(priors)

        def timed(fn):
            def run():
                with torch.no_grad():
                    fn()
            return time_ms(run, reps=7, warmup=2)

        return {
            "preprocess_ms": timed(lambda: preprocess_eval(u8, cfg.input_size)),
            "backbone_ms": timed(lambda: functional_call(
                model.InceptionV3, backbone_vars, (images,))),
            "head_ms": timed(lambda: functional_call(
                model.MultiBoxHead, head_vars, (endpoints,))),
            "postprocess_ms": timed(lambda: inference._pack_dets(
                inference.postprocess(loc, conf, tpriors, cfg))),
        }


def profile_detect(cfg, variables, data, priors, fns):
    """One detect loop under torch.profiler. From the device's own events
    (kernels and copies): the share of the window between the first and the
    last of them in which nothing ran, and the kernels that took most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        inference.run_detect_loop(cfg, variables, data, priors, fns=fns, device=DEV)
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
    emit({"phase": "profile", "batches": len(data),
          "window_ms": window_us / 1e3, "device_busy_ms": busy_us / 1e3,
          "device_idle_share": 1.0 - busy_us / window_us,
          "device_events": len(events),
          "top": [{"name": k[:70], "ms": v[0] / 1e3, "calls": v[1]} for k, v in top]})


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
            "box_encode": 0}
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


def phase_detect_folded(rng, variables, priors):
    """BN folded into the convolutions: the bf16 1×1 units run through the
    matmul kernel. Logits against the unfolded model's, atol 0.1 (bf16
    backbone; the fold moves where values are rounded)."""
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
            "box_encode": 0}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    if worst > 0.1 or worst > 0.2 * scale:
        raise AssertionError(f"folded vs unfolded outputs differ by {worst} (scale {scale})")
    emit({"phase": "detect_folded", "ok": True, "fused_1x1_units": fused_units,
          "max_abs_err_vs_unfolded": worst, "output_abs_max": scale, "launches": counts})


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None,
                        help="also write the kernels' full table (every shape) "
                             "to this JSON file")
    parser.add_argument("--profile", action="store_true",
                        help="also run one detect loop under torch.profiler and "
                             "print the device's idle share and top kernels")
    args = parser.parse_args()
    t_start = time.perf_counter()
    card_line = card()
    emit({"phase": "device", "card": card_line, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    path, log = kernels.build_library(ptxas_verbose=True)
    kernels.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(path),
          "ptxas": [ln for ln in log.splitlines() if "registers" in ln or "spill" in ln]})

    rng = np.random.default_rng(SEED)
    entries = [check_nms(rng), check_fused_matmul(rng), *check_boxes(rng)]
    torch.cuda.synchronize()
    emit({"phase": "kernels", "ok": True, "card": card_line, "kernels": entries})

    gen = torch.Generator().manual_seed(SEED)
    counts, variables, priors = phase_detect(rng, gen, card_line, args.profile)
    phase_detect_folded(rng, variables, priors)

    contract_keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
                     "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for e in entries:
        e["launches"] = counts[e["name"]]
    on_path = {"nms", "fused_matmul", "box_decode"}
    for e in entries:
        if e["name"] in on_path and e["launches"] < 1:
            raise AssertionError(f"{e['name']} was not launched on the main path")

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card_line, "kernels": entries,
                       "seconds": time.perf_counter() - t_start}, f, indent=1)

    emit({"kernels": [{k: e[k] for k in contract_keys} for e in entries]})
    print(card_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
