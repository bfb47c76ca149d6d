"""What the per-layer readers share: the idle share and model-FLOP share of
a traced run, a part of the program timed alone as a CUDA graph, the
program's head outputs on a pool batch, and a kernel's roofline share."""

from __future__ import annotations

from typing import Optional

import torch

from benchmark import count, devtrace


def idle_share(ctx) -> float:
    """% of the traced window in which no kernel or copy ran on the device."""
    busy, window = devtrace.busy_and_window_s(ctx.trace)
    return 100.0 * (1.0 - busy / window)


def mfu(ctx, rate: str, train: bool) -> float:
    """% of the card's dense bf16 peak that the model's operations take at
    the rate of the run's unprofiled window."""
    flops = count.model_flops(ctx.spec, train=train) * ctx.rates[rate]
    return 100.0 * flops / count.PEAK_FLOPS["bfloat16"]


def graph_ms(ctx, fn, replays: int = 50) -> float:
    """``fn`` captured alone as a CUDA graph (the program's own capture),
    then ms a replay by CUDA events over ``replays`` replays."""
    from multibox_tpu_torch import graphs

    with torch.no_grad():
        graph = graphs.CapturedGraph(fn, ctx.device)
    for _ in range(3):
        graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / replays


def model_input(ctx, index: int) -> torch.Tensor:
    """Pool batch ``index`` as the model takes it: the program's eval
    preprocessing of its canvases."""
    from multibox_tpu_torch.data.augment import preprocess_eval

    batch = ctx.runner.pool[index % len(ctx.runner.pool)]
    images = batch["images"] if isinstance(batch, dict) else batch
    return preprocess_eval(torch.as_tensor(images, device=ctx.device), ctx.spec["input_size"])


def head_outputs(ctx, index: int):
    """The program's ``(locations, confidences)`` on pool batch ``index``."""
    from multibox_tpu_torch.models import detector

    p = ctx.program
    with torch.no_grad():
        return detector.apply(p["model"], p["apply_vars"], model_input(ctx, index))


def roofline(ctx, pattern: str, bound_s: float) -> Optional[float]:
    """% of the traced time of the kernels named by ``pattern`` that
    ``bound_s`` (the least time of the same work) is; None where the trace
    holds no such kernel."""
    seconds, launches = devtrace.kernel_time(ctx.trace, pattern)
    if not launches:
        return None
    return 100.0 * bound_s / seconds
