"""The device trace of a traced stretch, and what the readers take from it.

``torch.profiler`` records the host's operations and the device's kernels
and copies (CUPTI); a stretch is wrapped in one host span, ``STRETCH``, whose
length is the traced window. Busy time is the union of the device's
intervals inside it: kernels, copies and sets (the ranges that host spans
leave on the device's timeline are no work and are left out). An idle gap
is named by the innermost host span or operation running at its middle.
"""

from __future__ import annotations

import re
from typing import Callable, List, NamedTuple, Tuple

import torch

STRETCH = "bench.traced_stretch"


class Event(NamedTuple):
    start_us: float
    end_us: float
    name: str


class Trace(NamedTuple):
    device: List[Event]  # kernels, copies and sets, by start
    host: List[Event]  # host operations and spans
    window: Event  # the stretch's own span


def record(fn: Callable[[], None]) -> Trace:
    """``fn()`` under the profiler, inside the span :data:`STRETCH`; the
    device is synchronized before the span closes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH):
            fn()
            torch.cuda.synchronize()
    device, host, window = [], [], None
    for e in prof.events():
        ev = Event(float(e.time_range.start), float(e.time_range.end), e.name)
        if e.device_type == DeviceType.CUDA:
            # a span's range on the device's timeline is no work of the device
            if not (e.is_user_annotation or e.name.startswith("bench.")):
                device.append(ev)
        elif e.name == STRETCH:
            window = ev
        else:
            host.append(ev)
    if window is None or not device:
        raise RuntimeError("the profiler recorded no stretch or no device event")
    device.sort()
    return Trace(device, host, window)


def busy_intervals(trace: Trace) -> List[Tuple[float, float]]:
    """The union of the device's intervals inside the window, in order."""
    out: List[Tuple[float, float]] = []
    lo, hi = trace.window.start_us, trace.window.end_us
    for e in trace.device:
        s, t = max(e.start_us, lo), min(e.end_us, hi)
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def busy_and_window_s(trace: Trace) -> Tuple[float, float]:
    busy = sum(t - s for s, t in busy_intervals(trace))
    return busy / 1e6, (trace.window.end_us - trace.window.start_us) / 1e6


def kernel_time(trace: Trace, pattern: str) -> Tuple[float, int]:
    """Seconds and launches of the device kernels whose name matches
    ``pattern`` (a regular expression searched in the name)."""
    rx = re.compile(pattern)
    hits = [e for e in trace.device if rx.search(e.name)]
    return sum(e.end_us - e.start_us for e in hits) / 1e6, len(hits)


def breakdown(trace: Trace, top: int = 10):
    """``{"device_ops": [[name, seconds]], "idle_gaps": [[name, seconds]]}``:
    the device operations that took most time, summed by name, and the
    longest idle gaps of the window, each by the host's innermost span or
    operation at its middle."""
    by_name = {}
    for e in trace.device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.end_us - e.start_us) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, at = [], trace.window.start_us
    for s, t in busy_intervals(trace) + [(trace.window.end_us, trace.window.end_us)]:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, t in gaps:
        mid = 0.5 * (s + t)
        around = [e for e in trace.host if e.start_us <= mid <= e.end_us]
        name = min(around, key=lambda e: e.end_us - e.start_us).name if around else "none"
        named.append([name[:120], (t - s) / 1e6])
    return {"device_ops": [[n[:120], v] for n, v in ops], "idle_gaps": named}
