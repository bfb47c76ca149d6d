"""The program's host spans in a traced stretch (``multibox_tpu_torch.utils.spans``,
recorded by the profiler as host events): a span's time less that of its
named children inside it, a traced batch or step."""

from __future__ import annotations

from typing import Optional, Sequence

from benchmark import devtrace


def self_ms(trace: devtrace.Trace, parent: str, children: Sequence[str] = ()) -> Optional[float]:
    """ms of every ``parent`` span less the ``children`` spans that lie
    inside one, summed; None where the trace holds no ``parent`` (a program
    without the span)."""
    parents = [e for e in trace.host if e.name == parent]
    if not parents:
        return None
    kids = [e for e in trace.host if e.name in children]
    total = 0.0
    for p in parents:
        total += p.end_us - p.start_us
        total -= sum(k.end_us - k.start_us for k in kids
                     if p.start_us <= k.start_us and k.end_us <= p.end_us)
    return total / 1e3


def per_traced_ms(ctx, parent: str, children: Sequence[str] = ()) -> Optional[float]:
    """:func:`self_ms` over the traced batches (detect) or steps (train)."""
    ms = self_ms(ctx.trace, parent, children)
    return None if ms is None else ms / len(ctx.traced)
