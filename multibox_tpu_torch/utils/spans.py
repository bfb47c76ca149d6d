"""Named host spans at the boundaries of the detect loop and the graphed
train step, recorded by ``torch.profiler`` on the clock of the device's
kernels and copies.

A span is a ``record_function`` range while a profiler records, and one
shared null context otherwise, so that a loop with no profiler pays one
check a span. No span is opened inside code that a CUDA graph captures: it
would be recorded once, at the capture, and never at a replay.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context that records ``name`` while a profiler records."""
    return torch.autograd.profiler.record_function(name) if _recording() else _OFF
