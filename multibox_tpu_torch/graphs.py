"""CUDA graphs: the detect and train steps captured once and replayed as one
launch.

In the JAX package a step is one compiled device program (``jax.jit``), and
``cfg.steps_per_host_transfer = K`` runs K steps in one device call
(``lax.scan``) with one transfer each way. The CUDA counterpart is a CUDA
graph: the step's hundreds to thousands of kernels, the hand-written ones
included, captured once from the eager code and replayed with one
``cudaGraphLaunch``. ``inference.run_detect_loop`` and
``train.loop.train_from_batches`` use them on the card without being
asked; a graph holds K steps, fed by one copy of the K stacked inputs
(:class:`StagedInputs`), and nothing waits for the device inside it.

How a graph is made (:class:`CapturedGraph`):

- its step runs once eagerly on the capture stream first (the warm-up), so
  that whatever a first call sets up (the kernels' shared-memory opt-in,
  cuBLAS and cuDNN workspaces, the launch plans, device constants) exists
  before the capture;
- the capture records the same calls; tensors they allocate come from the
  graph's own memory pool and live as long as the graph, and so do the
  kernels' scratch buffers (``ops.kernels.graph_scratch``);
- the launches the wrappers count during the warm-up and the capture are
  set aside; the capture's are added again at every replay, so that
  ``ops.kernels.launch_counts()`` reads as after the eager steps;
- each capture is counted by its owner (``"detect"``, ``"train"`` or
  ``"other"``) with the host seconds of its warm-up and its capture
  (:func:`capture_counts`), kept apart from the steps' own time;
- random numbers come from generators registered with the graph and seeded
  again before each replay, so that a replay draws what a fresh generator
  of the same seed draws eagerly.

A capture or a replay that fails raises: nothing falls back to the eager
path. What stays eager, by rule (:func:`eager_reason`):

- the CPU (no graphs there), which is what every CPU test runs;
- a caller that asks for it with ``eager=True`` (``chip_smoke.py`` does, to
  hold the graphs against it);
- train steps with Hungarian matching (its exit tests wait for the device,
  ``ops.matching``), under anomaly detection (``cfg.debug_nans``: its checks
  wait for the device), and data-parallel train steps over a group of more
  than one rank (their collectives are issued from the host,
  ``parallel.mesh``).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from multibox_tpu_torch.ops import kernels
from multibox_tpu_torch.utils.spans import span

log = logging.getLogger(__name__)


def eager_reason(device: torch.device, eager: bool = False, cfg=None,
                 parallel_ranks: int = 1) -> Optional[str]:
    """Why a step on ``device`` runs eagerly, or None when it is captured.
    ``cfg`` is given for a train step; ``parallel_ranks`` is the number of
    ranks its collectives span."""
    if device.type != "cuda":
        return f"the device is {device.type}, not CUDA"
    if eager:
        return "the caller asked for the eager path"
    if cfg is not None:
        if cfg.matching == "hungarian":
            return "Hungarian matching waits for the device in its exit tests"
        if cfg.debug_nans:
            return "anomaly detection (debug_nans) waits for the device in its checks"
        if parallel_ranks > 1:
            return (f"a data-parallel step over {parallel_ranks} ranks issues its "
                    "collectives from the host")
    return None


_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream a device's warm-ups and captures run on."""
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = torch.cuda.Stream(device=device)
        _CAPTURE_STREAMS[device] = stream
    return stream


class StagedInputs:
    """Host arrays → one pinned host buffer → one copy to a device buffer,
    whose views are a graph's static inputs.

    ``specs`` maps a name to ``(shape, numpy dtype)``; each field starts on
    16 bytes of both buffers. :meth:`put` waits (on the host) only for the
    previous copy out of the pinned buffer, never for a graph."""

    def __init__(self, specs: Dict[str, Tuple[Tuple[int, ...], np.dtype]],
                 device: torch.device):
        self.specs = {k: (tuple(shape), np.dtype(dt)) for k, (shape, dt) in specs.items()}
        offsets, total = {}, 0
        for name, (shape, dt) in self.specs.items():
            offsets[name] = total
            total += -(-int(np.prod(shape, dtype=np.int64)) * dt.itemsize // 16) * 16
        self.host = torch.empty(max(total, 16), dtype=torch.uint8, pin_memory=True)
        self.device_buf = torch.empty(max(total, 16), dtype=torch.uint8, device=device)
        host_np = self.host.numpy()
        self.host_views: Dict[str, np.ndarray] = {}
        self.views: Dict[str, torch.Tensor] = {}
        for name, (shape, dt) in self.specs.items():
            n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            lo = offsets[name]
            self.host_views[name] = host_np[lo:lo + n].view(dt).reshape(shape)
            tdt = torch.from_numpy(np.empty(0, dt)).dtype
            self.views[name] = self.device_buf[lo:lo + n].view(tdt).view(shape)
        self._copied: Optional[torch.cuda.Event] = None

    def put(self, fields: Dict[str, Sequence[np.ndarray]]) -> None:
        """Write each field (a sequence of arrays stacked along the first
        axis, or one array) into the pinned buffer, then one asynchronous
        copy to the device on the current stream."""
        with span("graphs.stage"):
            with span("graphs.stage.wait"):
                if self._copied is not None:
                    self._copied.synchronize()  # the last copy out of the pinned buffer
            for name, value in fields.items():
                dst = self.host_views[name]
                if isinstance(value, np.ndarray):
                    _copy_into(dst, value, name)
                else:
                    if len(value) != dst.shape[0]:
                        raise ValueError(f"staged input {name!r}: {len(value)} arrays for "
                                         f"{dst.shape[0]} slots")
                    for i, a in enumerate(value):
                        _copy_into(dst[i], np.asarray(a), name)
            self.device_buf.copy_(self.host, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record()


def _copy_into(dst: np.ndarray, src: np.ndarray, name: str) -> None:
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise ValueError(f"staged input {name!r}: got {src.dtype}{list(src.shape)}, the "
                         f"graph was captured for {dst.dtype}{list(dst.shape)}")
    np.copyto(dst, src)


def spec_of(arrays: Sequence[np.ndarray]) -> Tuple[Tuple[int, ...], np.dtype]:
    """``(shape, dtype)`` of arrays stacked along a new first axis."""
    first = np.asarray(arrays[0])
    return (len(arrays),) + first.shape, first.dtype


CAPTURES: Dict[str, Dict[str, float]] = {}


def capture_counts() -> Dict[str, Dict[str, float]]:
    """``{owner: {"captures": n, "warmup_s": s, "capture_s": s}}``: the
    graphs made since the last reset, and the host seconds of their
    warm-ups (until the device finished them) and captures."""
    return {owner: dict(c) for owner, c in CAPTURES.items()}


def reset_capture_counts() -> None:
    CAPTURES.clear()


class CapturedGraph:
    """``fn`` captured as a CUDA graph on ``device``.

    ``warmup`` (default ``fn``) runs once eagerly on the capture stream
    first; ``generators`` are registered with the graph (the caller seeds
    them before each :meth:`replay`). ``outputs`` is what ``fn`` returned
    during the capture: tensors of the graph's pool, rewritten by every
    replay. ``launches`` is what the wrappers counted during the capture.
    ``owner`` names the step in :func:`capture_counts`."""

    def __init__(self, fn: Callable, device: torch.device,
                 warmup: Optional[Callable] = None,
                 generators: Sequence[torch.Generator] = (), owner: str = "other"):
        self.device = device
        stream = capture_stream(device)
        with span("graphs.capture"):
            t0 = time.perf_counter()
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream), kernels.launches_set_aside():
                (warmup or fn)()
            stream.synchronize()  # as the capture would at its start
            t1 = time.perf_counter()
            torch.cuda.current_stream(device).wait_stream(stream)
            self.graph = torch.cuda.CUDAGraph()
            for gen in generators:
                self.graph.register_generator_state(gen)
            with kernels.launches_set_aside() as seen, kernels.graph_scratch() as owned:
                with torch.cuda.graph(self.graph, stream=stream):
                    self.outputs = fn()
            t2 = time.perf_counter()
        count = CAPTURES.setdefault(owner, {"captures": 0, "warmup_s": 0.0, "capture_s": 0.0})
        count["captures"] += 1
        count["warmup_s"] += t1 - t0
        count["capture_s"] += t2 - t1
        self.launches = dict(seen)
        self.scratch = owned  # the kernels' buffers the graph writes
        self.generators = tuple(generators)

    def replay(self) -> None:
        """One launch of the whole graph on the current stream."""
        with span("graphs.replay"):
            self.graph.replay()
        kernels.add_launches(self.launches)
