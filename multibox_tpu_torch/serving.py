"""Serving: load an exported detector and run inference.

The consumer side of ``multibox-torch-export`` (own counterpart of the JAX
package's ``serving.py``). An export directory holds:

- ``detect.pt2``: the smallest exported batch size, a ``torch.export``
  program (``torch.export.save``) with the chosen weights and the priors
  baked in as its state; ``detect_b{N}.pt2`` for each further size
  (``--batch_sizes``);
- ``params.npz`` (the frozen weights, ``collection/name`` keys),
  ``priors.pkl``, ``config.json`` (the versioned config and the device the
  programs were traced on) and ``detect.graph.txt`` (the printed program).

:func:`load_exported` returns a ready detector: a callable
``detect(images) -> {boxes, scores, classes, num}`` plus its config and
priors, with no model code needed at serving time. The kernels' custom
operators (``multibox_torch::*``) are registered by importing this module,
before any program is loaded.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from multibox_tpu_torch import priors as priors_mod
from multibox_tpu_torch.config import Config, parse_config_dict
from multibox_tpu_torch.device import resolve_device
from multibox_tpu_torch.ops.kernels import box_kernel, fused_matmul, nms_kernel  # noqa: F401  (operators)
from multibox_tpu_torch.version import __version__

# config.json's layout; a loader refuses a newer one.
EXPORT_FORMAT = 1
PROGRAM = "detect.pt2"
SIBLING_GLOB = "detect_b*.pt2"

# output name -> (shape without the batch axis, dtype)
OutputSpecs = Dict[str, Tuple[Tuple[int, ...], np.dtype]]


def _host(leaf) -> np.ndarray:
    """One output on the host: a device-to-host copy for a tensor."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
    return np.asarray(leaf)


@dataclass
class ExportedDetector:
    detect: Callable[[torch.Tensor], Dict[str, torch.Tensor]]
    config: Config
    priors: np.ndarray
    batch_size: int
    input_size: int
    # batch size -> program; single-program exports have one entry.
    calls: Dict[int, Callable] = field(default_factory=dict)
    device: torch.device = torch.device("cpu")
    # per output: the shape after the batch axis and the dtype, from the
    # programs' own output specs (an empty batch is answered from them)
    output_specs: OutputSpecs = field(default_factory=dict)

    def warmup(self) -> None:
        """Run every exported batch-size program once on zeros and copy every
        output to the host before returning. A serving daemon calls this
        before it reports ready, so that the first request group of each size
        pays no first-call cost (kernel build and load, cuDNN's algorithm
        choice, the allocator's first blocks). The copy of each output is the
        synchronisation: ``ready`` must not fire while a program is still in
        flight."""
        for size in sorted(self.calls):
            dummy = torch.zeros((size, self.input_size, self.input_size, 3),
                                dtype=torch.float32, device=self.device)
            with torch.no_grad():
                out = self.calls[size](dummy)
            for leaf in pytree.tree_leaves(out):
                _host(leaf)

    def __call__(self, images) -> Dict[str, np.ndarray]:
        """Run detection on ``[B, S, S, 3]`` float32 images in [-1, 1].

        Exported programs have static batch shapes; requests dispatch to the
        best-fitting exported size (greedily the largest program ≤ the
        remainder, the smallest program, padded, for the tail), so a
        multi-size export pads at most ``min(sizes) - 1`` rows a request.
        """
        images = np.asarray(images, np.float32)
        B = images.shape[0]
        sizes = sorted(self.calls) or [self.batch_size]
        if B == 0:
            # answered from the output specs, without running a program
            return {k: np.zeros((0,) + shape, dtype)
                    for k, (shape, dtype) in self.output_specs.items()}
        out_parts = []
        start = 0
        while start < B:
            rem = B - start
            fitting = [s for s in sizes if s <= rem]
            size = max(fitting) if fitting else sizes[0]
            n = min(size, rem)
            chunk = images[start:start + n]
            if n < size:
                pad = np.zeros((size - n,) + chunk.shape[1:], np.float32)
                chunk = np.concatenate([chunk, pad])
            call = self.calls.get(size, self.detect)
            with torch.no_grad():
                res = call(torch.from_numpy(chunk).to(self.device))
            out_parts.append({k: _host(v)[:n] for k, v in res.items()})
            start += n
        return {k: np.concatenate([p[k] for p in out_parts]) for k in out_parts[0]}


def write_config(cfg: Config, path: str, device: torch.device) -> None:
    """``config.json``: the format number, the package version, the device
    the programs were traced on and every config field. JSON keyed by field
    name, read back through ``config.parse_config_dict``, so that a field
    added or removed later loads with its default or a warning instead of
    failing as a pickled dataclass would."""
    with open(path, "w") as f:
        json.dump({"format": EXPORT_FORMAT, "version": __version__,
                   "device": torch.device(device).type,
                   "config": dataclasses.asdict(cfg)}, f, indent=1, sort_keys=True)


def read_config(path: str) -> Tuple[Config, str]:
    """``(config, device type)`` from a ``config.json``."""
    with open(path) as f:
        raw = json.load(f)
    if raw.get("format", 0) > EXPORT_FORMAT:
        raise ValueError(
            f"{path}: export format {raw.get('format')} is newer than this "
            f"package's {EXPORT_FORMAT}")
    cfg = parse_config_dict(raw["config"])
    # JSON has no tuples: give the tuple-valued fields back their type
    for f in dataclasses.fields(cfg):
        if isinstance(getattr(Config(), f.name), tuple):
            setattr(cfg, f.name, tuple(getattr(cfg, f.name)))
    return cfg, raw["device"]


def output_specs(program) -> OutputSpecs:
    """Each output's shape after the batch axis and its dtype, read from an
    ``ExportedProgram``'s graph (the traced values of its outputs)."""
    out_node = next(n for n in program.graph.nodes if n.op == "output")
    vals = [a.meta["val"] for a in out_node.args[0]]
    tree = pytree.tree_unflatten(vals, program.call_spec.out_spec)
    return {k: (tuple(int(d) for d in v.shape[1:]), torch.empty((), dtype=v.dtype).numpy().dtype)
            for k, v in tree.items()}


def load_exported(export_dir: str, device=None) -> ExportedDetector:
    """Load a ``multibox-torch-export`` directory into a callable detector
    on ``device`` (``None`` is the CUDA device, and raises without one).

    Reads the primary ``detect.pt2`` and any ``detect_b{N}.pt2`` siblings
    and dispatches each request by batch size; on a batch-size collision the
    primary program wins. Refuses a ``device`` other than the one the
    programs were traced on: their constants live there."""
    device = resolve_device(device)
    cfg, traced_on = read_config(os.path.join(export_dir, "config.json"))
    if traced_on != device.type:
        raise ValueError(
            f"{export_dir} was exported on {traced_on}; it cannot serve on {device} "
            f"(export it again with --device {device.type})")
    paths = [os.path.join(export_dir, PROGRAM)]
    paths += sorted(glob.glob(os.path.join(export_dir, SIBLING_GLOB)))
    calls: Dict[int, Callable] = {}
    input_size = specs = None
    for path in paths:
        program = torch.export.load(path)
        placeholder = next(n for n in program.graph.nodes if n.op == "placeholder"
                           and n.name in program.graph_signature.user_inputs)
        shape = placeholder.meta["val"].shape
        # primary first + setdefault: a stale sibling left by an older
        # export must not shadow the fresh program
        calls.setdefault(int(shape[0]), program.module())
        if input_size is None:
            input_size, specs = int(shape[1]), output_specs(program)
    priors = priors_mod.load_priors(os.path.join(export_dir, "priors.pkl"))
    largest = max(calls)
    return ExportedDetector(detect=calls[largest], config=cfg, priors=np.asarray(priors),
                            batch_size=largest, input_size=input_size, calls=calls,
                            device=device, output_specs=specs)
