"""Checkpoint conversion: flax variable trees → this package's variables.

:func:`flax_to_torch` takes the JAX package's variables as a nested
dictionary of **numpy** arrays (``params``, ``batch_stats``, optionally
``ema``) and returns the flat dictionaries ``models.detector.apply`` takes.
It imports neither framework of the source side: the caller hands over
plain numpy (``jax.tree_util.tree_map(np.asarray, variables)``).

Rules, leaf by leaf (the tree is walked by tuple keys — module names such
as ``Branch_0/Conv2d_0a_1x1`` contain ``/``, so joining on ``/`` and
splitting again would corrupt them):

* ``kernel`` of rank 4 (HWIO) → ``weight`` (OIHW);
* ``kernel`` of rank 2 (``[in, out]``) → ``kernel`` unchanged;
* ``bias``, ``mean``, ``var`` → same name, same values;
* BatchNorm has ``bias``, ``mean``, ``var`` and no ``scale`` (slim
  convention, eps 1e-3); a ``scale`` leaf is refused.

The ``ema`` tree has the shape of ``params`` and converts the same way.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from multibox_tpu_torch.device import resolve_device


def _walk(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def _convert_collection(tree: Mapping, device) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(tree):
        arr = np.asarray(leaf)
        scope, name = ".".join(path[:-1]), path[-1]
        if any("." in part for part in path):
            raise ValueError(f"module name with a dot cannot be mapped: {path}")
        if name == "kernel" and arr.ndim == 4:
            name, arr = "weight", np.transpose(arr, (3, 2, 0, 1))  # HWIO → OIHW
        elif name == "kernel" and arr.ndim == 2:
            pass
        elif name in ("bias", "mean", "var") and arr.ndim == 1:
            pass
        else:
            raise ValueError(
                f"no rule for leaf {'/'.join(path)} of shape {arr.shape}")
        key = f"{scope}.{name}"
        if key in out:
            raise ValueError(f"two leaves map to {key}")
        # np.array copies: the tensor never aliases (or inherits the
        # read-only flag of) the caller's array
        out[key] = torch.from_numpy(np.array(arr, order="C")).to(device)
    return out


def flax_to_torch(variables: Mapping, device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Convert ``{"params", "batch_stats"?, "ema"?}`` of numpy arrays to
    the variables of ``MultiBoxDetector`` on ``device`` (``None`` = CUDA)."""
    device = resolve_device(device)
    unknown = set(variables) - {"params", "batch_stats", "ema"}
    if unknown:
        raise ValueError(f"unknown variable collections: {sorted(unknown)}")
    if "params" not in variables:
        raise ValueError("variables have no 'params' collection")
    return {
        name: _convert_collection(variables[name], device)
        for name in ("params", "batch_stats", "ema")
        if name in variables
    }
