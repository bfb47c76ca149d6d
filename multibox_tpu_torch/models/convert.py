"""Checkpoint conversion: flax variable trees → this package's variables.

:func:`flax_to_torch` takes the JAX package's variables as a nested
dictionary of **numpy** arrays (``params``, ``batch_stats``, optionally
``ema``) and returns the flat dictionaries ``models.detector.apply`` takes.
It imports neither framework of the source side: the caller hands over
plain numpy (``jax.tree_util.tree_map(np.asarray, variables)``).

Rules, leaf by leaf (the tree is walked by tuple keys — module names such
as ``Branch_0/Conv2d_0a_1x1`` contain ``/``, so joining on ``/`` and
splitting again would corrupt them):

* ``kernel`` of rank 4 (HWIO) → ``weight`` (OIHW); a grouped
  (depthwise) kernel ``[kh, kw, in / groups, out]`` becomes
  ``[out, in / groups, kh, kw]`` under the same transpose;
* ``kernel`` of rank 2 (``[in, out]``) → ``kernel`` unchanged;
* ``bias``, ``mean``, ``var``, ``scale`` of rank 1 → same name, same
  values (Inception's BatchNorm has no ``scale``, slim's convention;
  MobileNetV2's learns one);
* the int8 model's leaves (``models.quant``): ``kernel_q`` of rank 4 (int8
  HWIO) → ``kernel_q`` (OIHW) under the same transpose, ``w_scale`` of
  rank 1 and the ``quant`` collection's ``x_scale`` of rank 0 unchanged;
* anything else is refused.

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
        elif name == "kernel_q" and arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))
        elif name == "kernel" and arr.ndim == 2:
            pass
        elif name in ("bias", "mean", "var", "scale", "w_scale") and arr.ndim == 1:
            pass
        elif name == "x_scale" and arr.ndim == 0:
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
    """Convert ``{"params", "batch_stats"?, "ema"?}`` (the int8 model's
    ``{"params", "quant"}``) of numpy arrays to the variables of
    ``MultiBoxDetector`` on ``device`` (``None`` = CUDA)."""
    device = resolve_device(device)
    unknown = set(variables) - {"params", "batch_stats", "ema", "quant"}
    if unknown:
        raise ValueError(f"unknown variable collections: {sorted(unknown)}")
    if "params" not in variables:
        raise ValueError("variables have no 'params' collection")
    return {
        name: _convert_collection(variables[name], device)
        for name in ("params", "batch_stats", "ema", "quant")
        if name in variables
    }
