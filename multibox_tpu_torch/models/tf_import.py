"""TensorFlow checkpoint → this package's variables.

The reference restores an ImageNet-pretrained tf-slim Inception-v3
checkpoint into its backbone, excluding the detection-head scopes, and at
inference restores the ExponentialMovingAverage shadow variables
(SURVEY.md §2 C4, §5.4). This module does both for the port's backbone:

* :func:`import_slim_checkpoint`: name-mapped import from a tf-slim
  ``InceptionV3/...`` checkpoint (``tf.train.load_checkpoint``), optionally
  reading the EMA shadows (``.../ExponentialMovingAverage``);
* :func:`import_keras_inception_v3`: order-based import from
  ``tf.keras.applications.InceptionV3``, whose Conv/BN layers are created
  in the order the backbone creates its units.

Both write into the variables ``models.convert.flax_to_torch`` produces,
``{"params": {name: tensor}, "batch_stats": {name: tensor}}``, and give
exactly what that conversion gives of the JAX package's import:

  TF conv kernel ``[kh, kw, cin, cout]`` → ``<unit>.Conv.weight``
  ``[cout, cin, kh, kw]``; slim BN ``beta`` → ``<unit>.BatchNorm.bias``,
  ``moving_mean`` / ``moving_variance`` → ``batch_stats``
  ``<unit>.BatchNorm.mean`` / ``.var``.

slim's naming quirks: ``Mixed_5c/Branch_1`` uses ``Conv2d_0b_1x1`` and
``Conv_1_0c_5x5`` where every other 35×35 block uses ``0a_1x1`` /
``0b_5x5``, and ``Mixed_7c/Branch_1`` names its 3×1 conv ``0c``.

TensorFlow is host-side tooling, imported inside the functions that read
its formats; without it they raise ``ImportError`` naming it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_STEM = [
    "Conv2d_1a_3x3",
    "Conv2d_2a_3x3",
    "Conv2d_2b_3x3",
    "Conv2d_3b_1x1",
    "Conv2d_4a_3x3",
]

_BLOCK_UNITS = {
    "InceptionA": [
        "Branch_0/Conv2d_0a_1x1",
        "Branch_1/Conv2d_0a_1x1",
        "Branch_1/Conv2d_0b_5x5",
        "Branch_2/Conv2d_0a_1x1",
        "Branch_2/Conv2d_0b_3x3",
        "Branch_2/Conv2d_0c_3x3",
        "Branch_3/Conv2d_0b_1x1",
    ],
    "ReductionA": [
        "Branch_0/Conv2d_1a_1x1",
        "Branch_1/Conv2d_0a_1x1",
        "Branch_1/Conv2d_0b_3x3",
        "Branch_1/Conv2d_1a_1x1",
    ],
    "InceptionB": [
        "Branch_0/Conv2d_0a_1x1",
        "Branch_1/Conv2d_0a_1x1",
        "Branch_1/Conv2d_0b_1x7",
        "Branch_1/Conv2d_0c_7x1",
        "Branch_2/Conv2d_0a_1x1",
        "Branch_2/Conv2d_0b_7x1",
        "Branch_2/Conv2d_0c_1x7",
        "Branch_2/Conv2d_0d_7x1",
        "Branch_2/Conv2d_0e_1x7",
        "Branch_3/Conv2d_0b_1x1",
    ],
    "ReductionB": [
        "Branch_0/Conv2d_0a_1x1",
        "Branch_0/Conv2d_1a_3x3",
        "Branch_1/Conv2d_0a_1x1",
        "Branch_1/Conv2d_0b_1x7",
        "Branch_1/Conv2d_0c_7x1",
        "Branch_1/Conv2d_1a_3x3",
    ],
    "InceptionC": [
        "Branch_0/Conv2d_0a_1x1",
        "Branch_1/Conv2d_0a_1x1",
        "Branch_1/Conv2d_0b_1x3",
        "Branch_1/Conv2d_0b_3x1",
        "Branch_2/Conv2d_0a_1x1",
        "Branch_2/Conv2d_0b_3x3",
        "Branch_2/Conv2d_0c_1x3",
        "Branch_2/Conv2d_0d_3x1",
        "Branch_3/Conv2d_0b_1x1",
    ],
}

_BLOCKS = [
    ("Mixed_5b", "InceptionA"),
    ("Mixed_5c", "InceptionA"),
    ("Mixed_5d", "InceptionA"),
    ("Mixed_6a", "ReductionA"),
    ("Mixed_6b", "InceptionB"),
    ("Mixed_6c", "InceptionB"),
    ("Mixed_6d", "InceptionB"),
    ("Mixed_6e", "InceptionB"),
    ("Mixed_7a", "ReductionB"),
    ("Mixed_7b", "InceptionC"),
    ("Mixed_7c", "InceptionC"),
]


def conv_unit_order() -> list:
    """All ConvBN unit paths in construction order (94 units)."""
    units = list(_STEM)
    for block, kind in _BLOCKS:
        units += [f"{block}/{u}" for u in _BLOCK_UNITS[kind]]
    return units


def _unit_key(prefix: str, unit: str) -> str:
    """The variables' key of a conv unit: the block and the branch's module
    name joined with dots (``Mixed_5b.Branch_0/Conv2d_0a_1x1``; the module
    name keeps its ``/``)."""
    block, _, rest = unit.partition("/")
    return prefix + (f"{block}.{rest}" if rest else block)


def _slim_name(unit: str) -> str:
    """Our unit path → the slim variable scope for that conv unit."""
    # slim quirk: Mixed_5c/Branch_1 names.
    if unit == "Mixed_5c/Branch_1/Conv2d_0a_1x1":
        return "Mixed_5c/Branch_1/Conv2d_0b_1x1"
    if unit == "Mixed_5c/Branch_1/Conv2d_0b_5x5":
        return "Mixed_5c/Branch_1/Conv_1_0c_5x5"
    # slim quirk: Mixed_7c/Branch_1 names its 3x1 conv 0c (Mixed_7b uses 0b).
    if unit == "Mixed_7c/Branch_1/Conv2d_0b_3x1":
        return "Mixed_7c/Branch_1/Conv2d_0c_3x1"
    return unit


def require_tensorflow(what: str):
    try:
        import tensorflow as tf  # local import: TF is host-side tooling only
    except ImportError as e:
        raise ImportError(f"{what} needs TensorFlow, which is not installed") from e
    return tf


def import_slim_checkpoint(
    ckpt_path: str,
    variables: Dict[str, Dict[str, torch.Tensor]],
    backbone_scope: str = "InceptionV3",
    use_ema: bool = False,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Load a tf-slim InceptionV3 checkpoint into the backbone's variables.

    ``variables``: ``{"params", "batch_stats"}`` of a detector (the head's
    are left as they are: the reference restores the backbone and keeps a
    fresh head) or of a bare backbone. ``use_ema`` reads
    ``<var>/ExponentialMovingAverage`` shadows where the checkpoint has
    them (the reference's inference-time restore). Returns new
    dictionaries; the tensors of ``variables`` are not written. A variable
    missing from the checkpoint raises ``KeyError``."""
    tf = require_tensorflow("reading a tf-slim checkpoint")
    reader = tf.train.load_checkpoint(ckpt_path)
    shape_map = reader.get_variable_to_shape_map()

    def read(name):
        if use_ema and f"{name}/ExponentialMovingAverage" in shape_map:
            return reader.get_tensor(f"{name}/ExponentialMovingAverage")
        if name not in shape_map:
            raise KeyError(f"variable {name} not found in checkpoint {ckpt_path}")
        return reader.get_tensor(name)

    def source(unit):
        slim = f"{backbone_scope}/{_slim_name(unit)}"
        return (read(f"{slim}/weights"), read(f"{slim}/BatchNorm/beta"),
                read(f"{slim}/BatchNorm/moving_mean"),
                read(f"{slim}/BatchNorm/moving_variance"))

    return _assign_units(variables, conv_unit_order(), map(source, conv_unit_order()))


def import_keras_inception_v3(
    keras_model, variables: Dict[str, Dict[str, torch.Tensor]]
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Copy weights from ``tf.keras.applications.InceptionV3`` (include_top
    irrelevant) into the backbone's variables, pairing Conv/BN layers in
    creation order. Returns new dictionaries, as
    :func:`import_slim_checkpoint`."""
    convs, bns = [], []
    for layer in keras_model.layers:
        cls = type(layer).__name__
        if cls == "Conv2D":
            convs.append(layer)
        elif cls == "BatchNormalization":
            bns.append(layer)

    # model.layers is topologically sorted (parallel branches interleave);
    # keras auto-names carry the creation counter ("conv2d", "conv2d_1", …)
    # which matches source construction order — sort on it.
    def creation_index(layer):
        suffix = layer.name.rsplit("_", 1)[-1]
        return int(suffix) if suffix.isdigit() else 0

    convs.sort(key=creation_index)
    bns.sort(key=creation_index)
    units = conv_unit_order()
    if len(convs) < len(units):
        raise ValueError(f"keras model has {len(convs)} convs; expected >= {len(units)}")
    sources = ((conv.get_weights()[0], *bn.get_weights()) for conv, bn in zip(convs, bns))
    return _assign_units(variables, units, sources)


def _assign_units(variables, units, sources):
    """Each unit's ``(kernel HWIO, beta, moving_mean, moving_variance)``
    into copies of ``params`` and ``batch_stats``."""
    params = dict(variables["params"])
    stats = dict(variables.get("batch_stats", {}))
    prefix = "InceptionV3." if any(k.startswith("InceptionV3.") for k in params) else ""
    for unit, (kernel, beta, mean, var) in zip(units, sources):
        key = _unit_key(prefix, unit)
        weight = np.transpose(np.asarray(kernel), (3, 2, 0, 1))  # HWIO → OIHW
        params[f"{key}.Conv.weight"] = _check_assign(params[f"{key}.Conv.weight"], weight)
        params[f"{key}.BatchNorm.bias"] = _check_assign(params[f"{key}.BatchNorm.bias"], beta)
        stats[f"{key}.BatchNorm.mean"] = _check_assign(stats[f"{key}.BatchNorm.mean"], mean)
        stats[f"{key}.BatchNorm.var"] = _check_assign(stats[f"{key}.BatchNorm.var"], var)
    out = dict(variables)
    out["params"] = params
    out["batch_stats"] = stats
    return out


def _check_assign(old: torch.Tensor, new) -> torch.Tensor:
    new = np.asarray(new)
    if tuple(old.shape) != tuple(new.shape):
        raise ValueError(f"shape mismatch: torch {tuple(old.shape)} vs tf {new.shape}")
    return torch.from_numpy(np.array(new, order="C")).to(old.device, old.dtype)
