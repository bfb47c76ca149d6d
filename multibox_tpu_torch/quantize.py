"""Int8 PTQ preparation: EMA-select → fold BN → quantize → calibrate.

Own counterpart of the JAX package's ``quantize.py``: the user-facing entry
point of the int8 detect path (``cfg.quantize = "int8"``). It produces the
variables that ``inference.make_detect_body`` applies directly:

    variables_q = prepare_quantized_variables(cfg, variables, calib_batches)
    results = run_detect_loop(cfg, variables_q, dataset, priors)

The detect CLI does this itself, calibrating on the first
``cfg.quant_calib_batches`` batches of its own input, and ``multibox-torch-export
--quantize int8`` on ``--calib_tfrecords``. See ``models/quant.py`` for the
scheme.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch
from torch.func import functional_call

from multibox_tpu_torch.config import Config
from multibox_tpu_torch.data.augment import preprocess_eval
from multibox_tpu_torch.device import resolve_device
from multibox_tpu_torch.models.inception_v3 import fold_batch_norms
from multibox_tpu_torch.models.quant import QuantConv, quantize_variables


@torch.no_grad()
def calibrate(model, variables: Dict[str, Dict[str, torch.Tensor]],
              images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One calibration pass of a ``quantize="calib"`` model over
    preprocessed ``images``: returns the new ``quant`` collection, each
    unit's ``max(x_scale, max|x|)``, the functional counterpart of flax's
    ``mutable=["quant"]``."""
    convs = [(name, m) for name, m in model.named_modules() if isinstance(m, QuantConv)]
    for _, m in convs:
        m.updated = None
    tensors = {**variables["params"], **variables["quant"]}
    functional_call(model, tensors, (images,), {"train": False}, strict=True)
    quant = {}
    for name, m in convs:
        quant[f"{name}.x_scale"] = m.updated
        m.updated = None
    return quant


def prepare_quantized_variables(
    cfg: Config,
    variables,
    calib_images: Iterable[np.ndarray],
    use_ema: bool = None,
    device=None,
):
    """Bake trained variables into calibrated int8 detect variables.

    Args:
      variables: ``params`` (+ ``ema``, ``batch_stats``) as
        ``TrainState.detect_variables`` returns them, on ``device``.
      calib_images: iterable of uint8 batches ``[B, S, S, 3]`` (the detect
        input format: they are preprocessed on the device as the detect
        loop does, so calibration sees the true activations).
      use_ema: default ``cfg.use_ema_for_detect``; the EMA choice is baked
        in here (the quantized variables have no shadow params).
      device: ``None`` is the CUDA device (raises without one).

    Returns ``{"params", "quant"}`` for the ``quantize="int8"`` model.
    """
    from multibox_tpu_torch.inference import build_model

    device = resolve_device(device)
    if use_ema is None:
        use_ema = cfg.use_ema_for_detect
    params = variables["params"]
    if use_ema and "ema" in variables:
        params = variables["ema"]
    folded = fold_batch_norms(
        {"params": params, "batch_stats": variables.get("batch_stats", {})})
    scope = {"inception_v3": "InceptionV3", "mobilenet_v2": "MobileNetV2"}[cfg.backbone]
    vq = quantize_variables(folded, backbone_scope=scope)

    calib_model = build_model(cfg, cfg.num_priors, folded=True, quantize="calib",
                              device=device)
    quant = vq["quant"]
    n = 0
    for images in calib_images:
        imgs = preprocess_eval(torch.as_tensor(np.asarray(images)).to(device),
                               cfg.input_size)
        quant = calibrate(calib_model, {"params": vq["params"], "quant": quant}, imgs)
        n += 1
    if n == 0:
        raise ValueError(
            "int8 calibration needs at least one image batch "
            "(got an empty calib_images iterable)")
    return {"params": vq["params"], "quant": quant}


def calib_batches_from_dataset(dataset, num_batches: int):
    """First ``num_batches`` image arrays from a ``DetectionDataset``-style
    iterable (each item a dict with an ``images`` uint8 array)."""
    out = []
    for batch in dataset:
        out.append(np.asarray(batch["images"]))
        if len(out) >= num_batches:
            break
    return out
