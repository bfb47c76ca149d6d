"""Full detector: Inception-v3 backbone + MultiBox head.

The public model surface — ``(variables, images) → (locations,
confidences)`` — as one ``nn.Module`` whose weights are passed per call.

Variables are a dictionary of flat dictionaries keyed by the module's
state-dict names: ``params`` (everything trainable), ``batch_stats`` (the
BatchNorm ``mean`` / ``var`` buffers) and optionally ``ema`` (moving
averages, shaped like ``params``). :func:`apply` runs the module on one
such set with ``torch.func.functional_call``; choosing ``ema`` over
``params`` costs no copy.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn
from torch.func import functional_call

from multibox_tpu_torch.models.heads import MultiBoxHead
from multibox_tpu_torch.models.inception_v3 import InceptionV3, feature_grid

Variables = Dict[str, Dict[str, torch.Tensor]]


class MultiBoxDetector(nn.Module):
    """Inception-v3 + MultiBox head → ``(locations, confidences)``.

    Args:
      num_priors: P (must equal the loaded priors' row count).
      input_size: side of the square model input; fixes the width of the
        head's fully-connected layers.
      head_type: ``"multibox"`` (FC head over Mixed_7c). ``"ssd"`` is not
        ported yet.
      num_classes: 1 for class-agnostic detection (reference behavior).
      compute_dtype: bfloat16 by default; params stay f32.
      device: where :meth:`init_variables` puts what it makes.

    Input images: ``[B, H, W, 3]`` float32 in ``[-1, 1]``
    (``inception_v3.preprocess_slim``). Default H = W = 299.
    """

    def __init__(self, num_priors: int, input_size: int = 299,
                 backbone: str = "inception_v3", head_type: str = "multibox",
                 num_classes: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 folded: bool = False, use_pallas: Optional[bool] = None,
                 quantize: Optional[str] = None, bottleneck_features: int = 96,
                 device=None):
        super().__init__()
        if backbone == "mobilenet_v2":
            raise NotImplementedError("the MobileNetV2 backbone is not ported yet")
        if backbone != "inception_v3":
            raise ValueError(f"unknown backbone: {backbone}")
        if head_type == "ssd":
            raise NotImplementedError("the SSD head is not ported yet")
        if head_type != "multibox":
            raise ValueError(f"unknown head_type: {head_type}")
        self.num_priors = num_priors
        self.input_size = input_size
        self.folded = folded
        self.device = torch.device("cpu" if device is None else device)
        self.InceptionV3 = InceptionV3(
            compute_dtype=compute_dtype, folded=folded, use_pallas=use_pallas,
            quantize=quantize)
        self.MultiBoxHead = MultiBoxHead(
            num_priors=num_priors,
            in_features=self.InceptionV3.out_features,
            grid=feature_grid(input_size, "Mixed_7c"),
            num_classes=num_classes,
            bottleneck_features=bottleneck_features,
            endpoint="Mixed_7c",
            use_pallas=use_pallas,
        )

    def forward(self, images: torch.Tensor, train: bool = False):
        if images.shape[1] != self.input_size or images.shape[2] != self.input_size:
            raise ValueError(
                f"model built for {self.input_size}×{self.input_size} input, "
                f"got {tuple(images.shape)}")
        endpoints = self.InceptionV3(images, train=train)
        loc, conf = self.MultiBoxHead(endpoints, train=train)
        return loc, conf

    def init_variables(self, generator: torch.Generator) -> Variables:
        """Random variables for this module, drawn from ``generator`` (a CPU
        or CUDA ``torch.Generator``) and placed on ``self.device``: He-normal
        convolutions, LeCun-normal head, zero biases, BatchNorm mean 0 and
        variance 1. For smoke runs and tests; trained weights come through
        ``models.convert``."""
        dev = self.device
        params, stats = {}, {}
        for name, p in self.named_parameters():
            shape = tuple(p.shape)
            if name.endswith("bias"):
                params[name] = torch.zeros(shape, device=dev)
                continue
            if p.dim() == 4:  # OIHW
                fan_in = shape[1] * shape[2] * shape[3]
                gain = 2.0 if name.startswith("InceptionV3.") else 1.0
            else:  # dense kernel [in, out]
                fan_in, gain = shape[0], 1.0
            w = torch.randn(shape, generator=generator, device=generator.device)
            params[name] = (w * math.sqrt(gain / fan_in)).to(dev)
        for name, b in self.named_buffers():
            fill = torch.ones if name.endswith(".var") else torch.zeros
            stats[name] = fill(tuple(b.shape), device=dev)
        out = {"params": params}
        if stats:
            out["batch_stats"] = stats
        return out


def apply(model: MultiBoxDetector, apply_vars: Variables, images: torch.Tensor,
          train: bool = False):
    """Run ``model`` on ``{"params": ..., "batch_stats": ...}``."""
    tensors = dict(apply_vars["params"])
    tensors.update(apply_vars.get("batch_stats", {}))
    return functional_call(model, tensors, (images,), {"train": train}, strict=True)
