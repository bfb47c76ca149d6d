"""Full detector: Inception-v3 or MobileNetV2 backbone + MultiBox or SSD
head.

The public model surface — ``(variables, images) → (locations,
confidences)`` — as one ``nn.Module`` whose weights are passed per call.

Variables are a dictionary of flat dictionaries keyed by the module's
state-dict names: ``params`` (everything trainable), ``batch_stats`` (the
BatchNorm ``mean`` / ``var`` buffers) and optionally ``ema`` (moving
averages, shaped like ``params``). :func:`apply` runs the module on one
such set with ``torch.func.functional_call``; choosing ``ema`` over
``params`` costs no copy. With ``train=True`` it also returns the new
``batch_stats``, as flax's ``apply(..., mutable=["batch_stats"])`` does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.func import functional_call

from multibox_tpu_torch.device import resolve_device
from multibox_tpu_torch.models import inception_v3, mobilenet
from multibox_tpu_torch.models.heads import MultiBoxHead, SSDHead
from multibox_tpu_torch.models.inception_v3 import InceptionV3, SlimBatchNorm
from multibox_tpu_torch.models.mobilenet import MobileNetV2

Variables = Dict[str, Dict[str, torch.Tensor]]

_INCEPTION_SSD_ENDPOINTS = ("Mixed_5d", "Mixed_6e", "Mixed_7c")


class MultiBoxDetector(nn.Module):
    """Backbone + detection head → ``(locations, confidences)``.

    Args:
      num_priors: P (must equal the loaded priors' row count).
      input_size: side of the square model input; fixes the width of the
        MultiBox head's fully-connected layers.
      backbone: ``"inception_v3"`` or ``"mobilenet_v2"`` (width
        ``mobilenet_width``).
      head_type: ``"multibox"`` (FC head over the final endpoint, the
        reference's design) or ``"ssd"`` (multi-scale conv heads over
        ``ssd_endpoints``, ``ssd_priors_per_cell`` priors a cell; the
        priors must come from ``generate_priors_multiscale`` with matching
        feature-map sizes). Inception's default ``ssd_endpoints`` on the
        MobileNet backbone map to its stride-8/16/32 pyramid.
      num_classes: 1 for class-agnostic detection (reference behavior).
      compute_dtype: bfloat16 by default; params stay f32.
      bn_momentum: momentum of the BatchNorm running statistics in training
        (slim's 0.9997 by default).
      device: where :meth:`init_variables` puts what it makes; ``None``
        is the CUDA device (raises without one), as for every entry point.

    Input images: ``[B, H, W, 3]`` float32 in ``[-1, 1]``
    (``inception_v3.preprocess_slim``). Default H = W = 299.
    """

    def __init__(self, num_priors: int, input_size: int = 299,
                 backbone: str = "inception_v3", head_type: str = "multibox",
                 num_classes: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 folded: bool = False, use_pallas: Optional[bool] = None,
                 quantize: Optional[str] = None, bottleneck_features: int = 96,
                 bn_momentum: float = 0.9997, mobilenet_width: float = 1.0,
                 ssd_endpoints: Sequence[str] = _INCEPTION_SSD_ENDPOINTS,
                 ssd_priors_per_cell: int = 6, device=None):
        super().__init__()
        if backbone == "inception_v3":
            net = InceptionV3(compute_dtype=compute_dtype, folded=folded,
                              use_pallas=use_pallas, quantize=quantize,
                              bn_momentum=bn_momentum)
            final_endpoint, grid = "Mixed_7c", inception_v3.feature_grid
            self.backbone_scope = "InceptionV3"
        elif backbone == "mobilenet_v2":
            net = MobileNetV2(width=mobilenet_width, compute_dtype=compute_dtype,
                              bn_momentum=bn_momentum, folded=folded,
                              quantize=quantize)
            final_endpoint, grid = "Final", mobilenet.feature_grid
            self.backbone_scope = "MobileNetV2"
        else:
            raise ValueError(f"unknown backbone: {backbone}")
        if head_type == "multibox":
            head = MultiBoxHead(
                num_priors=num_priors,
                in_features=net.endpoint_features[final_endpoint],
                grid=grid(input_size, final_endpoint),
                num_classes=num_classes,
                bottleneck_features=bottleneck_features,
                endpoint=final_endpoint,
                use_pallas=use_pallas,
            )
            self.head_scope = "MultiBoxHead"
        elif head_type == "ssd":
            ssd_endpoints = tuple(ssd_endpoints)
            missing = [e for e in ssd_endpoints if e not in net.endpoint_features]
            if missing:
                if backbone == "mobilenet_v2" and ssd_endpoints == _INCEPTION_SSD_ENDPOINTS:
                    # Inception defaults on the mobilenet backbone: map to
                    # the equivalent stride-8/16/32 pyramid automatically.
                    ssd_endpoints = ("Stage_2", "Stage_4", "Stage_6")
                else:
                    raise ValueError(
                        f"ssd_endpoints {missing} not produced by backbone "
                        f"{backbone!r}; available: {sorted(net.endpoint_features)}")
            head = SSDHead(net.endpoint_features, endpoints_spec=ssd_endpoints,
                           priors_per_cell=ssd_priors_per_cell,
                           num_classes=num_classes)
            self.head_scope = "SSDHead"
        else:
            raise ValueError(f"unknown head_type: {head_type}")
        self.num_priors = num_priors
        self.input_size = input_size
        self.folded = folded
        self.device = resolve_device(device)
        self.add_module(self.backbone_scope, net)
        self.add_module(self.head_scope, head)

    @property
    def backbone(self) -> nn.Module:
        return self._modules[self.backbone_scope]

    @property
    def head(self) -> nn.Module:
        return self._modules[self.head_scope]

    def forward(self, images: torch.Tensor, train: bool = False):
        if images.shape[1] != self.input_size or images.shape[2] != self.input_size:
            raise ValueError(
                f"model built for {self.input_size}×{self.input_size} input, "
                f"got {tuple(images.shape)}")
        endpoints = self.backbone(images, train=train)
        loc, conf = self.head(endpoints, train=train)
        if loc.shape[1] != self.num_priors:
            raise ValueError(
                f"head produced {loc.shape[1]} priors but num_priors="
                f"{self.num_priors}; for head_type='ssd' the priors file must "
                "be generated with matching feature_map_sizes/priors_per_cell")
        return loc, conf

    def init_variables(self, generator: torch.Generator) -> Variables:
        """Random variables for this module, drawn from ``generator`` (a CPU
        or CUDA ``torch.Generator``) and placed on ``self.device``: He-normal
        backbone convolutions, LeCun-normal head, zero biases, BatchNorm γ 1,
        mean 0 and variance 1. For smoke runs and tests; trained weights
        come through ``models.convert``."""
        dev = self.device
        params, stats = {}, {}
        for name, p in self.named_parameters():
            shape = tuple(p.shape)
            if name.endswith("bias"):
                params[name] = torch.zeros(shape, device=dev)
                continue
            if name.endswith("BatchNorm.scale"):
                params[name] = torch.ones(shape, device=dev)
                continue
            if p.dim() == 4:  # OIHW, [out, in / groups, kh, kw]
                fan_in = shape[1] * shape[2] * shape[3]
                gain = 2.0 if name.startswith(self.backbone_scope + ".") else 1.0
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
    """Run ``model`` on ``{"params": ..., "batch_stats": ...}`` (the int8
    variant: ``{"params": ..., "quant": ...}``).

    Returns ``(loc, conf)``; with ``train=True``, ``((loc, conf),
    new_batch_stats)``: BatchNorm normalizes with the batch statistics and
    ``new_batch_stats`` holds every unit's updated running ``mean``/``var``
    (detached), keyed like ``batch_stats``."""
    tensors = dict(apply_vars["params"])
    tensors.update(apply_vars.get("batch_stats", {}))
    tensors.update(apply_vars.get("quant", {}))
    if not train:
        return functional_call(model, tensors, (images,), {"train": False},
                               strict=True)
    bns = [(name, m) for name, m in model.named_modules()
           if isinstance(m, SlimBatchNorm)]
    for _, m in bns:
        m.updated = None
    out = functional_call(model, tensors, (images,), {"train": True}, strict=True)
    new_stats = {}
    for name, m in bns:
        new_stats[f"{name}.mean"], new_stats[f"{name}.var"] = m.updated
        m.updated = None
    return out, new_stats
