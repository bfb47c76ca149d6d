"""MobileNetV2 backbone as ``nn.Module``s.

The inverted-residual architecture of Sandler et al., "MobileNetV2:
Inverted Residuals and Linear Bottlenecks" (arXiv:1801.04381), module for
module and name for name with the flax model of the JAX package (``Stem``,
``Stage_3/Block_1/Expand``, ``Head`` …), so a converted checkpoint maps by
name (``models.convert``). Named endpoints: ``Stage_0`` … ``Stage_6``
after each stage (``Stage_2`` / ``Stage_4`` / ``Stage_6`` are the stride
8 / 16 / 32 pyramid of the SSD head) and ``Final``, the 1280-channel
features of the MultiBox head.

Conventions are those of ``models.inception_v3``: NHWC in and out, logical
NCHW in ``channels_last`` memory inside; parameters on the ``meta`` device,
supplied per call; BatchNorm (eps 1e-3, here with a learned γ) is
:class:`~multibox_tpu_torch.models.inception_v3.SlimBatchNorm`, so the
train-mode statistics and the running update are the Inception ones; SAME
padding is TensorFlow's (:func:`~multibox_tpu_torch.models.inception_v3.conv2d_same`).
Every unit is a cuDNN convolution, folded or not, as in the JAX package,
whose MobileNet units are ``nn.Conv`` and never the Pallas matmul.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from multibox_tpu_torch.models.inception_v3 import (
    SlimBatchNorm,
    _Conv,
    check_quantize,
    conv2d_same,
)

# (expansion t, channels c, repeats n, stride s) per arXiv:1801.04381 Table 2.
_INVERTED_RESIDUAL_SPEC = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

# Endpoints exposed to heads: taken after the last block of the marked
# stages (stride 8 / 16 / 32 pyramid), plus the final 1x1-conv features.
ENDPOINTS = ("Stage_2", "Stage_4", "Stage_6", "Final")


def relu6(x: torch.Tensor) -> torch.Tensor:
    """``min(max(x, 0), 6)`` as the JAX package writes it,
    ``jnp.minimum(nn.relu(x), 6.0)``: at x = 6 exactly the gradient is ½
    (``minimum`` splits a tie), where ``F.relu6``'s is 0; at x = 0 it is 0
    in both."""
    return torch.minimum(torch.relu(x), x.new_tensor(6.0))


class ConvBNRelu6(nn.Module):
    """Conv → BatchNorm(γ) → ReLU6. ``groups = in_features`` is a depthwise
    convolution. ``folded=True`` is the inference-only variant with BN
    baked into the conv (``inception_v3.fold_batch_norms``, which folds γ):
    Conv gains a bias, no BatchNorm op. State-dict keys ``Conv.weight``
    (OIHW, ``[out, in / groups, kh, kw]``), ``Conv.bias`` when folded,
    ``BatchNorm.{scale,bias,mean,var}`` otherwise. ``quantize`` (``"int8"``
    or ``"calib"``, folded only) makes the convolution a
    :class:`~multibox_tpu_torch.models.quant.QuantConv`, grouped too."""

    def __init__(self, in_features: int, features: int,
                 kernel: Sequence[int] = (3, 3), strides: Sequence[int] = (1, 1),
                 groups: int = 1, compute_dtype: torch.dtype = torch.bfloat16,
                 bn_momentum: float = 0.997, relu: bool = True,
                 folded: bool = False, quantize: Optional[str] = None):
        super().__init__()
        self.strides = tuple(strides)
        self.groups = groups
        self.compute_dtype = compute_dtype
        self.relu = relu
        self.folded = folded
        self.quantize = check_quantize(quantize, folded)
        if self.quantize:
            from multibox_tpu_torch.models.quant import QuantConv

            self.Conv = QuantConv(in_features, features, tuple(kernel), self.strides,
                                  groups=groups, calibrate=self.quantize == "calib",
                                  compute_dtype=compute_dtype)
        else:
            self.Conv = _Conv(in_features // groups, features, tuple(kernel),
                              use_bias=folded)
        if not folded:
            self.BatchNorm = SlimBatchNorm(features, bn_momentum, use_scale=True)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.quantize:
            x = self.Conv(x)
            return relu6(x) if self.relu else x
        dt = self.compute_dtype
        bias = self.Conv.bias.to(dt) if self.folded else None
        x = conv2d_same(x, self.Conv.weight.to(dt), bias, self.strides, self.groups)
        if not self.folded:
            x = self.BatchNorm(x, train)
        return relu6(x) if self.relu else x


class InvertedResidual(nn.Module):
    """1×1 expand (skipped at t = 1) → 3×3 depthwise at ``stride`` → 1×1
    linear projection, plus the input when the stride is 1 and the channel
    count is kept."""

    def __init__(self, in_features: int, features: int, stride: int, expand: int,
                 **unit_kw):
        super().__init__()
        hidden = in_features * expand
        self.residual = stride == 1 and in_features == features
        if expand != 1:
            self.Expand = ConvBNRelu6(in_features, hidden, (1, 1), **unit_kw)
        else:
            self.Expand = None
        self.Depthwise = ConvBNRelu6(hidden, hidden, (3, 3), strides=(stride, stride),
                                     groups=hidden, **unit_kw)
        self.Project = ConvBNRelu6(hidden, features, (1, 1), relu=False, **unit_kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = x if self.Expand is None else self.Expand(x, train)
        h = self.Project(self.Depthwise(h, train), train)
        return h + x if self.residual else h


def _channels(ch: int, width: float) -> int:
    """The JAX package's width rounding: to a multiple of 8, at least 8."""
    ch = int(ch * width)
    return max((ch + 4) // 8 * 8, 8)


class MobileNetV2(nn.Module):
    """MobileNetV2 feature extractor with named endpoints.

    Input ``[B, S, S, 3]`` in [-1, 1]; ``Final`` is the feature map of
    ``max(c(1280), 1280)`` channels at stride 32 (7×7 for 224).
    """

    def __init__(self, width: float = 1.0, compute_dtype: torch.dtype = torch.bfloat16,
                 bn_momentum: float = 0.997, folded: bool = False,
                 quantize: Optional[str] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        kw = dict(compute_dtype=compute_dtype, bn_momentum=bn_momentum,
                  folded=folded, quantize=quantize)
        c = _channels(32, width)
        self.Stem = ConvBNRelu6(3, c, (3, 3), strides=(2, 2), **kw)
        self._stages = []
        self.endpoint_features: Dict[str, int] = {}
        for stage, (t, ch, n, s) in enumerate(_INVERTED_RESIDUAL_SPEC):
            names = []
            for i in range(n):
                name = f"Stage_{stage}/Block_{i}"
                out = _channels(ch, width)
                self.add_module(name, InvertedResidual(c, out, s if i == 0 else 1, t, **kw))
                names.append(name)
                c = out
            self._stages.append(names)
            self.endpoint_features[f"Stage_{stage}"] = c
        head = max(_channels(1280, width), 1280)
        self.Head = ConvBNRelu6(c, head, (1, 1), **kw)
        self.endpoint_features["Final"] = head

    def forward(self, x: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        # NHWC in → logical NCHW over the same bytes (channels_last).
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        x = self.Stem(x, train)
        eps: Dict[str, torch.Tensor] = {}
        for stage, names in enumerate(self._stages):
            for name in names:
                x = self._modules[name](x, train)
            eps[f"Stage_{stage}"] = x.permute(0, 2, 3, 1)
        x = self.Head(x, train)
        eps["Final"] = x.permute(0, 2, 3, 1)
        return eps


def feature_grid(input_size: int, endpoint: str = "Final") -> int:
    """Side length of ``endpoint``'s feature map for a square input: each
    stride-2 SAME step takes ``ceil(n / 2)`` (224 → 7 at ``Final``)."""
    n = -(-input_size // 2)  # Stem
    for stage, (_, _, _, s) in enumerate(_INVERTED_RESIDUAL_SPEC):
        n = -(-n // s)
        if endpoint == f"Stage_{stage}":
            return n
    if endpoint == "Final":
        return n
    raise ValueError(f"unknown endpoint: {endpoint!r}")
