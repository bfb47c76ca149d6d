"""Inception-v3 backbone as ``nn.Module``s.

Re-implementation of the architecture of Szegedy et al., "Rethinking the
Inception Architecture for Computer Vision" (arXiv:1512.00567), matching the
tf-slim ``inception_v3_base`` topology, module for module and name for name
with the flax model of the JAX package (``Conv2d_1a_3x3``,
``Mixed_5b/Branch_0/Conv2d_0a_1x1`` …), so a converted checkpoint maps by
name (``models.convert``).

Choices made here:

- The public layout is NHWC (``[B, H, W, C]`` in, endpoints NHWC out).
  Inside, tensors are logical NCHW in ``torch.channels_last`` memory
  format, i.e. the same bytes as NHWC: the permutes at the boundary are
  views, and the ``[B·H·W, C]`` matrix a folded 1×1 unit needs is free.
- Separate ``compute_dtype`` (bfloat16 by default) from the parameter
  dtype (float32). Weights are cast where they are used.
- BatchNorm follows slim's conventions (eps 1e-3, no scale γ); statistics
  and bias stay float32. :class:`SlimBatchNorm` takes an optional γ for
  the MobileNetV2 backbone (``models.mobilenet``), which shares it.
- SAME padding is TensorFlow's at every stride (:func:`conv2d_same`): at
  stride 2 on an even input it pads one pixel after and none before.
- Parameters are created on the ``meta`` device: a module describes the
  computation and the names, and the weights are supplied per call
  (``torch.func.functional_call``), as the flax model takes its variables.
- ``train=True`` normalizes with the batch statistics and leaves each
  BatchNorm's updated running statistics on the module
  (:attr:`SlimBatchNorm.updated`), from where ``models.detector.apply``
  collects them into a new ``batch_stats`` dictionary: the functional
  counterpart of flax's ``mutable=["batch_stats"]``. ``F.batch_norm``'s
  running-buffer update is not used (it keeps the unbiased variance and
  takes the momentum in the opposite sense).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multibox_tpu_torch.models.layers import FusedConv1x1
from multibox_tpu_torch.parallel import mesh

# Endpoints exposed to detection heads, in forward order.
ENDPOINTS = (
    "Conv2d_1a_3x3",
    "Conv2d_2a_3x3",
    "Conv2d_2b_3x3",
    "MaxPool_3a_3x3",
    "Conv2d_3b_1x1",
    "Conv2d_4a_3x3",
    "MaxPool_5a_3x3",
    "Mixed_5b",
    "Mixed_5c",
    "Mixed_5d",
    "Mixed_6a",
    "Mixed_6b",
    "Mixed_6c",
    "Mixed_6d",
    "Mixed_6e",
    "Mixed_7a",
    "Mixed_7b",
    "Mixed_7c",
)

BN_EPS = 1e-3

def _meta(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device="meta"))


class SlimBatchNorm(nn.Module):
    """BatchNorm ``(x − μ)·γ/√(σ² + 1e-3) + bias`` over the channel axis of
    an NCHW tensor. slim's convention has no γ (``use_scale=False``, the
    Inception units); MobileNetV2's units learn one (``use_scale=True``,
    parameter ``scale``). ``bias`` and ``scale`` are parameters; ``mean``
    and ``var`` are buffers (the ``batch_stats`` collection).

    Inference uses the running ``mean``/``var``. Training follows flax's
    ``BatchNorm``: the batch statistics are computed in float32 or wider
    whatever the input dtype, the variance is the biased fast form
    ``max(0, E[x²] − E[x]²)``, gradients flow through both, and the running
    statistics become ``m·running + (1 − m)·batch`` with ``m = momentum``
    (0.9997, slim's), left in :attr:`updated` for the caller to collect.
    Inside a data-parallel step (``parallel.mesh.reducing``) the statistics
    are the global batch's, so the replicas' running statistics agree."""

    def __init__(self, features: int, momentum: float = 0.9997,
                 use_scale: bool = False):
        super().__init__()
        self.momentum = momentum
        if use_scale:
            self.scale = _meta(features)
        else:
            self.register_parameter("scale", None)
        self.bias = _meta(features)
        self.register_buffer("mean", torch.empty(features, device="meta"))
        self.register_buffer("var", torch.empty(features, device="meta"))
        self.updated = None  # (mean, var) after a train-mode call

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                                False, 0.0, BN_EPS)
        # statistics in at least float32 (flax's promote_types(dtype, f32))
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = (0, 2, 3)
        if mesh.reducing():
            # the global batch's statistics (flax's BatchNorm under the
            # sharded jit): Σx, Σx² and the count summed over the ranks
            C = x32.shape[1]
            count = x32.new_full((1,), x32.numel() // C)
            sums = mesh.all_reduce_sum(
                torch.cat([x32.sum(dims), (x32 * x32).sum(dims), count]), "batch_norm")
            mean = sums[:C] / sums[-1]
            var = (sums[C:2 * C] / sums[-1] - mean * mean).clamp_min(0.0)
        else:
            mean = x32.mean(dims)
            var = ((x32 * x32).mean(dims) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + BN_EPS)
        if self.scale is not None:  # flax: mul *= scale, then y *= mul
            mul = mul * self.scale
        y = (x32 - mean[:, None, None]) * mul[:, None, None]
        y = y + self.bias[:, None, None]
        m = self.momentum
        self.updated = (m * self.mean + (1.0 - m) * mean.detach(),
                        m * self.var + (1.0 - m) * var.detach())
        return y.to(x.dtype)


def same_padding(size: int, kernel: int, stride: int):
    """TensorFlow's SAME padding along one axis, ``(before, after)``: the
    output has ``ceil(size / stride)`` positions and the odd pixel of
    padding goes after (flax and XLA pad this way)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, bias, strides,
                groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` with SAME padding at any stride. Symmetric padding goes
    to the convolution; an asymmetric one (stride 2 on an even input) is an
    explicit ``F.pad``, since ``nn.Conv2d(padding=1)`` would pad (1, 1) and
    shift every output by one pixel."""
    (top, bottom), (left, right) = (
        same_padding(x.shape[2], weight.shape[2], strides[0]),
        same_padding(x.shape[3], weight.shape[3], strides[1]))
    if top == bottom and left == right:
        return F.conv2d(x, weight, bias, strides, (top, left), groups=groups)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, weight, bias, strides, 0, groups=groups)


class _Conv(nn.Module):
    """Holder of a convolution's parameters (``weight`` OIHW, optional
    ``bias``); :class:`ConvBN` applies them."""

    def __init__(self, in_features, features, kernel, use_bias):
        super().__init__()
        self.weight = _meta(features, in_features, kernel[0], kernel[1])
        if use_bias:
            self.bias = _meta(features)
        else:
            self.register_parameter("bias", None)


class ConvBN(nn.Module):
    """slim-style conv unit: Conv(no bias) → BatchNorm(no γ) → ReLU.

    ``folded=True`` is the inference-only variant with BN pre-folded into
    the conv (Conv gains a bias, no BatchNorm op) — see
    :func:`fold_batch_norms`. A folded 1×1 stride-1 unit is a
    :class:`FusedConv1x1`: with ``use_pallas=True`` it runs as one fused
    matmul + bias + ReLU kernel. The state-dict keys are the same either
    way (``Conv.weight``, ``Conv.bias``).

    ``quantize`` (``"int8"`` or ``"calib"``, folded only) makes every unit,
    1×1 ones included, a :class:`~multibox_tpu_torch.models.quant.QuantConv`
    (``Conv.kernel_q``, ``Conv.w_scale``, ``Conv.bias``, ``Conv.x_scale``),
    as in the JAX package, where the int8 path takes precedence over the
    fused 1×1 one."""

    def __init__(self, in_features: int, features: int, kernel: Sequence[int],
                 strides: Sequence[int] = (1, 1), padding: str = "SAME",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 folded: bool = False, use_pallas: Optional[bool] = None,
                 quantize: Optional[str] = None, bn_momentum: float = 0.9997):
        super().__init__()
        kernel, strides = tuple(kernel), tuple(strides)
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding: {padding!r}")
        self.features = features
        self.strides = strides
        self.padding = padding
        self.compute_dtype = compute_dtype
        self.folded = folded
        self.quantize = check_quantize(quantize, folded)
        self.fused = folded and kernel == (1, 1) and strides == (1, 1)
        if self.quantize:
            from multibox_tpu_torch.models.quant import QuantConv

            self.fused = False
            self.Conv = QuantConv(in_features, features, kernel, strides, padding,
                                  calibrate=self.quantize == "calib",
                                  compute_dtype=compute_dtype)
        elif self.fused:
            self.Conv = FusedConv1x1(
                in_features, features, use_bias=True, relu=True,
                use_pallas=use_pallas, dtype=compute_dtype)
        else:
            self.Conv = _Conv(in_features, features, kernel, use_bias=folded)
        if not folded:
            self.BatchNorm = SlimBatchNorm(features, bn_momentum)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.compute_dtype
        if self.quantize:
            return torch.relu(self.Conv(x))
        if self.fused:
            # NCHW channels_last ↔ NHWC are views of the same bytes.
            return self.Conv(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        bias = self.Conv.bias.to(dt) if self.folded else None
        if self.padding == "SAME":
            x = conv2d_same(x, self.Conv.weight.to(dt), bias, self.strides)
        else:
            x = F.conv2d(x, self.Conv.weight.to(dt), bias, self.strides)
        if not self.folded:
            x = self.BatchNorm(x, train)
        return torch.relu(x)


def check_quantize(quantize: Optional[str], folded: bool) -> Optional[str]:
    """A unit's ``quantize`` option: ``None``, ``"int8"`` or ``"calib"``,
    the last two on the folded variant only (the BatchNorm is already in
    the weights that were quantized)."""
    if quantize and quantize not in ("int8", "calib"):
        raise ValueError(f"unknown quantize mode: {quantize!r} (expected 'int8' or 'calib')")
    if quantize and not folded:
        raise ValueError("quantize requires the folded model variant")
    return quantize or None


def _max_pool(x, window, strides):
    return F.max_pool2d(x, window, strides)


def _avg_pool_3x3_same(x):
    # count_include_pad=False: divide by the number of valid elements in the
    # window (TF semantics) — with the default the border pixels differ and
    # checkpoint parity breaks.
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=False)


class _Block(nn.Module):
    """Shared plumbing of the Inception blocks: units are registered under
    their slim scope names, which contain ``/``."""

    def __init__(self, compute_dtype, folded, use_pallas, quantize,
                 bn_momentum):
        super().__init__()
        self._kw = dict(compute_dtype=compute_dtype, folded=folded,
                        use_pallas=use_pallas, quantize=quantize,
                        bn_momentum=bn_momentum)

    def unit(self, name, in_features, features, kernel, **kw):
        self.add_module(name, ConvBN(in_features, features, kernel,
                                     **kw, **self._kw))
        return features

    def run(self, name, x, train):
        return self._modules[name](x, train)


class InceptionA(_Block):
    """35×35 Inception block (Mixed_5b/5c/5d): 1x1 / 5x5 / double-3x3 / pool."""

    def __init__(self, in_features: int, pool_features: int,
                 compute_dtype=torch.bfloat16, folded=False, use_pallas=None,
                 quantize=None, bn_momentum=0.9997):
        super().__init__(compute_dtype, folded, use_pallas, quantize,
                         bn_momentum)
        c = in_features
        self.unit("Branch_0/Conv2d_0a_1x1", c, 64, (1, 1))
        self.unit("Branch_1/Conv2d_0a_1x1", c, 48, (1, 1))
        self.unit("Branch_1/Conv2d_0b_5x5", 48, 64, (5, 5))
        self.unit("Branch_2/Conv2d_0a_1x1", c, 64, (1, 1))
        self.unit("Branch_2/Conv2d_0b_3x3", 64, 96, (3, 3))
        self.unit("Branch_2/Conv2d_0c_3x3", 96, 96, (3, 3))
        self.unit("Branch_3/Conv2d_0b_1x1", c, pool_features, (1, 1))
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x, train: bool = False):
        b0 = self.run("Branch_0/Conv2d_0a_1x1", x, train)
        b1 = self.run("Branch_1/Conv2d_0a_1x1", x, train)
        b1 = self.run("Branch_1/Conv2d_0b_5x5", b1, train)
        b2 = self.run("Branch_2/Conv2d_0a_1x1", x, train)
        b2 = self.run("Branch_2/Conv2d_0b_3x3", b2, train)
        b2 = self.run("Branch_2/Conv2d_0c_3x3", b2, train)
        b3 = self.run("Branch_3/Conv2d_0b_1x1", _avg_pool_3x3_same(x), train)
        return torch.cat([b0, b1, b2, b3], dim=1)


class ReductionA(_Block):
    """35→17 grid reduction (Mixed_6a)."""

    def __init__(self, in_features: int, compute_dtype=torch.bfloat16,
                 folded=False, use_pallas=None, quantize=None,
                 bn_momentum=0.9997):
        super().__init__(compute_dtype, folded, use_pallas, quantize,
                         bn_momentum)
        c = in_features
        self.unit("Branch_0/Conv2d_1a_1x1", c, 384, (3, 3), strides=(2, 2),
                  padding="VALID")
        self.unit("Branch_1/Conv2d_0a_1x1", c, 64, (1, 1))
        self.unit("Branch_1/Conv2d_0b_3x3", 64, 96, (3, 3))
        self.unit("Branch_1/Conv2d_1a_1x1", 96, 96, (3, 3), strides=(2, 2),
                  padding="VALID")
        self.out_features = 384 + 96 + c

    def forward(self, x, train: bool = False):
        b0 = self.run("Branch_0/Conv2d_1a_1x1", x, train)
        b1 = self.run("Branch_1/Conv2d_0a_1x1", x, train)
        b1 = self.run("Branch_1/Conv2d_0b_3x3", b1, train)
        b1 = self.run("Branch_1/Conv2d_1a_1x1", b1, train)
        b2 = _max_pool(x, 3, 2)
        return torch.cat([b0, b1, b2], dim=1)


class InceptionB(_Block):
    """17×17 Inception block (Mixed_6b..6e): factorized 7×7 convolutions."""

    def __init__(self, in_features: int, channels_7x7: int,
                 compute_dtype=torch.bfloat16, folded=False, use_pallas=None,
                 quantize=None, bn_momentum=0.9997):
        super().__init__(compute_dtype, folded, use_pallas, quantize,
                         bn_momentum)
        c, c7 = in_features, channels_7x7
        self.unit("Branch_0/Conv2d_0a_1x1", c, 192, (1, 1))
        self.unit("Branch_1/Conv2d_0a_1x1", c, c7, (1, 1))
        self.unit("Branch_1/Conv2d_0b_1x7", c7, c7, (1, 7))
        self.unit("Branch_1/Conv2d_0c_7x1", c7, 192, (7, 1))
        self.unit("Branch_2/Conv2d_0a_1x1", c, c7, (1, 1))
        self.unit("Branch_2/Conv2d_0b_7x1", c7, c7, (7, 1))
        self.unit("Branch_2/Conv2d_0c_1x7", c7, c7, (1, 7))
        self.unit("Branch_2/Conv2d_0d_7x1", c7, c7, (7, 1))
        self.unit("Branch_2/Conv2d_0e_1x7", c7, 192, (1, 7))
        self.unit("Branch_3/Conv2d_0b_1x1", c, 192, (1, 1))
        self.out_features = 192 * 4

    def forward(self, x, train: bool = False):
        b0 = self.run("Branch_0/Conv2d_0a_1x1", x, train)
        b1 = self.run("Branch_1/Conv2d_0a_1x1", x, train)
        b1 = self.run("Branch_1/Conv2d_0b_1x7", b1, train)
        b1 = self.run("Branch_1/Conv2d_0c_7x1", b1, train)
        b2 = self.run("Branch_2/Conv2d_0a_1x1", x, train)
        b2 = self.run("Branch_2/Conv2d_0b_7x1", b2, train)
        b2 = self.run("Branch_2/Conv2d_0c_1x7", b2, train)
        b2 = self.run("Branch_2/Conv2d_0d_7x1", b2, train)
        b2 = self.run("Branch_2/Conv2d_0e_1x7", b2, train)
        b3 = self.run("Branch_3/Conv2d_0b_1x1", _avg_pool_3x3_same(x), train)
        return torch.cat([b0, b1, b2, b3], dim=1)


class ReductionB(_Block):
    """17→8 grid reduction (Mixed_7a)."""

    def __init__(self, in_features: int, compute_dtype=torch.bfloat16,
                 folded=False, use_pallas=None, quantize=None,
                 bn_momentum=0.9997):
        super().__init__(compute_dtype, folded, use_pallas, quantize,
                         bn_momentum)
        c = in_features
        self.unit("Branch_0/Conv2d_0a_1x1", c, 192, (1, 1))
        self.unit("Branch_0/Conv2d_1a_3x3", 192, 320, (3, 3), strides=(2, 2),
                  padding="VALID")
        self.unit("Branch_1/Conv2d_0a_1x1", c, 192, (1, 1))
        self.unit("Branch_1/Conv2d_0b_1x7", 192, 192, (1, 7))
        self.unit("Branch_1/Conv2d_0c_7x1", 192, 192, (7, 1))
        self.unit("Branch_1/Conv2d_1a_3x3", 192, 192, (3, 3), strides=(2, 2),
                  padding="VALID")
        self.out_features = 320 + 192 + c

    def forward(self, x, train: bool = False):
        b0 = self.run("Branch_0/Conv2d_0a_1x1", x, train)
        b0 = self.run("Branch_0/Conv2d_1a_3x3", b0, train)
        b1 = self.run("Branch_1/Conv2d_0a_1x1", x, train)
        b1 = self.run("Branch_1/Conv2d_0b_1x7", b1, train)
        b1 = self.run("Branch_1/Conv2d_0c_7x1", b1, train)
        b1 = self.run("Branch_1/Conv2d_1a_3x3", b1, train)
        b2 = _max_pool(x, 3, 2)
        return torch.cat([b0, b1, b2], dim=1)


class InceptionC(_Block):
    """8×8 Inception block (Mixed_7b/7c): expanded-filter-bank outputs."""

    def __init__(self, in_features: int, compute_dtype=torch.bfloat16,
                 folded=False, use_pallas=None, quantize=None,
                 bn_momentum=0.9997):
        super().__init__(compute_dtype, folded, use_pallas, quantize,
                         bn_momentum)
        c = in_features
        self.unit("Branch_0/Conv2d_0a_1x1", c, 320, (1, 1))
        self.unit("Branch_1/Conv2d_0a_1x1", c, 384, (1, 1))
        self.unit("Branch_1/Conv2d_0b_1x3", 384, 384, (1, 3))
        self.unit("Branch_1/Conv2d_0b_3x1", 384, 384, (3, 1))
        self.unit("Branch_2/Conv2d_0a_1x1", c, 448, (1, 1))
        self.unit("Branch_2/Conv2d_0b_3x3", 448, 384, (3, 3))
        self.unit("Branch_2/Conv2d_0c_1x3", 384, 384, (1, 3))
        self.unit("Branch_2/Conv2d_0d_3x1", 384, 384, (3, 1))
        self.unit("Branch_3/Conv2d_0b_1x1", c, 192, (1, 1))
        self.out_features = 320 + 768 + 768 + 192

    def forward(self, x, train: bool = False):
        b0 = self.run("Branch_0/Conv2d_0a_1x1", x, train)
        b1 = self.run("Branch_1/Conv2d_0a_1x1", x, train)
        b1 = torch.cat([
            self.run("Branch_1/Conv2d_0b_1x3", b1, train),
            self.run("Branch_1/Conv2d_0b_3x1", b1, train),
        ], dim=1)
        b2 = self.run("Branch_2/Conv2d_0a_1x1", x, train)
        b2 = self.run("Branch_2/Conv2d_0b_3x3", b2, train)
        b2 = torch.cat([
            self.run("Branch_2/Conv2d_0c_1x3", b2, train),
            self.run("Branch_2/Conv2d_0d_3x1", b2, train),
        ], dim=1)
        b3 = self.run("Branch_3/Conv2d_0b_1x1", _avg_pool_3x3_same(x), train)
        return torch.cat([b0, b1, b2, b3], dim=1)


class InceptionV3(nn.Module):
    """Inception-v3 feature extractor returning named endpoints.

    Input: ``[B, 299, 299, 3]`` float, scaled to ``[-1, 1]`` (slim
    convention ``(x/255 − 0.5)×2``; the input pipeline handles scaling).
    Output: dict of endpoint name → NHWC feature map; ``Mixed_7c`` is
    ``[B, 8, 8, 2048]``.
    """

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16,
                 final_endpoint: str = "Mixed_7c", folded: bool = False,
                 use_pallas: Optional[bool] = None,
                 quantize: Optional[str] = None, bn_momentum: float = 0.9997):
        super().__init__()
        if final_endpoint not in ENDPOINTS:
            raise ValueError(f"unknown final_endpoint: {final_endpoint!r}")
        self.compute_dtype = compute_dtype
        self.final_endpoint = final_endpoint
        kw = dict(compute_dtype=compute_dtype, folded=folded,
                  use_pallas=use_pallas, quantize=quantize,
                  bn_momentum=bn_momentum)
        # (name, constructor) in forward order; None = pooling layer.
        c = 3
        plan = []

        features = {}  # endpoint → channels

        def stem(name, n, kernel, **conv_kw):
            nonlocal c
            plan.append((name, ConvBN(c, n, kernel, **conv_kw, **kw)))
            c = features[name] = n

        def block(name, cls, *args):
            nonlocal c
            module = cls(c, *args, **kw)
            plan.append((name, module))
            c = features[name] = module.out_features

        stem("Conv2d_1a_3x3", 32, (3, 3), strides=(2, 2), padding="VALID")
        stem("Conv2d_2a_3x3", 32, (3, 3), padding="VALID")
        stem("Conv2d_2b_3x3", 64, (3, 3))
        plan.append(("MaxPool_3a_3x3", None))
        features["MaxPool_3a_3x3"] = c
        stem("Conv2d_3b_1x1", 80, (1, 1), padding="VALID")
        stem("Conv2d_4a_3x3", 192, (3, 3), padding="VALID")
        plan.append(("MaxPool_5a_3x3", None))
        features["MaxPool_5a_3x3"] = c
        for name, pool_features in (("Mixed_5b", 32), ("Mixed_5c", 64),
                                    ("Mixed_5d", 64)):
            block(name, InceptionA, pool_features)
        block("Mixed_6a", ReductionA)
        for name, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160),
                         ("Mixed_6d", 160), ("Mixed_6e", 192)):
            block(name, InceptionB, c7)
        block("Mixed_7a", ReductionB)
        block("Mixed_7b", InceptionC)
        block("Mixed_7c", InceptionC)

        self._order = []
        for name, module in plan:
            self._order.append(name)
            if module is not None:
                self.add_module(name, module)
            if name == final_endpoint:
                break
        # channels of each endpoint this network produces
        self.endpoint_features = {n: features[n] for n in self._order}

    def forward(self, x: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        # NHWC in → logical NCHW over the same bytes (channels_last).
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        eps: Dict[str, torch.Tensor] = {}
        for name in self._order:
            module = self._modules.get(name)
            x = _max_pool(x, 3, 2) if module is None else module(x, train)
            eps[name] = x.permute(0, 2, 3, 1)
        return eps


def feature_grid(input_size: int, endpoint: str = "Mixed_7c") -> int:
    """Side length of ``endpoint``'s feature map for a square input
    (299 → 8 at ``Mixed_7c``)."""
    def halve(n):  # 3×3 VALID, stride 2
        return (n - 3) // 2 + 1

    n = input_size
    steps = {
        "Conv2d_1a_3x3": halve, "Conv2d_2a_3x3": lambda n: n - 2,
        "MaxPool_3a_3x3": halve, "Conv2d_4a_3x3": lambda n: n - 2,
        "MaxPool_5a_3x3": halve, "Mixed_6a": halve, "Mixed_7a": halve,
    }
    for name in ENDPOINTS:
        n = steps.get(name, lambda n: n)(n)
        if n < 1:
            raise ValueError(f"input size {input_size} is too small for {name}")
        if name == endpoint:
            return n
    raise ValueError(f"unknown endpoint: {endpoint!r}")


def fused_unit_shapes(batch: int, input_size: int = 299,
                      compute_dtype: torch.dtype = torch.bfloat16):
    """``(name, M, K, N)`` of every 1×1 unit of the folded backbone, in
    forward order: the matmul ``[M = batch·H·W, K = Cin] × [K, N = Cout]``
    each runs as. Found by a forward on the ``meta`` device (shapes only,
    no data, no weights)."""
    model = InceptionV3(compute_dtype=compute_dtype, folded=True, use_pallas=True)
    shapes, hooks = [], []
    for name, mod in model.named_modules():
        if isinstance(mod, FusedConv1x1):
            def record(mod, args, out, name=name):
                b, h, w, c = args[0].shape
                shapes.append((name, b * h * w, c, mod.features))
            hooks.append(mod.register_forward_hook(record))
    tensors = {n: torch.empty(p.shape, device="meta") for n, p in model.named_parameters()}
    with torch.no_grad():
        torch.func.functional_call(
            model, tensors, (torch.empty(batch, input_size, input_size, 3, device="meta"),))
    for h in hooks:
        h.remove()
    return shapes


def preprocess_slim(images_uint8: torch.Tensor) -> torch.Tensor:
    """slim input scaling: uint8 [0,255] → float [−1, 1]."""
    return (images_uint8.to(torch.float32) / 255.0 - 0.5) * 2.0


def fold_batch_norms(variables):
    """Fold BN statistics into conv weights for the ``folded=True`` model.

    ``BN(conv(x)) = conv'(x) + b'`` with ``w' = w·s`` and ``b' = β − μ·s``
    where ``s = γ/√(σ²+ε)``: slim-style BN (the Inception units) has no γ
    (γ ≡ 1), MobileNetV2's carries one, which is consumed into the weight
    here and dropped. ``variables`` holds the flat ``params`` and
    ``batch_stats`` dictionaries of the unfolded model; returns
    ``{"params": ...}`` for the folded variant (Conv has a bias, no
    BatchNorm) — one normalization pass per conv unit eliminated at
    inference.
    """
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    def bn_scale(unit):
        s = torch.rsqrt(stats[unit + ".BatchNorm.var"].to(torch.float32) + BN_EPS)
        gamma = params.get(unit + ".BatchNorm.scale")
        return s if gamma is None else s * gamma.to(torch.float32)

    out = {}
    for key, value in params.items():
        if key.endswith(".Conv.weight"):
            unit = key[: -len(".Conv.weight")]
            if unit + ".BatchNorm.var" in stats:
                s = bn_scale(unit)
                out[key] = (value.to(torch.float32) * s[:, None, None, None]).to(value.dtype)
                continue
        if key.endswith(".BatchNorm.bias"):
            unit = key[: -len(".BatchNorm.bias")]
            mean = stats.get(unit + ".BatchNorm.mean")
            if mean is not None:
                bias = value.to(torch.float32) - mean.to(torch.float32) * bn_scale(unit)
                out[unit + ".Conv.bias"] = bias.to(value.dtype)
                continue
        if key.endswith(".BatchNorm.scale"):
            # consumed into the weight above: the folded unit has no BatchNorm
            if key[: -len(".scale")] + ".var" in stats:
                continue
        out[key] = value
    return {"params": out}
