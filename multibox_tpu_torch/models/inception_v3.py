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
  and bias stay float32.
- Parameters are created on the ``meta`` device: a module describes the
  computation and the names, and the weights are supplied per call
  (``torch.func.functional_call``), as the flax model takes its variables.
  Inference only in this slice: ``train=True`` raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multibox_tpu_torch.models.layers import FusedConv1x1

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

_TRAINING_MSG = (
    "train=True (batch statistics, their running update and the backward) "
    "belongs to the training slice of the port"
)


def _meta(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device="meta"))


class SlimBatchNorm(nn.Module):
    """Inference BatchNorm without γ: ``(x − mean)/√(var + 1e-3) + bias``
    over the channel axis of an NCHW tensor. ``bias`` is a parameter;
    ``mean`` and ``var`` are buffers (the ``batch_stats`` collection)."""

    def __init__(self, features: int):
        super().__init__()
        self.bias = _meta(features)
        self.register_buffer("mean", torch.empty(features, device="meta"))
        self.register_buffer("var", torch.empty(features, device="meta"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.mean, self.var, None, self.bias,
                            False, 0.0, BN_EPS)


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
    way (``Conv.weight``, ``Conv.bias``)."""

    def __init__(self, in_features: int, features: int, kernel: Sequence[int],
                 strides: Sequence[int] = (1, 1), padding: str = "SAME",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 folded: bool = False, use_pallas: Optional[bool] = None,
                 quantize: Optional[str] = None):
        super().__init__()
        if quantize:
            raise NotImplementedError(
                "quantize (int8 post-training quantization) is a later slice "
                "of the port")
        kernel, strides = tuple(kernel), tuple(strides)
        if padding == "SAME":
            if strides != (1, 1):
                raise ValueError("SAME padding is implemented for stride 1 only")
            pad = (kernel[0] // 2, kernel[1] // 2)
        elif padding == "VALID":
            pad = (0, 0)
        else:
            raise ValueError(f"unknown padding: {padding!r}")
        self.features = features
        self.strides = strides
        self.pad = pad
        self.compute_dtype = compute_dtype
        self.folded = folded
        self.fused = folded and kernel == (1, 1) and strides == (1, 1)
        if self.fused:
            self.Conv = FusedConv1x1(
                in_features, features, use_bias=True, relu=True,
                use_pallas=use_pallas, dtype=compute_dtype)
        else:
            self.Conv = _Conv(in_features, features, kernel, use_bias=folded)
        if not folded:
            self.BatchNorm = SlimBatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            raise NotImplementedError(_TRAINING_MSG)
        dt = self.compute_dtype
        if self.fused:
            # NCHW channels_last ↔ NHWC are views of the same bytes.
            return self.Conv(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        bias = self.Conv.bias.to(dt) if self.folded else None
        x = F.conv2d(x, self.Conv.weight.to(dt), bias, self.strides, self.pad)
        if not self.folded:
            x = self.BatchNorm(x)
        return torch.relu(x)


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

    def __init__(self, compute_dtype, folded, use_pallas, quantize):
        super().__init__()
        self._kw = dict(compute_dtype=compute_dtype, folded=folded,
                        use_pallas=use_pallas, quantize=quantize)

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
                 quantize=None):
        super().__init__(compute_dtype, folded, use_pallas, quantize)
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
                 folded=False, use_pallas=None, quantize=None):
        super().__init__(compute_dtype, folded, use_pallas, quantize)
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
                 quantize=None):
        super().__init__(compute_dtype, folded, use_pallas, quantize)
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
                 folded=False, use_pallas=None, quantize=None):
        super().__init__(compute_dtype, folded, use_pallas, quantize)
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
                 folded=False, use_pallas=None, quantize=None):
        super().__init__(compute_dtype, folded, use_pallas, quantize)
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
                 quantize: Optional[str] = None):
        super().__init__()
        if final_endpoint not in ENDPOINTS:
            raise ValueError(f"unknown final_endpoint: {final_endpoint!r}")
        self.compute_dtype = compute_dtype
        self.final_endpoint = final_endpoint
        kw = dict(compute_dtype=compute_dtype, folded=folded,
                  use_pallas=use_pallas, quantize=quantize)
        # (name, constructor) in forward order; None = pooling layer.
        c = 3
        plan = []

        def stem(name, features, kernel, **conv_kw):
            nonlocal c
            plan.append((name, ConvBN(c, features, kernel, **conv_kw, **kw)))
            c = features

        def block(name, cls, *args):
            nonlocal c
            module = cls(c, *args, **kw)
            plan.append((name, module))
            c = module.out_features

        stem("Conv2d_1a_3x3", 32, (3, 3), strides=(2, 2), padding="VALID")
        stem("Conv2d_2a_3x3", 32, (3, 3), padding="VALID")
        stem("Conv2d_2b_3x3", 64, (3, 3))
        plan.append(("MaxPool_3a_3x3", None))
        stem("Conv2d_3b_1x1", 80, (1, 1), padding="VALID")
        stem("Conv2d_4a_3x3", 192, (3, 3), padding="VALID")
        plan.append(("MaxPool_5a_3x3", None))
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
        self.out_features = c

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


def preprocess_slim(images_uint8: torch.Tensor) -> torch.Tensor:
    """slim input scaling: uint8 [0,255] → float [−1, 1]."""
    return (images_uint8.to(torch.float32) / 255.0 - 0.5) * 2.0


def fold_batch_norms(variables):
    """Fold BN statistics into conv weights for the ``folded=True`` model.

    ``BN(conv(x)) = conv'(x) + b'`` with ``w' = w·s`` and ``b' = β − μ·s``
    where ``s = 1/√(σ²+ε)`` (slim-style BN has no γ). ``variables`` holds
    the flat ``params`` and ``batch_stats`` dictionaries of the unfolded
    model; returns ``{"params": ...}`` for the folded variant (Conv has a
    bias, no BatchNorm) — one normalization pass per conv unit eliminated
    at inference.
    """
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out = {}
    for key, value in params.items():
        if key.endswith(".Conv.weight"):
            unit = key[: -len(".Conv.weight")]
            var = stats.get(unit + ".BatchNorm.var")
            if var is not None:
                s = torch.rsqrt(var.to(torch.float32) + BN_EPS)
                out[key] = (value.to(torch.float32) * s[:, None, None, None]).to(value.dtype)
                continue
        if key.endswith(".BatchNorm.bias"):
            unit = key[: -len(".BatchNorm.bias")]
            mean = stats.get(unit + ".BatchNorm.mean")
            if mean is not None:
                s = torch.rsqrt(stats[unit + ".BatchNorm.var"].to(torch.float32) + BN_EPS)
                bias = value.to(torch.float32) - mean.to(torch.float32) * s
                out[unit + ".Conv.bias"] = bias.to(value.dtype)
                continue
        out[key] = value
    return {"params": out}
