"""Dense and 1×1-conv layers with a CUDA fast path.

``FusedDense`` / ``FusedConv1x1`` hold the same parameters whichever path
computes them. With ``use_pallas=True`` (the option keeps the name it has
in the JAX package and in the YAML files) the forward goes through
``ops.kernels.fused_matmul`` — matmul + bias + activation fused in one
kernel — and otherwise through the same arithmetic in plain PyTorch.

``use_pallas=None`` is the plain path: only ``True`` turns the kernel on.

Parameter layouts:

* ``FusedDense.kernel`` is ``[in, out]`` (the layout the kernel reads, and
  the one of the converted checkpoints), not ``nn.Linear``'s ``[out, in]``.
* ``FusedConv1x1.weight`` is ``[out, in, 1, 1]`` like ``nn.Conv2d``, so a
  folded 1×1 unit keeps the state-dict keys of the convolution it replaces.

Both take and return channels-last tensors: ``[..., in]`` / ``[B, H, W, C]``.
Parameters are created on the ``meta`` device: the weights are supplied per
call (``torch.func.functional_call``), see ``models.detector``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multibox_tpu_torch.ops.kernels.fused_matmul import fused_matmul_bias_relu


class FusedDense(nn.Module):
    """Dense layer (+ optional fused ReLU). ``x [..., in] → [..., out]``."""

    def __init__(self, in_features: int, features: int, relu: bool = False,
                 use_pallas: Optional[bool] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = features
        self.relu = relu
        self.use_pallas = use_pallas
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features, device="meta"))
        self.bias = nn.Parameter(torch.empty(features, device="meta"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        k = self.kernel.to(self.dtype)
        if self.use_pallas:  # None/False -> plain (see module docstring)
            lead = x.shape[:-1]
            y = fused_matmul_bias_relu(
                x.reshape(-1, x.shape[-1]).contiguous(), k.contiguous(),
                self.bias, self.relu)
            return y.reshape(*lead, self.features)
        y = x @ k + self.bias.to(self.dtype)
        return torch.relu(y) if self.relu else y


class FusedConv1x1(nn.Module):
    """1×1 stride-1 convolution (+ optional fused ReLU) over NHWC input —
    a matmul over ``[B·H·W, Cin]``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 relu: bool = False, use_pallas: Optional[bool] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = features
        self.relu = relu
        self.use_pallas = use_pallas
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_features, 1, 1, device="meta"))
        if use_bias:
            self.bias = nn.Parameter(torch.empty(features, device="meta"))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, cin = x.shape
        x = x.to(self.dtype).reshape(B * H * W, cin)
        # [out, in, 1, 1] → [in, out]; a small copy per call (≤ 2048×448).
        k = self.weight.reshape(self.features, cin).t().to(self.dtype).contiguous()
        bias = self.bias
        if bias is None:
            bias = torch.zeros(self.features, dtype=torch.float32, device=x.device)
        if self.use_pallas:  # None/False -> plain (see module docstring)
            y = fused_matmul_bias_relu(x.contiguous(), k, bias, self.relu)
        else:
            y = x @ k + bias.to(self.dtype)
            if self.relu:
                y = torch.relu(y)
        return y.reshape(B, H, W, self.features)
