"""Post-training int8 quantization of the BN-folded backbone.

Own counterpart of the JAX package's ``models/quant.py``, the same scheme:

* **Weights**: symmetric per-output-channel int8, ``w = kernel_q · w_scale``
  with ``w_scale[cout] = max|w[cout, ...]| / 127``.
* **Activations**: one symmetric scale a unit, calibrated as a running
  abs-max over calibration batches (the ``quantize="calib"`` variant leaves
  the new value on the module, :attr:`QuantConv.updated`, from where
  ``quantize.calibrate`` collects it into the ``quant`` collection).
* **Compute**: the activation requantized to int8, an int8 × int8 → int32
  convolution, then ``y·(x_scale/127)·w_scale + bias`` in float32, emitted in
  ``compute_dtype``. The heads stay float32 and untouched.

The JAX package computes the integer convolution as a plain XLA op
(``preferred_element_type=int32``), outside any Pallas kernel, so no
hand-written kernel stands behind it here either: :func:`int8_conv` takes an
exact integer product on the card and on the CPU. Its routes
(:func:`int8_conv_route`) on a CUDA tensor:

* ``int_mm_1x1``: a 1×1 stride-1 unit is ``[B·H·W, Cin] × [Cin, Cout]``, one
  ``torch._int_mm`` (cuBLASLt int8, int32 accumulation) over the NHWC bytes;
* ``int_mm_columns``: any other ungrouped unit, the same product over its
  columns ``[B·Ho·Wo, kh·kw·Cin]``, gathered from the padded NHWC input as
  kh·kw strided views;
* ``grouped_f32``: a grouped (depthwise) unit as a float32 convolution over
  the integer values, exact because each output sums at most
  kh·kw·(Cin/groups)·127² < 2²⁴ (9·127² for MobileNet's 3×3 depthwise).

``_int_mm`` wants K and N multiples of 8 and more than 16 rows; K is padded
with zero columns, N and M with zero rows, and the padding dropped after.
On the CPU the plain version convolves in float64, exact while
kh·kw·Cin·127² < 2⁵³. Parameter layout: ``kernel_q`` is OIHW like every
convolution of the port (``models.convert`` transposes the JAX package's
HWIO).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multibox_tpu_torch.models.inception_v3 import conv2d_same, same_padding

# The f32 route stays exact while every output sums fewer than 2**24.
_F32_EXACT = 2**24


def _meta(*shape, dtype=torch.float32, requires_grad=True) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device="meta"),
                        requires_grad=requires_grad)


def int8_conv_route(kernel: Sequence[int], strides: Sequence[int], groups: int,
                    cin: int) -> str:
    """The route :func:`int8_conv` takes for a unit on a CUDA tensor (see the
    module docstring). Raises ValueError for a grouped unit whose sums could
    leave float32's exact integers."""
    kernel, strides = tuple(kernel), tuple(strides)
    if groups == 1:
        return "int_mm_1x1" if kernel == (1, 1) and strides == (1, 1) else "int_mm_columns"
    if kernel[0] * kernel[1] * (cin // groups) * 127 * 127 >= _F32_EXACT:
        raise ValueError(
            f"int8 grouped convolution of {kernel} over {cin // groups} channels a group "
            "can exceed float32's exact integers")
    return "grouped_f32"


def _same_pad_nhwc(x: torch.Tensor, kernel, strides, padding: str) -> torch.Tensor:
    """TF's SAME (or VALID: none) padding of an NHWC tensor."""
    if padding == "VALID":
        return x
    (top, bottom), (left, right) = (same_padding(x.shape[1], kernel[0], strides[0]),
                                    same_padding(x.shape[2], kernel[1], strides[1]))
    return F.pad(x, (0, 0, left, right, top, bottom))


def _int_mm_padded(a: torch.Tensor, w_nk: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8 @ w_nk [N, K]ᵀ int8 → [M, N] int32`` through
    ``torch._int_mm``, K padded to a multiple of 8 with zero columns, N to a
    multiple of 8 and M past 16 with zero rows (all dropped after)."""
    M, Kd = a.shape
    N = w_nk.shape[0]
    kpad, npad, mpad = -Kd % 8, -N % 8, max(0, 17 - M)
    if kpad:
        a = F.pad(a, (0, kpad))
        w_nk = F.pad(w_nk, (0, kpad))
    if npad:
        w_nk = F.pad(w_nk, (0, 0, 0, npad))
    if mpad:
        a = F.pad(a, (0, 0, 0, mpad))
    out = torch._int_mm(a.contiguous(), w_nk.contiguous().t())
    return out[:M, :N]


def int8_conv_columns(xq: torch.Tensor, kernel_q: torch.Tensor, strides, padding: str
                      ) -> torch.Tensor:
    """An ungrouped int8 convolution as one ``torch._int_mm``: ``xq``
    ``[B, C, H, W]`` int8 (any memory format), ``kernel_q`` OIHW int8 →
    int32 ``[B, O, Ho, Wo]`` (channels-last memory). 1×1 stride-1 units
    multiply the NHWC bytes directly; others gather kh·kw strided views of
    the padded input into columns ordered (i, j, c), as the weight's
    ``[O, kh, kw, C]`` rows."""
    O, C, kh, kw = kernel_q.shape
    sh, sw = tuple(strides)
    x = xq.permute(0, 2, 3, 1)  # NHWC
    B = x.shape[0]
    w_nk = kernel_q.permute(0, 2, 3, 1).reshape(O, kh * kw * C)
    if (kh, kw, sh, sw) == (1, 1, 1, 1):
        Ho, Wo = x.shape[1], x.shape[2]
        cols = x.reshape(B * Ho * Wo, C)
    else:
        x = _same_pad_nhwc(x, (kh, kw), (sh, sw), padding)
        Ho = (x.shape[1] - kh) // sh + 1
        Wo = (x.shape[2] - kw) // sw + 1
        taps = [x[:, i:i + sh * (Ho - 1) + 1:sh, j:j + sw * (Wo - 1) + 1:sw, :]
                for i in range(kh) for j in range(kw)]
        cols = torch.stack(taps, dim=3).reshape(B * Ho * Wo, kh * kw * C)
    y = _int_mm_padded(cols, w_nk)
    return y.reshape(B, Ho, Wo, O).permute(0, 3, 1, 2)


def _conv(x: torch.Tensor, w: torch.Tensor, strides, padding: str, groups: int):
    """A convolution with TF's SAME or with VALID padding."""
    if padding == "SAME":
        return conv2d_same(x, w, None, tuple(strides), groups)
    return F.conv2d(x, w, None, tuple(strides), groups=groups)


def _conv_exact_float(xq: torch.Tensor, kernel_q: torch.Tensor, strides, padding: str,
                      groups: int, dtype: torch.dtype) -> torch.Tensor:
    """The integer convolution in a float type whose sums stay exact,
    cast to int32."""
    return _conv(xq.to(dtype), kernel_q.to(dtype), strides, padding, groups).to(torch.int32)


def int8_conv(xq: torch.Tensor, kernel_q: torch.Tensor, strides=(1, 1),
              padding: str = "SAME", groups: int = 1) -> torch.Tensor:
    """``conv(int8, int8) → int32``, exact: ``xq [B, Cin, H, W]``,
    ``kernel_q [Cout, Cin / groups, kh, kw]``. On a CUDA tensor the route of
    :func:`int8_conv_route`; on the CPU the plain version, a float64
    convolution."""
    if not xq.is_cuda:
        return _conv_exact_float(xq, kernel_q, strides, padding, groups, torch.float64)
    route = int8_conv_route(kernel_q.shape[2:], strides, groups, xq.shape[1])
    if route == "grouped_f32":
        return _conv_exact_float(xq, kernel_q, strides, padding, groups, torch.float32)
    return int8_conv_columns(xq, kernel_q, strides, padding)


class QuantConv(nn.Module):
    """Int8 conv + bias, shaped like a folded convolution unit.

    Parameters ``kernel_q`` (int8 OIHW), ``w_scale`` (f32 ``[cout]``, the
    dequantization multiplier) and ``bias`` (f32 ``[cout]``), made from a
    folded checkpoint by :func:`quantize_variables`, never trained; the
    activation scale is the buffer ``x_scale`` (the ``quant`` collection).

    ``calibrate=True`` runs the convolution in ``compute_dtype`` with the
    dequantized weights (so that later units see realistic activations),
    accumulating in float32, and leaves ``max(x_scale, max|x|)`` in
    :attr:`updated`. Otherwise: ``round(x·127/scale)`` clipped to ±127, the
    exact int8 convolution, then ``y·(scale/127)·w_scale + bias``, in that
    order, in float32 (``scale`` is ``x_scale``, or 1 where it is 0).

    Takes and returns logical NCHW tensors, as the units around it.
    """

    def __init__(self, in_features: int, features: int, kernel: Sequence[int],
                 strides: Sequence[int] = (1, 1), padding: str = "SAME",
                 groups: int = 1, calibrate: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        kh, kw = tuple(kernel)
        self.strides = tuple(strides)
        self.padding = padding
        self.groups = groups
        self.calibrate = calibrate
        self.compute_dtype = compute_dtype
        self.kernel_q = _meta(features, in_features // groups, kh, kw, dtype=torch.int8,
                              requires_grad=False)
        self.w_scale = _meta(features)
        self.bias = _meta(features)
        self.register_buffer("x_scale", torch.empty((), device="meta"))
        self.updated: Optional[torch.Tensor] = None  # x_scale after a calibrate call

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.calibrate:
            amax = x.abs().max().to(torch.float32)
            self.updated = torch.maximum(self.x_scale, amax)
            dt = self.compute_dtype
            w = self.kernel_q.to(dt) * self.w_scale.to(dt)[:, None, None, None]
            # inputs rounded to compute_dtype, products and sums in float32
            # (the JAX package's preferred_element_type=float32)
            y = _conv(x.to(dt).to(torch.float32), w.to(torch.float32), self.strides,
                      self.padding, self.groups)
            return (y + self.bias[:, None, None]).to(dt)
        scale = torch.where(self.x_scale > 0, self.x_scale, torch.ones_like(self.x_scale))
        xq = torch.clamp(torch.round(x.to(torch.float32) * (127.0 / scale)), -127, 127
                         ).to(torch.int8)
        y = int8_conv(xq, self.kernel_q, self.strides, self.padding, self.groups)
        mult = (scale / 127.0) * self.w_scale
        y = y.to(torch.float32) * mult[:, None, None] + self.bias[:, None, None]
        return y.to(self.compute_dtype)


def quantize_conv_params(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of an OIHW weight:
    ``(kernel_q int8 OIHW, w_scale f32 [cout])`` with ``weight ≈ kernel_q ·
    w_scale``. The JAX package's function on the transposed (HWIO) kernel,
    value for value."""
    w = weight.to(torch.float32)
    absmax = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12)
    w_scale = absmax / 127.0
    kernel_q = torch.clamp(torch.round(w / w_scale[:, None, None, None]), -127, 127)
    return kernel_q.to(torch.int8), w_scale


def quantize_variables(folded_variables, backbone_scope: str = "InceptionV3"
                       ) -> Dict[str, Dict[str, torch.Tensor]]:
    """BN-folded f32 variables (``{"params": flat dict}``) → the int8
    model's: every ``<backbone_scope>.**.Conv.weight`` becomes
    ``Conv.kernel_q`` + ``Conv.w_scale`` (its bias passes through), with a
    zero ``quant`` entry ``Conv.x_scale`` awaiting calibration. The heads and
    anything outside the backbone pass through untouched."""
    params, quant = {}, {}
    for key, value in folded_variables["params"].items():
        if key.startswith(backbone_scope + ".") and key.endswith(".Conv.weight"):
            unit = key[: -len(".weight")]
            params[unit + ".kernel_q"], params[unit + ".w_scale"] = quantize_conv_params(value)
            quant[unit + ".x_scale"] = torch.zeros((), dtype=torch.float32,
                                                   device=value.device)
        else:
            params[key] = value
    return {"params": params, "quant": quant}
