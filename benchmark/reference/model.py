"""Plain float32 Inception-v3 with the MultiBox and SSD heads.

The architecture of Szegedy et al., "Rethinking the Inception Architecture
for Computer Vision" (arXiv:1512.00567), in tf-slim's topology and scope
names, with the MultiBox head (arXiv:1412.1441: a 1x1 bottleneck and two
fully connected layers over the final 8x8 map, one output per clustered
prior) or the SSD head (arXiv:1512.02325: a 3x3 convolution pair per
endpoint). Written as functions of a flat dictionary of tensors keyed by
those scope names, in the standard NCHW layout, with no kernel, no cache
and no batching trick: the yardstick that the benchmark holds the program
to. It imports nothing but torch.

Conventions that the published model fixes and that this follows:

- slim's BatchNorm: eps 1e-3, no scale; in training the batch's own mean and
  biased variance, and running statistics ``m * running + (1 - m) * batch``;
- TensorFlow's SAME padding, the odd pixel after;
- the 3x3 average pool divides by the pixels inside the image;
- the MultiBox head's flatten runs over (row, column, channel).

Every convolution and product reads its operands through a
:class:`Precision`; the reference's is exact float32, and the control of the
benchmark's correctness check rounds them to a lower precision.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
Tensors = Dict[str, torch.Tensor]


def _exact(x: torch.Tensor) -> torch.Tensor:
    return x


def _scaled_round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` with one scale for the tensor, its
    largest magnitude at ``top``."""
    scale = x.abs().max().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, one scale for the tensor, as an fp8
    product reads its operands; the gradient passes through unchanged."""
    return x + (_scaled_round(x.detach(), torch.float8_e4m3fn, 448.0) - x.detach())


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 bits of mantissa, to nearest), as a TF32
    product reads float32 operands; the gradient passes through unchanged."""
    return x + (_tf32(x.detach()) - x.detach())


class _Round(torch.autograd.Function):
    """``fwd(x)``, whose gradient is ``bwd(g)``: a tensor stored in a lower
    precision on the way forward and its gradient on the way back."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def _fp8_e4m3(x):
    return _scaled_round(x, torch.float8_e4m3fn, 448.0)


def _fp8_e5m2(g):
    return _scaled_round(g, torch.float8_e5m2, 57344.0)


def fp8_activation(x: torch.Tensor) -> torch.Tensor:
    """``x`` stored in float8 e4m3 and its gradient in e5m2, each with one
    scale for the tensor: fp8 training's formats."""
    return _Round.apply(x, _fp8_e4m3, _fp8_e5m2)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_activation(x: torch.Tensor) -> torch.Tensor:
    """``x`` stored in bfloat16, and its gradient too."""
    return _Round.apply(x, _bf16, _bf16)


def tf32_gradient(y: torch.Tensor) -> torch.Tensor:
    """``y``; its gradient rounded to TF32."""
    return _Round.apply(y, _exact, _tf32)


class Precision:
    """What the products read and the activations are stored in:
    ``backbone`` and ``head`` round the operands of Inception-v3's
    convolutions and of the head's products; ``activation`` stores each
    tensor the backbone makes (the input, every convolution's output, every
    unit's and pool's), and ``head_out`` each product of the head (on the way
    back, the gradients they pass on)."""

    def __init__(self, backbone: Callable = _exact, head: Callable = _exact,
                 activation: Callable = _exact, head_out: Callable = _exact):
        self.backbone, self.head = backbone, head
        self.activation, self.head_out = activation, head_out


FLOAT32 = Precision()
# the control: the configuration's bfloat16 backbone one step lower, computed
# as the program computes in bfloat16 (every operand and activation stored in
# the format, products accumulated in float32) but in fp8 (e4m3, e5m2 for
# gradients); its float32 head with TF32 off one step lower (TF32), forward
# and backward
CONTROL = Precision(backbone=round_fp8, head=round_tf32, activation=fp8_activation,
                    head_out=tf32_gradient)
# the program's precision but for its convolutions' operands, read in fp8
# (e4m3, one scale a tensor): activations and their gradients stored in
# bfloat16, the head in float32
FP8_PRODUCTS = Precision(backbone=round_fp8, activation=bf16_activation)


# ---------------------------------------------------------------------------
# the network as data: blocks of units (cin, cout, kh, kw, stride, padding)
# ---------------------------------------------------------------------------

Unit = Tuple[int, int, int, int, int, str]


def _inception_a(c: int, pool: int) -> Dict[str, Unit]:
    return {
        "Branch_0/Conv2d_0a_1x1": (c, 64, 1, 1, 1, "SAME"),
        "Branch_1/Conv2d_0a_1x1": (c, 48, 1, 1, 1, "SAME"),
        "Branch_1/Conv2d_0b_5x5": (48, 64, 5, 5, 1, "SAME"),
        "Branch_2/Conv2d_0a_1x1": (c, 64, 1, 1, 1, "SAME"),
        "Branch_2/Conv2d_0b_3x3": (64, 96, 3, 3, 1, "SAME"),
        "Branch_2/Conv2d_0c_3x3": (96, 96, 3, 3, 1, "SAME"),
        "Branch_3/Conv2d_0b_1x1": (c, pool, 1, 1, 1, "SAME"),
    }


def _reduction_a(c: int) -> Dict[str, Unit]:
    return {
        "Branch_0/Conv2d_1a_1x1": (c, 384, 3, 3, 2, "VALID"),
        "Branch_1/Conv2d_0a_1x1": (c, 64, 1, 1, 1, "SAME"),
        "Branch_1/Conv2d_0b_3x3": (64, 96, 3, 3, 1, "SAME"),
        "Branch_1/Conv2d_1a_1x1": (96, 96, 3, 3, 2, "VALID"),
    }


def _inception_b(c: int, c7: int) -> Dict[str, Unit]:
    return {
        "Branch_0/Conv2d_0a_1x1": (c, 192, 1, 1, 1, "SAME"),
        "Branch_1/Conv2d_0a_1x1": (c, c7, 1, 1, 1, "SAME"),
        "Branch_1/Conv2d_0b_1x7": (c7, c7, 1, 7, 1, "SAME"),
        "Branch_1/Conv2d_0c_7x1": (c7, 192, 7, 1, 1, "SAME"),
        "Branch_2/Conv2d_0a_1x1": (c, c7, 1, 1, 1, "SAME"),
        "Branch_2/Conv2d_0b_7x1": (c7, c7, 7, 1, 1, "SAME"),
        "Branch_2/Conv2d_0c_1x7": (c7, c7, 1, 7, 1, "SAME"),
        "Branch_2/Conv2d_0d_7x1": (c7, c7, 7, 1, 1, "SAME"),
        "Branch_2/Conv2d_0e_1x7": (c7, 192, 1, 7, 1, "SAME"),
        "Branch_3/Conv2d_0b_1x1": (c, 192, 1, 1, 1, "SAME"),
    }


def _reduction_b(c: int) -> Dict[str, Unit]:
    return {
        "Branch_0/Conv2d_0a_1x1": (c, 192, 1, 1, 1, "SAME"),
        "Branch_0/Conv2d_1a_3x3": (192, 320, 3, 3, 2, "VALID"),
        "Branch_1/Conv2d_0a_1x1": (c, 192, 1, 1, 1, "SAME"),
        "Branch_1/Conv2d_0b_1x7": (192, 192, 1, 7, 1, "SAME"),
        "Branch_1/Conv2d_0c_7x1": (192, 192, 7, 1, 1, "SAME"),
        "Branch_1/Conv2d_1a_3x3": (192, 192, 3, 3, 2, "VALID"),
    }


def _inception_c(c: int) -> Dict[str, Unit]:
    return {
        "Branch_0/Conv2d_0a_1x1": (c, 320, 1, 1, 1, "SAME"),
        "Branch_1/Conv2d_0a_1x1": (c, 384, 1, 1, 1, "SAME"),
        "Branch_1/Conv2d_0b_1x3": (384, 384, 1, 3, 1, "SAME"),
        "Branch_1/Conv2d_0b_3x1": (384, 384, 3, 1, 1, "SAME"),
        "Branch_2/Conv2d_0a_1x1": (c, 448, 1, 1, 1, "SAME"),
        "Branch_2/Conv2d_0b_3x3": (448, 384, 3, 3, 1, "SAME"),
        "Branch_2/Conv2d_0c_1x3": (384, 384, 1, 3, 1, "SAME"),
        "Branch_2/Conv2d_0d_3x1": (384, 384, 3, 1, 1, "SAME"),
        "Branch_3/Conv2d_0b_1x1": (c, 192, 1, 1, 1, "SAME"),
    }


def blocks() -> List[Tuple[str, str, Dict[str, Unit], int]]:
    """``(endpoint, kind, units, out_channels)`` in forward order; a stem
    unit's one unit is keyed "" and a pool has no units."""
    out = [
        ("Conv2d_1a_3x3", "unit", {"": (3, 32, 3, 3, 2, "VALID")}, 32),
        ("Conv2d_2a_3x3", "unit", {"": (32, 32, 3, 3, 1, "VALID")}, 32),
        ("Conv2d_2b_3x3", "unit", {"": (32, 64, 3, 3, 1, "SAME")}, 64),
        ("MaxPool_3a_3x3", "pool", {}, 64),
        ("Conv2d_3b_1x1", "unit", {"": (64, 80, 1, 1, 1, "VALID")}, 80),
        ("Conv2d_4a_3x3", "unit", {"": (80, 192, 3, 3, 1, "VALID")}, 192),
        ("MaxPool_5a_3x3", "pool", {}, 192),
    ]
    c = 192
    for name, pool in (("Mixed_5b", 32), ("Mixed_5c", 64), ("Mixed_5d", 64)):
        out.append((name, "a", _inception_a(c, pool), 224 + pool))
        c = 224 + pool
    out.append(("Mixed_6a", "reduction_a", _reduction_a(c), 384 + 96 + c))
    c = 384 + 96 + c
    for name, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160),
                     ("Mixed_6e", 192)):
        out.append((name, "b", _inception_b(c, c7), 768))
        c = 768
    out.append(("Mixed_7a", "reduction_b", _reduction_b(c), 320 + 192 + c))
    c = 320 + 192 + c
    for name in ("Mixed_7b", "Mixed_7c"):
        out.append((name, "c", _inception_c(c), 2048))
        c = 2048
    return out


def endpoint_channels() -> Dict[str, int]:
    return {name: ch for name, _, _, ch in blocks()}


def grid_size(input_size: int, endpoint: str) -> int:
    """Side of ``endpoint``'s feature map for a square input (299 -> 35 at
    Mixed_5d, 17 at Mixed_6e, 8 at Mixed_7c)."""
    n = input_size
    for name, kind, units, _ in blocks():
        if kind == "pool" or kind.startswith("reduction"):
            n = (n - 3) // 2 + 1
        elif kind == "unit":
            _, _, kh, _, stride, pad = units[""]
            n = (n - kh) // stride + 1 if pad == "VALID" else -(-n // stride)
        if name == endpoint:
            return n
    raise ValueError(f"unknown endpoint {endpoint!r}")


def unit_names() -> List[Tuple[str, Unit]]:
    """``(scope, unit)`` of every convolution unit, in forward order."""
    out = []
    for name, _, units, _ in blocks():
        for sub, unit in units.items():
            out.append((f"InceptionV3.{name}" + (f".{sub}" if sub else ""), unit))
    return out


def parameter_shapes(model: Dict) -> Tuple[Dict[str, tuple], Dict[str, tuple]]:
    """``(params, batch_stats)``: name -> shape of every tensor the model
    reads. ``model``: ``input_size``, ``head_type`` ("multibox" | "ssd"),
    ``num_priors``, ``num_classes``, ``bottleneck_features``,
    ``ssd_endpoints``, ``ssd_priors_per_cell``."""
    params, stats = {}, {}
    for scope, (cin, cout, kh, kw, _, _) in unit_names():
        params[f"{scope}.Conv.weight"] = (cout, cin, kh, kw)
        params[f"{scope}.BatchNorm.bias"] = (cout,)
        stats[f"{scope}.BatchNorm.mean"] = (cout,)
        stats[f"{scope}.BatchNorm.var"] = (cout,)
    channels = endpoint_channels()
    C = model.get("num_classes", 1)
    if model.get("head_type", "multibox") == "multibox":
        bn = model.get("bottleneck_features", 96)
        flat = grid_size(model["input_size"], "Mixed_7c") ** 2 * bn
        P = model["num_priors"]
        params["MultiBoxHead.Bottleneck.weight"] = (bn, channels["Mixed_7c"], 1, 1)
        params["MultiBoxHead.Bottleneck.bias"] = (bn,)
        params["MultiBoxHead.Locations.kernel"] = (flat, P * 4)
        params["MultiBoxHead.Locations.bias"] = (P * 4,)
        params["MultiBoxHead.Confidences.kernel"] = (flat, P * C)
        params["MultiBoxHead.Confidences.bias"] = (P * C,)
    else:
        K = model.get("ssd_priors_per_cell", 6)
        for ep in model["ssd_endpoints"]:
            params[f"SSDHead.Loc_{ep}.weight"] = (K * 4, channels[ep], 3, 3)
            params[f"SSDHead.Loc_{ep}.bias"] = (K * 4,)
            params[f"SSDHead.Conf_{ep}.weight"] = (K * C, channels[ep], 3, 3)
            params[f"SSDHead.Conf_{ep}.bias"] = (K * C,)
    return params, stats


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _same(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d(x, w, bias, stride: int, padding: str):
    if padding == "SAME":
        top, bottom = _same(x.shape[2], w.shape[2], stride)
        left, right = _same(x.shape[3], w.shape[3], stride)
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w, bias, stride)


class _Run:
    """One forward pass: the tensors, the precision, train mode and the
    new BatchNorm statistics it collects."""

    def __init__(self, params: Tensors, stats: Tensors, prec: Precision, train: bool,
                 momentum: float):
        self.p, self.s, self.prec, self.train, self.m = params, stats, prec, train, momentum
        self.new_stats: Tensors = {}

    def unit(self, scope: str, spec: Unit, x):
        _, _, _, _, stride, pad = spec
        q = self.prec.backbone
        a = self.prec.activation
        y = a(conv2d(q(x), q(self.p[f"{scope}.Conv.weight"]), None, stride, pad))
        bias = self.p[f"{scope}.BatchNorm.bias"][None, :, None, None]
        mean_key, var_key = f"{scope}.BatchNorm.mean", f"{scope}.BatchNorm.var"
        if self.train:
            mean = y.mean((0, 2, 3))
            var = ((y * y).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
            self.new_stats[mean_key] = self.m * self.s[mean_key] + (1 - self.m) * mean.detach()
            self.new_stats[var_key] = self.m * self.s[var_key] + (1 - self.m) * var.detach()
        else:
            mean, var = self.s[mean_key], self.s[var_key]
        y = (y - mean[None, :, None, None]) * torch.rsqrt(var + BN_EPS)[None, :, None, None]
        return a(torch.relu(y + bias))


def _avg_pool(run: "_Run", x):
    return run.prec.activation(F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=False))


def _block(run: _Run, name: str, kind: str, units: Dict[str, Unit], x):
    def u(sub, inp):
        return run.unit(f"InceptionV3.{name}.{sub}", units[sub], inp)

    if kind == "unit":
        return run.unit(f"InceptionV3.{name}", units[""], x)
    if kind == "pool":
        return F.max_pool2d(x, 3, 2)
    if kind == "a":
        b0 = u("Branch_0/Conv2d_0a_1x1", x)
        b1 = u("Branch_1/Conv2d_0b_5x5", u("Branch_1/Conv2d_0a_1x1", x))
        b2 = u("Branch_2/Conv2d_0c_3x3", u("Branch_2/Conv2d_0b_3x3",
                                            u("Branch_2/Conv2d_0a_1x1", x)))
        b3 = u("Branch_3/Conv2d_0b_1x1", _avg_pool(run, x))
        return torch.cat([b0, b1, b2, b3], 1)
    if kind == "reduction_a":
        b0 = u("Branch_0/Conv2d_1a_1x1", x)
        b1 = u("Branch_1/Conv2d_1a_1x1", u("Branch_1/Conv2d_0b_3x3",
                                            u("Branch_1/Conv2d_0a_1x1", x)))
        return torch.cat([b0, b1, F.max_pool2d(x, 3, 2)], 1)
    if kind == "b":
        b0 = u("Branch_0/Conv2d_0a_1x1", x)
        b1 = x
        for sub in ("Branch_1/Conv2d_0a_1x1", "Branch_1/Conv2d_0b_1x7",
                    "Branch_1/Conv2d_0c_7x1"):
            b1 = u(sub, b1)
        b2 = x
        for sub in ("Branch_2/Conv2d_0a_1x1", "Branch_2/Conv2d_0b_7x1",
                    "Branch_2/Conv2d_0c_1x7", "Branch_2/Conv2d_0d_7x1",
                    "Branch_2/Conv2d_0e_1x7"):
            b2 = u(sub, b2)
        b3 = u("Branch_3/Conv2d_0b_1x1", _avg_pool(run, x))
        return torch.cat([b0, b1, b2, b3], 1)
    if kind == "reduction_b":
        b0 = u("Branch_0/Conv2d_1a_3x3", u("Branch_0/Conv2d_0a_1x1", x))
        b1 = x
        for sub in ("Branch_1/Conv2d_0a_1x1", "Branch_1/Conv2d_0b_1x7",
                    "Branch_1/Conv2d_0c_7x1", "Branch_1/Conv2d_1a_3x3"):
            b1 = u(sub, b1)
        return torch.cat([b0, b1, F.max_pool2d(x, 3, 2)], 1)
    if kind == "c":
        b0 = u("Branch_0/Conv2d_0a_1x1", x)
        b1 = u("Branch_1/Conv2d_0a_1x1", x)
        b1 = torch.cat([u("Branch_1/Conv2d_0b_1x3", b1), u("Branch_1/Conv2d_0b_3x1", b1)], 1)
        b2 = u("Branch_2/Conv2d_0b_3x3", u("Branch_2/Conv2d_0a_1x1", x))
        b2 = torch.cat([u("Branch_2/Conv2d_0c_1x3", b2), u("Branch_2/Conv2d_0d_3x1", b2)], 1)
        b3 = u("Branch_3/Conv2d_0b_1x1", _avg_pool(run, x))
        return torch.cat([b0, b1, b2, b3], 1)
    raise ValueError(f"unknown block kind {kind!r}")


def backbone(run: _Run, images: torch.Tensor) -> Tensors:
    """``images [B, H, W, 3]`` in [-1, 1] -> every endpoint, NCHW."""
    x = run.prec.activation(images.permute(0, 3, 1, 2))
    endpoints = {}
    for name, kind, units, _ in blocks():
        x = _block(run, name, kind, units, x)
        endpoints[name] = x
    return endpoints


def multibox_head(run: _Run, model: Dict, x: torch.Tensor):
    q, o, p = run.prec.head, run.prec.head_out, run.p
    B = x.shape[0]
    P, C = model["num_priors"], model.get("num_classes", 1)
    w = p["MultiBoxHead.Bottleneck.weight"]
    nhwc = x.permute(0, 2, 3, 1)
    y = o(q(nhwc) @ q(w.reshape(w.shape[0], w.shape[1]).t())) + p["MultiBoxHead.Bottleneck.bias"]
    y = torch.relu(y).reshape(B, -1)
    loc = o(q(y) @ q(p["MultiBoxHead.Locations.kernel"])) + p["MultiBoxHead.Locations.bias"]
    conf = o(q(y) @ q(p["MultiBoxHead.Confidences.kernel"])) + p["MultiBoxHead.Confidences.bias"]
    conf = conf.reshape(B, P) if C == 1 else conf.reshape(B, P, C)
    return loc.reshape(B, P, 4), conf


def ssd_head(run: _Run, model: Dict, endpoints: Tensors):
    q, o, p = run.prec.head, run.prec.head_out, run.p
    K, C = model.get("ssd_priors_per_cell", 6), model.get("num_classes", 1)
    locs, confs = [], []
    for ep in model["ssd_endpoints"]:
        x = q(endpoints[ep])
        B, _, H, W = x.shape
        loc = o(F.conv2d(x, q(p[f"SSDHead.Loc_{ep}.weight"]), None, 1, 1)) \
            + p[f"SSDHead.Loc_{ep}.bias"][None, :, None, None]
        conf = o(F.conv2d(x, q(p[f"SSDHead.Conf_{ep}.weight"]), None, 1, 1)) \
            + p[f"SSDHead.Conf_{ep}.bias"][None, :, None, None]
        locs.append(loc.permute(0, 2, 3, 1).reshape(B, H * W * K, 4))
        confs.append(conf.permute(0, 2, 3, 1).reshape(B, H * W * K, C))
    conf = torch.cat(confs, 1)
    return torch.cat(locs, 1), conf.squeeze(-1) if C == 1 else conf


def forward(model: Dict, params: Tensors, stats: Tensors, images: torch.Tensor,
            prec: Precision = FLOAT32, train: bool = False,
            new_stats: Optional[Tensors] = None):
    """``(locations [B, P, 4], confidences [B, P])`` of ``images [B, S, S,
    3]`` in [-1, 1]. With ``train`` BatchNorm normalizes by the batch and
    the updated running statistics go into ``new_stats``."""
    run = _Run(params, stats, prec, train, model.get("bn_momentum", 0.9997))
    endpoints = backbone(run, images)
    if model.get("head_type", "multibox") == "multibox":
        out = multibox_head(run, model, endpoints["Mixed_7c"])
    else:
        out = ssd_head(run, model, endpoints)
    if new_stats is not None:
        new_stats.update(run.new_stats)
    return out
