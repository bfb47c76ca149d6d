"""MultiBox detection heads.

Two head families, as in the JAX package:

* :class:`MultiBoxHead` — the DeepMultiBox head (Erhan et al., CVPR'14;
  Szegedy et al., arXiv:1412.1441): from the final feature map, a 1×1-conv
  bottleneck + fully-connected layers emit ``locations [B, P, 4]``
  (linear, residual offsets w.r.t. the P clustered priors) and
  ``confidences [B, P]`` (logits). P is the number of *clustered* priors —
  predictions are tied to priors by index, not by spatial cell.
* :class:`SSDHead` — per-endpoint 3×3 conv heads over several feature-map
  resolutions (Liu et al., arXiv:1512.02325). Priors must be grid priors
  from ``priors.generate_priors_multiscale`` with matching feature-map
  sizes and priors-per-cell; output ordering is level → row → col →
  shape, identical to the prior generator's.

Both emit ``(locations [B, P, 4], confidences [B, P] or [B, P, C])``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multibox_tpu_torch.models.inception_v3 import _Conv
from multibox_tpu_torch.models.layers import FusedConv1x1, FusedDense


class MultiBoxHead(nn.Module):
    """FC MultiBox head over the final endpoint (default ``Mixed_7c``).

    All three layers route through the fused matmul kernel
    (``ops.kernels.fused_matmul``) when ``use_pallas`` is true; the
    parameters are identical either way.

    ``in_features`` and ``grid`` are the channel count and side length of
    the endpoint's feature map (2048 and 8 for Inception-v3 at 299).
    """

    def __init__(self, num_priors: int, in_features: int, grid: int,
                 num_classes: int = 1, bottleneck_features: int = 96,
                 endpoint: str = "Mixed_7c",
                 use_pallas: Optional[bool] = None):
        super().__init__()
        self.num_priors = num_priors
        self.num_classes = num_classes
        self.endpoint = endpoint
        # The head computes in float32 even under a bf16 backbone: bf16
        # logits stall confidence training, while the head is a negligible
        # fraction of the FLOPs. Standard mixed-precision practice.
        f32 = torch.float32
        self.Bottleneck = FusedConv1x1(
            in_features, bottleneck_features, use_bias=True, relu=True,
            use_pallas=use_pallas, dtype=f32)
        flat = grid * grid * bottleneck_features
        self.Locations = FusedDense(flat, num_priors * 4,
                                    use_pallas=use_pallas, dtype=f32)
        self.Confidences = FusedDense(flat, num_priors * num_classes,
                                      use_pallas=use_pallas, dtype=f32)

    def forward(self, endpoints: Dict[str, torch.Tensor], train: bool = False):
        x = endpoints[self.endpoint].to(torch.float32)  # NHWC
        B = x.shape[0]
        # Shared 1×1 bottleneck keeps the FC input tractable
        # (8·8·2048 → 8·8·96 ≈ 6k features); ReLU fused into the matmul
        # epilogue on the kernel path. The flatten is row-major over
        # (row, col, channel), which is why the layer is NHWC.
        x = self.Bottleneck(x).flatten(1)  # also for B = 0
        loc = self.Locations(x).reshape(B, self.num_priors, 4)
        conf = self.Confidences(x)
        if self.num_classes == 1:
            conf = conf.reshape(B, self.num_priors)
        else:
            conf = conf.reshape(B, self.num_priors, self.num_classes)
        return loc, conf


class SSDHead(nn.Module):
    """Multi-scale conv head: one (loc, conf) 3×3 SAME conv pair per
    endpoint, named ``Loc_<endpoint>`` / ``Conf_<endpoint>``, in float32
    over the (bf16) backbone features. ``in_features`` maps each endpoint
    to its channel count. Convolutions run on cuDNN, as the JAX package's
    ``nn.Conv`` do (no Pallas kernel there)."""

    def __init__(self, in_features: Mapping[str, int],
                 endpoints_spec: Sequence[str] = ("Mixed_5d", "Mixed_6e", "Mixed_7c"),
                 priors_per_cell: int = 6, num_classes: int = 1):
        super().__init__()
        self.endpoints_spec = tuple(endpoints_spec)
        self.priors_per_cell = priors_per_cell
        self.num_classes = num_classes
        K, C = priors_per_cell, num_classes
        for name in self.endpoints_spec:
            self.add_module(f"Loc_{name}", _Conv(in_features[name], K * 4, (3, 3), True))
            self.add_module(f"Conf_{name}", _Conv(in_features[name], K * C, (3, 3), True))

    def forward(self, endpoints: Dict[str, torch.Tensor], train: bool = False):
        locs, confs = [], []
        K, C = self.priors_per_cell, self.num_classes
        for name in self.endpoints_spec:
            # f32 head over bf16 backbone features (see MultiBoxHead);
            # NHWC → logical NCHW over the same bytes
            x = endpoints[name].to(torch.float32).permute(0, 3, 1, 2)
            B, _, H, W = x.shape
            out = []
            for conv in (self._modules[f"Loc_{name}"], self._modules[f"Conf_{name}"]):
                y = F.conv2d(x, conv.weight, conv.bias, 1, 1)  # 3×3 SAME
                # back to NHWC: the flatten is row → col → (shape, coord)
                out.append(y.permute(0, 2, 3, 1))
            locs.append(out[0].reshape(B, H * W * K, 4))
            confs.append(out[1].reshape(B, H * W * K, C))
        loc = torch.cat(locs, dim=1)
        conf = torch.cat(confs, dim=1)
        if C == 1:
            conf = conf.squeeze(-1)
        return loc, conf
