"""MultiBox detection head.

:class:`MultiBoxHead` — the DeepMultiBox head (Erhan et al., CVPR'14;
Szegedy et al., arXiv:1412.1441): from the final feature map, a 1×1-conv
bottleneck + fully-connected layers emit ``locations [B, P, 4]`` (linear,
residual offsets w.r.t. the P clustered priors) and ``confidences [B, P]``
(logits). P is the number of *clustered* priors — predictions are tied to
priors by index, not by spatial cell.

The SSD multi-scale head of the JAX package is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

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
        x = self.Bottleneck(x).reshape(B, -1)
        loc = self.Locations(x).reshape(B, self.num_priors, 4)
        conf = self.Confidences(x)
        if self.num_classes == 1:
            conf = conf.reshape(B, self.num_priors)
        else:
            conf = conf.reshape(B, self.num_priors, self.num_classes)
        return loc, conf
