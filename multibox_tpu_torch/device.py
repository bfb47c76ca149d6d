"""Device selection and numeric precision for the whole package.

Entry points take ``device=None``, which means the CUDA device: there is
no silent CPU path. A caller that wants the CPU (the parity tests do) says
so with ``device="cpu"``.

Precision: float32 matrix products and float32 cuDNN convolutions both run
in full float32. cuDNN would otherwise use TF32 (about three decimal
digits) for float32 convolutions, which the float32 configuration of the
model does not expect.
"""

from __future__ import annotations

import torch


def set_precision() -> None:
    """Turn TF32 off for matmuls and cuDNN convolutions (both stated, both
    set: the first is PyTorch's default, the second is not)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda`` (raises when there is none); otherwise the
    device the caller named."""
    set_precision()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: multibox_tpu_torch runs on the GPU unless "
                "the caller passes device='cpu' explicitly"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device
