"""MultiBox object detection in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (``sm_90a``).

The package mirrors the module layout of ``multibox_tpu`` (the JAX
implementation it was ported from) so each counterpart is found under the
same name, but it imports nothing from it. Public tensors keep that
package's layouts: images ``[B, H, W, 3]``, endpoints ``[B, H, W, C]``,
``locations [B, P, 4]``, ``confidences [B, P]`` or ``[B, P, C]``.

Entry points run on the CUDA device unless the caller passes ``device``;
see :func:`multibox_tpu_torch.device.resolve_device`.
"""

from multibox_tpu_torch.config import Config, parse_config_dict, parse_config_file
from multibox_tpu_torch.device import resolve_device
from multibox_tpu_torch.version import __version__


def __getattr__(name):
    """Lazy ``load_exported`` (keeps a bare ``import multibox_tpu_torch``
    from loading the serving path)."""
    if name == "load_exported":
        from multibox_tpu_torch.serving import load_exported

        return load_exported
    raise AttributeError(f"module 'multibox_tpu_torch' has no attribute {name!r}")


__all__ = [
    "__version__",
    "Config",
    "parse_config_dict",
    "parse_config_file",
    "load_exported",
    "resolve_device",
]
