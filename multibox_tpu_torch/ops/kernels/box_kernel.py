"""CUDA kernels: bbox decode (+ clip) and encode, batched.

Replaces ``decode_boxes_pallas`` / ``encode_boxes_pallas`` of the JAX
package (``multibox_tpu/ops/pallas/box_kernel.py``). Semantics identical to
``ops.boxes.decode_boxes`` / ``encode_boxes`` (the MultiBox residual
parameterization); add-then-clip and subtract are exact in f32, so the
kernel's result is bitwise the plain version's.

Bound on this card: bytes. Each element is read twice (offset, prior) and
written once for one flop. The design therefore moves nothing it need not:
one thread per element with coalesced accesses, and the priors are indexed
``i % (P·4)`` inside the kernel so their broadcast over the batch is never
written out (the ``[P, 4]`` priors stay in L2 across the batch).

Source: ``csrc/box.cu``.
"""

from __future__ import annotations

import torch

from multibox_tpu_torch.ops import kernels as K


def decode_boxes_plain(
    offsets: torch.Tensor, priors: torch.Tensor, clip: bool = True
) -> torch.Tensor:
    """Plain PyTorch version of the decode kernel."""
    boxes = priors + offsets
    return boxes.clamp(0.0, 1.0) if clip else boxes


def encode_boxes_plain(gt: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the encode kernel."""
    return gt - priors


def _check(a: torch.Tensor, priors: torch.Tensor, what: str) -> int:
    """Validate a kernel call; returns the broadcast period (prior numel)."""
    K.require(priors.device == a.device,
              f"{what}: priors on {priors.device}, boxes on {a.device}")
    K.require(a.dtype == torch.float32 and priors.dtype == torch.float32,
              f"{what}: float32 only, got {a.dtype} / {priors.dtype}")
    K.require(a.dim() >= 1 and a.shape[-1] == 4, f"{what}: boxes must be [..., 4]")
    K.require(a.is_contiguous() and priors.is_contiguous(),
              f"{what}: tensors must be contiguous")
    # priors broadcast over LEADING dims only: [P, 4], [1, P, 4], or a.shape.
    core = list(priors.shape)
    while core and core[0] == 1 and len(core) > 1:
        core = core[1:]
    K.require(len(core) <= a.dim() and list(a.shape[a.dim() - len(core):]) == core
              and priors.numel() > 0,
              f"{what}: priors {tuple(priors.shape)} do not broadcast over the "
              f"leading dims of {tuple(a.shape)}")
    return priors.numel()


def decode_boxes_cuda(
    offsets: torch.Tensor, priors: torch.Tensor, clip: bool = True
) -> torch.Tensor:
    """``prior + offset`` (+ clip to [0, 1]) in one pass. ``offsets``
    ``[..., P, 4]`` f32, ``priors`` ``[P, 4]`` or ``[1, P, 4]`` f32."""
    if not offsets.is_cuda:
        return decode_boxes_plain(offsets, priors, clip)
    period = _check(offsets, priors, "decode_boxes_cuda")
    out = torch.empty_like(offsets)
    lib = K.load_library()
    err = lib.mbx_box_decode(offsets.data_ptr(), priors.data_ptr(), out.data_ptr(),
                             offsets.numel(), period, int(bool(clip)),
                             K.current_stream_ptr())
    K.check_launch(err, "mbx_box_decode")
    K.LAUNCHES["box_decode"] += 1
    return out


def encode_boxes_cuda(gt: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """``gt − prior``; same broadcasting as :func:`decode_boxes_cuda`."""
    if not gt.is_cuda:
        return encode_boxes_plain(gt, priors)
    period = _check(gt, priors, "encode_boxes_cuda")
    out = torch.empty_like(gt)
    lib = K.load_library()
    err = lib.mbx_box_encode(gt.data_ptr(), priors.data_ptr(), out.data_ptr(),
                             gt.numel(), period, K.current_stream_ptr())
    K.check_launch(err, "mbx_box_encode")
    K.LAUNCHES["box_encode"] += 1
    return out
