"""CUDA kernels: bbox decode (+ clip) and encode, batched.

Replaces ``decode_boxes_pallas`` / ``encode_boxes_pallas`` of the JAX
package (``multibox_tpu/ops/pallas/box_kernel.py``). Semantics identical to
``ops.boxes.decode_boxes`` / ``encode_boxes`` (the MultiBox residual
parameterization); add-then-clip and subtract are exact in f32, so the
kernel's result is bitwise the plain version's.

Bound on this card: bytes. Each box is read twice (offset, prior: 32 B)
and written once (16 B) for four flops. The first version gave each thread one
float and found its prior with a 64-bit ``i % (P·4)``, which the card
computes in software, dozens of instructions an element. Now each thread
takes one whole box with 16-byte (``float4``) loads and stores, and a 2-D
grid (:func:`_plan`: x over the P boxes of a prior set, y over the rows of
the leading dimensions) makes the prior's index the thread's own x index and
a row's offset a multiply, with no division; a thread loads its prior once
for every row it visits. The broadcast of the priors over the batch is
never written out. ``float4`` needs 16-byte alignment, so the wrapper
refuses a tensor that does not start on a 16-byte boundary (there is no
scalar path). At the detect batch (32 × 256 boxes) the floor is the launch
and one round trip to memory, not the bytes.

The decode's launch is the operator ``multibox_torch::decode_boxes``
(``torch.library.custom_op``), so that ``torch.export`` records it as one
call; the encode (training only) is a plain function.

Source: ``csrc/box.cu``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

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


THREADS = 256  # a block's threads, one box each (csrc/box.cu kThreads)
MAX_GRID_Y = 65535


class Plan(NamedTuple):
    """A launch of ``csrc/box.cu``: ``rows`` × ``P`` boxes, blocks of
    :data:`THREADS` on a ``grid`` (x over the P boxes of a prior set, y over
    the rows, each y block visiting rows ``y, y + grid[1], ...``)."""

    P: int
    rows: int
    grid: Tuple[int, int]


def _plan(n_boxes: int, period_boxes: int) -> Plan:
    """The grid for ``n_boxes`` boxes over priors of ``period_boxes`` boxes:
    one thread a box, one y block a row up to the grid's y limit. Indices
    stay 32-bit within a row; a row's offset is a 64-bit multiply in the
    kernel, so no size needs another path."""
    K.require(period_boxes > 0 and n_boxes % period_boxes == 0,
              "box kernel: {} boxes are not rows of {} priors", n_boxes, period_boxes)
    K.require(period_boxes < 2**31, "box kernel: {} priors are too many", period_boxes)
    rows = n_boxes // period_boxes
    return Plan(period_boxes, rows, (-(-period_boxes // THREADS), max(1, min(rows, MAX_GRID_Y))))


def _check(a: torch.Tensor, priors: torch.Tensor, what: str) -> Plan:
    """Validate a kernel call; returns its launch plan."""
    K.require(priors.device == a.device,
              f"{what}: priors on {priors.device}, boxes on {a.device}")
    K.require(a.dtype == torch.float32 and priors.dtype == torch.float32,
              f"{what}: float32 only, got {a.dtype} / {priors.dtype}")
    K.require(a.dim() >= 1 and a.shape[-1] == 4, f"{what}: boxes must be [..., 4]")
    K.require(a.is_contiguous() and priors.is_contiguous(),
              f"{what}: tensors must be contiguous")
    # float4 loads and stores: one box is 16 bytes, and so must its address be
    K.require(a.data_ptr() % 16 == 0 and priors.data_ptr() % 16 == 0,
              "{}: boxes and priors must start on a 16-byte boundary", what)
    # priors broadcast over LEADING dims only: [P, 4], [1, P, 4], or a.shape.
    core = list(priors.shape)
    while core and core[0] == 1 and len(core) > 1:
        core = core[1:]
    K.require(len(core) <= a.dim() and list(a.shape[a.dim() - len(core):]) == core
              and priors.numel() > 0,
              f"{what}: priors {tuple(priors.shape)} do not broadcast over the "
              f"leading dims of {tuple(a.shape)}")
    return _plan(a.numel() // 4, priors.numel() // 4)


def _require_aligned(out: torch.Tensor, what: str) -> None:
    K.require(out.data_ptr() % 16 == 0, "{}: output not on a 16-byte boundary", what)


@torch.library.custom_op("multibox_torch::decode_boxes", mutates_args=())
def decode_boxes_cuda(
    offsets: torch.Tensor, priors: torch.Tensor, clip: bool = True
) -> torch.Tensor:
    """``prior + offset`` (+ clip to [0, 1]) in one pass. ``offsets``
    ``[..., P, 4]`` f32, ``priors`` ``[P, 4]`` or ``[1, P, 4]`` f32, both
    starting on a 16-byte boundary. The operator
    ``multibox_torch::decode_boxes``: the launch is counted here, so an
    exported program counts its launches when it runs."""
    if not offsets.is_cuda:
        return decode_boxes_plain(offsets, priors, clip)
    plan = _check(offsets, priors, "decode_boxes_cuda")
    out = torch.empty_like(offsets)
    _require_aligned(out, "decode_boxes_cuda")
    if plan.rows:
        lib = K.load_library()
        err = lib.mbx_box_decode(offsets.data_ptr(), priors.data_ptr(), out.data_ptr(),
                                 plan.P, plan.rows, *plan.grid, int(clip),
                                 K.current_stream_ptr())
        K.check_launch(err, "mbx_box_decode")
        K.LAUNCHES["box_decode"] += 1
    return out


@decode_boxes_cuda.register_fake
def _decode_boxes_fake(offsets, priors, clip=True):
    return torch.empty_like(offsets)


def encode_boxes_cuda(gt: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """``gt − prior``; same broadcasting and alignment as
    :func:`decode_boxes_cuda`."""
    if not gt.is_cuda:
        return encode_boxes_plain(gt, priors)
    plan = _check(gt, priors, "encode_boxes_cuda")
    out = torch.empty_like(gt)
    _require_aligned(out, "encode_boxes_cuda")
    if plan.rows:
        lib = K.load_library()
        err = lib.mbx_box_encode(gt.data_ptr(), priors.data_ptr(), out.data_ptr(),
                                 plan.P, plan.rows, *plan.grid, K.current_stream_ptr())
        K.check_launch(err, "mbx_box_encode")
        K.LAUNCHES["box_encode"] += 1
    return out
