"""CUDA kernels: fused matmul + bias + ReLU (the 1×1-conv primitive).

Replaces ``fused_matmul_bias_relu`` / ``conv1x1_bias_relu`` of the JAX
package (``multibox_tpu/ops/pallas/fused_matmul.py``). The MultiBox head is
a 1×1 conv and two dense layers, and a 1×1 conv IS a matmul over
``[B·H·W, Cin] × [Cin, Cout]``. The kernels compute the product in their
own bodies with f32 accumulation and apply the f32 bias, the ReLU and the
cast to ``x.dtype`` in an epilogue.

The shapes the port runs are limited by different things on this card, so
:func:`_plan` picks a route from ``(M, K, N, dtype)`` before the launch
(never after a failure):

- ``skinny`` (f32, M ≤ 64: the FC layers at batch 32), bound by reading
  ``w`` once: 128-column tiles split along K until two blocks an SM run,
  partial sums in an f32 workspace ``[S, M, N]``, summed in a fixed order
  by a second kernel that applies bias and ReLU (no float atomics: the
  same inputs give the same bits).
- ``tall_f32`` (f32, M ≥ 512: the Bottleneck), bound by f32 operations: a
  register-blocked 128×96 tile with an 8×6 micro-tile, split along K until
  128 blocks run, the same workspace and reduction.
- ``tall_bf16`` (bf16, K and N multiples of 8: the folded 1×1 units),
  bound by reading ``x``: tensor cores (``mma.sync`` m16n8k16, bf16 in,
  f32 accumulate), 128-row tiles, the whole width in one tile up to
  N = 128 and 64 columns beyond; split along K like the others where its
  tiles fill a quarter of the SMs or less (small batches), the reduction
  casting to bf16.
- ``general``: the first port's 64×64 f32-FMA tile, for what no fast route
  takes (rows not a multiple of 16 bytes, f32 with 64 < M < 512).

The wrapper owns the workspace (kept per device and stream, grown with
``torch.empty``); the kernels allocate nothing. The launch is the operator
``multibox_torch::fused_matmul_bias_relu`` (``torch.library.custom_op``),
so that ``torch.export`` records it as one call.

Backward: when an input requires grad, the call goes through
:class:`_FusedLayer`, a ``torch.autograd.Function`` whose forward launches
the same kernels and saves ``x, w, b`` and the output ``y``, and whose
backward is the JAX package's (``fused_matmul.py`` ``_bwd``), step by
step: the ReLU mask from the output (``y > 0``), then ``dx = g·wᵀ``,
``dw = xᵀ·g`` and ``db = Σg`` in f32, each cast to its input's dtype. Those
are plain matrix products outside any kernel in the JAX package too, so
they stay ``torch.matmul`` here.

Source: ``csrc/fused_matmul.cu``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from multibox_tpu_torch.ops import kernels as K

SMS = 132  # streaming multiprocessors of an H100 SXM
ROUTES = {"general": 0, "skinny": 1, "tall_f32": 2, "tall_bf16": 3}
SKINNY_MAX_M = 64
TALL_F32_MIN_M = 512
_GRID_YZ_MAX = 65535


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs: ``route``; ``tile`` = (rows, columns, K step) of
    a block; ``split_k`` slices of ``kslice`` along K (slice s is
    ``[s·kslice, min((s+1)·kslice, K))``); ``grid`` of the main kernel;
    the f32 ``workspace_floats`` the slices' partial sums take
    (``split_k·M·N``, 0 without a split)."""

    route: str
    tile: Tuple[int, int, int]
    split_k: int
    kslice: int
    grid: Tuple[int, int, int]
    workspace_floats: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split(K: int, tiles: int, target: int, min_slice: int, step: int) -> Tuple[int, int]:
    """(slices, slice length) along K so that ``tiles · slices`` reaches
    ``target`` blocks; slices are a multiple of ``step`` long and at least
    ``min_slice``, the last one possibly shorter."""
    if tiles >= target or K < 2 * min_slice:
        return 1, K
    want = _cdiv(target, tiles)
    length = max(min_slice, (K // want) // step * step)
    return _cdiv(K, length), length


def _bf16_tile_n(N: int) -> int:
    """Column tile of the bf16 route: the whole width up to 128, else 64
    (more blocks; on the H100 it beat 96 and 128, split or not, on every
    folded unit wider than 128)."""
    return next((t for t in (32, 64, 96, 128) if N <= t), 64)


@functools.lru_cache(maxsize=4096)
def _plan(M: int, K: int, N: int, dtype: torch.dtype, aligned: bool = True) -> Plan:
    """The route for ``x [M, K] @ w [K, N]`` in ``dtype``. ``aligned``: x
    and w start on 16 bytes (the fast routes copy 16-byte chunks). Raises
    ValueError for a shape no grid can cover. Cached: a model calls it
    with the same few shapes on every batch."""
    if max(M, K, N) >= 2**31:
        raise ValueError("fused_matmul: dimension too large")
    rows16 = aligned and K > 0
    if dtype == torch.bfloat16 and rows16 and K % 8 == 0 and N % 8 == 0:
        # 128-row tiles, K steps of 64. Split only where the tiles fill a
        # quarter of the SMs or less: above that the split's f32 partial
        # sums and second launch cost more than they give (on an H100).
        route, bm, bn, bk, min_slice, step = "tall_bf16", 128, _bf16_tile_n(N), 64, 256, 64
        target = SMS if 4 * _cdiv(M, bm) * _cdiv(N, bn) <= SMS else 0
    elif dtype == torch.float32 and rows16 and K % 4 == 0 and N % 4 == 0 \
            and M <= SKINNY_MAX_M:
        # two blocks an SM: the reads of w have to be in flight everywhere
        route, bn, bk, target, min_slice, step = "skinny", 128, 32, 2 * SMS, 32, 4
        bm = 8 * next(r for r in (1, 2, 4, 8) if 8 * r >= M)
    elif dtype == torch.float32 and rows16 and K % 4 == 0 and N % 4 == 0 \
            and M >= TALL_F32_MIN_M:
        route, bm, bn, bk, target, min_slice, step = "tall_f32", 128, 96, 32, 128, 128, 4
    else:
        route, bm, bn, bk = "general", 64, 64, 16
        target, min_slice, step = 0, K, 1
    mt, nt = _cdiv(M, bm), _cdiv(N, bn)
    split, kslice = _split(K, mt * nt, target, min_slice, step)
    grid = (nt, mt, split) if route == "skinny" else (mt, nt, split)
    plan = Plan(route, (bm, bn, bk), split, kslice, grid, split * M * N if split > 1 else 0)
    if plan.grid[1] > _GRID_YZ_MAX or plan.grid[2] > _GRID_YZ_MAX:
        raise ValueError("fused_matmul: dimension too large")
    return plan


def _workspace(device: torch.device, stream: int, floats: int) -> torch.Tensor:
    """The f32 workspace of the split routes (``kernels.scratch``)."""
    return K.scratch(device, stream, floats, torch.float32)


def fused_matmul_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True
) -> torch.Tensor:
    """Plain PyTorch version: f32 accumulate, f32 bias, output in x.dtype."""
    y = x.to(torch.float32) @ w.to(torch.float32) + b.to(torch.float32)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def fused_matmul_bias_relu(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True
) -> torch.Tensor:
    """``relu(x @ w + b)`` with the epilogue fused in the kernel.

    x: ``[M, K]``; w: ``[K, N]`` (both f32 or both bf16); b: ``[N]`` f32.
    Returns ``[M, N]`` in ``x.dtype``, through the operator
    ``multibox_torch::fused_matmul_bias_relu`` (:func:`fused_matmul_op`):
    CUDA tensors launch the route :func:`_plan` picks (or raise); CPU
    tensors take :func:`fused_matmul_plain`. When an input requires grad
    the call goes through :class:`_FusedLayer`.
    """
    if (torch.is_grad_enabled()
            and (x.requires_grad or w.requires_grad or b.requires_grad)):
        return _FusedLayer.apply(x, w, b, relu)
    return fused_matmul_op(x, w, b, bool(relu))


def _check_shapes(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    K.require(x.dim() == 2 and w.dim() == 2 and b.dim() == 1
              and x.shape[1] == w.shape[0] and w.shape[1] == b.shape[0],
              "fused_matmul: x [M, K], w [K, N], b [N] expected, got {}, {}, {}",
              tuple(x.shape), tuple(w.shape), tuple(b.shape))
    K.require(x.device == w.device == b.device,
              "fused_matmul: tensors on {}, {}, {}", x.device, w.device, b.device)


@torch.library.custom_op("multibox_torch::fused_matmul_bias_relu", mutates_args=())
def fused_matmul_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    relu: bool) -> torch.Tensor:
    """The operator behind :func:`fused_matmul_bias_relu`'s forward: the
    launch (counted here, so an exported program counts its launches when
    it runs), the plain version for a CPU tensor."""
    _check_shapes(x, w, b)
    if not x.is_cuda:
        return fused_matmul_plain(x, w, b, relu)
    K.require(x.dtype in (torch.float32, torch.bfloat16) and w.dtype == x.dtype,
              "fused_matmul: x and w both float32 or both bfloat16, got {} / {}",
              x.dtype, w.dtype)
    K.require(b.dtype == torch.float32, "fused_matmul: bias float32, got {}", b.dtype)
    K.require(x.is_contiguous() and w.is_contiguous() and b.is_contiguous(),
              "fused_matmul: tensors must be contiguous")
    M, Kdim = x.shape
    N = w.shape[1]
    plan = _plan(M, Kdim, N, x.dtype,
                 aligned=x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M > 0 and N > 0:
        lib = K.load_library()
        stream = K.current_stream_ptr()
        ws = (_workspace(x.device, stream, plan.workspace_floats).data_ptr()
              if plan.workspace_floats else 0)
        err = lib.mbx_fused_matmul(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), ws, M, Kdim, N,
            int(relu), int(x.dtype == torch.bfloat16), ROUTES[plan.route],
            plan.split_k, plan.kslice, plan.tile[1], stream)
        K.check_launch(err, "mbx_fused_matmul")
        K.LAUNCHES["fused_matmul"] += 1
    return out


@fused_matmul_op.register_fake
def _fused_matmul_fake(x, w, b, relu):
    _check_shapes(x, w, b)
    return x.new_empty((x.shape[0], w.shape[1]))


def fused_matmul_backward(x, w, b, y, g, relu: bool, needs=(True, True, True)):
    """The backward of :func:`fused_matmul_bias_relu` given its saved
    inputs and output: ``(dx, dw, db)``, ``None`` where ``needs`` says the
    gradient is not wanted. The JAX package's ``_bwd``. Counted (as
    ``fused_matmul_backward``) when it runs on the card."""
    if relu:
        g = torch.where(y > 0, g, torch.zeros_like(g))
    g32 = g.to(torch.float32)
    dx = (g32 @ w.to(torch.float32).T).to(x.dtype) if needs[0] else None
    dw = (x.to(torch.float32).T @ g32).to(w.dtype) if needs[1] else None
    db = g32.sum(0).to(b.dtype) if needs[2] else None
    if g.is_cuda:
        K.LAUNCHES["fused_matmul_backward"] += 1
    return dx, dw, db


class _FusedLayer(torch.autograd.Function):
    """Autograd for the fused layer: the kernel forward, the plain backward."""

    @staticmethod
    def forward(ctx, x, w, b, relu):
        y = fused_matmul_op(x, w, b, bool(relu))
        ctx.save_for_backward(x, w, b, y)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, b, y = ctx.saved_tensors
        dx, dw, db = fused_matmul_backward(x, w, b, y, g, ctx.relu,
                                           ctx.needs_input_grad[:3])
        return dx, dw, db, None


def conv1x1_bias_relu(
    x_nhwc: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True
) -> torch.Tensor:
    """1×1 conv as fused matmul. x: ``[B, H, W, Cin]``; w: ``[Cin, Cout]``;
    b: ``[Cout]``."""
    B, H, W, C = x_nhwc.shape
    y = fused_matmul_bias_relu(
        x_nhwc.reshape(B * H * W, C).contiguous(), w, b, relu)
    return y.reshape(B, H, W, -1)
