"""CUDA kernel: fused matmul + bias + ReLU (the 1×1-conv primitive).

Replaces ``fused_matmul_bias_relu`` / ``conv1x1_bias_relu`` of the JAX
package (``multibox_tpu/ops/pallas/fused_matmul.py``). The MultiBox head is
a 1×1 conv and two dense layers, and a 1×1 conv IS a matmul over
``[B·H·W, Cin] × [Cin, Cout]``. The kernel computes the product in its own
body (a tiled shared-memory GEMM with f32 accumulation) and applies the f32
bias, the ReLU and the cast to ``x.dtype`` in its epilogue, so the
pre-activation never goes to device memory.

Bound on this card: operations for the tall problems (bottleneck layer,
folded 1×1 units), the single read of ``w`` for the batch-sized dense
layers, where M = 32 also means few blocks. The design masks ragged M, N
and K itself instead of padding copies of x and w, and otherwise stays
simple: CUDA cores, no tensor cores, no split along K.

Backward: when an input requires grad, the call goes through
:class:`_FusedLayer`, a ``torch.autograd.Function`` whose forward launches
the same kernel and saves ``x, w, b`` and the output ``y``, and whose
backward is the JAX package's (``fused_matmul.py`` ``_bwd``), step by
step: the ReLU mask from the output (``y > 0``), then ``dx = g·wᵀ``,
``dw = xᵀ·g`` and ``db = Σg`` in f32, each cast to its input's dtype. Those
are plain matrix products outside any kernel in the JAX package too, so
they stay ``torch.matmul`` here.

Source: ``csrc/fused_matmul.cu``.
"""

from __future__ import annotations

import torch

from multibox_tpu_torch.ops import kernels as K


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
    Returns ``[M, N]`` in ``x.dtype``. CUDA tensors launch the kernel (or
    raise); CPU tensors take :func:`fused_matmul_plain`.
    """
    if (torch.is_grad_enabled()
            and (x.requires_grad or w.requires_grad or b.requires_grad)):
        # the Function's forward comes back here with grad mode off
        return _FusedLayer.apply(x, w, b, relu)
    K.require(x.dim() == 2 and w.dim() == 2 and b.dim() == 1
              and x.shape[1] == w.shape[0] and w.shape[1] == b.shape[0],
              f"fused_matmul: x [M, K], w [K, N], b [N] expected, got "
              f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    K.require(x.device == w.device == b.device,
              f"fused_matmul: tensors on {x.device}, {w.device}, {b.device}")
    if not x.is_cuda:
        return fused_matmul_plain(x, w, b, relu)
    K.require(x.dtype in (torch.float32, torch.bfloat16) and w.dtype == x.dtype,
              f"fused_matmul: x and w both float32 or both bfloat16, got "
              f"{x.dtype} / {w.dtype}")
    K.require(b.dtype == torch.float32, f"fused_matmul: bias float32, got {b.dtype}")
    K.require(x.is_contiguous() and w.is_contiguous() and b.is_contiguous(),
              "fused_matmul: tensors must be contiguous")
    M, Kdim = x.shape
    N = w.shape[1]
    K.require(max(M, Kdim, N) < 2**31 and (N + 63) // 64 <= 65535,
              "fused_matmul: dimension too large")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M > 0 and N > 0:
        lib = K.load_library()
        err = lib.mbx_fused_matmul(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            M, Kdim, N, int(bool(relu)), int(x.dtype == torch.bfloat16),
            K.current_stream_ptr())
        K.check_launch(err, "mbx_fused_matmul")
        K.LAUNCHES["fused_matmul"] += 1
    return out


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
        y = fused_matmul_bias_relu(x, w, b, relu)
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
