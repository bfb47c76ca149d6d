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

Forward only: the backward (plain matmuls in the JAX package) belongs to
the training slice, so a tensor that requires grad is refused.

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
        raise NotImplementedError(
            "fused_matmul_bias_relu is forward-only: its backward is part of "
            "the training slice of the port; call it under torch.no_grad()"
        )
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


def conv1x1_bias_relu(
    x_nhwc: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True
) -> torch.Tensor:
    """1×1 conv as fused matmul. x: ``[B, H, W, Cin]``; w: ``[Cin, Cout]``;
    b: ``[Cout]``."""
    B, H, W, C = x_nhwc.shape
    y = fused_matmul_bias_relu(
        x_nhwc.reshape(B * H * W, C).contiguous(), w, b, relu)
    return y.reshape(B, H, W, -1)
