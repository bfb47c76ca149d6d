"""CUDA kernel: greedy bipartite prior matching, batched.

Replaces ``greedy_match_pallas_batched`` / ``greedy_match_pallas`` of the
JAX package (``multibox_tpu/ops/pallas/match_kernel.py``). Semantics are
those of that package's ``ops.matching.greedy_match`` over the IoU benefit:
per image, rows ``>= num_gt`` are padding; each round the live (gt, prior)
cell of largest IoU (the first row-major cell among equal values) assigns
the gt to the prior, and the row and the column die. Output ``[B, G]``
int32, −1 for a gt never assigned. G ≤ 128.

Bound on this card: the min(num_gt, P) dependent rounds, not bytes (B=32,
G=16, P=256 moves about 12 KB) and not flops. The design gives one thread
block to each image, computes the IoU benefit once into shared memory (or,
when G·P·4 bytes do not fit, into a global scratch buffer this wrapper
allocates), marks dead rows and columns with one flag each, and reduces
the (benefit, flat index) pair with warp shuffles and two barriers a
round. The TPU kernel's masked-min arg-max and its 8-row output tile
answered that compiler's lack of dynamic indexing and are not carried
over.

:func:`greedy_match_plain` is the plain PyTorch version: the same IoU
arithmetic op for op, so assignments agree exactly, ties included.

Source: ``csrc/match.cu``.
"""

from __future__ import annotations

import torch

from multibox_tpu_torch.ops import kernels as K
from multibox_tpu_torch.ops import matching

MAX_GT = 128


def greedy_match_plain(gt_boxes: torch.Tensor, num_gt: torch.Tensor,
                       priors: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``greedy_match(compute_benefit(...))`` over
    the batch, ``[B, G, 4]``, ``[B]``, ``[P, 4]`` → ``[B, G]`` int32."""
    return matching.greedy_match(matching.compute_benefit(gt_boxes, priors), num_gt)


def greedy_match_cuda(gt_boxes: torch.Tensor, num_gt: torch.Tensor,
                      priors: torch.Tensor) -> torch.Tensor:
    """Batched greedy IoU matching: ``gt_boxes [B, G, 4]`` f32, ``num_gt
    [B]`` int, shared ``priors [P, 4]`` f32 → ``[B, G]`` int32 (−1 =
    unassigned). On a CUDA tensor this launches the kernel (or raises); a
    CPU tensor takes :func:`greedy_match_plain`."""
    K.require(gt_boxes.dim() == 3 and gt_boxes.shape[-1] == 4
              and priors.dim() == 2 and priors.shape[-1] == 4
              and num_gt.shape == gt_boxes.shape[:1],
              f"greedy_match: gt [B, G, 4], num_gt [B], priors [P, 4] expected, "
              f"got {tuple(gt_boxes.shape)}, {tuple(num_gt.shape)}, "
              f"{tuple(priors.shape)}")
    K.require(gt_boxes.device == priors.device == num_gt.device,
              f"greedy_match: tensors on {gt_boxes.device}, {num_gt.device}, "
              f"{priors.device}")
    if not gt_boxes.is_cuda:
        return greedy_match_plain(gt_boxes, num_gt, priors)
    B, G = gt_boxes.shape[:2]
    P = priors.shape[0]
    K.require(G <= MAX_GT, f"greedy_match: at most {MAX_GT} gt boxes, got {G}")
    K.require(gt_boxes.dtype == torch.float32 and priors.dtype == torch.float32,
              f"greedy_match: float32 boxes only, got {gt_boxes.dtype} / "
              f"{priors.dtype}")
    K.require(P < 2**31 // max(G, 1), "greedy_match: too many priors")
    gt_boxes = gt_boxes.contiguous()
    priors = priors.contiguous()
    num_gt = num_gt.to(torch.int32).contiguous()
    out = torch.empty((B, G), dtype=torch.int32, device=gt_boxes.device)
    if B > 0 and G > 0:
        lib = K.load_library()
        floats = lib.mbx_greedy_match_scratch_floats(G, P)
        scratch = None
        if floats:  # the benefit does not fit shared memory: global scratch
            scratch = torch.empty((B, floats), dtype=torch.float32,
                                  device=gt_boxes.device)
        err = lib.mbx_greedy_match(
            gt_boxes.data_ptr(), num_gt.data_ptr(), priors.data_ptr(),
            out.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
            B, G, P, K.current_stream_ptr())
        K.check_launch(err, "mbx_greedy_match")
        K.LAUNCHES["match"] += 1
    return out
