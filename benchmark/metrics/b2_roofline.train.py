"""B2 (csrc/fused_matmul.cu) in the forward of the MultiBox head inside the
train step (its backward is on cuBLAS): the traced device time of its
launches against the least time of the head's three products in float32
(each operand and output once, 2·M·K·N operations)."""
from benchmark import count, readers

KERNELS = r"\b(skinny_kernel|f32_tile_kernel|splitk_reduce_kernel|general_kernel|wgmma_kernel)\b"


def read(ctx):
    per_batch = sum(count.matmul_bound_s(*mkn)
                    for mkn in count.head_matmuls(ctx.spec, ctx.traffic["batch"]))
    return readers.roofline(ctx, KERNELS, per_batch * len(ctx.traced))
