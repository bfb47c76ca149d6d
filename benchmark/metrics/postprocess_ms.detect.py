"""ms of the program's postprocess (decode, scores, B1, the packing) on the
cell's own head outputs, captured alone as a CUDA graph and timed by CUDA
events."""
from benchmark import readers


def read(ctx):
    from multibox_tpu_torch import inference

    p = ctx.program
    loc, conf = readers.head_outputs(ctx, 0)
    return readers.graph_ms(ctx, lambda: inference._pack_dets(
        inference.postprocess(loc, conf, p["priors"], p["cfg"])))
