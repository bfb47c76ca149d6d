"""ms of the program's Inception-v3 forward on one batch of the cell,
captured alone as a CUDA graph and timed by CUDA events."""
from torch.func import functional_call

from benchmark import readers


def read(ctx):
    model = ctx.program["model"]
    scope = model.backbone_scope + "."
    tensors = {k[len(scope):]: v for coll in ctx.program["apply_vars"].values()
               for k, v in coll.items() if k.startswith(scope)}
    x = readers.model_input(ctx, 0)
    return readers.graph_ms(
        ctx, lambda: functional_call(model.backbone, tensors, (x,), {"train": False}))
