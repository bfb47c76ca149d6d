"""B4 (csrc/match.cu, greedy matching): its traced device time against the
least time matching needs on the traced steps' own ground truth: the IoU of
every live box, after the step's augmentation, with every prior."""
import numpy as np
import torch

from benchmark import count, readers
from benchmark.reference import train as ref_train

KERNELS = r"\bmatch_kernel\b"


def read(ctx):
    aug, seed = ctx.cell.config["train"], ctx.runner.seed
    bound = 0.0
    for i, index in enumerate(ctx.traced):
        batch = {k: torch.as_tensor(v, device=ctx.device) for k, v in ctx.runner.pool[index].items()}
        gen = torch.Generator(device=ctx.device).manual_seed(
            ref_train.step_seed(seed, ctx.runner.traced_from + i))
        with torch.no_grad():
            _, _, num = ref_train.augment(gen, batch["images"], batch["boxes"],
                                          batch["num_boxes"], aug, ctx.spec["input_size"])
        bound += count.match_bound_s(np.asarray(num.cpu()), ctx.traffic["max_boxes"],
                                     ctx.spec["num_priors"])
    return readers.roofline(ctx, KERNELS, bound)
