"""ms of the program's MultiBox loss with its matching (B4, B3b) on fixed
head outputs and ground truth of the cell's shape, captured alone as a
CUDA graph and timed by CUDA events (the forward of the loss)."""
import torch

from benchmark import readers


def read(ctx):
    from multibox_tpu_torch.train.loss import multibox_loss

    cfg, priors = ctx.program["cfg"], ctx.program["priors"]
    loc, conf = readers.head_outputs(ctx, 0)
    batch = ctx.runner.pool[0]
    boxes = torch.as_tensor(batch["boxes"], device=ctx.device)
    num = torch.as_tensor(batch["num_boxes"], device=ctx.device)
    return readers.graph_ms(ctx, lambda: multibox_loss(
        loc, conf, boxes, num, priors, alpha=cfg.location_loss_alpha, matching=cfg.matching,
        hybrid_conf_weight=cfg.hybrid_conf_weight, hard_negative_ratio=cfg.hard_negative_ratio,
        multi_match_iou=cfg.multi_match_iou, encode=cfg.box_encoding, use_pallas=cfg.use_pallas,
        conf_loss=cfg.conf_loss, focal_gamma=cfg.focal_gamma, focal_alpha=cfg.focal_alpha)[0])
