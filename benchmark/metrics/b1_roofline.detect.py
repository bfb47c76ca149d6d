"""B1 (csrc/nms.cu, NMS + top-k): its traced device time against the least
time greedy NMS needs on the traced batches' own boxes and scores (every
score, the boxes reached, the outputs; the IoU tests the output needs)."""
import torch

from benchmark import count, readers

KERNELS = r"\bnms_(full|window)_kernel\b"


def read(ctx):
    from multibox_tpu_torch import inference

    cfg, priors = ctx.program["cfg"], ctx.program["priors"]
    bound = 0.0
    for index in ctx.traced:
        loc, conf = readers.head_outputs(ctx, index)
        with torch.no_grad():
            boxes = inference.decode_candidates(loc, priors, cfg)
        bound += count.nms_bound_s(boxes.float().cpu().numpy(),
                                   torch.sigmoid(conf).float().cpu().numpy(),
                                   cfg.max_detections, cfg.nms_iou_threshold,
                                   cfg.detect_score_threshold)
    return readers.roofline(ctx, KERNELS, bound)
