"""multibox-torch-visualize-inputs — render the augmented training inputs.

The port's counterpart of the JAX package's ``multibox-visualize-inputs``:
runs the train-time input pipeline (``data.pipeline.DetectionDataset`` on
the host, ``data.augment`` on the device) and draws the images with their
transformed ground-truth boxes (and, with ``--priors``, the priors greedy
matching assigns them) to PNG files: the debugging tool for the
augmentation. Headless (matplotlib's Agg backend). The flags of that CLI,
plus ``--device``; batch ``b`` is augmented from a generator seeded with
``(--seed, b)``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from multibox_tpu_torch import priors as priors_mod
from multibox_tpu_torch.cli.common import (
    add_config_arg,
    add_device_arg,
    expand_tfrecords,
    load_config,
    setup_logging,
)


def draw_boxes(ax, boxes, color, labels=None):
    import matplotlib.patches as patches

    for i, (y0, x0, y1, x1) in enumerate(np.asarray(boxes)):
        ax.add_patch(
            patches.Rectangle(
                (x0, y0), x1 - x0, y1 - y0,
                linewidth=1.5, edgecolor=color, facecolor="none",
            )
        )
        if labels is not None:
            ax.text(x0, y0 - 0.01, str(labels[i]), color=color, fontsize=7)


def main(argv=None) -> int:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch

    from multibox_tpu_torch.data import augment as augment_mod
    from multibox_tpu_torch.data.pipeline import DetectionDataset
    from multibox_tpu_torch.device import resolve_device
    from multibox_tpu_torch.ops import matching as matching_ops
    from multibox_tpu_torch.train.loop import step_generator

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--tfrecords", nargs="+", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--num_batches", type=int, default=1)
    parser.add_argument("--priors", default=None,
                        help="optionally draw the matched priors too")
    parser.add_argument("--seed", type=int, default=0)
    add_config_arg(parser)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    setup_logging()
    device = resolve_device(args.device)

    cfg = load_config(args)
    os.makedirs(args.output_dir, exist_ok=True)

    priors = None
    if args.priors:
        priors = torch.as_tensor(priors_mod.load_priors(args.priors), device=device)

    canvas = max(int(cfg.input_size * 1.15), cfg.input_size)
    dataset = DetectionDataset(
        expand_tfrecords(args.tfrecords),
        batch_size=cfg.batch_size,
        canvas_size=canvas,
        max_num_bboxes=cfg.max_num_bboxes,
        shuffle=True,
        seed=args.seed,
    )
    count = 0
    for b_idx, batch in enumerate(dataset):
        if b_idx >= args.num_batches:
            break
        images, boxes, num_boxes = augment_mod.augment_batch(
            step_generator(args.seed, b_idx, device),
            torch.as_tensor(batch["images"], device=device),
            torch.as_tensor(batch["boxes"], device=device),
            torch.as_tensor(batch["num_boxes"], device=device),
            cfg,
        )

        matched = None
        if priors is not None:
            assignment = matching_ops.match_priors(boxes, num_boxes, priors)[0]
            matched = assignment.cpu().numpy()
        images = ((images + 1.0) / 2.0).cpu().numpy()
        boxes = boxes.cpu().numpy()
        num_boxes = num_boxes.cpu().numpy()

        for i in range(int(batch["batch_valid"])):
            fig, ax = plt.subplots(figsize=(5, 5))
            # normalized coords: draw in [0,1] space over the image extent
            ax.imshow(images[i], extent=[0, 1, 1, 0])
            n = int(num_boxes[i])
            draw_boxes(ax, boxes[i, :n], "lime")
            if matched is not None and n:
                idx = matched[i, :n]
                draw_boxes(ax, priors.cpu().numpy()[idx[idx >= 0]], "red")
            ax.set_xlim(0, 1)
            ax.set_ylim(1, 0)
            ax.set_title(f"{batch['image_ids'][i]} ({n} boxes)", fontsize=8)
            out = os.path.join(args.output_dir, f"input_{count:04d}.png")
            fig.savefig(out, dpi=120, bbox_inches="tight")
            plt.close(fig)
            count += 1
    print(f"wrote {count} visualizations to {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
