"""multibox-torch-visualize — render predicted boxes on validation images.

The port's counterpart of the JAX package's ``multibox-visualize``: runs
detection from a checkpoint over tfrecords (``cli.detect.run_detection``)
and draws the predictions above a score threshold (green = ground truth,
red = prediction and score). Headless PNG output. The flags of that CLI,
plus ``--device``.
"""

from __future__ import annotations

import argparse
import os

from multibox_tpu_torch import priors as priors_mod
from multibox_tpu_torch.cli.common import (
    add_config_arg,
    add_device_arg,
    expand_tfrecords,
    load_config,
    setup_logging,
)
from multibox_tpu_torch.cli.visualize_inputs import draw_boxes
from multibox_tpu_torch.data.example_proto import parse_detection_example
from multibox_tpu_torch.data.jpeg import decode_jpeg
from multibox_tpu_torch.data.tfrecord import read_records
from multibox_tpu_torch.device import resolve_device


def main(argv=None) -> int:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--tfrecords", nargs="+", required=True)
    parser.add_argument("--priors", required=True)
    parser.add_argument("--checkpoint_path", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--score_threshold", type=float, default=0.3)
    parser.add_argument("--max_images", type=int, default=16)
    parser.add_argument("--class_names", default=None,
                        help="JSON mapping MODEL class ids (what detections "
                             "carry, 0-based after label_offset) to display "
                             "names: {\"0\": \"cat\", ...} or a list indexed "
                             "by class id")
    add_config_arg(parser)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    setup_logging()
    device = resolve_device(args.device)

    names = {}
    if args.class_names:
        import json

        with open(args.class_names) as f:
            raw = json.load(f)
        if isinstance(raw, list):
            names = {i: str(n) for i, n in enumerate(raw)}
        else:
            names = {int(k): str(v) for k, v in raw.items()}

    cfg = load_config(args)
    priors = priors_mod.load_priors(args.priors)
    cfg.num_priors = priors.shape[0]

    from multibox_tpu_torch.cli.detect import run_detection

    tfrecords = expand_tfrecords(args.tfrecords)
    results = run_detection(cfg, tfrecords, priors, args.checkpoint_path,
                            args.score_threshold, device=device)
    by_id = {r["image_id"]: r for r in results}

    os.makedirs(args.output_dir, exist_ok=True)
    count = 0
    for rec in read_records(tfrecords):
        if count >= args.max_images:
            break
        ex = parse_detection_example(rec)
        det = by_id.get(ex["image_id"])
        if det is None:
            continue
        img = decode_jpeg(ex["image_bytes"])
        fig, ax = plt.subplots(figsize=(5, 5))
        ax.imshow(img, extent=[0, 1, 1, 0])
        draw_boxes(ax, ex["boxes"], "lime")
        draw_boxes(
            ax, det["boxes"], "red",
            labels=[
                (f"{names[int(c)]} {s:.2f}" if int(c) in names else f"{s:.2f}")
                for s, c in zip(det["scores"], det["classes"])
            ],
        )
        ax.set_xlim(0, 1)
        ax.set_ylim(1, 0)
        ax.set_title(ex["image_id"], fontsize=8)
        out = os.path.join(args.output_dir, f"pred_{count:04d}.png")
        fig.savefig(out, dpi=120, bbox_inches="tight")
        plt.close(fig)
        count += 1
    print(f"wrote {count} visualizations to {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
