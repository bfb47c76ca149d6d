"""multibox-torch-priors — generate the prior boxes pickle.

Either k-means over the training set's ground-truth boxes, or SSD-style
multi-scale grid priors. The flags of the JAX package's
``multibox-priors``, plus ``--device`` (where k-means runs)."""

from __future__ import annotations

import argparse

import numpy as np

from multibox_tpu_torch import priors as priors_mod
from multibox_tpu_torch.cli.common import add_device_arg, expand_tfrecords, setup_logging
from multibox_tpu_torch.data.example_proto import parse_detection_example
from multibox_tpu_torch.data.tfrecord import read_records
from multibox_tpu_torch.device import resolve_device


def collect_gt_boxes(tfrecords) -> np.ndarray:
    boxes = []
    for rec in read_records(tfrecords):
        ex = parse_detection_example(rec)
        if len(ex["boxes"]):
            boxes.append(ex["boxes"])
    if not boxes:
        raise SystemExit("no ground-truth boxes found in tfrecords")
    return np.concatenate(boxes, axis=0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--output", required=True, help="priors pickle path")
    parser.add_argument("--mode", choices=["kmeans", "multiscale"],
                        default="kmeans")
    parser.add_argument("--tfrecords", nargs="+", default=None,
                        help="(kmeans) training tfrecords to cluster")
    parser.add_argument("--num_priors", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--feature_map_sizes", type=int, nargs="+",
                        default=[35, 17, 8],
                        help="(multiscale) grid sizes, e.g. 35 17 8")
    parser.add_argument("--aspect_ratios", type=float, nargs="+",
                        default=[1.0, 2.0, 0.5, 3.0, 1.0 / 3.0])
    add_device_arg(parser)
    args = parser.parse_args(argv)
    setup_logging()
    device = resolve_device(args.device)

    if args.mode == "kmeans":
        if not args.tfrecords:
            raise SystemExit("--tfrecords required for kmeans mode")
        gt = collect_gt_boxes(expand_tfrecords(args.tfrecords))
        priors = priors_mod.generate_priors_kmeans(
            gt, args.num_priors, seed=args.seed, device=device
        )
    else:
        priors = priors_mod.generate_priors_multiscale(
            args.feature_map_sizes, aspect_ratios=tuple(args.aspect_ratios)
        )
    priors_mod.save_priors(priors, args.output)
    print(f"wrote {priors.shape[0]} priors to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
