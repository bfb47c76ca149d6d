"""multibox-torch-eval — score detections against tfrecord ground truth.

Reports AP@0.5, AP@0.75, COCO mAP@[.5:.95] and recall (per class and by
object size on request). Takes a detections file from either package's
detect CLI, or a checkpoint to run detection inline. The flags of the JAX
package's ``multibox-eval``, plus ``--device`` and ``--dist_backend``: under
``torchrun`` the inline detection is sharded over the ranks and gathered,
and rank 0 prints.
"""

from __future__ import annotations

import argparse
import json
import pickle

import numpy as np

from multibox_tpu_torch import priors as priors_mod
from multibox_tpu_torch.cli.common import (
    add_config_arg,
    add_device_arg,
    add_parallel_arg,
    expand_tfrecords,
    init_parallel,
    load_config,
    setup_logging,
)
from multibox_tpu_torch.data.example_proto import parse_detection_example
from multibox_tpu_torch.data.tfrecord import read_records
from multibox_tpu_torch.device import resolve_device
from multibox_tpu_torch.evaluate import evaluate_detections
from multibox_tpu_torch.parallel import mesh


def load_groundtruth(tfrecords, with_labels: bool = False,
                     label_offset: int = 0, with_sizes: bool = False):
    """image_id → gt boxes (and labels / pixel sizes). ``label_offset`` is
    subtracted from raw labels so they align with model class ids.
    ``with_sizes`` also returns image_id → (height, width) from the
    image/height+width features; images without them are left out."""
    gt = {}
    labels = {}
    sizes = {}
    for rec in read_records(tfrecords):
        ex = parse_detection_example(rec)
        gt[ex["image_id"]] = np.asarray(ex["boxes"], np.float64)
        labels[ex["image_id"]] = np.asarray(ex["labels"], np.int64) - label_offset
        if "height" in ex:
            sizes[ex["image_id"]] = (ex["height"], ex["width"])
    out = [gt]
    if with_labels:
        out.append(labels)
    if with_sizes:
        out.append(sizes)
    return tuple(out) if len(out) > 1 else gt


def evaluate(results, tfrecords, cfg, per_class: bool = False,
             by_size: bool = False):
    """The metrics ``main`` prints, as a dict."""
    # one pass over the tfrecords serves every protocol
    gt, gt_labels, sizes = load_groundtruth(
        tfrecords, with_labels=True, with_sizes=True,
        label_offset=cfg.label_offset,
    )
    if per_class:
        from multibox_tpu_torch.evaluate import evaluate_detections_per_class

        metrics = evaluate_detections_per_class(results, gt, gt_labels)
    else:
        metrics = evaluate_detections(results, gt)
    if by_size:
        from multibox_tpu_torch.evaluate import evaluate_detections_by_size

        metrics.update(
            evaluate_detections_by_size(
                results, gt, sizes,
                groundtruth_labels=gt_labels if per_class else None,
            )
        )
    return metrics


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--tfrecords", nargs="+", required=True,
                        help="eval tfrecords (ground truth)")
    parser.add_argument("--detections", default=None,
                        help="detections .pkl/.json from a detect CLI")
    parser.add_argument("--checkpoint_path", default=None,
                        help="or: run detection inline from this checkpoint")
    parser.add_argument("--priors", default=None)
    parser.add_argument("--per_class", action="store_true",
                        help="multi-class protocol: AP per class, averaged")
    parser.add_argument("--by_size", action="store_true",
                        help="COCO size-stratified AP (small/medium/large "
                             "bands in source pixels; needs image/height + "
                             "image/width features)")
    add_config_arg(parser)
    add_device_arg(parser)
    add_parallel_arg(parser)
    args = parser.parse_args(argv)
    setup_logging()
    init_parallel(args)
    device = resolve_device(args.device)

    tfrecords = expand_tfrecords(args.tfrecords)
    cfg = load_config(args)
    if args.detections:
        if args.detections.endswith(".json"):
            with open(args.detections) as f:
                results = json.load(f)
        else:
            with open(args.detections, "rb") as f:
                results = pickle.load(f)
    else:
        if not (args.checkpoint_path and args.priors):
            raise SystemExit("need --detections or (--checkpoint_path and --priors)")
        from multibox_tpu_torch.cli.detect import run_detection

        priors = priors_mod.load_priors(args.priors)
        cfg.num_priors = priors.shape[0]
        results = run_detection(cfg, tfrecords, priors, args.checkpoint_path,
                                device=device)

    metrics = evaluate(results, tfrecords, cfg, args.per_class, args.by_size)
    if mesh.rank() != 0:
        return 0
    for k, v in metrics.items():
        print(f"{k}: {v:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
