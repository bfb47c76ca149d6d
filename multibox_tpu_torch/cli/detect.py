"""multibox-torch-detect — batched detection over tfrecords (or image
files) from a checkpoint.

Restores the latest checkpoint of a train logdir (the EMA shadows by
default), runs the detect pipeline batch by batch and writes
{image_id → boxes, scores, classes} to a pickle or JSON file: the format
of the JAX package's ``multibox-detect``, so either package's evaluator
reads the other's output. The flags of that CLI, plus ``--device`` and
``--dist_backend``. Under ``torchrun`` each rank detects its shard of the
records or image files, the results are gathered, and rank 0 writes.
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
from multibox_tpu_torch.device import resolve_device
from multibox_tpu_torch.parallel import mesh


def run_detection(cfg, tfrecords, priors, checkpoint_path,
                  score_threshold=None, dataset=None, device=None):
    """Detections of the latest checkpoint in ``checkpoint_path`` over
    ``tfrecords`` (or over ``dataset``, e.g. an ``ImageFileDataset``): a
    list of per-image dicts with the valid slots only (host numpy). The
    host loop is ``inference.run_detect_loop``. With ``cfg.quantize ==
    "int8"`` the EMA weights are folded, quantized and calibrated on this
    run's own first ``cfg.quant_calib_batches`` batches (the dataset is
    iterated again from the start for the detection; under a process group
    each rank calibrates on its own shard). Under a process group the
    default dataset is sharded over the ranks and every rank returns the
    whole gathered list (``inference.run_detect_loop``)."""
    from multibox_tpu_torch.data.pipeline import DetectionDataset
    from multibox_tpu_torch.inference import build_model, run_detect_loop
    from multibox_tpu_torch.train.state import create_train_state
    from multibox_tpu_torch.utils.checkpoint import CheckpointManager

    device = resolve_device(device)
    model = build_model(cfg, priors.shape[0], device=device)
    state = create_train_state(cfg, model, 0, priors.shape[0], device=device)
    state = CheckpointManager(checkpoint_path).restore(state, device=device)
    if dataset is None:
        dataset = DetectionDataset(
            tfrecords,
            batch_size=cfg.batch_size,
            canvas_size=cfg.input_size,
            max_num_bboxes=cfg.max_num_bboxes,
            shard_index=mesh.rank(),
            shard_count=mesh.world_size(),
        )
    variables = state.detect_variables()
    if cfg.quantize != "none":
        from multibox_tpu_torch.quantize import (
            calib_batches_from_dataset,
            prepare_quantized_variables,
        )

        variables = prepare_quantized_variables(
            cfg, variables, calib_batches_from_dataset(dataset, cfg.quant_calib_batches),
            device=device)
    return run_detect_loop(cfg, variables, dataset, priors,
                           score_threshold=score_threshold, device=device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--tfrecords", nargs="+", default=None)
    parser.add_argument("--images", nargs="+", default=None,
                        help="raw image files/globs (JPEG/PNG/...) instead "
                             "of tfrecords")
    parser.add_argument("--priors", required=True)
    parser.add_argument("--checkpoint_path", required=True,
                        help="logdir with checkpoints")
    parser.add_argument("--output", required=True, help=".pkl or .json output")
    parser.add_argument("--coco_json", default=None,
                        help="also write a COCO results-format JSON "
                             "(pixel [x,y,w,h]; needs image/height+width "
                             "features in the tfrecords)")
    parser.add_argument("--score_threshold", type=float, default=None)
    add_config_arg(parser)
    add_device_arg(parser)
    add_parallel_arg(parser)
    args = parser.parse_args(argv)
    setup_logging()
    init_parallel(args)
    device = resolve_device(args.device)

    if bool(args.tfrecords) == bool(args.images):
        raise SystemExit("need exactly one of --tfrecords / --images")
    cfg = load_config(args)
    priors = priors_mod.load_priors(args.priors)
    cfg.num_priors = priors.shape[0]

    image_dataset = None
    if args.images:
        import glob as globmod

        from multibox_tpu_torch.data.pipeline import ImageFileDataset

        paths = []
        for p in args.images:
            matched = sorted(globmod.glob(p))
            paths.extend(matched if matched else [p])
        # every rank globs the same sorted list and keeps its shard
        image_dataset = ImageFileDataset(
            paths, batch_size=cfg.batch_size, canvas_size=cfg.input_size,
            shard_index=mesh.rank(), shard_count=mesh.world_size())

    results = run_detection(
        cfg,
        expand_tfrecords(args.tfrecords) if args.tfrecords else None,
        priors, args.checkpoint_path, args.score_threshold,
        dataset=image_dataset, device=device,
    )
    if image_dataset is not None and mesh.world_size() > 1:
        # each rank recorded the source sizes of its own shard; --coco_json
        # needs all of them. A collective: every rank, before the write gate
        from multibox_tpu_torch.parallel import process_allgather_objects

        merged = {}
        for shard_sizes in process_allgather_objects(image_dataset.sizes):
            merged.update(shard_sizes)
        image_dataset.sizes = merged
    if mesh.rank() != 0:
        return 0  # every rank holds the whole list; rank 0 alone writes

    if args.output.endswith(".json"):
        payload = [
            {
                "image_id": r["image_id"],
                "boxes": np.asarray(r["boxes"]).tolist(),
                "scores": np.asarray(r["scores"]).tolist(),
                "classes": np.asarray(r["classes"]).tolist(),
            }
            for r in results
        ]
        with open(args.output, "w") as f:
            json.dump(payload, f)
    else:
        with open(args.output, "wb") as f:
            pickle.dump(results, f)
    print(f"wrote {len(results)} image results to {args.output}")

    if args.coco_json:
        from multibox_tpu_torch.evaluate import to_coco_results

        if image_dataset is not None:
            sizes = image_dataset.sizes  # recorded during iteration
        else:
            from multibox_tpu_torch.cli.evaluate import load_groundtruth

            _, sizes = load_groundtruth(
                expand_tfrecords(args.tfrecords), with_sizes=True
            )
        coco = to_coco_results(results, sizes, label_offset=cfg.label_offset)
        with open(args.coco_json, "w") as f:
            json.dump(coco, f)
        print(f"wrote {len(coco)} COCO-format detections to {args.coco_json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
