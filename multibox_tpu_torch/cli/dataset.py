"""multibox-torch-dataset — build detection tfrecords from images + annotations.

The port's counterpart of the JAX package's ``multibox-dataset``, host code
only: the same flags and the same record files byte for byte (the same
Example encoding, PIL's decode and canvas resize). Input: a JSON
annotation file

    [{"image": "path/to.jpg", "id": "img-1",
      "boxes": [[ymin, xmin, ymax, xmax], ...],   # normalized [0,1]
      "labels": [1, ...]}, ...]

Output: sharded tfrecords with the standard ``image/encoded`` +
``image/object/bbox/*`` schema, readable by this framework AND by TF.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from multibox_tpu_torch.cli.common import setup_logging
from multibox_tpu_torch.data.example_proto import build_detection_example
from multibox_tpu_torch.data.jpeg import decode_jpeg
from multibox_tpu_torch.data.tfrecord import TFRecordWriter


def coco_to_items(coco: dict, skip_crowd: bool = True,
                  remap_categories: bool = False):
    """Convert a COCO instances dict to the builder's item list.

    COCO: ``images`` [{id, file_name, height, width}], ``annotations``
    [{image_id, category_id, bbox [x, y, w, h] in pixels, iscrowd}].
    Pixel xywh becomes normalized (ymin, xmin, ymax, xmax) via each
    image's recorded height/width, clipped to [0, 1] (COCO boxes may
    overhang the frame slightly). Crowd regions are skipped by default
    (the usual training protocol; this builder has no ignore-region
    channel).

    Labels: by default the raw ``category_id`` (typically 1-based —
    train/eval with ``label_offset: 1``). Real COCO ids are
    NON-CONTIGUOUS (2017 instances span 1..90 for 80 classes), which
    would force dead confidence channels; ``remap_categories=True``
    renumbers the ids present in ``categories`` (or, failing that, in the
    annotations) to contiguous 1..C in sorted order, so ``label_offset:
    1`` + ``num_classes: C`` just work. Returns ``(items, label_map)``
    where label_map is {original_id: remapped_id} (identity when not
    remapping).

    Each item also carries the JSON-declared ``height``/``width`` so the
    builder can cross-check them against the actually-decoded image —
    stale metadata (e.g. locally downscaled images with the original
    JSON) would otherwise silently normalize every box by the wrong
    denominator.
    """
    cat_ids = sorted(
        {int(c["id"]) for c in coco.get("categories", [])}
        or {int(a["category_id"]) for a in coco.get("annotations", [])}
    )
    if remap_categories:
        label_map = {c: i + 1 for i, c in enumerate(cat_ids)}
    else:
        label_map = {c: c for c in cat_ids}
    by_image = {}
    for ann in coco.get("annotations", []):
        if skip_crowd and ann.get("iscrowd"):
            continue
        by_image.setdefault(ann["image_id"], []).append(ann)
    items = []
    for img in coco["images"]:
        h, w = float(img["height"]), float(img["width"])
        boxes, labels = [], []
        for ann in by_image.get(img["id"], []):
            x, y, bw, bh = ann["bbox"]
            boxes.append([
                min(max(y / h, 0.0), 1.0),
                min(max(x / w, 0.0), 1.0),
                min(max((y + bh) / h, 0.0), 1.0),
                min(max((x + bw) / w, 0.0), 1.0),
            ])
            labels.append(label_map[int(ann["category_id"])])
        items.append({
            "image": img["file_name"],
            "id": str(img["id"]),
            "boxes": boxes,
            "labels": labels,
            "height": int(img["height"]),
            "width": int(img["width"]),
        })
    return items, label_map


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--annotations", required=True, help="JSON annotations")
    parser.add_argument("--coco", action="store_true",
                        help="annotations file is COCO instances format "
                             "(pixel xywh bboxes, category_id labels)")
    parser.add_argument("--keep_crowd", action="store_true",
                        help="with --coco: keep iscrowd annotations as "
                             "ordinary boxes instead of skipping them")
    parser.add_argument("--remap_categories", action="store_true",
                        help="with --coco: renumber non-contiguous COCO "
                             "category_ids to contiguous 1..C (mapping "
                             "written to label_map.json next to the "
                             "shards) so label_offset: 1 + num_classes: C "
                             "just work")
    parser.add_argument("--image_root", default=".", help="base dir for image paths")
    parser.add_argument("--output_prefix", required=True,
                        help="e.g. /data/train -> /data/train-00000-of-00002.tfrecord")
    parser.add_argument("--num_shards", type=int, default=1)
    parser.add_argument(
        "--store_raw_canvas", type=int, default=0, metavar="SIZE",
        help="also store a pre-decoded SIZE×SIZE uint8 canvas per example "
             "(image/raw): the input pipeline then skips host JPEG decode — "
             "the right trade on decode-bound hosts (larger shards, "
             "~SIZE²·3 bytes/example)",
    )
    args = parser.parse_args(argv)
    setup_logging()

    with open(args.annotations) as f:
        items = json.load(f)
    if args.coco:
        items, label_map = coco_to_items(
            items, skip_crowd=not args.keep_crowd,
            remap_categories=args.remap_categories,
        )
        if args.remap_categories:
            map_path = os.path.join(
                os.path.dirname(os.path.abspath(args.output_prefix)),
                "label_map.json",
            )
            os.makedirs(os.path.dirname(map_path), exist_ok=True)
            with open(map_path, "w") as f:
                json.dump(
                    {str(k): v for k, v in label_map.items()}, f, indent=1
                )
            print(f"wrote category remap to {map_path}")

    os.makedirs(os.path.dirname(os.path.abspath(args.output_prefix)), exist_ok=True)
    writers = [
        TFRecordWriter(
            f"{args.output_prefix}-{i:05d}-of-{args.num_shards:05d}.tfrecord"
        )
        for i in range(args.num_shards)
    ]
    written = 0
    for idx, item in enumerate(items):
        path = os.path.join(args.image_root, item["image"])
        with open(path, "rb") as f:
            image_bytes = f.read()
        # Validate the JPEG decodes; record true dimensions.
        img = decode_jpeg(image_bytes)
        # Annotations normalized against DECLARED dimensions (the COCO
        # path) are only correct if the file on disk actually has them —
        # stale metadata (e.g. locally resized images with the original
        # JSON) would silently skew every box.
        if "height" in item and (
            img.shape[0] != int(item["height"])
            or img.shape[1] != int(item["width"])
        ):
            raise SystemExit(
                f"{item.get('id', path)}: annotation declares "
                f"{item['height']}x{item['width']} but {path} decodes to "
                f"{img.shape[0]}x{img.shape[1]} — normalized boxes would "
                "be wrong; fix the images or the annotations"
            )
        boxes = np.asarray(item.get("boxes", []), np.float32).reshape(-1, 4)
        if len(boxes) and (boxes.min() < 0 or boxes.max() > 1.0):
            raise SystemExit(
                f"{item.get('id', path)}: boxes must be normalized to [0,1]"
            )
        raw_canvas = None
        if args.store_raw_canvas:
            raw_canvas = decode_jpeg(image_bytes, canvas=args.store_raw_canvas)
        writers[idx % args.num_shards].write(
            build_detection_example(
                image_bytes,
                str(item.get("id", os.path.basename(path))),
                boxes,
                labels=item.get("labels"),
                height=img.shape[0],
                width=img.shape[1],
                raw_canvas=raw_canvas,
            )
        )
        written += 1
    for w in writers:
        w.close()
    print(f"wrote {written} examples into {args.num_shards} shard(s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
