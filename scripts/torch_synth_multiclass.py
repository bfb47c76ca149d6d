"""Synthetic multi-class detection dataset: 3 shape classes + occlusion.

Reproducible generator for the multi-class quality loop (BASELINE.md):
class 0 = warm squares, class 1 = green circles, class 2 = blue triangles,
1–4 objects per image with overlap allowed (boxes keep their full extent,
so partially occluded objects must still be localized). Images are written
as standard JPEG detection Examples PLUS a pre-decoded raw canvas
(``image/raw``) so training on a decode-bound host skips JPEG decode.

The port's copy of ``scripts/synth_multiclass.py``: the same flags and the
same generator, written with ``multibox_tpu_torch.data`` (tfrecord writer,
``build_detection_example``, PIL's JPEG encoder), so that for the same seed and counts
its shards are byte-identical to the JAX package's script's.

Usage:
  python scripts/torch_synth_multiclass.py \
      --output_dir OUT_DIR --train 1024 --val 128 --canvas 343
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multibox_tpu_torch.data.example_proto import build_detection_example  # noqa: E402
from multibox_tpu_torch.data.jpeg import encode_jpeg  # noqa: E402
from multibox_tpu_torch.data.tfrecord import TFRecordWriter  # noqa: E402

# Per-class base colors (RGB ranges): warm / green / blue.
_COLOR_RANGES = [
    ((180, 255), (30, 100), (30, 100)),
    ((30, 100), (160, 255), (30, 100)),
    ((30, 100), (30, 100), (160, 255)),
]


def _draw(img: np.ndarray, cls: int, box, rng) -> None:
    """Draw one object of class ``cls`` into ``img`` (uint8, HxWx3)."""
    H, W = img.shape[:2]
    y0, x0, y1, x1 = (np.array(box) * [H, W, H, W]).astype(int)
    y1, x1 = max(y1, y0 + 2), max(x1, x0 + 2)
    color = np.array(
        [rng.integers(lo, hi) for lo, hi in _COLOR_RANGES[cls]], np.uint8
    )
    yy, xx = np.mgrid[y0:y1, x0:x1]
    if cls == 0:  # square
        mask = np.ones_like(yy, bool)
    elif cls == 1:  # circle (ellipse inscribed in the box)
        cy, cx = (y0 + y1) / 2, (x0 + x1) / 2
        ry, rx = max((y1 - y0) / 2, 1), max((x1 - x0) / 2, 1)
        mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    else:  # upright triangle: apex mid-top, base at the bottom
        h = max(y1 - y0, 1)
        frac = (yy - y0) / h  # 0 at top → 1 at bottom
        cx = (x0 + x1) / 2
        half = (x1 - x0) / 2
        mask = np.abs(xx - cx) <= frac * half
    img[y0:y1, x0:x1][mask] = color


def _class_table(num_classes: int):
    """Extended class space for the many-class stress configs: class =
    (shape, hue) pair — 4 shapes × ⌈C/4⌉ evenly spaced hues. Only used
    when ``num_classes != 3``; the 3-class pinned protocol keeps the
    legacy color table above bit-exactly."""
    import colorsys

    n_hues = (num_classes + 3) // 4
    table = []
    for c in range(num_classes):
        shape = c % 4
        hue = (c // 4) / n_hues
        r, g, b = colorsys.hsv_to_rgb(hue, 0.85, 0.9)
        table.append((shape, (int(r * 255), int(g * 255), int(b * 255))))
    return table


def _draw_extended(img, shape: int, color, box, rng) -> None:
    H, W = img.shape[:2]
    y0, x0, y1, x1 = (np.array(box) * [H, W, H, W]).astype(int)
    y1, x1 = max(y1, y0 + 2), max(x1, x0 + 2)
    jitter = rng.integers(-20, 21, 3)
    col = np.clip(np.array(color, int) + jitter, 0, 255).astype(np.uint8)
    yy, xx = np.mgrid[y0:y1, x0:x1]
    cy, cx = (y0 + y1) / 2, (x0 + x1) / 2
    ry, rx = max((y1 - y0) / 2, 1), max((x1 - x0) / 2, 1)
    if shape == 0:  # square
        mask = np.ones_like(yy, bool)
    elif shape == 1:  # ellipse
        mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    elif shape == 2:  # upright triangle
        frac = (yy - y0) / max(y1 - y0, 1)
        mask = np.abs(xx - cx) <= frac * ((x1 - x0) / 2)
    else:  # diamond
        mask = np.abs((yy - cy) / ry) + np.abs((xx - cx) / rx) <= 1.0
    img[y0:y1, x0:x1][mask] = col


def make_image(rng, canvas: int, num_classes: int = 3):
    img = rng.integers(20, 60, (canvas, canvas, 3)).astype(np.uint8)
    n = int(rng.integers(1, 5))
    boxes, labels = [], []
    table = None if num_classes == 3 else _class_table(num_classes)
    for _ in range(n):
        cls = int(rng.integers(0, num_classes))
        h, w = rng.uniform(0.15, 0.45, 2)
        y0 = rng.uniform(0.02, 0.96 - h)
        x0 = rng.uniform(0.02, 0.96 - w)
        box = (y0, x0, y0 + h, x0 + w)
        if table is None:  # legacy 3-class path (pinned protocol)
            _draw(img, cls, box, rng)
        else:
            shape, color = table[cls]
            _draw_extended(img, shape, color, box, rng)
        boxes.append(box)
        labels.append(cls)
    return img, np.array(boxes, np.float32), labels


def write_split(path: str, n: int, canvas: int, rng, prefix: str,
                num_classes: int = 3, label_base: int = 0) -> None:
    with TFRecordWriter(path) as w:
        for i in range(n):
            img, boxes, labels = make_image(rng, canvas, num_classes)
            labels = [lab + label_base for lab in labels]
            w.write(
                build_detection_example(
                    encode_jpeg(img, quality=90),
                    f"{prefix}-{i}",
                    boxes,
                    labels=labels,
                    height=canvas,
                    width=canvas,
                    raw_canvas=img,
                )
            )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--train", type=int, default=1024)
    p.add_argument("--val", type=int, default=128)
    p.add_argument("--canvas", type=int, default=343)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_classes", type=int, default=3,
                   help="3 = legacy pinned classes; otherwise a "
                        "(shape x hue) stress class space")
    p.add_argument("--label_base", type=int, default=0,
                   help="added to every written label: 1 emits COCO-style "
                        "1-based category ids so a config with "
                        "label_offset: 1 (e.g. coco_dp.yaml) runs as "
                        "shipped")
    args = p.parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    write_split(
        os.path.join(args.output_dir, "train.tfrecord"),
        args.train, args.canvas, rng, "tr", args.num_classes,
        args.label_base,
    )
    write_split(
        os.path.join(args.output_dir, "val.tfrecord"),
        args.val, args.canvas, rng, "va", args.num_classes,
        args.label_base,
    )
    print(f"wrote {args.train} train + {args.val} val to {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
