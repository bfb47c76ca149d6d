"""``multibox-torch-dataset`` against the JAX package's ``multibox-dataset``
on the CPU: the same images and annotations through both CLIs' ``main``
must write byte-identical record files (JSON and COCO annotations, crowd
regions, category remapping, shards, pre-decoded canvases), the same
``label_map.json`` and the same refusals. Host code only.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from multibox_tpu.cli import dataset as jcli
from multibox_tpu_torch.cli import dataset as tcli
from multibox_tpu_torch.data.example_proto import parse_detection_example
from multibox_tpu_torch.data.tfrecord import read_records
from tests.conftest import random_boxes


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Six JPEG files of VOC-like aspect at small sizes, with JSON and COCO
    annotations of 0-4 boxes each (one crowd region, category ids 3 / 7 /
    11, as COCO's are not contiguous)."""
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    items, coco = [], {"images": [], "annotations": [],
                       "categories": [{"id": c} for c in (3, 7, 11)]}
    for i in range(6):
        h, w = (37, 50) if i % 2 else (50, 37)
        Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)).save(
            root / f"im{i}.jpg", quality=90)
        boxes = random_boxes(rng, int(rng.integers(0, 5)))
        labels = [int(c) for c in rng.choice([3, 7, 11], len(boxes))]
        items.append({"image": f"im{i}.jpg", "id": f"img-{i}", "boxes": boxes.tolist(),
                      "labels": labels})
        coco["images"].append({"id": 100 + i, "file_name": f"im{i}.jpg", "height": h,
                               "width": w})
        for (y0, x0, y1, x1), c in zip(boxes, labels):
            coco["annotations"].append({
                "image_id": 100 + i, "category_id": c, "iscrowd": 0,
                "bbox": [float(x0 * w), float(y0 * h), float((x1 - x0) * w),
                         float((y1 - y0) * h)]})
    coco["annotations"][0]["iscrowd"] = 1
    (root / "items.json").write_text(json.dumps(items))
    (root / "coco.json").write_text(json.dumps(coco))
    return root, items, coco


def run_both(root, tmp_path, args):
    out = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        prefix = tmp_path / name / "train"
        assert cli.main(["--image_root", str(root), "--output_prefix", str(prefix)] + args) == 0
        out[name] = {f: (tmp_path / name / f).read_bytes()
                     for f in sorted(os.listdir(tmp_path / name))}
    return out


@pytest.mark.parametrize("args", [
    ["--annotations", "items.json"],
    ["--annotations", "items.json", "--num_shards", "2"],
    ["--annotations", "items.json", "--num_shards", "2", "--store_raw_canvas", "33"],
    ["--annotations", "coco.json", "--coco"],
    ["--annotations", "coco.json", "--coco", "--keep_crowd", "--num_shards", "3"],
    ["--annotations", "coco.json", "--coco", "--remap_categories", "--num_shards", "2",
     "--store_raw_canvas", "20"],
], ids=["json", "json_shards", "json_raw_canvas", "coco", "coco_keep_crowd_shards",
        "coco_remap_raw_canvas"])
def test_dataset_cli_writes_the_jax_clis_files(images, tmp_path, args):
    root = images[0]
    args = [a if not a.endswith(".json") else str(root / a) for a in args]
    out = run_both(root, tmp_path, args)
    assert list(out["torch"]) == list(out["jax"])
    for name in out["jax"]:
        assert out["torch"][name] == out["jax"][name], name
    shards = int(args[args.index("--num_shards") + 1]) if "--num_shards" in args else 1
    assert sum(f.endswith(".tfrecord") for f in out["torch"]) == shards
    assert ("label_map.json" in out["torch"]) == ("--remap_categories" in args)


def test_records_parse_back_to_their_annotations(images, tmp_path):
    root, items, _ = images
    assert tcli.main(["--annotations", str(root / "items.json"), "--image_root", str(root),
                      "--output_prefix", str(tmp_path / "t"), "--num_shards", "2",
                      "--store_raw_canvas", "24"]) == 0
    paths = sorted(str(tmp_path / f) for f in os.listdir(tmp_path))
    parsed = {}
    for rec in read_records(paths):
        ex = parse_detection_example(rec)
        parsed[ex["image_id"]] = ex
    assert sorted(parsed) == sorted(it["id"] for it in items)
    for it in items:
        ex = parsed[it["id"]]
        np.testing.assert_array_equal(ex["boxes"], np.asarray(it["boxes"], np.float32)
                                      .reshape(-1, 4))
        assert list(ex["labels"]) == it["labels"]
        assert ex["image_bytes"] == (root / it["image"]).read_bytes()
        assert ex["raw"].shape == (24, 24, 3)


def test_coco_to_items_matches(images):
    coco = images[2]
    for kw in ({}, {"skip_crowd": False}, {"remap_categories": True}):
        assert tcli.coco_to_items(coco, **kw) == jcli.coco_to_items(coco, **kw)
    items, label_map = tcli.coco_to_items(coco, remap_categories=True)
    assert label_map == {3: 1, 7: 2, 11: 3}
    assert sum(len(it["boxes"]) for it in items) == len(coco["annotations"]) - 1  # a crowd


@pytest.mark.parametrize("fault", ["box_outside", "stale_size"])
def test_dataset_cli_refuses_as_the_jax_cli_does(images, tmp_path, fault):
    root, items, coco = images
    if fault == "box_outside":
        bad = [dict(items[0], boxes=[[0.1, 0.1, 1.2, 0.5]])]
        args = []
    else:
        bad = dict(coco, images=[dict(coco["images"][0], height=99)])
        args = ["--coco"]
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    messages = []
    for name, cli in (("jax", jcli), ("torch", tcli)):
        with pytest.raises(SystemExit) as e:
            cli.main(["--annotations", str(tmp_path / "bad.json"), "--image_root", str(root),
                      "--output_prefix", str(tmp_path / name / "x")] + args)
        messages.append(str(e.value))
    assert messages[0] == messages[1] and messages[0]
