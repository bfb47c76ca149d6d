"""configs/coco_dp.yaml's paths against the JAX package on the CPU, at a
small size: 75 px, P = 32 priors, G = 8 boxes with one image full, the
configuration's 80 classes, Hungarian matching with dense matching at 0.5
and ``label_offset`` 1.

- One train step (Inception-v3, float64 backbone as in
  ``tests/test_torch_train.py``, whose docstring says why): loss and
  metrics rtol 1e-5, every parameter, running statistic and EMA shadow
  after it rtol 1e-5 and atol 1e-5, except ``Conv2d_2a_3x3``'s weight and
  its EMA shadow at atol 1e-4. The 80-class head's float32 backward sums
  over 2,560 outputs (the tiny single-class head's over 8) and the 75-px
  BatchNorms amplify its rounding into the first convolutions: measured
  3.6e-5 on 2 of that weight's 9,216 values (3.2e-5 in its shadow), 2.1e-5
  without dense matching and 1.1e-5 without hard negatives, so neither
  matching nor mining is the cause; every other tensor within 6.4e-6. The
  JAX step moves every leaf by more than its tolerance (the least, a
  running mean, by 1.2e-4), which the test asserts: a dropped update fails.
- The 80-class postprocess (the per-class sweep to ``detect_candidates``,
  NMS with class offsets up to class 79): counts, classes and the NMS's
  indices exact, boxes and scores atol 1e-6.
- A COCO instances file with COCO 2017's 80 gapped category ids through
  each package's dataset CLI (``--coco --remap_categories``), read back by
  each package's ``DetectionDataset(label_offset=1, num_classes=80)``:
  record files byte-identical, labels equal.
- A label outside [0, 80) after the offset raises in both packages.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from multibox_tpu import inference as jinference
from multibox_tpu.cli import dataset as jdataset_cli
from multibox_tpu.config import Config as JConfig
from multibox_tpu.config import parse_config_file as jparse
from multibox_tpu.data import pipeline as jpipeline
from multibox_tpu.models.detector import MultiBoxDetector as JDetector
from multibox_tpu.ops.nms import batched_nms as jbatched_nms
from multibox_tpu_torch import inference
from multibox_tpu_torch.cli import dataset as dataset_cli
from multibox_tpu_torch.config import Config, parse_config_file
from multibox_tpu_torch.data import pipeline
from multibox_tpu_torch.data.example_proto import build_detection_example
from multibox_tpu_torch.data.jpeg import encode_jpeg
from multibox_tpu_torch.data.tfrecord import TFRecordWriter
from multibox_tpu_torch.ops.nms import batched_nms
from tests.conftest import random_boxes
from tests.test_torch_mobilenet import jax_init, perturb, train_step_against_jax
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

# COCO 2017's 80 category ids: 1-90 with its gaps
COCO_IDS = (*range(1, 12), *range(13, 26), 27, 28, *range(31, 45), *range(46, 66), 67, 70,
            *range(72, 83), *range(84, 91))
SIZE, P, G, C = 75, 32, 8, 80


def coco_kw(**over):
    """configs/coco_dp.yaml as shipped, cut to the test's size."""
    cfg = parse_config_file("configs/coco_dp.yaml")
    assert (cfg.num_classes, cfg.matching, cfg.multi_match_iou, cfg.label_offset) == (
        C, "hungarian", 0.5, 1)
    assert dataclasses.asdict(jparse("configs/coco_dp.yaml")) == dataclasses.asdict(cfg)
    kw = dataclasses.asdict(cfg)
    kw.update(input_size=SIZE, num_priors=P, batch_size=2, max_num_bboxes=G,
              compute_dtype="float32", num_train_examples=2, initial_learning_rate=0.003)
    kw.update(over)
    return kw


def priors_from(rng):
    return np.sort(rng.uniform(0.05, 0.95, (P, 2, 2)).astype(np.float32),
                   axis=1).reshape(P, 4)


def test_coco_dp_train_step_matches_jax():
    """One update of the 80-class Inception-v3 detector with Hungarian and
    dense matching, image 0 holding all G boxes, labels up to class 79."""
    rng = np.random.default_rng(80)
    priors = priors_from(rng)
    init = perturb(jax_init(JDetector(num_priors=P, num_classes=C, compute_dtype=jnp.float32),
                            np.zeros((1, SIZE, SIZE, 3), np.float32)), rng)
    batch = {"images": rng.normal(0, 0.5, (2, SIZE, SIZE, 3)).astype(np.float32),
             "boxes": np.stack([random_boxes(rng, G, min_size=0.2) for _ in range(2)]),
             "num_boxes": np.array([G, 3], np.int32),
             "labels": rng.integers(0, C, (2, G)).astype(np.int32)}
    batch["labels"][0, 0] = C - 1
    wide = {"InceptionV3.Conv2d_2a_3x3.Conv.weight": 1e-4}
    m = train_step_against_jax(coco_kw(), {"num_classes": C}, init, priors, batch,
                               leaf_atol=wide, moved=True)
    # dense matching: more positives than the 11 gt boxes
    assert m["num_pos"] > 11 and m["num_bad_labels"] == 0


def test_coco_dp_postprocess_matches_jax():
    """The per-class sweep keeps min(detect_candidates, P·C) = 1,024 of the
    2,560 (prior, class) pairs, and one NMS pass suppresses within each
    class through coordinate offsets of up to 79 × 2."""
    rng = np.random.default_rng(81)
    priors = priors_from(rng)
    loc = rng.normal(0, 0.5, (2, P, 4)).astype(np.float32)
    conf = rng.normal(-2, 2, (2, P, C)).astype(np.float32)
    conf[:, :, C - 1] += 4.0  # the last class among the kept candidates
    kw = coco_kw(max_detections=100, detect_score_threshold=0.05)
    assert min(kw["detect_candidates"], P * C) == 1024
    want = jinference.postprocess(jnp.asarray(loc), jnp.asarray(conf), jnp.asarray(priors),
                                  JConfig(**kw))
    got = inference.postprocess(torch.from_numpy(loc), torch.from_numpy(conf),
                                torch.from_numpy(priors), Config(**kw))
    for key in ("num", "classes"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-6,
                                   err_msg=key)
    assert int(got["num"].min()) > 0 and int(got["classes"].max()) == C - 1

    # the NMS alone at the sweep's shape, classes 0..79: indices exact
    boxes = random_boxes(rng, (2, 1024))
    scores = rng.uniform(0, 1, (2, 1024)).astype(np.float32)
    classes = rng.integers(0, C, (2, 1024)).astype(np.int32)
    classes[:, :8] = C - 1
    jout = jbatched_nms(jnp.asarray(boxes), jnp.asarray(scores), 100, 0.5, 0.05,
                        class_ids=jnp.asarray(classes))
    tout = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 100, 0.5, 0.05,
                       class_ids=torch.from_numpy(classes))
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))


def coco_file(root, rng):
    """Four JPEGs and a COCO instances file: 1-9 boxes each with ids drawn
    from the 80, id 90 among them, one crowd region (skipped by both CLIs)."""
    (root / "images").mkdir()
    coco = {"images": [], "annotations": [],
            "categories": [{"id": c, "name": str(c)} for c in COCO_IDS]}
    for i in range(4):
        h, w = (48, 64) if i % 2 else (64, 48)
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        (root / "images" / f"im{i}.jpg").write_bytes(encode_jpeg(img))
        coco["images"].append({"id": i, "file_name": f"im{i}.jpg", "height": h, "width": w})
        for y0, x0, y1, x1 in random_boxes(rng, int(rng.integers(1, 10)), min_size=0.1):
            coco["annotations"].append({
                "image_id": i, "category_id": int(rng.choice(COCO_IDS)), "iscrowd": 0,
                "bbox": [float(x0) * w, float(y0) * h, float(x1 - x0) * w, float(y1 - y0) * h]})
    coco["annotations"][0]["category_id"] = 90
    coco["annotations"].append({"image_id": 1, "category_id": 1, "iscrowd": 1,
                                "bbox": [0.0, 0.0, 10.0, 10.0]})
    path = root / "coco.json"
    path.write_text(json.dumps(coco))
    return path


def read_labels(module, path, **kw):
    ds = module.DetectionDataset([str(path)], batch_size=2, canvas_size=SIZE,
                                 max_num_bboxes=G, **kw)
    return [(b["num_boxes"].copy(), b["labels"].copy()) for b in ds]


def test_coco_ids_through_the_dataset_cli_give_the_jax_packages_labels(tmp_path, capsys):
    coco = coco_file(tmp_path, np.random.default_rng(82))
    out = {}
    for name, cli in (("jax", jdataset_cli), ("torch", dataset_cli)):
        assert cli.main(["--annotations", str(coco), "--coco", "--remap_categories",
                         "--image_root", str(tmp_path / "images"),
                         "--output_prefix", str(tmp_path / name / "train")]) == 0
        out[name] = tmp_path / name / "train-00000-of-00001.tfrecord"
    assert out["torch"].read_bytes() == out["jax"].read_bytes()
    assert json.loads((tmp_path / "torch" / "label_map.json").read_text()) == {
        str(c): i + 1 for i, c in enumerate(COCO_IDS)}
    got = read_labels(pipeline, out["torch"], label_offset=1, num_classes=C)
    want = read_labels(jpipeline, out["jax"], label_offset=1, num_classes=C)
    assert len(got) == len(want) == 2
    for (gn, gl), (wn, wl) in zip(got, want):
        np.testing.assert_array_equal(gn, wn)
        np.testing.assert_array_equal(gl, wl)
    labels = np.concatenate([gl[i, :gn[i]] for gn, gl in got for i in range(len(gn))])
    assert labels.min() >= 0 and labels.max() == C - 1  # id 90 is class 79
    capsys.readouterr()


@pytest.mark.parametrize("raw_label", [0, 81], ids=["below", "above"])
def test_a_label_outside_the_classes_raises_in_both_packages(tmp_path, raw_label):
    """With label_offset 1 and 80 classes, a raw label of 0 (class -1) or
    81 (class 80) fails loudly on the host in both packages."""
    path = tmp_path / "bad.tfrecord"
    img = np.zeros((SIZE, SIZE, 3), np.uint8)
    with TFRecordWriter(str(path)) as w:
        w.write(build_detection_example(b"", "bad", np.array([[0.1, 0.1, 0.5, 0.5]], np.float32),
                                        labels=[raw_label], raw_canvas=img))
    for module in (pipeline, jpipeline):
        with pytest.raises(ValueError, match=r"outside \[0, 80\) after label_offset=1"):
            read_labels(module, path, label_offset=1, num_classes=C)
