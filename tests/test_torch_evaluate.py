"""multibox_tpu_torch.evaluate against the JAX package's evaluate.py on
random detections: host numpy in float64 on both sides, the same
operations in the same order, so every number is exactly equal.
"""

import numpy as np
import pytest

from multibox_tpu import evaluate as jev
from multibox_tpu_torch import evaluate as tev
from tests.conftest import random_boxes


def world(seed, num_images=12, classes=3):
    """Detections near the gt (some hits at every IoU threshold), extra
    false positives, images with no gt or no detections, pixel sizes for
    most images, class labels."""
    rng = np.random.default_rng(seed)
    dets, gt, labels, sizes = [], {}, {}, {}
    for i in range(num_images):
        image_id = f"im{i}"
        n = int(rng.integers(0, 5)) if i else 0
        g = random_boxes(rng, n).astype(np.float64)
        gt[image_id] = g
        labels[image_id] = rng.integers(0, classes, n)
        if i % 4 != 3:
            sizes[image_id] = (int(rng.integers(50, 900)), int(rng.integers(50, 900)))
        if i == 5:
            continue  # an image without a detections entry
        jitter = g + rng.normal(0, 0.03, g.shape)
        extra = random_boxes(rng, int(rng.integers(0, 4)))
        boxes = np.clip(np.concatenate([jitter, extra]), 0, 1).astype(np.float32)
        scores = rng.uniform(0, 1, len(boxes)).astype(np.float32)
        scores[:2] = scores[:1].max(initial=0.5)  # equal scores: the sort's tie order
        cls = np.concatenate([labels[image_id], rng.integers(0, classes, len(extra))])
        dets.append({"image_id": image_id, "boxes": boxes, "scores": scores,
                     "classes": cls.astype(np.int32)})
    return dets, gt, labels, sizes


def assert_same(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_summary_and_per_class_and_by_size_equal(seed):
    dets, gt, labels, sizes = world(seed)
    assert_same(tev.evaluate_detections(dets, gt), jev.evaluate_detections(dets, gt))
    assert_same(tev.evaluate_detections_per_class(dets, gt, labels),
                jev.evaluate_detections_per_class(dets, gt, labels))
    for kw in ({}, {"groundtruth_labels": labels},
               {"area_ranges": {"tiny": (0.0, 900.0), "rest": (900.0, 1e10)}}):
        assert_same(tev.evaluate_detections_by_size(dets, gt, sizes, **kw),
                    jev.evaluate_detections_by_size(dets, gt, sizes, **kw))
    summary = tev.evaluate_detections(dets, gt)
    assert 0 < summary["AP@0.5"] <= 1  # the world has hits


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.75])
def test_ap_recall_and_matching_equal(thr):
    dets, gt, _, sizes = world(3)
    assert_same(tev.average_precision(dets, gt, thr), jev.average_precision(dets, gt, thr))
    for m in (1, 3, 100):
        assert_same(tev.average_recall(dets, gt, m), jev.average_recall(dets, gt, m))
    for d in dets:
        g = gt[d["image_id"]]
        assert_same(tev.match_detections(d["boxes"], d["scores"], g, thr),
                    jev.match_detections(d["boxes"], d["scores"], g, thr))
        assert_same(tev._iou_matrix_np(d["boxes"], g), jev._iou_matrix_np(d["boxes"], g))
        ignore = g[::2]
        oob = np.arange(len(d["boxes"])) % 3 == 0
        assert_same(tev._match_with_ignore(d["boxes"], d["scores"], g[1::2], ignore, thr, oob),
                    jev._match_with_ignore(d["boxes"], d["scores"], g[1::2], ignore, thr, oob))
    assert_same(tev._average_precision_banded(dets, gt, sizes, 0.0, 5e4, thr),
                jev._average_precision_banded(dets, gt, sizes, 0.0, 5e4, thr))


def test_class_slices_and_coco_results_equal():
    dets, gt, labels, sizes = world(4)
    for c in range(3):
        assert_same(tev._slice_by_class(dets, gt, labels, c),
                    jev._slice_by_class(dets, gt, labels, c))
    for offset in (0, 1):
        got = tev.to_coco_results(dets, sizes, label_offset=offset)
        assert got == jev.to_coco_results(dets, sizes, label_offset=offset) and got
    empty = tev.evaluate_detections([], {})
    assert_same(empty, jev.evaluate_detections([], {}))
