"""Detection evaluation: precision/recall + AP/mAP.

Own copy of the JAX package's ``evaluate.py``, unchanged (host numpy), so
that both packages score detections alike and the port imports nothing
from the other.

The reference's eval scored detections against ground truth at IoU ≥ 0.5
(ref:eval.py, SURVEY.md §2 C10); BASELINE.json asks for "mAP parity", so
this module implements the standard protocols:

* :func:`average_precision` — VOC-style AP for one class/threshold with
  greedy matching of detections (score-descending) to gt, all-point
  interpolation (area under the PR curve).
* :func:`evaluate_detections` — dataset-level: AP@0.5, AP@0.75, and
  COCO-style mAP averaged over IoU ∈ {0.5, 0.55, …, 0.95}, plus recall.

Host-side numpy (eval is not a hot path; detections arrive as small arrays
from the on-device pipeline).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _iou_matrix_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    ay0, ax0, ay1, ax1 = a[:, 0:1], a[:, 1:2], a[:, 2:3], a[:, 3:4]
    by0, bx0, by1, bx1 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    ih = np.maximum(0.0, np.minimum(ay1, by1) - np.maximum(ay0, by0))
    iw = np.maximum(0.0, np.minimum(ax1, bx1) - np.maximum(ax0, bx0))
    inter = ih * iw
    area_a = np.maximum(0.0, ay1 - ay0) * np.maximum(0.0, ax1 - ax0)
    area_b = np.maximum(0.0, by1 - by0) * np.maximum(0.0, bx1 - bx0)
    union = area_a + area_b - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def match_detections(
    det_boxes: np.ndarray,
    det_scores: np.ndarray,
    gt_boxes: np.ndarray,
    iou_threshold: float,
) -> np.ndarray:
    """Greedy TP/FP assignment for one image.

    Detections in score-descending order claim the best unclaimed gt with
    IoU ≥ threshold (the VOC/COCO protocol). Returns bool TP mask aligned
    with the (sorted) detections.
    """
    order = np.argsort(-det_scores, kind="stable")
    det_boxes = det_boxes[order]
    iou = _iou_matrix_np(det_boxes, gt_boxes)
    claimed = np.zeros(len(gt_boxes), bool)
    tp = np.zeros(len(det_boxes), bool)
    for d in range(len(det_boxes)):
        if len(gt_boxes) == 0:
            break
        candidates = np.where(~claimed, iou[d], -1.0)
        best = int(np.argmax(candidates))
        if candidates[best] >= iou_threshold:
            claimed[best] = True
            tp[d] = True
    return tp


def average_precision(
    detections: Sequence[Dict],
    groundtruth: Dict[str, np.ndarray],
    iou_threshold: float = 0.5,
) -> Tuple[float, float]:
    """(AP, recall) over a dataset at one IoU threshold.

    Args:
      detections: list of {image_id, boxes [K,4], scores [K]}.
      groundtruth: image_id → gt boxes [N, 4].
    """
    total_gt = int(sum(len(b) for b in groundtruth.values()))
    scores_all: List[np.ndarray] = []
    tp_all: List[np.ndarray] = []
    for det in detections:
        boxes = np.asarray(det["boxes"], np.float64).reshape(-1, 4)
        scores = np.asarray(det["scores"], np.float64).reshape(-1)
        gt = np.asarray(
            groundtruth.get(det["image_id"], np.zeros((0, 4))), np.float64
        ).reshape(-1, 4)
        tp = match_detections(boxes, scores, gt, iou_threshold)
        order = np.argsort(-scores, kind="stable")
        scores_all.append(scores[order])
        tp_all.append(tp)
    if total_gt == 0:
        return 0.0, 0.0
    if not scores_all:
        return 0.0, 0.0
    scores_cat = np.concatenate(scores_all)
    tp_cat = np.concatenate(tp_all)
    order = np.argsort(-scores_cat, kind="stable")
    tp_sorted = tp_cat[order]

    cum_tp = np.cumsum(tp_sorted)
    cum_fp = np.cumsum(~tp_sorted)
    recall = cum_tp / total_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)

    # All-point interpolation (monotone precision envelope).
    mprec = np.concatenate([[0.0], precision, [0.0]])
    mrec = np.concatenate([[0.0], recall, [1.0]])
    for i in range(len(mprec) - 2, -1, -1):
        mprec[i] = max(mprec[i], mprec[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    ap = float(np.sum((mrec[idx + 1] - mrec[idx]) * mprec[idx + 1]))
    final_recall = float(recall[-1]) if len(recall) else 0.0
    return ap, final_recall


def average_recall(
    detections: Sequence[Dict],
    groundtruth: Dict[str, np.ndarray],
    max_dets: int = 100,
) -> float:
    """COCO AR@maxDets: recall averaged over IoU ∈ [.5:.95:.05], with each
    image's detections capped at the ``max_dets`` highest-scored."""
    capped = []
    for det in detections:
        boxes = np.asarray(det["boxes"], np.float64).reshape(-1, 4)
        scores = np.asarray(det["scores"], np.float64).reshape(-1)
        order = np.argsort(-scores, kind="stable")[:max_dets]
        capped.append(
            {"image_id": det["image_id"], "boxes": boxes[order],
             "scores": scores[order]}
        )
    recalls = [
        average_precision(capped, groundtruth, t)[1]
        for t in np.arange(0.5, 1.0, 0.05)
    ]
    return float(np.mean(recalls))


def evaluate_detections(
    detections: Sequence[Dict],
    groundtruth: Dict[str, np.ndarray],
) -> Dict[str, float]:
    """Standard summary: AP@.5, AP@.75, COCO mAP@[.5:.95:.05], recall@.5,
    AR@{1,10,100} (cocoeval's recall family)."""
    # One threshold sweep yields both the AP family and the uncapped
    # recalls; AR@100 reuses those recalls whenever no image carries more
    # than 100 detections (the common case — the detect pipeline caps at
    # cfg.max_detections), so only AR@1/AR@10 pay extra capped passes.
    pairs = [
        average_precision(detections, groundtruth, t)
        for t in np.arange(0.5, 1.0, 0.05)
    ]
    ap50, rec50 = pairs[0]
    ap75 = pairs[5][0]
    if all(len(np.asarray(d["scores"]).reshape(-1)) <= 100 for d in detections):
        ar100 = float(np.mean([r for _, r in pairs]))
    else:
        ar100 = average_recall(detections, groundtruth, 100)
    return {
        "AP@0.5": ap50,
        "AP@0.75": ap75,
        "mAP@[.5:.95]": float(np.mean([a for a, _ in pairs])),
        "recall@0.5": rec50,
        "AR@1": average_recall(detections, groundtruth, 1),
        "AR@10": average_recall(detections, groundtruth, 10),
        "AR@100": ar100,
        "num_images": float(len(detections)),
        "num_gt": float(sum(len(b) for b in groundtruth.values())),
    }


def to_coco_results(
    detections: Sequence[Dict],
    image_sizes: Dict[str, Tuple[int, int]],
    label_offset: int = 0,
) -> List[Dict]:
    """Convert per-image detection dicts to the COCO results-file format
    (one flat list of ``{image_id, category_id, bbox [x,y,w,h] in source
    pixels, score}``), consumable by pycocotools' ``loadRes``. Normalized
    (ymin,xmin,ymax,xmax) corners are scaled by the image's (height,
    width); images without a known size are skipped (COCO bboxes are
    pixel-absolute). ``label_offset`` is ADDED back to class ids so a
    1-based dataset round-trips (the inverse of cfg.label_offset at
    train/eval time). Numeric image ids are emitted as ints (the COCO
    convention); other ids stay strings.
    """
    out: List[Dict] = []
    for det in detections:
        img = det["image_id"]
        if img not in image_sizes:
            continue
        h, w = image_sizes[img]
        image_id = int(img) if str(img).isdigit() else img
        boxes = np.asarray(det["boxes"], np.float64).reshape(-1, 4)
        scores = np.asarray(det["scores"], np.float64).reshape(-1)
        classes = np.asarray(
            det.get("classes", np.zeros(len(scores))), np.int64
        ).reshape(-1)
        for b, s, c in zip(boxes, scores, classes):
            y0, x0, y1, x1 = b
            out.append(
                {
                    "image_id": image_id,
                    "category_id": int(c) + label_offset,
                    # w/h clamped at 0: a decoded box with inverted corners
                    # (possible from an undertrained head; decode clips to
                    # [0,1] but does not order corners) is an empty box,
                    # and COCO bboxes must have non-negative extent.
                    "bbox": [
                        float(x0 * w),
                        float(y0 * h),
                        float(max(x1 - x0, 0.0) * w),
                        float(max(y1 - y0, 0.0) * h),
                    ],
                    "score": float(s),
                }
            )
    return out


# COCO object-size bands, in source-image pixels² (cocoeval's areaRng).
COCO_AREA_RANGES = {
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, float("inf")),
}


def _match_with_ignore(
    det_boxes: np.ndarray,
    det_scores: np.ndarray,
    gt_boxes: np.ndarray,
    ignore_boxes: np.ndarray,
    iou_threshold: float,
    det_out_of_band: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy matching with COCO ignore semantics for one image.

    Score-descending detections first claim countable gt (TP at
    IoU ≥ threshold). A detection that instead lands on an *ignored* gt
    (out-of-band for the current size stratum) is excluded from the PR
    curve — neither TP nor FP — as is an unmatched detection whose OWN
    area is out of band (cocoeval's dtIg rule). Returns (tp, keep) masks
    aligned with the sorted detections.
    """
    order = np.argsort(-det_scores, kind="stable")
    det_boxes = det_boxes[order]
    det_oob = det_out_of_band[order]
    iou_gt = _iou_matrix_np(det_boxes, gt_boxes)
    iou_ig = _iou_matrix_np(det_boxes, ignore_boxes)
    claimed = np.zeros(len(gt_boxes), bool)
    claimed_ig = np.zeros(len(ignore_boxes), bool)
    tp = np.zeros(len(det_boxes), bool)
    keep = np.ones(len(det_boxes), bool)
    for d in range(len(det_boxes)):
        if len(gt_boxes):
            cand = np.where(~claimed, iou_gt[d], -1.0)
            best = int(np.argmax(cand))
            if cand[best] >= iou_threshold:
                claimed[best] = True
                tp[d] = True
                continue
        if len(ignore_boxes):
            cand = np.where(~claimed_ig, iou_ig[d], -1.0)
            best = int(np.argmax(cand))
            if cand[best] >= iou_threshold:
                claimed_ig[best] = True
                keep[d] = False
                continue
        if det_oob[d]:
            keep[d] = False  # unmatched + own area out of band → ignored
    return tp, keep


def _average_precision_banded(
    detections: Sequence[Dict],
    groundtruth: Dict[str, np.ndarray],
    image_sizes: Dict[str, Tuple[int, int]],
    area_lo: float,
    area_hi: float,
    iou_threshold: float,
) -> Tuple[float, float, int]:
    """(AP, recall, num_gt_in_band) at one IoU threshold for one size band."""
    def px_area(b, h, w):
        return (
            np.maximum(0.0, b[:, 2] - b[:, 0])
            * np.maximum(0.0, b[:, 3] - b[:, 1])
            * float(h) * float(w)
        )

    # Total in-band gt over ALL groundtruth images (like
    # average_precision) — an image with gt but no detection entry must
    # still count as missed gt, or banded recall/AP inflate.
    total_gt = 0
    for img, gt in groundtruth.items():
        if img not in image_sizes:
            continue
        gt = np.asarray(gt, np.float64).reshape(-1, 4)
        a = px_area(gt, *image_sizes[img])
        total_gt += int(((a >= area_lo) & (a < area_hi)).sum())

    scores_all: List[np.ndarray] = []
    tp_all: List[np.ndarray] = []
    for det in detections:
        img = det["image_id"]
        if img not in image_sizes:
            continue
        h, w = image_sizes[img]
        boxes = np.asarray(det["boxes"], np.float64).reshape(-1, 4)
        scores = np.asarray(det["scores"], np.float64).reshape(-1)
        gt = np.asarray(
            groundtruth.get(img, np.zeros((0, 4))), np.float64
        ).reshape(-1, 4)
        a_gt = px_area(gt, h, w)
        gt_in = (a_gt >= area_lo) & (a_gt < area_hi)
        a_det = px_area(boxes, h, w)
        det_oob = ~((a_det >= area_lo) & (a_det < area_hi))
        tp, keep = _match_with_ignore(
            boxes, scores, gt[gt_in], gt[~gt_in], iou_threshold, det_oob
        )
        order = np.argsort(-scores, kind="stable")
        scores_all.append(scores[order][keep])
        tp_all.append(tp[keep])
    if total_gt == 0 or not scores_all:
        return 0.0, 0.0, total_gt
    scores_cat = np.concatenate(scores_all)
    tp_cat = np.concatenate(tp_all)
    order = np.argsort(-scores_cat, kind="stable")
    tp_sorted = tp_cat[order]
    cum_tp = np.cumsum(tp_sorted)
    cum_fp = np.cumsum(~tp_sorted)
    recall = cum_tp / total_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    mprec = np.concatenate([[0.0], precision, [0.0]])
    mrec = np.concatenate([[0.0], recall, [1.0]])
    for i in range(len(mprec) - 2, -1, -1):
        mprec[i] = max(mprec[i], mprec[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    ap = float(np.sum((mrec[idx + 1] - mrec[idx]) * mprec[idx + 1]))
    final_recall = float(recall[-1]) if len(recall) else 0.0
    return ap, final_recall, total_gt


def evaluate_detections_by_size(
    detections: Sequence[Dict],
    groundtruth: Dict[str, np.ndarray],
    image_sizes: Dict[str, Tuple[int, int]],
    area_ranges: Optional[Dict[str, Tuple[float, float]]] = None,
    groundtruth_labels: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, float]:
    """COCO size-stratified summary: AP@0.5 / mAP@[.5:.95] / recall@0.5
    per object-size band (small <32², medium 32²–96², large >96² source
    pixels — cocoeval's areaRng). Out-of-band gt are IGNORE regions:
    detections matching them, and unmatched out-of-band detections, are
    excluded from the PR curve rather than counted as FPs (the cocoeval
    gtIg/dtIg rules). Images without a known (height, width) are skipped
    and counted in ``num_images_skipped``.

    Without ``groundtruth_labels`` the bands are class-agnostic (single-
    class reference lineage). With them (and ``classes`` in detections)
    each band's AP is computed per class and averaged — cocoeval's actual
    protocol (stratify per class, then mean over classes present in gt).
    """
    ranges = area_ranges or COCO_AREA_RANGES
    out: Dict[str, float] = {}
    skipped = sum(1 for d in detections if d["image_id"] not in image_sizes)

    if groundtruth_labels is None:
        class_slices = [(detections, groundtruth)]
    else:
        class_slices = [
            _slice_by_class(detections, groundtruth, groundtruth_labels, c)
            for c in sorted(
                {int(c) for ls in groundtruth_labels.values() for c in ls}
            )
        ]

    # The 10-threshold loop recomputes matching per threshold like
    # average_precision does (cocoeval caches IoUs instead) — accepted for
    # symmetry with the rest of this module; eval is offline host code.
    for name, (lo, hi) in ranges.items():
        ap50s, rec50s, coco_aps, n_gt = [], [], [], 0
        for det_s, gt_s in class_slices:
            ap50, rec50, n = _average_precision_banded(
                det_s, gt_s, image_sizes, lo, hi, 0.5
            )
            n_gt += n
            if n == 0:
                # cocoeval skips (-1) classes with no gt in the band —
                # averaging their 0 in would deflate every band missing
                # some class.
                continue
            aps = [
                _average_precision_banded(det_s, gt_s, image_sizes, lo, hi, t)[0]
                for t in np.arange(0.5, 1.0, 0.05)
            ]
            ap50s.append(ap50)
            rec50s.append(rec50)
            coco_aps.append(float(np.mean(aps)))
        out[f"AP@0.5/{name}"] = float(np.mean(ap50s)) if ap50s else 0.0
        out[f"mAP@[.5:.95]/{name}"] = float(np.mean(coco_aps)) if coco_aps else 0.0
        out[f"recall@0.5/{name}"] = float(np.mean(rec50s)) if rec50s else 0.0
        out[f"num_gt/{name}"] = float(n_gt)
    out["num_images_skipped"] = float(skipped)
    return out


def _slice_by_class(
    detections: Sequence[Dict],
    groundtruth_boxes: Dict[str, np.ndarray],
    groundtruth_labels: Dict[str, np.ndarray],
    c: int,
) -> Tuple[List[Dict], Dict[str, np.ndarray]]:
    """Restrict detections + gt to one class (the per-class protocols'
    shared slicer). Robust to class-agnostic inputs: detections without a
    ``classes`` entry count as class 0, images missing from
    ``groundtruth_labels`` contribute no gt for any class."""
    gt_c = {}
    for img, boxes in groundtruth_boxes.items():
        boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
        labels = np.asarray(
            groundtruth_labels.get(img, np.zeros(len(boxes)))
        ).reshape(-1)
        gt_c[img] = boxes[labels == c]
    det_c = []
    for det in detections:
        boxes = np.asarray(det["boxes"], np.float64).reshape(-1, 4)
        scores = np.asarray(det["scores"], np.float64).reshape(-1)
        classes = np.asarray(
            det.get("classes", np.zeros(len(scores)))
        ).reshape(-1)
        mask = classes == c
        det_c.append(
            {
                "image_id": det["image_id"],
                "boxes": boxes[mask],
                "scores": scores[mask],
            }
        )
    return det_c, gt_c


def evaluate_detections_per_class(
    detections: Sequence[Dict],
    groundtruth_boxes: Dict[str, np.ndarray],
    groundtruth_labels: Dict[str, np.ndarray],
) -> Dict[str, float]:
    """Multi-class protocol: AP computed per class, averaged (VOC/COCO).

    Detections must carry ``classes``; ground truth labels per image are
    aligned with the gt boxes. Classes absent from the ground truth are
    skipped (COCO convention).
    """
    classes = sorted(
        {int(c) for labels in groundtruth_labels.values() for c in labels}
    )
    summary: Dict[str, float] = {}
    per_class_50 = []
    per_class_coco = []
    for c in classes:
        det_c, gt_c = _slice_by_class(
            detections, groundtruth_boxes, groundtruth_labels, c
        )
        ap50, _ = average_precision(det_c, gt_c, 0.5)
        coco = float(
            np.mean(
                [average_precision(det_c, gt_c, t)[0]
                 for t in np.arange(0.5, 1.0, 0.05)]
            )
        )
        per_class_50.append(ap50)
        per_class_coco.append(coco)
        summary[f"AP@0.5/class_{c}"] = ap50
    summary["mAP@0.5"] = float(np.mean(per_class_50)) if per_class_50 else 0.0
    summary["mAP@[.5:.95]"] = (
        float(np.mean(per_class_coco)) if per_class_coco else 0.0
    )
    summary["num_classes"] = float(len(classes))
    return summary
