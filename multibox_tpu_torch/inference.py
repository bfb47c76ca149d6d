"""Detection pipeline: forward → decode → threshold → NMS → top-k.

The ENTIRE post-processing runs on the device the model runs on; only the
final fixed-size detection arrays come back to the host, as one packed
``[B, K, 7]`` copy per batch.

Decode semantics (parity-critical): ``box = prior + predicted_offset`` in
normalized corner coordinates, clipped to [0,1] — the DeepMultiBox residual
parameterization (arXiv:1312.2249), NOT the SSD center/log encoding (that
one is used only when ``cfg.box_encoding == "ssd"``).

Every entry point takes ``device=None``, which means the CUDA device and
raises when there is none; pass ``device="cpu"`` to run on the CPU. The
functions are eager PyTorch: ``make_detect_fn`` has nothing to compile and
returns the same callable as ``make_detect_body``.
"""

from __future__ import annotations

import logging
from collections import Counter
from typing import Dict

import numpy as np
import torch

from multibox_tpu_torch.config import Config
from multibox_tpu_torch.data.augment import preprocess_eval
from multibox_tpu_torch.data.pipeline import Prefetcher
from multibox_tpu_torch.device import resolve_device
from multibox_tpu_torch.models import detector as detector_mod
from multibox_tpu_torch.models.detector import MultiBoxDetector
from multibox_tpu_torch.ops import boxes as box_ops
from multibox_tpu_torch.ops.kernels import box_kernel, resolve_use_pallas
from multibox_tpu_torch.ops.nms import batched_nms, batched_soft_nms
from multibox_tpu_torch.parallel.gather import process_allgather_objects
from multibox_tpu_torch.parallel.sync import world_size

log = logging.getLogger(__name__)


def build_model(
    cfg: Config,
    num_priors: int,
    folded: bool = False,
    quantize: str = None,
    device=None,
) -> MultiBoxDetector:
    """Construct the detector module from a config (single source of truth
    for model hyperparameters across detect / export / train).

    ``folded=True`` builds the inference-only BN-folded variant (use with
    params from ``models.inception_v3.fold_batch_norms``); ``quantize``
    (``"int8"`` | ``"calib"``) builds the int8 PTQ variant on top of it (use
    with variables from ``quantize.prepare_quantized_variables``)."""
    return MultiBoxDetector(
        num_priors=num_priors,
        input_size=cfg.input_size,
        folded=folded,
        quantize=quantize,
        use_pallas=cfg.use_pallas,
        backbone=cfg.backbone,
        mobilenet_width=cfg.mobilenet_width,
        head_type=cfg.head_type,
        num_classes=cfg.num_classes,
        compute_dtype={"bfloat16": torch.bfloat16, "float64": torch.float64}.get(
            cfg.compute_dtype, torch.float32),
        bottleneck_features=cfg.bottleneck_features,
        ssd_endpoints=tuple(cfg.ssd_endpoints),
        ssd_priors_per_cell=cfg.ssd_priors_per_cell,
        bn_momentum=cfg.bn_momentum,
        device=resolve_device(device),
    )


def postprocess(
    locations: torch.Tensor,
    confidences: torch.Tensor,
    priors: torch.Tensor,
    cfg: Config,
) -> Dict[str, torch.Tensor]:
    """Decode + score + NMS, fully on-device, static output shapes.

    Args:
      locations: ``[B, P, 4]`` predicted offsets.
      confidences: ``[B, P]`` logits (class-agnostic) or ``[B, P, C]``.
      priors: ``[P, 4]``.

    Multi-class models run the standard per-class score sweep by default
    (``cfg.per_class_detect``): each (prior, class) score is a candidate,
    top-k-pruned to ``cfg.detect_candidates`` per image, with NMS applied
    within each class.

    Returns dict with ``boxes [B, K, 4]``, ``scores [B, K]``,
    ``classes [B, K]`` (zeros when class-agnostic), ``num [B]``.
    """
    return select_detections(
        decode_candidates(locations, priors, cfg), confidences, cfg
    )


def decode_candidates(
    locations: torch.Tensor, priors: torch.Tensor, cfg: Config
) -> torch.Tensor:
    """Offsets ``[B, P, 4]`` → clipped candidate boxes ``[B, P, 4]`` under
    the configured encoding. With ``cfg.use_pallas`` true the residual
    decode runs in the box kernel (bitwise the plain result)."""
    if cfg.box_encoding == "multibox":
        if cfg.use_pallas:
            return box_kernel.decode_boxes_cuda(
                locations.to(torch.float32).contiguous(), priors.contiguous(),
                clip=True,
            )
        return box_ops.decode_boxes(locations, priors[None], clip=True)
    return box_ops.decode_boxes_ssd(locations, priors[None], clip=True)


def _top_k_lowest_index_first(flat: torch.Tensor, k: int):
    """``(values, indices)`` of the k largest entries per row, equal values
    in ascending index order (a stable sort; ``torch.topk`` promises no
    order among ties)."""
    values, indices = torch.sort(flat, dim=1, descending=True, stable=True)
    return values[:, :k], indices[:, :k]


def select_detections(
    boxes: torch.Tensor, confidences: torch.Tensor, cfg: Config
) -> Dict[str, torch.Tensor]:
    """Score + NMS over already-decoded candidate boxes (the back half of
    :func:`postprocess`; flip-TTA feeds it the union of both orientations'
    candidates, so the candidate axis need not equal the prior count)."""
    if confidences.dim() == 2:
        scores = torch.sigmoid(confidences)  # [B, P]
        class_ids = None
    else:
        probs = torch.sigmoid(confidences)  # [B, P, C]
        per_class = (
            cfg.per_class_detect if cfg.per_class_detect is not None else True
        )
        if per_class:
            # Per-class score sweep (standard VOC/COCO protocol): every
            # (prior, class) pair is a detection candidate, so one prior
            # can emit several classes. The [P·C] grid is top-k-pruned to
            # a static candidate budget, then a single NMS pass suppresses
            # within each class via the class-offset trick in batched_nms.
            B, P, C = probs.shape
            cand = min(cfg.detect_candidates, P * C)
            scores, top_idx = _top_k_lowest_index_first(
                probs.reshape(B, P * C), cand
            )  # [B, cand]
            prior_idx = top_idx // C
            class_ids = (top_idx % C).to(torch.int32)
            boxes = torch.gather(
                boxes, 1, prior_idx[..., None].expand(B, cand, 4)
            )  # [B, cand, 4]
        else:
            # Cheaper approximation: per-prior best class only — depresses
            # per-class AP when one prior covers objects of several classes.
            scores, class_ids = probs.max(dim=-1)
            class_ids = class_ids.to(torch.int32)

    if cfg.nms_mode == "soft":
        # Gaussian soft-NMS (arXiv:1704.04503): occluding true positives
        # decay instead of vanishing. Plain PyTorch only (the CUDA kernel
        # implements hard suppression).
        sel_boxes, sel_scores, sel_idx, num = batched_soft_nms(
            boxes,
            scores,
            cfg.max_detections,
            sigma=cfg.soft_nms_sigma,
            score_threshold=max(cfg.detect_score_threshold, 1e-3),
            class_ids=class_ids,
        )
    elif cfg.nms_mode == "hard":
        sel_boxes, sel_scores, sel_idx, num = batched_nms(
            boxes,
            scores,
            cfg.max_detections,
            iou_threshold=cfg.nms_iou_threshold,
            score_threshold=cfg.detect_score_threshold,
            class_ids=class_ids,
            use_pallas=resolve_use_pallas(cfg.use_pallas, scores),
        )
    else:
        # A typo'd mode silently measuring the wrong NMS arm would poison
        # any quality A/B — fail loudly.
        raise ValueError(
            f"unknown nms_mode: {cfg.nms_mode!r} (expected 'hard' or 'soft')"
        )
    if class_ids is None:
        sel_classes = torch.zeros_like(sel_idx, dtype=torch.int32)
    else:
        safe = sel_idx.clamp_min(0).to(torch.int64)
        sel_classes = torch.where(
            sel_idx >= 0, torch.gather(class_ids, 1, safe), -1
        ).to(torch.int32)
    return {
        "boxes": sel_boxes,
        "scores": sel_scores,
        "classes": sel_classes,
        "num": num,
    }


def apply_and_postprocess(model, apply_vars, images, priors, cfg: Config):
    """One forward pass + postprocess — the shared tail of every detect
    program.

    With ``cfg.flip_tta`` the batch doubles with horizontally-mirrored
    images inside the SAME forward (one pass at 2B, not two), the mirrored
    pass's decoded boxes are flipped back
    (``ops.boxes.flip_boxes_horizontal``), and the union of both
    orientations' candidates goes through one NMS pass. About twice the
    detect FLOPs; validate per dataset before enabling.
    """
    if not cfg.flip_tta:
        locations, confidences = detector_mod.apply(model, apply_vars, images)
        return postprocess(locations, confidences, priors, cfg)
    B = images.shape[0]
    both = torch.cat([images, images.flip(2)], dim=0)
    locations, confidences = detector_mod.apply(model, apply_vars, both)
    boxes = decode_candidates(locations, priors, cfg)
    boxes = torch.cat(
        [boxes[:B], box_ops.flip_boxes_horizontal(boxes[B:])], dim=1
    )
    confidences = torch.cat([confidences[:B], confidences[B:]], dim=1)
    return select_detections(boxes, confidences, cfg)


def make_detect_fn(cfg: Config, priors, use_ema: bool = None, device=None):
    """Build the batched detect step.

    Returns ``detect(variables, images) -> detections`` where ``images`` is
    ``[B, S, S, 3]`` float32 in [-1, 1] and detections are the static-shape
    tensors of :func:`postprocess`. ``variables`` may carry an ``ema``
    collection (moving-average shadows); when present and
    ``cfg.use_ema_for_detect``, EMA params are used — the reference's
    inference behavior.
    """
    return make_detect_body(cfg, priors, use_ema=use_ema, device=device)


def make_detect_body(cfg: Config, priors, use_ema: bool = None, device=None):
    """The detect step — single source of the EMA-selection and
    postprocess semantics. Runs under ``torch.no_grad()`` on ``device``."""
    if cfg.quantize not in ("none", "int8"):
        # A typo'd mode silently measuring the f32 arm would poison any
        # quantization A/B — fail loudly (same rationale as nms_mode).
        raise ValueError(
            f"unknown quantize mode: {cfg.quantize!r} (expected 'none' or 'int8')"
        )
    device = resolve_device(device)
    priors = torch.as_tensor(np.asarray(priors, np.float32)).to(device)
    if cfg.quantize == "int8":
        # Int8 PTQ: EMA selection, BN folding and weight quantization are
        # already baked into the prepared variables
        # (quantize.prepare_quantized_variables): apply them directly.
        model_q = build_model(cfg, priors.shape[0], folded=True, quantize="int8",
                              device=device)

        @torch.no_grad()
        def detect_q(variables, images):
            images = torch.as_tensor(images).to(device)
            return apply_and_postprocess(
                model_q, {"params": variables["params"], "quant": variables["quant"]},
                images, priors, cfg)

        return detect_q
    model = build_model(cfg, priors.shape[0], device=device)
    if use_ema is None:
        use_ema = cfg.use_ema_for_detect

    @torch.no_grad()
    def detect(variables, images):
        params = variables["params"]
        if use_ema and "ema" in variables:
            params = variables["ema"]
        apply_vars = {"params": params}
        if "batch_stats" in variables:
            apply_vars["batch_stats"] = variables["batch_stats"]
        images = torch.as_tensor(images).to(device)
        return apply_and_postprocess(model, apply_vars, images, priors, cfg)

    return detect


def _pack_dets(det):
    """Pack ``{boxes, scores, classes, num}`` into ONE ``[B, K, 7]`` f32
    tensor (4 box coords | score | class id | num-valid broadcast), so the
    host drain is one device-to-host copy per batch.
    Class ids and counts are exact in f32 (< 2**24)."""
    b = det["boxes"].to(torch.float32)
    B, K = b.shape[0], b.shape[1]
    s = det["scores"].to(torch.float32)[..., None]
    c = det["classes"].to(torch.float32)[..., None]
    n = det["num"].to(torch.float32)[:, None, None].expand(B, K, 1)
    return torch.cat([b, s, c, n], dim=-1)


def _unpack_dets(arr):
    """Host-side inverse of :func:`_pack_dets` on a numpy ``[B, K, 7]``."""
    boxes = arr[..., :4]
    scores = arr[..., 4]
    classes = arr[..., 5].astype(np.int32)
    nums = arr[:, 0, 6].astype(np.int32)
    return boxes, scores, classes, nums


def make_detect_loop_fns(cfg: Config, priors, use_ema: bool = None, device=None):
    """Functions for :func:`run_detect_loop`, built once so repeated
    invocations (periodic in-training eval) reuse them. ``per_batch``
    takes uint8 images, preprocesses on the device and returns PACKED
    detections (:func:`_pack_dets`)."""
    device = resolve_device(device)
    body = make_detect_body(cfg, priors, use_ema=use_ema, device=device)
    if int(cfg.steps_per_host_transfer) > 1:
        # Grouping batches per transfer changes no result; it exists for
        # links that charge per transfer and is not carried over.
        log.warning(
            "steps_per_host_transfer=%s is ignored: batches are dispatched "
            "one by one", cfg.steps_per_host_transfer,
        )

    @torch.no_grad()
    def one(variables, images):
        images = torch.as_tensor(images).to(device)
        return _pack_dets(body(variables, preprocess_eval(images, cfg.input_size)))

    return {"per_batch": one, "device": device}


class _Fetch:
    """One packed result on its way to the host. On CUDA the copy into
    pinned memory is asynchronous and an event marks its end, so the host
    can unpack batch N while the device works on batch N+1."""

    def __init__(self, packed: torch.Tensor):
        if packed.is_cuda:
            self._host = torch.empty(
                packed.shape, dtype=packed.dtype, pin_memory=True)
            self._host.copy_(packed, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = packed, None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def run_detect_loop(
    cfg: Config,
    variables,
    dataset,
    priors,
    score_threshold: float = None,
    use_ema: bool = None,
    fns=None,
    device=None,
):
    """Drive detection over a dataset: the host loop shared by the detect /
    eval / visualize entry points and in-training eval.

    ``dataset`` is any iterable of batch dicts ``{images uint8 [B, H, W, 3],
    image_ids, batch_valid}``. Batches ship as uint8 (4× smaller than f32 —
    preprocessing runs on the device), and the drain of batch N's outputs
    overlaps batch N+1's device work (1-deep pipeline). ``variables`` must
    already live on ``device``.

    Under a process group of more than one rank (the counterpart of the
    JAX package's ``make_parallel_detect_fn``), each rank runs this loop on
    its card over its shard of the records (``dataset`` built with
    ``shard_index`` / ``shard_count`` = rank / world; ``cfg.batch_size`` is
    a rank's batch), and one ``process_allgather_objects`` merges the
    ranks' lists in rank order: every rank returns the whole list.

    Returns a list of per-image dicts {image_id, boxes, scores, classes}
    with only valid, above-threshold slots (host numpy).
    """
    thr = cfg.detect_score_threshold if score_threshold is None else score_threshold
    world = world_size()
    if world > 1 and getattr(dataset, "shard_count", 1) != world:
        # every rank would detect the same images and the merge duplicate them
        raise ValueError(
            "multi-process detect needs a dataset sharded over the ranks: build it "
            "with shard_index=rank, shard_count=world size (got shard_count="
            f"{getattr(dataset, 'shard_count', 1)} with {world} ranks)")
    if fns is None:
        fns = make_detect_loop_fns(cfg, priors, use_ema=use_ema, device=device)
    elif device is not None and torch.device(device).type != fns["device"].type:
        raise ValueError(
            f"fns were built for {fns['device']}, run_detect_loop got {device}")

    results = []

    def drain(batch, fetch):
        boxes, scores, classes, nums = _unpack_dets(fetch.numpy())
        for i in range(int(batch["batch_valid"])):
            n = int(nums[i])
            keep = scores[i, :n] >= thr
            results.append(
                {
                    "image_id": batch["image_ids"][i],
                    "boxes": boxes[i, :n][keep],
                    "scores": scores[i, :n][keep],
                    "classes": classes[i, :n][keep],
                }
            )

    inflight = None
    for batch in Prefetcher(iter(dataset), depth=2):
        # async on CUDA — the device works while the host drains
        fetch = _Fetch(fns["per_batch"](variables, np.asarray(batch["images"])))
        if inflight is not None:
            drain(*inflight)
        inflight = (batch, fetch)
    if inflight is not None:
        drain(*inflight)
    if world > 1:
        results = [r for part in process_allgather_objects(results) for r in part]
        # two ranks mis-wired with the same shard_index would detect one
        # shard twice and drop another, with no other symptom
        ids = [r["image_id"] for r in results]
        if len(set(ids)) != len(ids):
            dups = [k for k, n in Counter(ids).items() if n > 1]
            raise RuntimeError(
                f"multi-process gather merged duplicate image ids ({dups[:5]}"
                f"{'...' if len(dups) > 5 else ''}): check that every rank's "
                "dataset was built with its own shard_index (= its rank)")
    return results
