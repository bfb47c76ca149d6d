"""Configuration: typed dataclass + YAML loading.

Own copy of the ``Config`` surface of the JAX package, field for field, so
the same YAML files load unchanged (snake_case keys and the original
UPPER_CASE keys). ``data_axis`` (the JAX package's mesh axis) is kept so
that a config file round-trips, and read by nothing here: the port's data
parallelism is one process a card under ``torch.distributed``
(``parallel``). Unknown keys warn instead of failing so older configs load.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Optional, Sequence

import yaml

log = logging.getLogger(__name__)


@dataclass
class Config:
    # --- model ---
    input_size: int = 299
    num_priors: int = 256
    backbone: str = "inception_v3"  # "inception_v3" | "mobilenet_v2"
    mobilenet_width: float = 1.0
    head_type: str = "multibox"  # "multibox" | "ssd"
    num_classes: int = 1
    bottleneck_features: int = 96
    ssd_endpoints: Sequence[str] = ("Mixed_5d", "Mixed_6e", "Mixed_7c")
    ssd_priors_per_cell: int = 6
    box_encoding: str = "multibox"  # "multibox" (residual) | "ssd"
    compute_dtype: str = "bfloat16"
    # slim parity default; lower (e.g. 0.9) for short training runs or the
    # inference-mode BN statistics never leave their init values.
    bn_momentum: float = 0.9997
    # rematerialize the backbone in the backward pass: trades recompute
    # FLOPs for activation memory.
    remat: bool = False

    # --- training ---
    batch_size: int = 32
    # >1 → split each step's batch into this many sequential microbatches,
    # average their gradients, and apply the optimizer ONCE — the effective
    # batch stays batch_size while activation memory scales with
    # batch_size/grad_accum_steps (compose with `remat` for the largest
    # effective batches). batch_size must be divisible by it. BN caveat
    # (standard for grad accumulation): train-mode BN normalizes over each
    # MICRObatch, and the running stats take grad_accum_steps momentum
    # updates per optimizer step.
    grad_accum_steps: int = 1
    max_num_bboxes: int = 16
    location_loss_alpha: float = 1.0  # α weight on the location loss
    matching: str = "greedy"  # "greedy" | "hungarian"
    hybrid_conf_weight: float = 0.0  # >0 → loss-aware (hybrid) matching
    hard_negative_ratio: float = 3.0  # negatives per positive; 0 → all
    # >0 → log N input canvases (gt boxes burned in) to TensorBoard every
    # this many steps. 0 = off (image summaries cost host work and
    # event-file bytes).
    image_summary_steps: int = 0
    # >0 → SSD dense matching (arXiv:1512.02325 §2.2): on top of the
    # bipartite best matches, every prior with best-gt IoU ≥ this trains
    # as a positive; 0 keeps pure reference behavior.
    multi_match_iou: float = 0.0
    # Confidence loss: "bce" (reference) | "focal" (RetinaNet-style
    # focal sigmoid CE — useful when conf training plateaus under extreme
    # class imbalance; pair with hard_negative_ratio: 0).
    conf_loss: str = "bce"
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    # Raw tfrecord label ids have cfg.label_offset subtracted before use —
    # set 1 for conventional 1-based datasets (VOC/COCO with 0=background).
    # After the offset every label must lie in [0, num_classes): the host
    # pipeline fails loudly on violations, and the loss reports a
    # num_bad_labels metric as defense in depth.
    label_offset: int = 0
    initial_learning_rate: float = 0.01
    learning_rate_decay_factor: float = 0.94
    num_epochs_per_decay: float = 4.0
    # LR schedule shape: "exponential" (slim staircase, reference parity)
    # | "cosine". min_learning_rate floors either schedule (the staircase
    # otherwise decays below useful magnitudes on long runs); warmup_steps
    # prepends a linear ramp from 0.
    lr_schedule: str = "exponential"
    min_learning_rate: float = 0.0
    warmup_steps: int = 0
    num_train_examples: int = 5000
    # Optimizer family (slim train_image_classifier surface): rmsprop is
    # the reference default; momentum/sgd/adam are the other slim-era
    # choices. "momentum" reuses rmsprop_momentum as its coefficient.
    optimizer: str = "rmsprop"
    rmsprop_decay: float = 0.9
    rmsprop_epsilon: float = 1.0
    rmsprop_momentum: float = 0.9
    adam_epsilon: float = 1e-8
    # >0 → clip gradients to this global norm before the optimizer update
    # (slim's clip_gradient_norm flag). 0 = off.
    clip_gradient_norm: float = 0.0
    moving_average_decay: float = 0.9999
    max_number_of_steps: int = 100000
    save_every_steps: int = 1000
    log_every_steps: int = 100
    keep_checkpoints: int = 3
    seed: int = 0
    # >0 → the train CLI supervises bounded-lifetime child processes of
    # this many steps each, resuming from the logdir between them
    # (tf.train.Supervisor lineage: a crashed worker is restarted from the
    # last checkpoint instead of killing the run).
    restart_every_steps: int = 0

    # --- host input pipeline (see data/pipeline) ---
    decode_draft: bool = False  # libjpeg DCT-scaled decode for train inputs
    decode_cache_items: int = 0  # RAM-cache N decoded items across epochs
    # Steps per host call, as in the JAX package: K > 1 stacks K host
    # batches (train steps or detect batches), copies them to the device at
    # once and runs the K steps with no wait for the device in between: on
    # the card one CUDA graph of K steps (multibox_tpu_torch.graphs), else
    # back to back (train.loop.make_chunked_step). The results are those of
    # K single steps.
    steps_per_host_transfer: int = 1

    # NMS flavor: "hard" (reference semantics, CUDA kernel on the GPU) or
    # "soft" (Gaussian score decay, arXiv:1704.04503 — occluding true
    # positives keep reduced scores instead of vanishing; plain PyTorch).
    nms_mode: str = "hard"
    soft_nms_sigma: float = 0.5

    # --- augmentation (train input pipeline) ---
    augment: bool = True
    random_flip: bool = True
    random_crop: bool = True
    crop_min_object_covered: float = 0.7
    crop_min_area: float = 0.5
    crop_max_area: float = 1.0
    color_distort: bool = True
    brightness_max_delta: float = 0.125
    contrast_range: Sequence[float] = (0.5, 1.5)
    hue_max_delta: float = 0.05  # fraction of a full hue rotation; 0 = off

    # --- detection / NMS ---
    detect_score_threshold: float = 0.01
    nms_iou_threshold: float = 0.5
    max_detections: int = 100
    use_ema_for_detect: bool = True
    # Multi-class postprocess: None = auto (per-class sweep when
    # num_classes > 1 — the standard VOC/COCO protocol: every (prior,
    # class) score is a candidate, NMS within each class). False = the
    # cheaper argmax-class-per-prior approximation. Class-agnostic models
    # ignore this.
    per_class_detect: Optional[bool] = None
    # Per-image candidate budget for the per-class sweep: the [P·C] score
    # grid is top-k-pruned to this many candidates before NMS so the NMS
    # cost stays independent of num_classes (static shapes). Raise for
    # class counts ≫ 32.
    detect_candidates: int = 1024
    # Horizontal-flip test-time augmentation (classic detection-era TTA):
    # the detect step runs the backbone on the image AND its mirror in
    # ONE doubled batch, mirrors the flipped pass's decoded boxes back, and
    # feeds the union of candidates through one NMS pass. About twice the
    # detect FLOPs; validate per dataset. Off by default.
    flip_tta: bool = False
    # Post-training quantization of the detect path: "none" | "int8".
    quantize: str = "none"
    quant_calib_batches: int = 4

    # --- parallel ---
    data_axis: str = "data"

    # --- ops backend ---
    # Hand-written kernel routing. The field keeps the name it has in the
    # JAX package so the same YAML loads. None = auto: the NMS kernel when
    # the tensors are on a CUDA device. True additionally routes the
    # head / folded 1×1-conv matmuls and the box decode through the CUDA
    # kernels. False = plain PyTorch everywhere. A wrapper handed a CUDA
    # tensor launches its kernel or raises; only CPU tensors take the
    # plain version.
    use_pallas: Optional[bool] = None

    # --- debugging / observability ---
    debug_nans: bool = False  # anomaly-detection toggle (training slice)
    # >0: a torch.profiler trace of N train steps, with the program's spans
    # (utils.spans: prefetch wait, staging, replay) beside the device's kernels
    profile_steps: int = 0


# Reference-era UPPER_CASE YAML key → dataclass field.
_KEY_ALIASES = {
    "INPUT_SIZE": "input_size",
    "IMAGE_SIZE": "input_size",
    "NUM_PRIORS": "num_priors",
    "BATCH_SIZE": "batch_size",
    "MAX_NUM_BBOXES": "max_num_bboxes",
    "LOCATION_LOSS_ALPHA": "location_loss_alpha",
    "INITIAL_LEARNING_RATE": "initial_learning_rate",
    "LEARNING_RATE_DECAY_FACTOR": "learning_rate_decay_factor",
    "NUM_EPOCHS_PER_DECAY": "num_epochs_per_decay",
    "NUM_TRAIN_EXAMPLES": "num_train_examples",
    "OPTIMIZER": "optimizer",
    "CLIP_GRADIENT_NORM": "clip_gradient_norm",
    "MOMENTUM": "rmsprop_momentum",
    "RMSPROP_DECAY": "rmsprop_decay",
    "RMSPROP_EPSILON": "rmsprop_epsilon",
    "RMSPROP_MOMENTUM": "rmsprop_momentum",
    "MOVING_AVERAGE_DECAY": "moving_average_decay",
    "MAX_NUMBER_OF_STEPS": "max_number_of_steps",
    "NUM_STEPS": "max_number_of_steps",
    "RANDOM_FLIP": "random_flip",
    "RANDOM_CROP": "random_crop",
    "COLOR_DISTORT": "color_distort",
    "AUGMENT": "augment",
    "DETECT_SCORE_THRESHOLD": "detect_score_threshold",
    "CONFIDENCE_THRESHOLD": "detect_score_threshold",
    "NMS_IOU_THRESHOLD": "nms_iou_threshold",
    "MAX_DETECTIONS": "max_detections",
    "SEED": "seed",
}

_FIELDS = {f.name for f in dataclasses.fields(Config)}


def parse_config_file(path: str) -> Config:
    """Load a YAML config; accepts both snake_case and the reference's
    UPPER_CASE keys."""
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return parse_config_dict(raw)


def parse_config_dict(raw: dict) -> Config:
    kwargs = {}
    for key, value in raw.items():
        name = _KEY_ALIASES.get(key, key.lower() if key.isupper() else key)
        if name in _FIELDS:
            kwargs[name] = value
        else:
            log.warning("ignoring unknown config key: %s", key)
    return Config(**kwargs)


def save_config(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f, sort_keys=True)
