"""Training loop: tfrecords → host batches → on-device augment → train
step → metrics, checkpoints and periodic eval.

- Resumes from the latest checkpoint in ``logdir`` by default.
- Each step is one call: augmentation, forward, matching, loss, backward,
  optimizer and EMA run on the device; only the uint8 canvases and the
  padded boxes cross from the host, and metrics come back only when they
  are logged.
- The augmentation's random numbers come from a generator seeded with
  ``(cfg.seed, step)``: deterministic, and the same after a resume.
- :func:`train` reads tfrecords through ``data.pipeline.DetectionDataset``
  (the JAX package's record order); :func:`train_from_batches` takes any
  stream of host batches. With ``eval_tfrecords`` the loop runs detection
  and AP over them every ``eval_every_steps`` steps.
- Data parallel under a process group (``torchrun``, ``parallel``): each
  rank reads its shard of the records at ``cfg.batch_size // world`` images
  a step, the step runs over the global batch
  (``parallel.make_parallel_train_step``), rank 0 alone writes metrics and
  checkpoints, and periodic eval detects each rank's shard and gathers.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from multibox_tpu_torch.config import Config
from multibox_tpu_torch.data import augment as augment_mod
from multibox_tpu_torch.data.pipeline import DetectionDataset, Prefetcher
from multibox_tpu_torch.device import resolve_device
from multibox_tpu_torch.inference import build_model, make_detect_loop_fns, run_detect_loop
from multibox_tpu_torch.parallel import (
    coordination_barrier,
    make_mesh,
    make_parallel_train_step,
    replicate_state,
    shard_batch,
)
from multibox_tpu_torch.parallel import mesh
from multibox_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    make_train_step,
)
from multibox_tpu_torch.utils.checkpoint import CheckpointManager
from multibox_tpu_torch.utils.metrics import MetricsWriter

log = logging.getLogger(__name__)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The augmentation generator of one step, on ``device``, seeded from
    ``(seed, step)``."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def make_augmented_train_step(cfg: Config, model, priors, device=None):
    """Wrap the train step so that augmentation runs first, on the device.

    Batch in: uint8 canvases ``images [B, H, W, 3]``, ``boxes [B, G, 4]``,
    ``num_boxes [B]`` and optional ``labels [B, G]`` (numpy or tensors).
    With ``cfg.augment`` off, images only go through ``preprocess_eval``.
    Inside a data-parallel step the batch is the rank's rows of the global
    batch, and the augmentation parameters are drawn for the global batch
    (``augment_batch(rows=...)``), so each image is augmented as in one
    process.
    """
    device = resolve_device(device)
    base_step = make_train_step(cfg, model, priors, device=device)

    def step(state: TrainState, batch):
        batch = shard_batch(batch, device)
        labels = batch.get("labels")
        if cfg.augment:
            gen = step_generator(cfg.seed, state.step, device)
            out = augment_mod.augment_batch(
                gen, batch["images"], batch["boxes"], batch["num_boxes"], cfg,
                labels=labels, rows=mesh.global_rows(batch["images"].shape[0]))
            if labels is not None:
                images, boxes, num_boxes, labels = out
            else:
                images, boxes, num_boxes = out
        else:
            images = augment_mod.preprocess_eval(batch["images"], cfg.input_size)
            boxes, num_boxes = batch["boxes"], batch["num_boxes"]
        device_batch = {"images": images, "boxes": boxes, "num_boxes": num_boxes}
        if labels is not None and cfg.num_classes > 1:
            device_batch["labels"] = labels
        return base_step(state, device_batch)

    return step


def make_chunked_step(step_fn, num_steps: int):
    """Run ``num_steps`` train steps over a stacked superbatch (leading
    chunk axis) in one call; returns the last step's metrics."""

    def chunk_step(state, superbatch):
        metrics = None
        for k in range(num_steps):
            state, metrics = step_fn(state, {key: v[k] for key, v in superbatch.items()})
        return state, metrics

    return chunk_step


_BACKBONE_SCOPES = ("InceptionV3", "MobileNetV2")


def _restore_pretrained(state: TrainState, path: str, device) -> TrainState:
    """Restore a pretrained backbone with the head scopes excluded (the
    reference's behaviour, SURVEY.md §3.1). Three source formats:

    - a logdir of another run of this package: the warm start below;
    - a keras ``.h5`` / ``.keras`` file (``models.tf_import``);
    - otherwise a tf-slim checkpoint prefix (``models.tf_import``).

    The last two need TensorFlow. The backbone's params and statistics are
    replaced, the EMA params become a copy of the params, and the head and
    the optimizer stay as initialized."""
    if os.path.isdir(path) and CheckpointManager(path).latest_step() is not None:
        return _warm_start_from_logdir(state, path, device)
    from multibox_tpu_torch.models import tf_import

    variables = {"params": state.params, "batch_stats": state.batch_stats}
    if path.endswith((".h5", ".keras")):
        tf = tf_import.require_tensorflow("reading a keras model file")
        variables = tf_import.import_keras_inception_v3(tf.keras.models.load_model(path),
                                                        variables)
    else:
        variables = tf_import.import_slim_checkpoint(path, variables)
    with torch.no_grad():
        for dst, src in ((state.params, variables["params"]),
                         (state.batch_stats, variables["batch_stats"])):
            for k, v in dst.items():
                if src[k] is not v:
                    v.copy_(src[k])
        for k, v in state.params.items():
            state.ema_params[k].copy_(v)
    log.info("restored pretrained backbone from %s", path)
    return state


def _warm_start_from_logdir(state: TrainState, path: str, device) -> TrainState:
    """Copy the backbone's params and batch_stats (EMA shadows preferred)
    out of another run's latest checkpoint into a fresh state; the head
    and the optimizer stay as initialized."""
    raw = CheckpointManager(path).restore_raw(device=device)
    src_params = raw.get("ema_params") or raw["params"]
    src_stats = raw.get("batch_stats") or {}
    scopes = [s for s in _BACKBONE_SCOPES
              if any(k.startswith(s + ".") for k in src_params)
              and any(k.startswith(s + ".") for k in state.params)]
    if not scopes:
        raise ValueError(f"no common backbone scope between {path} and this model")

    def graft(dst, src, what):
        mismatch = []
        for k, v in dst.items():
            if not k.split(".", 1)[0] in scopes:
                continue
            if k not in src or tuple(src[k].shape) != tuple(v.shape):
                mismatch.append((k, tuple(v.shape),
                                 tuple(src[k].shape) if k in src else None))
                continue
            with torch.no_grad():
                v.copy_(src[k])
        if mismatch:
            raise ValueError(f"warm-start {what} shape mismatch (differing backbone "
                             f"config?): {mismatch[:5]}")

    graft(state.params, src_params, "params")
    graft(state.batch_stats, src_stats, "batch_stats")
    with torch.no_grad():
        for k, v in state.params.items():
            state.ema_params[k].copy_(v)
    log.info("warm-started backbone scope(s) %s from %s (EMA weights)", scopes, path)
    return state


def eval_config(cfg: Config) -> Config:
    """The detect/eval config of a rank, from the training config:
    ``cfg.batch_size`` is the global train batch, and ``run_detect_loop``
    takes ``batch_size`` a rank, so each rank evaluates at its share."""
    per_rank = max(1, cfg.batch_size // mesh.world_size())
    if per_rank == cfg.batch_size:
        return cfg
    return dataclasses.replace(cfg, batch_size=per_rank)


def make_eval_fns(cfg: Config, priors, device):
    """The detect functions of periodic eval, built once so that repeated
    evals reuse them. ``cfg`` is the training config (:func:`eval_config`
    is applied here)."""
    return make_detect_loop_fns(eval_config(cfg), priors, device=device)


def evaluate_state(cfg: Config, state: TrainState, priors, eval_tfrecords,
                   eval_fns=None, gt=None, device=None):
    """Run detection + AP over a validation set from the current state.

    Ground truth is read from the tfrecords (full box lists), not from the
    padded batch, which truncates to ``cfg.max_num_bboxes``. ``gt`` may be
    passed pre-loaded (the loop reads it once per run): the boxes dict, or
    a ``(boxes, labels)`` tuple; with labels and ``cfg.num_classes > 1``
    the summary also carries the per-class protocol (``mAP@0.5``, the
    per-class APs and ``mAP@[.5:.95]/per_class``). Under a process group
    each rank detects its shard of the records and ``run_detect_loop``
    gathers, so the summary is global and the same on every rank."""
    from multibox_tpu_torch.cli.evaluate import load_groundtruth
    from multibox_tpu_torch.evaluate import (
        evaluate_detections,
        evaluate_detections_per_class,
    )

    device = resolve_device(device)
    cfg = eval_config(cfg)
    dataset = DetectionDataset(
        eval_tfrecords,
        batch_size=cfg.batch_size,
        canvas_size=cfg.input_size,
        max_num_bboxes=cfg.max_num_bboxes,
        shard_index=mesh.rank(),
        shard_count=mesh.world_size(),
    )
    gt_labels = None
    if gt is None:
        if cfg.num_classes > 1:
            gt, gt_labels = load_groundtruth(
                eval_tfrecords, with_labels=True, label_offset=cfg.label_offset)
        else:
            gt = load_groundtruth(eval_tfrecords)
    elif isinstance(gt, tuple):
        gt, gt_labels = gt
    results = run_detect_loop(
        cfg, state.detect_variables(), dataset, priors,
        fns=eval_fns or make_eval_fns(cfg, priors, device), device=device)
    summary = evaluate_detections(results, gt)
    if cfg.num_classes > 1 and gt_labels is not None:
        per_class = evaluate_detections_per_class(results, gt, gt_labels)
        # the agnostic COCO mAP above keeps its key; the per-class one
        # (cocoeval's own protocol) gets its own
        per_class["mAP@[.5:.95]/per_class"] = per_class.pop("mAP@[.5:.95]")
        summary.update(per_class)
    return summary


def _log_eval(step: int, metrics) -> None:
    if "mAP@0.5" in metrics:
        log.info("eval @%d: AP@0.5=%.3f mAP@0.5(per-class)=%.3f mAP=%.3f recall=%.3f",
                 step, metrics["AP@0.5"], metrics["mAP@0.5"],
                 metrics["mAP@[.5:.95]/per_class"], metrics["recall@0.5"])
    else:
        log.info("eval @%d: AP@0.5=%.3f mAP=%.3f recall=%.3f", step,
                 metrics["AP@0.5"], metrics["mAP@[.5:.95]"], metrics["recall@0.5"])


def train(
    cfg: Config,
    tfrecords: Sequence[str],
    priors: np.ndarray,
    logdir: str,
    pretrained_model: Optional[str] = None,
    max_steps: Optional[int] = None,
    use_mesh: bool = True,
    canvas_size: Optional[int] = None,
    eval_tfrecords: Optional[Sequence[str]] = None,
    eval_every_steps: int = 0,
    schedule_total: Optional[int] = None,
    shuffle: bool = True,
    device=None,
) -> TrainState:
    """Train from tfrecords; returns the final state. Resumes from
    ``logdir``'s latest checkpoint when there is one.

    Records are decoded onto a ``canvas_size`` canvas (default
    ``max(int(1.15·input_size), input_size)``, room for the random crop)
    by ``DetectionDataset``, repeated and, unless ``shuffle=False``,
    shuffled with the seed ``cfg.seed + start step``: a resumed run (or each
    ``--restart_every_steps`` child) does not replay the stream from its
    top; the seed is the same on every rank.

    Under a process group ``cfg.batch_size`` is the global batch: each rank
    reads ``cfg.batch_size // world`` images a step from its shard of the
    records (``DetectionDataset``'s round-robin, as in the JAX package), and
    the global batch is the ranks' batches in rank order.
    See :func:`train_from_batches` for the rest (``use_mesh`` there).
    """
    canvas = canvas_size or max(int(cfg.input_size * 1.15), cfg.input_size)
    world = mesh.world_size()
    if cfg.batch_size % world:
        raise ValueError(
            f"batch_size {cfg.batch_size} not divisible by the world size {world}")
    local_batch = cfg.batch_size // world

    def batches(start_step: int):
        dataset = DetectionDataset(
            tfrecords,
            batch_size=local_batch,
            canvas_size=canvas,
            max_num_bboxes=cfg.max_num_bboxes,
            shuffle=shuffle,
            repeat=True,
            seed=cfg.seed + start_step,
            decode_draft=cfg.decode_draft,
            cache_items=cfg.decode_cache_items,
            label_offset=cfg.label_offset,
            # multi-class: an out-of-range label fails loudly on the host
            num_classes=cfg.num_classes if cfg.num_classes > 1 else None,
            shard_index=mesh.rank(),
            shard_count=world,
        )
        keys = ("images", "boxes", "num_boxes") + (
            ("labels",) if cfg.num_classes > 1 else ())
        for batch in dataset:
            yield {k: batch[k] for k in keys}

    return train_from_batches(
        cfg, batches, priors, logdir, pretrained_model=pretrained_model,
        max_steps=max_steps, eval_tfrecords=eval_tfrecords,
        eval_every_steps=eval_every_steps, schedule_total=schedule_total,
        use_mesh=use_mesh, device=device)


def train_from_batches(
    cfg: Config,
    batches: Union[Iterable, Callable[[int], Iterable]],
    priors: np.ndarray,
    logdir: str,
    pretrained_model: Optional[str] = None,
    max_steps: Optional[int] = None,
    eval_tfrecords: Optional[Sequence[str]] = None,
    eval_every_steps: int = 0,
    schedule_total: Optional[int] = None,
    use_mesh: bool = True,
    device=None,
) -> TrainState:
    """Run training over a stream of host batches; returns
    the final state. Resumes from ``logdir``'s latest checkpoint when there
    is one.

    ``batches`` is an iterable of host batch dicts (``images`` uint8
    ``[B, H, W, 3]`` canvases, ``boxes [B, G, 4]``, ``num_boxes [B]``,
    optional ``labels``), or a callable that takes the step training
    starts from and returns such an iterable (so that a resumed run need
    not replay the stream from its start).

    ``max_steps`` bounds this invocation and sets the horizon of the LR
    schedule; ``schedule_total`` pins that horizon instead when one run
    spans several bounded invocations. With ``eval_tfrecords`` and
    ``eval_every_steps``, :func:`evaluate_state` runs whenever the step
    crosses a multiple of ``eval_every_steps``, and its metrics are written
    with an ``eval/`` prefix. ``device=None`` is the CUDA device (the
    rank's card under a process group).

    Under a process group of N ranks each rank passes its own local batches
    (``cfg.batch_size // N`` rows; the global batch is the ranks' batches in
    rank order). With ``use_mesh`` (the default) the state is broadcast
    from rank 0 and the step runs over the global batch
    (``parallel.make_parallel_train_step``); ``use_mesh=False`` keeps the
    JAX package's meaning, a one-device step in each process (the ranks
    then train apart). Rank 0 writes the metrics and checkpoints.
    """
    place = make_mesh(device)
    device = place.device
    if cfg.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    total = max_steps if max_steps is not None else cfg.max_number_of_steps
    horizon = schedule_total if schedule_total is not None else total
    if horizon != cfg.max_number_of_steps:
        cfg = dataclasses.replace(cfg, max_number_of_steps=horizon)
    priors = np.asarray(priors, np.float32)
    model = build_model(cfg, priors.shape[0], device=device)
    state = create_train_state(cfg, model, cfg.seed, priors.shape[0], device=device)

    # ranks reach the checkpoint directory with their start-up's skew
    coordination_barrier("train/pre_checkpoint_manager")
    ckpt = CheckpointManager(logdir, keep=cfg.keep_checkpoints,
                             save_every=cfg.save_every_steps)
    start_step = 0
    latest = ckpt.latest_known_step
    if latest is not None:
        log.info("resuming from checkpoint step %d", latest)
        state = ckpt.restore(state, device=device)
        start_step = int(latest)
    elif pretrained_model:
        state = _restore_pretrained(state, pretrained_model, device)

    step_fn = make_augmented_train_step(cfg, model, priors, device=device)
    if place.size > 1 and use_mesh:
        state = replicate_state(state)
        step_fn = make_parallel_train_step(step_fn)
    elif place.size > 1:
        log.warning("use_mesh=False under %d ranks: each rank trains on its own "
                    "shard with its own step", place.size)
    chunk = max(1, int(cfg.steps_per_host_transfer))
    cstep = make_chunked_step(step_fn, chunk) if chunk > 1 else None
    source = batches(start_step) if callable(batches) else batches
    writer = MetricsWriter(logdir, enabled=place.rank == 0)

    t_last = time.time()
    step_idx = start_step
    last_logged_step = start_step
    profiler = None
    profiled = False
    profile_start_step = start_step
    eval_fns = None
    eval_gt = None  # ground truth parsed once per run, not per eval
    pending: list = []

    def run_pending(state, pending, step_idx):
        if cstep is not None and len(pending) == chunk:
            superbatch = {k: np.stack([np.asarray(b[k]) for b in pending])
                          for k in pending[0]}
            state, metrics = cstep(state, superbatch)
            return state, metrics, step_idx + len(pending)
        metrics = None
        for b in pending:
            state, metrics = step_fn(state, b)
            step_idx += 1
        return state, metrics, step_idx

    # the ranks start the steps together, every manager made before rank 0 saves
    coordination_barrier("train/first_step")
    try:
        for batch in Prefetcher(iter(source), depth=3):
            if step_idx >= total:
                break
            pending.append(batch)
            if len(pending) < min(chunk, total - step_idx):
                continue
            # One-shot profiler window of at least profile_steps steps, armed
            # after the first (warm-up) iteration.
            if (cfg.profile_steps and not profiled and profiler is None
                    and step_idx >= start_step + 1):
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if device.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                profiler = profile(activities=acts)
                profiler.__enter__()
                profile_start_step = step_idx
            prev_step = step_idx
            state, metrics, step_idx = run_pending(state, pending, step_idx)
            pending = []
            if profiler is not None and step_idx >= profile_start_step + cfg.profile_steps:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                profiler.__exit__(None, None, None)
                profiler.export_chrome_trace(os.path.join(
                    logdir, "trace.json" if place.size == 1 else f"trace_rank{place.rank}.json"))
                profiler, profiled = None, True
                log.info("wrote profiler trace to %s", logdir)

            if (step_idx // cfg.log_every_steps > prev_step // cfg.log_every_steps
                    or step_idx == total):
                metrics = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                steps_done = step_idx - last_logged_step
                ips = cfg.batch_size * steps_done / max(now - t_last, 1e-9)
                t_last = now
                last_logged_step = step_idx
                metrics["images_per_sec"] = ips
                writer.write(step_idx, metrics)
                log.info("step %d loss=%.4f (conf=%.4f loc=%.4f) %.1f img/s",
                         step_idx, metrics["loss"], metrics["loss_conf"],
                         metrics["loss_loc"], ips)
            if (cfg.image_summary_steps
                    and step_idx // cfg.image_summary_steps
                    > prev_step // cfg.image_summary_steps):
                writer.write_images(step_idx, np.asarray(batch["images"]),
                                    np.asarray(batch["boxes"]),
                                    np.asarray(batch["num_boxes"]))
            if (eval_tfrecords and eval_every_steps
                    and step_idx // eval_every_steps > prev_step // eval_every_steps):
                if eval_fns is None:
                    from multibox_tpu_torch.cli.evaluate import load_groundtruth

                    eval_fns = make_eval_fns(cfg, priors, device)
                    if cfg.num_classes > 1:
                        eval_gt = load_groundtruth(eval_tfrecords, with_labels=True,
                                                   label_offset=cfg.label_offset)
                    else:
                        eval_gt = load_groundtruth(eval_tfrecords)
                summary = evaluate_state(cfg, state, priors, eval_tfrecords, eval_fns,
                                         gt=eval_gt, device=device)
                writer.write(step_idx, {f"eval/{k}": v for k, v in summary.items()})
                _log_eval(step_idx, summary)
            if chunk > 1:
                # step_idx advances by K: save on crossings of the cadence
                if step_idx // cfg.save_every_steps > prev_step // cfg.save_every_steps:
                    ckpt.save(step_idx, state, force=True)
            else:
                ckpt.save(step_idx, state)
        # from the manager's record: rank 0 may be writing the directory
        if ckpt.latest_known_step != step_idx:
            ckpt.save(step_idx, state, force=True)
    finally:
        if profiler is not None:
            profiler.__exit__(None, None, None)
        writer.close()
        ckpt.close()
    return state
