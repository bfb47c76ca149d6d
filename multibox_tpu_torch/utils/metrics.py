"""Metrics writer: JSONL always, TensorBoard events when TensorFlow imports.

Scalar names follow the JAX package's (loss, loss_conf, loss_loc,
learning_rate, images_per_sec). Own copy of that package's
``utils/metrics.py``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


def burn_boxes(images: np.ndarray, boxes: np.ndarray, nums: np.ndarray) -> np.ndarray:
    """Burn 1-px green gt rectangles into uint8 canvases.

    images ``[N, H, W, 3]`` uint8, boxes ``[N, G, 4]`` normalized
    (ymin, xmin, ymax, xmax), nums ``[N]`` valid counts. Host-side numpy,
    for image summaries.
    """
    out = np.array(images, copy=True)
    H, W = out.shape[1], out.shape[2]
    green = np.array([0, 255, 0], out.dtype)
    for i in range(out.shape[0]):
        for b in np.asarray(boxes[i, : int(nums[i])]):
            y0, y1 = sorted(int(round(float(v) * (H - 1))) for v in (b[0], b[2]))
            x0, x1 = sorted(int(round(float(v) * (W - 1))) for v in (b[1], b[3]))
            y0, y1 = max(0, y0), min(H - 1, y1)
            x0, x1 = max(0, x0), min(W - 1, x1)
            out[i, y0 : y1 + 1, (x0, x1)] = green
            out[i, (y0, y1), x0 : x1 + 1] = green
    return out


class MetricsWriter:
    """Appends one JSON record a call to ``<logdir>/metrics.jsonl``; with
    TensorFlow importable, writes the same scalars as TensorBoard events.
    ``enabled=False`` (every rank but 0 of a data-parallel run) opens
    nothing, and every method does nothing."""

    def __init__(self, logdir: str, enabled: bool = True):
        self._tb = None
        self._jsonl = None
        self.enabled = enabled
        if not enabled:
            return
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        try:
            import tensorflow as tf

            # TensorFlow only writes event files here: keep it off the GPU,
            # whose memory it would otherwise reserve
            try:
                tf.config.set_visible_devices([], "GPU")
            except RuntimeError:  # its devices were initialized already
                pass
            self._tb = tf.summary.create_file_writer(logdir)
        except Exception:
            self._tb = None

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        if not self.enabled:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            import tensorflow as tf

            with self._tb.as_default():
                for k, v in scalars.items():
                    tf.summary.scalar(k, float(v), step=int(step))
            self._tb.flush()

    def write_images(
        self,
        step: int,
        images: np.ndarray,
        boxes: Optional[np.ndarray] = None,
        nums: Optional[np.ndarray] = None,
        tag: str = "inputs",
        max_images: int = 4,
    ) -> None:
        """TensorBoard image summary of host input canvases with the gt
        boxes burned in (pre-augmentation: augmentation runs on the
        device). No-op without TensorFlow."""
        if self._tb is None:
            return
        import tensorflow as tf

        imgs = np.asarray(images[:max_images])
        if imgs.dtype != np.uint8:
            imgs = np.clip(imgs, 0, 255).astype(np.uint8)
        if boxes is not None and nums is not None:
            imgs = burn_boxes(imgs, boxes[:max_images], nums[:max_images])
        with self._tb.as_default():
            tf.summary.image(tag, imgs, step=int(step), max_outputs=max_images)
        self._tb.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
