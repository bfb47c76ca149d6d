"""Host-side dataset: tfrecords → decoded, padded, batched numpy.

Own copy of the JAX package's ``data/pipeline.py``: the same record order
(shuffle and shard), decode and padding, so both packages see the same
batches. The host does only what the device can't: file IO, Example
parsing, JPEG entropy decode (a thread pool) and padding to static shapes.
Batches come out as numpy dicts; all augmentation runs on the device
afterwards (``data.augment``). N decode threads → bounded queue
(:class:`Prefetcher`) → the training or detect loop.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from multibox_tpu_torch.data import jpeg as jpeg_mod
from multibox_tpu_torch.data.example_proto import parse_detection_example
from multibox_tpu_torch.data.tfrecord import read_records


def pad_boxes(boxes: np.ndarray, max_num: int):
    """Pad/truncate ``[N, 4]`` boxes to ``[max_num, 4]`` + valid count."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    n = min(len(boxes), max_num)
    out = np.zeros((max_num, 4), np.float32)
    out[:n] = boxes[:n]
    return out, np.int32(n)


class DetectionDataset:
    """Batched detection dataset over tfrecord files.

    Yields dicts:
      images    [B, canvas, canvas, 3] uint8
      boxes     [B, max_num_bboxes, 4] float32
      num_boxes [B] int32
      image_ids list[str] (host-side metadata, not shipped to device)
    """

    def __init__(
        self,
        tfrecord_paths: Sequence[str],
        batch_size: int,
        canvas_size: int = 330,
        max_num_bboxes: int = 16,
        shuffle: bool = False,
        shuffle_buffer: int = 512,
        num_decode_threads: int = 8,
        repeat: bool = False,
        seed: int = 0,
        drop_remainder: Optional[bool] = None,
        decode_draft: bool = False,
        cache_items: int = 0,
        label_offset: int = 0,
        num_classes: Optional[int] = None,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        """See class docstring. Host-decode knobs:

        decode_draft: libjpeg DCT-scaled decode (big win when sources are
          much larger than the canvas; training-input option — pixels
          differ slightly from the full-decode path).
        cache_items: keep up to N decoded items in RAM keyed by image_id —
          epochs after the first skip JPEG decode entirely. At canvas 330
          an item is ~330 KB; size to the host's memory. 0 = off.
        Records carrying a pre-decoded ``image/raw`` canvas (written by
        ``build_detection_example(raw_canvas=...)``) always skip decode.

        label_offset is subtracted from raw tfrecord class labels (1 for
        conventional 1-based datasets where 0 = background). When
        num_classes is given, any offset label outside [0, num_classes)
        raises — a silently out-of-range label would otherwise train real
        objects as background (all-zero onehot at matched priors).

        shard_index/shard_count: multi-HOST data parallelism — each
        process keeps records where ``i % shard_count == shard_index``
        (record-level round-robin: exact and balanced regardless of file
        count, unlike file-level splits). Every host still READS all
        records (raw IO is cheap; the expensive parse/decode is skipped
        for foreign records). The train loop, periodic eval and the detect
        CLI wire this from the process's rank under a process group
        (``parallel``); one process reads everything.
        """
        self.paths = list(map(str, tfrecord_paths))
        self.batch_size = batch_size
        self.canvas_size = canvas_size
        self.max_num_bboxes = max_num_bboxes
        self.shuffle = shuffle
        self.shuffle_buffer = shuffle_buffer
        self.num_decode_threads = num_decode_threads
        self.repeat = repeat
        self.seed = seed
        self.decode_draft = decode_draft
        self.cache_items = cache_items
        self.label_offset = label_offset
        self.num_classes = num_classes
        if not 0 <= shard_index < shard_count:
            raise ValueError(
                f"shard_index {shard_index} outside [0, {shard_count})"
            )
        self.shard_index = shard_index
        self.shard_count = shard_count
        self._cache: Dict[str, Dict] = {}
        # Train-style usage (repeat) keeps static batch shapes; one-shot
        # eval pads the final partial batch instead of dropping it.
        self.drop_remainder = repeat if drop_remainder is None else drop_remainder

    def _shard(self, records: Iterator[bytes]) -> Iterator[bytes]:
        """Record-level round-robin shard filter (multi-host DP)."""
        if self.shard_count == 1:
            yield from records
            return
        for i, rec in enumerate(records):
            if i % self.shard_count == self.shard_index:
                yield rec

    def _records(self) -> Iterator[bytes]:
        rng = np.random.default_rng(self.seed)
        # Path order must be IDENTICAL on every host of a sharded run, so
        # it gets its own rng: the reservoir rng below consumes a
        # shard-dependent number of draws, and sharing one stream would
        # desynchronize epoch-2+ path orders across hosts (overlapping /
        # dropped records).
        path_rng = np.random.default_rng(rng.integers(2**63))
        if not self.shuffle:
            while True:
                yield from self._shard(read_records(list(self.paths)))
                if not self.repeat:
                    return
        # Reservoir shuffle with a PERSISTENT buffer: when repeating, the
        # buffer stays warm across epoch boundaries so late-epoch-N records
        # mix with early-epoch-N+1 records (draining it every epoch would
        # weaken cross-epoch mixing — round-1 review finding).
        buf: List[bytes] = []
        while True:
            paths = list(self.paths)
            path_rng.shuffle(paths)
            for rec in self._shard(read_records(paths)):
                buf.append(rec)
                if len(buf) >= self.shuffle_buffer:
                    idx = rng.integers(len(buf))
                    buf[idx], buf[-1] = buf[-1], buf[idx]
                    yield buf.pop()
            if not self.repeat:
                rng.shuffle(buf)
                yield from buf
                return

    def _decode_one(self, record: bytes) -> Dict:
        ex = parse_detection_example(record)
        if self.cache_items:
            cached = self._cache.get(ex["image_id"])
            if cached is not None:
                return cached
        raw = ex.get("raw")
        if raw is not None:
            # Pre-decoded canvas shard: no JPEG decode on this host at all.
            image = (
                raw
                if raw.shape[0] == self.canvas_size
                else jpeg_mod._resize_np(raw, self.canvas_size)
            )
        else:
            image = jpeg_mod.decode_jpeg(
                ex["image_bytes"],
                canvas=self.canvas_size,
                draft=self.decode_draft,
            )
        boxes, n = pad_boxes(ex["boxes"], self.max_num_bboxes)
        labels = np.zeros((self.max_num_bboxes,), np.int32)
        k = min(len(ex["labels"]), self.max_num_bboxes)
        labels[:k] = np.asarray(ex["labels"][:k], np.int64) - self.label_offset
        if self.num_classes is not None and k:
            bad = (labels[:k] < 0) | (labels[:k] >= self.num_classes)
            if bad.any():
                raise ValueError(
                    f"image {ex['image_id']!r}: class labels "
                    f"{sorted(set(labels[:k][bad].tolist()))} outside "
                    f"[0, {self.num_classes}) after label_offset="
                    f"{self.label_offset} — check the dataset's label base "
                    "(1-based datasets need label_offset: 1) or num_classes"
                )
        item = {
            "image": image,
            "boxes": boxes,
            "num_boxes": n,
            "image_id": ex["image_id"],
            "labels": labels,
        }
        if self.cache_items and len(self._cache) < self.cache_items:
            # dict set is GIL-atomic; items are treated as read-only
            # downstream (_collate copies into the batch arrays).
            self._cache[ex["image_id"]] = item
        return item

    def _decoded(self) -> Iterator[Dict]:
        """Threaded decode with a bounded in-flight window.

        (NOT ``Executor.map`` — that consumes the whole input iterable
        eagerly, which never returns on a ``repeat=True`` record stream.)
        """
        from collections import deque

        window = max(2 * self.num_decode_threads, 8)
        with ThreadPoolExecutor(max_workers=self.num_decode_threads) as pool:
            records = self._records()
            futures: deque = deque()
            try:
                for rec in records:
                    futures.append(pool.submit(self._decode_one, rec))
                    if len(futures) >= window:
                        yield futures.popleft().result()
                while futures:
                    yield futures.popleft().result()
            finally:
                for f in futures:
                    f.cancel()

    def __iter__(self) -> Iterator[Dict]:
        batch: List[Dict] = []
        for item in self._decoded():
            batch.append(item)
            if len(batch) == self.batch_size:
                yield self._collate(batch)
                batch = []
        if batch and not self.drop_remainder:
            yield self._collate(batch, pad_to=self.batch_size)

    def _collate(self, items: List[Dict], pad_to: Optional[int] = None) -> Dict:
        n = len(items)
        size = pad_to or n
        images = np.zeros(
            (size, self.canvas_size, self.canvas_size, 3), np.uint8
        )
        boxes = np.zeros((size, self.max_num_bboxes, 4), np.float32)
        num_boxes = np.zeros((size,), np.int32)
        labels = np.zeros((size, self.max_num_bboxes), np.int32)
        ids = []
        for i, item in enumerate(items):
            images[i] = item["image"]
            boxes[i] = item["boxes"]
            num_boxes[i] = item["num_boxes"]
            labels[i] = item["labels"]
            ids.append(item["image_id"])
        ids += [""] * (size - n)
        return {
            "images": images,
            "boxes": boxes,
            "num_boxes": num_boxes,
            "labels": labels,
            "image_ids": ids,
            "batch_valid": np.int32(n),
        }


class ImageFileDataset:
    """Batched detection input from raw image FILES (any PIL-decodable
    format — JPEG, PNG, …) instead of tfrecords: the
    ``multibox-torch-detect --images`` path for users without a tfrecord
    pipeline. Yields the batch-dict surface ``inference.run_detect_loop``
    consumes (``images`` uint8 [B, canvas, canvas, 3], ``image_ids``,
    ``batch_valid``), padding the final partial batch.

    ``image_id`` is the file basename when unique across the input set,
    else the full path. After iteration ``self.sizes`` maps image_id →
    source (height, width) in pixels (COCO-format export needs them).

    shard_index/shard_count: multi-HOST data parallelism, same round-robin
    rule as ``DetectionDataset`` — this process keeps files where
    ``i % shard_count == shard_index`` over the GLOBAL path order, so the
    shards partition the input exactly. Id uniqueness is decided on the
    global set (every process must assign the same id to the same file —
    the post-gather merge keys on it). ``self.sizes`` covers only this
    process's shard (the detect CLI gathers them).
    """

    def __init__(self, paths: Sequence[str], batch_size: int,
                 canvas_size: int, shard_index: int = 0,
                 shard_count: int = 1):
        paths = [str(p) for p in paths]
        if not paths:
            raise ValueError("no image files given")
        if not 0 <= shard_index < shard_count:
            raise ValueError(
                f"shard_index {shard_index} outside [0, {shard_count})"
            )
        names = [os.path.basename(p) for p in paths]
        unique = len(set(names)) == len(names)
        self._ids = {
            p: (os.path.basename(p) if unique else p) for p in paths
        }
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.paths = (
            paths if shard_count == 1
            else [p for i, p in enumerate(paths)
                  if i % shard_count == shard_index]
        )
        self.batch_size = batch_size
        self.canvas_size = canvas_size
        self.sizes: Dict[str, tuple] = {}

    def _decode(self, path: str) -> Dict:
        import io

        from PIL import Image

        data = open(path, "rb").read()
        with Image.open(io.BytesIO(data)) as im:
            w, h = im.size  # lazy header read — no full decode
        image_id = self._ids[path]
        self.sizes[image_id] = (h, w)
        return {
            "image": jpeg_mod.decode_jpeg(data, canvas=self.canvas_size),
            "image_id": image_id,
        }

    def __iter__(self):
        buf = []
        for path in self.paths:
            buf.append(self._decode(path))
            if len(buf) == self.batch_size:
                yield self._collate(buf)
                buf = []
        if buf:
            yield self._collate(buf)

    def _collate(self, items) -> Dict:
        n = len(items)
        images = np.zeros(
            (self.batch_size, self.canvas_size, self.canvas_size, 3),
            np.uint8,
        )
        ids = []
        for i, item in enumerate(items):
            images[i] = item["image"]
            ids.append(item["image_id"])
        ids += [""] * (self.batch_size - n)
        return {
            "images": images,
            "image_ids": ids,
            "batch_valid": np.int32(n),
        }


class Prefetcher:
    """Bounded background prefetch: overlaps host decode with device steps.

    Exceptions raised in the producer (corrupt records, decode failures)
    are re-raised in the consumer — a failing pipeline must never look
    like a clean end-of-stream."""

    def __init__(self, iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._iterable = iterable
        self._done = object()
        self._error = None
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._iterable:
                self._q.put(item)
        except BaseException as e:  # re-raised on the consumer side
            self._error = e
        finally:
            self._q.put(self._done)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._done:
                if self._error is not None:
                    raise self._error
                return
            yield item
