"""Minimal tf.Example protobuf wire codec (no protobuf/TF dependency).

Own copy of the JAX package's ``data/example_proto.py``, unchanged, so the
port reads and writes the same records without importing it.

Implements exactly the subset of the protobuf wire format that
``tf.train.Example`` uses, so the framework can read/write the reference's
tfrecord schema (SURVEY.md §2 C14):

    Example        { Features features = 1; }
    Features       { map<string, Feature> feature = 1; }
    Feature        { oneof { BytesList(1) | FloatList(2) | Int64List(3) } }
    BytesList      { repeated bytes value = 1; }
    FloatList      { repeated float value = 1 [packed]; }
    Int64List      { repeated int64 value = 1 [packed]; }

Detection schema (the TF object-detection standard, used by the companion
dataset-builder repo the reference points at):
    image/encoded           bytes (JPEG)
    image/id | image/source_id   bytes
    image/height, image/width    int64
    image/object/bbox/{ymin,xmin,ymax,xmax}   float lists (normalized)
    image/object/class/label     int64 list (optional)
"""

from __future__ import annotations

import logging
import struct
from typing import Dict, List, Tuple, Union

FeatureValue = Union[List[bytes], List[float], List[int]]


# ---------------------------------------------------------------------------
# varint + wire primitives
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        _, pos = _read_varint(buf, pos)
        return pos
    if wire_type == 1:  # 64-bit
        return pos + 8
    if wire_type == 2:  # length-delimited
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wire_type == 5:  # 32-bit
        return pos + 4
    raise ValueError(f"unsupported wire type {wire_type}")


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------


def _parse_feature(buf: bytes) -> FeatureValue:
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        n, pos = _read_varint(buf, pos)
        payload = buf[pos : pos + n]
        pos += n
        if field == 1:  # BytesList
            return _parse_bytes_list(payload)
        if field == 2:  # FloatList
            return _parse_float_list(payload)
        if field == 3:  # Int64List
            return _parse_int64_list(payload)
        del wire
    return []


def _parse_bytes_list(buf: bytes) -> List[bytes]:
    out, pos = [], 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        n, pos = _read_varint(buf, pos)
        out.append(buf[pos : pos + n])
        pos += n
        del tag
    return out


def _parse_float_list(buf: bytes) -> List[float]:
    out, pos = [], 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        wire = tag & 7
        if wire == 2:  # packed
            n, pos = _read_varint(buf, pos)
            out.extend(struct.unpack(f"<{n // 4}f", buf[pos : pos + n]))
            pos += n
        else:  # unpacked single float
            out.append(struct.unpack("<f", buf[pos : pos + 4])[0])
            pos += 4
    return out


def _parse_int64_list(buf: bytes) -> List[int]:
    out, pos = [], 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        wire = tag & 7
        if wire == 2:  # packed
            n, pos = _read_varint(buf, pos)
            end = pos + n
            while pos < end:
                v, pos = _read_varint(buf, pos)
                out.append(_to_signed(v))
        else:
            v, pos = _read_varint(buf, pos)
            out.append(_to_signed(v))
    return out


def _to_signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def parse_example(serialized: bytes) -> Dict[str, FeatureValue]:
    """serialized tf.Example → {feature name: list of values}."""
    features: Dict[str, FeatureValue] = {}
    pos = 0
    buf = serialized
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field != 1 or wire != 2:  # not Features; skip
            pos = _skip_field(buf, pos, wire)
            continue
        n, pos = _read_varint(buf, pos)
        features_buf = buf[pos : pos + n]
        pos += n
        fpos = 0
        while fpos < len(features_buf):
            ftag, fpos = _read_varint(features_buf, fpos)
            if ftag >> 3 != 1 or ftag & 7 != 2:
                fpos = _skip_field(features_buf, fpos, ftag & 7)
                continue
            fn, fpos = _read_varint(features_buf, fpos)
            entry = features_buf[fpos : fpos + fn]
            fpos += fn
            # map entry: key(1)=string, value(2)=Feature
            key, value = b"", b""
            epos = 0
            while epos < len(entry):
                etag, epos = _read_varint(entry, epos)
                en, epos = _read_varint(entry, epos)
                if etag >> 3 == 1:
                    key = entry[epos : epos + en]
                else:
                    value = entry[epos : epos + en]
                epos += en
            features[key.decode("utf-8")] = _parse_feature(value)
    return features


# ---------------------------------------------------------------------------
# building
# ---------------------------------------------------------------------------


def _encode_length_delimited(out: bytearray, field: int, payload: bytes) -> None:
    _write_varint(out, (field << 3) | 2)
    _write_varint(out, len(payload))
    out.extend(payload)


def _encode_feature(value: FeatureValue) -> bytes:
    inner = bytearray()
    if not value:
        pass
    elif isinstance(value[0], (bytes, str)):
        lst = bytearray()
        for v in value:
            if isinstance(v, str):
                v = v.encode("utf-8")
            _encode_length_delimited(lst, 1, v)
        _encode_length_delimited(inner, 1, bytes(lst))
    elif isinstance(value[0], float):
        packed = struct.pack(f"<{len(value)}f", *value)
        lst = bytearray()
        _encode_length_delimited(lst, 1, packed)
        _encode_length_delimited(inner, 2, bytes(lst))
    elif isinstance(value[0], int):
        packed = bytearray()
        for v in value:
            _write_varint(packed, v & 0xFFFFFFFFFFFFFFFF)
        lst = bytearray()
        _encode_length_delimited(lst, 1, bytes(packed))
        _encode_length_delimited(inner, 3, bytes(lst))
    else:
        raise TypeError(f"unsupported feature value type: {type(value[0])}")
    return bytes(inner)


def build_example(features: Dict[str, FeatureValue]) -> bytes:
    """{feature name: values} → serialized tf.Example bytes."""
    fbuf = bytearray()
    for key, value in features.items():
        entry = bytearray()
        _encode_length_delimited(entry, 1, key.encode("utf-8"))
        _encode_length_delimited(entry, 2, _encode_feature(value))
        _encode_length_delimited(fbuf, 1, bytes(entry))
    out = bytearray()
    _encode_length_delimited(out, 1, bytes(fbuf))
    return bytes(out)


# ---------------------------------------------------------------------------
# detection schema
# ---------------------------------------------------------------------------


def parse_detection_example(serialized: bytes) -> Dict:
    """Parse the standard detection Example into a plain dict:
    {image_bytes, image_id, boxes [N,4] float numpy (ymin,xmin,ymax,xmax),
     labels [N] int numpy}."""
    import numpy as np

    f = parse_example(serialized)
    image = f.get("image/encoded", [b""])[0]
    image_id = f.get("image/id", f.get("image/source_id", f.get("image/filename", [b""])))[0]
    if isinstance(image_id, bytes):
        image_id = image_id.decode("utf-8", "replace")
    ymin = np.asarray(f.get("image/object/bbox/ymin", []), np.float32)
    xmin = np.asarray(f.get("image/object/bbox/xmin", []), np.float32)
    ymax = np.asarray(f.get("image/object/bbox/ymax", []), np.float32)
    xmax = np.asarray(f.get("image/object/bbox/xmax", []), np.float32)
    boxes = np.stack([ymin, xmin, ymax, xmax], axis=-1) if len(ymin) else np.zeros(
        (0, 4), np.float32
    )
    labels = np.asarray(f.get("image/object/class/label", []), np.int64)
    out = {
        "image_bytes": image,
        "image_id": image_id,
        "boxes": boxes,
        "labels": labels,
    }
    # Source pixel dimensions (standard image/height + image/width int64
    # features) — needed by size-stratified COCO eval, where area bands
    # are defined in source-image pixels, not normalized units.
    if f.get("image/height") and f.get("image/width"):
        out["height"] = int(f["image/height"][0])
        out["width"] = int(f["image/width"][0])
    # Pre-decoded canvas shards (rebuild extension for decode-bound hosts):
    # raw uint8 RGB at a fixed square canvas, written by
    # `multibox-dataset --store_raw_canvas`.
    raw = f.get("image/raw")
    if raw:
        size = int(f.get("image/raw_size", [0])[0])
        if size and len(raw[0]) == size * size * 3:
            out["raw"] = np.frombuffer(raw[0], np.uint8).reshape(
                size, size, 3
            )
        else:
            # A present-but-malformed raw canvas silently falling back to
            # JPEG decode loses the shard's entire performance benefit;
            # make corruption / writer-reader size mismatch visible (once).
            global _warned_bad_raw
            if not _warned_bad_raw:
                _warned_bad_raw = True
                logging.getLogger(__name__).warning(
                    "image/raw present but malformed (raw_size=%d, %d bytes,"
                    " expected %d) — falling back to JPEG decode; further"
                    " occurrences suppressed",
                    size, len(raw[0]), size * size * 3,
                )
    return out


_warned_bad_raw = False


def build_detection_example(
    image_bytes: bytes, image_id: str, boxes, labels=None, height=None,
    width=None, raw_canvas=None,
) -> bytes:
    """Build a standard detection Example (fixtures + dataset-builder CLI).

    ``raw_canvas``: optional pre-decoded square uint8 RGB array — stored as
    ``image/raw`` + ``image/raw_size`` alongside (or instead of) the JPEG,
    letting the input pipeline skip host JPEG decode entirely (the 1-core
    host's bottleneck; see PARITY.md / README perf notes).
    """
    import numpy as np

    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    feats = {
        "image/encoded": [image_bytes],
        "image/format": [b"jpeg"],
        "image/id": [image_id.encode("utf-8")],
        "image/object/bbox/ymin": [float(v) for v in boxes[:, 0]],
        "image/object/bbox/xmin": [float(v) for v in boxes[:, 1]],
        "image/object/bbox/ymax": [float(v) for v in boxes[:, 2]],
        "image/object/bbox/xmax": [float(v) for v in boxes[:, 3]],
    }
    if labels is not None:
        feats["image/object/class/label"] = [int(v) for v in labels]
    if height is not None:
        feats["image/height"] = [int(height)]
        feats["image/width"] = [int(width)]
    if raw_canvas is not None:
        raw_canvas = np.ascontiguousarray(raw_canvas, np.uint8)
        s = raw_canvas.shape[0]
        if raw_canvas.shape != (s, s, 3):
            raise ValueError(f"raw_canvas must be square RGB, got {raw_canvas.shape}")
        feats["image/raw"] = [raw_canvas.tobytes()]
        feats["image/raw_size"] = [s]
    return build_example(feats)
