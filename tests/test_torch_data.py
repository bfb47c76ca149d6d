"""The port's data layer (tfrecord, Example codec, JPEG, datasets) against
the JAX package's on the CPU. Everything is host numpy or bytes, so every
comparison is exact: the same bytes written, the same records parsed, the
same batches in the same order (shuffle, shard and padding included).
"""

import os

import numpy as np
import pytest

from multibox_tpu.data import example_proto as jex
from multibox_tpu.data import jpeg as jjpeg
from multibox_tpu.data import pipeline as jpipe
from multibox_tpu.data import tfrecord as jtf
from multibox_tpu_torch.data import example_proto as tex
from multibox_tpu_torch.data import jpeg as tjpeg
from multibox_tpu_torch.data import pipeline as tpipe
from multibox_tpu_torch.data import tfrecord as ttf
from tests.conftest import random_boxes


_BYTES = np.random.default_rng(9).integers(0, 256, 353 * 1024 + 17).astype(np.uint8).tobytes()


@pytest.mark.parametrize("data", [
    b"", b"a", b"123456789", bytes(range(256)) * 3, _BYTES[:1024], _BYTES[:1025],
    _BYTES[:4159], _BYTES[:100003], _BYTES, bytes(5000), b"\xff" * 5000],
    ids=["empty", "one", "check", "short", "16_lanes", "16_lanes_and_a_byte",
         "odd_lanes", "100k", "canvas_record", "zeros", "ones"])
def test_crc_matches_the_jax_packages(data):
    """The lane-parallel CRC (long inputs) equals the byte loop and the
    JAX package's CRC exactly."""
    assert ttf.crc32c(data) == jtf.crc32c(data)
    assert ttf.crc32c(data) == ttf._crc_update(0xFFFFFFFF, data) ^ 0xFFFFFFFF
    assert ttf.masked_crc(data) == jtf.masked_crc(data)
    if data == b"123456789":
        assert ttf.crc32c(data) == 0xE3069283  # the CRC-32C check value


def write_records(path, module, records):
    with module.TFRecordWriter(str(path)) as w:
        for rec in records:
            w.write(rec)


def test_tfrecord_bytes_and_reading_match(tmp_path):
    records = [b"", b"x" * 3, os.urandom(1000)]
    write_records(tmp_path / "t.tfrecord", ttf, records)
    write_records(tmp_path / "j.tfrecord", jtf, records)
    assert (tmp_path / "t.tfrecord").read_bytes() == (tmp_path / "j.tfrecord").read_bytes()
    paths = [str(tmp_path / "t.tfrecord"), str(tmp_path / "j.tfrecord")]
    assert list(ttf.read_records(paths)) == records * 2
    assert list(ttf.read_records(paths[0], use_native=False)) == records
    assert list(ttf.read_records(paths, use_native=True)) == records * 2


def test_tfrecord_reader_refuses_corruption(tmp_path):
    path = tmp_path / "c.tfrecord"
    write_records(path, ttf, [b"payload"])
    raw = bytearray(path.read_bytes())
    raw[14] ^= 1  # a byte of the record body
    path.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corrupt record crc"):
        list(ttf.read_records(str(path)))
    assert list(ttf.read_records(str(path), verify_crc=False)) == [b"paxload"]
    path.write_bytes(bytes(raw[:15]))
    with pytest.raises(IOError, match="truncated"):
        list(ttf.read_records(str(path), verify_crc=False))


def example_args(rng, i, raw=False):
    boxes = random_boxes(rng, int(rng.integers(0, 4)))
    kw = dict(labels=list(rng.integers(1, 5, len(boxes))), height=int(rng.integers(20, 90)),
              width=int(rng.integers(20, 90)))
    if raw:
        kw["raw_canvas"] = rng.integers(0, 256, (12, 12, 3)).astype(np.uint8)
    return (os.urandom(int(rng.integers(0, 40))), f"im-{i}", boxes), kw


@pytest.mark.parametrize("raw", [False, True], ids=["jpeg", "raw_canvas"])
def test_example_codec_round_trips_across_packages(raw):
    rng = np.random.default_rng(0)
    for i in range(6):
        args, kw = example_args(rng, i, raw)
        t_bytes = tex.build_detection_example(*args, **kw)
        j_bytes = jex.build_detection_example(*args, **kw)
        assert t_bytes == j_bytes
        for parse, data in ((tex.parse_detection_example, j_bytes),
                            (jex.parse_detection_example, t_bytes)):
            got, want = parse(data), jex.parse_detection_example(j_bytes)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    assert tex.parse_example(tex.build_example({"a": [1, -2], "b": [0.5], "c": [b"x"]})) == \
        {"a": [1, -2], "b": [0.5], "c": [b"x"]}


def test_pad_boxes_matches():
    boxes = random_boxes(np.random.default_rng(1), 5)
    for n in (0, 3, 5, 8):
        got, want = tpipe.pad_boxes(boxes[:n], 4), jpipe.pad_boxes(boxes[:n], 4)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == min(n, 4)


def make_shards(root, raw):
    """Two files of 11 and 6 records: tiny JPEGs (or raw canvases), 0-5
    boxes (more than max_num_bboxes in some), 1-based labels."""
    rng = np.random.default_rng(2)
    paths = []
    for f, n in enumerate((11, 6)):
        path = str(root / f"shard{f}.tfrecord")
        with ttf.TFRecordWriter(path) as w:
            for i in range(n):
                img = rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)
                boxes = random_boxes(rng, int(rng.integers(0, 6)))
                w.write(tex.build_detection_example(
                    b"" if raw else tjpeg.encode_jpeg(img), f"f{f}-{i}", boxes,
                    labels=list(rng.integers(1, 4, len(boxes))),
                    raw_canvas=img if raw else None))
        paths.append(path)
    return paths


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k == "image_ids":
                assert g[k] == w[k]
            else:
                assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("raw", [False, True], ids=["jpeg", "raw_canvas"])
@pytest.mark.parametrize("kw", [
    dict(shuffle=False),
    dict(shuffle=True, shuffle_buffer=5, seed=3),
    dict(shuffle=True, shuffle_buffer=4, seed=1, repeat=True, take=7),
    dict(shuffle=False, shard_index=1, shard_count=3, label_offset=1, num_classes=3),
], ids=["ordered", "shuffled", "repeat", "sharded"])
def test_detection_dataset_batches_equal_the_jax_packages(tmp_path, raw, kw):
    paths = make_shards(tmp_path, raw)
    kw = dict(kw)
    take = kw.pop("take", None)
    args = dict(batch_size=4, canvas_size=16 if raw else 20, max_num_bboxes=3,
                num_decode_threads=2, **kw)
    got, want = [], []
    for ds, out in ((tpipe.DetectionDataset(paths, **args), got),
                    (jpipe.DetectionDataset(paths, **args), want)):
        for batch in ds:
            out.append(batch)
            if take and len(out) == take:
                break
    assert_batches_equal(got, want)
    if not kw.get("repeat"):
        assert want[-1]["batch_valid"] <= 4  # a padded last batch, not dropped


def test_detection_dataset_resizes_a_raw_canvas_and_refuses_bad_labels(tmp_path):
    paths = make_shards(tmp_path, raw=True)
    args = dict(batch_size=5, canvas_size=10, max_num_bboxes=3)
    assert_batches_equal(list(tpipe.DetectionDataset(paths, **args)),
                         list(jpipe.DetectionDataset(paths, **args)))
    with pytest.raises(ValueError, match="outside"):
        list(tpipe.DetectionDataset(paths, num_classes=2, **args))


def test_jpeg_decode_and_image_files_match(tmp_path):
    rng = np.random.default_rng(4)
    files = []
    for i in range(5):
        img = rng.integers(0, 256, (int(rng.integers(10, 30)), 21, 3)).astype(np.uint8)
        data = tjpeg.encode_jpeg(img)
        assert data == jjpeg.encode_jpeg(img)
        for kw in ({}, {"canvas": 17}, {"canvas": 8, "draft": True}):
            np.testing.assert_array_equal(tjpeg.decode_jpeg(data, **kw),
                                          jjpeg.decode_jpeg(data, **kw))
        path = tmp_path / f"img{i}.jpg"
        path.write_bytes(data)
        files.append(str(path))
    # the native decoder is opt-in; its full decode is libjpeg's, as PIL's
    # (tests/test_torch_native.py holds it bitwise to the JAX package's)
    native = tjpeg.decode_jpeg(data, backend="native")
    assert native.shape == tjpeg.decode_jpeg(data).shape
    assert np.abs(native.astype(int) - tjpeg.decode_jpeg(data)).mean() < 1.0
    tds = tpipe.ImageFileDataset(files, batch_size=2, canvas_size=12)
    jds = jpipe.ImageFileDataset(files, batch_size=2, canvas_size=12)
    assert_batches_equal(list(tds), list(jds))
    assert tds.sizes == jds.sizes and len(tds.sizes) == 5
