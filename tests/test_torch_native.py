"""The port's native layer (``data/_native.py`` over ``native/*.cc``, built
with g++ at first use) against the JAX package on the CPU.

Records are compared byte for byte with the JAX package's Python reader
(``read_records(..., use_native=False)``), errors by type and message, the
CRC exactly with both packages' ``crc32c``. The native JPEG decoder is held
bitwise to the JAX package's: its ``jpeg_decode.cc`` is compiled here into
the test's own directory and called through ctypes (``make`` in
``multibox_tpu/native`` belongs to ``tests/test_native.py``, which may run
in another worker at the same time).
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest

from multibox_tpu.data import jpeg as jjpeg
from multibox_tpu.data import tfrecord as jtf
from multibox_tpu_torch.data import _native
from multibox_tpu_torch.data import jpeg as tjpeg
from multibox_tpu_torch.data import pipeline as tpipe
from multibox_tpu_torch.data import tfrecord as ttf
from tests.test_torch_data import make_shards

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write(path, records):
    with jtf.TFRecordWriter(str(path)) as w:
        for rec in records:
            w.write(rec)
    return str(path)


def outcome(read):
    """The records a read yields, or the type and message it raises."""
    try:
        return list(read())
    except Exception as e:  # compared as data: type and message
        return (type(e), str(e))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("records")
    rng = np.random.default_rng(0)
    paths, records = [], []
    for f in range(3):
        recs = [rng.integers(0, 256, int(rng.integers(0, 5000))).astype(np.uint8).tobytes()
                for _ in range(20)] + [b""]
        paths.append(write(root / f"f{f}.tfrecord", recs))
        records += recs
    paths.append(write(root / "canvas.tfrecord", [bytes(353 * 1024 + 3)]))
    empty = root / "empty.tfrecord"
    empty.write_bytes(b"")
    good = (root / "f0.tfrecord").read_bytes()
    corrupt = bytearray(good)
    corrupt[14] ^= 0xFF  # a byte of the first record's body
    (root / "corrupt_body.tfrecord").write_bytes(bytes(corrupt))
    corrupt = bytearray(good)
    corrupt[3] ^= 0x01  # the length field
    (root / "corrupt_length.tfrecord").write_bytes(bytes(corrupt))
    (root / "header.tfrecord").write_bytes(good + good[:7])
    (root / "body.tfrecord").write_bytes(good[:30])
    return {"root": root, "paths": paths, "records": records + [bytes(353 * 1024 + 3)],
            "empty": str(empty)}


def test_native_reader_yields_the_jax_readers_records(files):
    paths = files["paths"]
    want = list(jtf.read_records(paths, use_native=False))
    assert want == files["records"]
    assert list(_native.read_records(paths)) == want
    assert list(ttf.read_records(paths)) == want
    assert list(ttf.read_records(paths, use_native=True)) == want
    assert list(ttf.read_records(paths, use_native=False)) == want
    # one path, a path-like, the empty file between two others
    assert list(ttf.read_records(paths[0])) == list(jtf.read_records(paths[0],
                                                                     use_native=False))
    mixed = [paths[1], files["empty"], files["root"] / "f2.tfrecord"]
    assert list(ttf.read_records(mixed)) == list(jtf.read_records(mixed, use_native=False))
    assert list(ttf.read_records([files["empty"]])) == []


@pytest.mark.parametrize("name", ["corrupt_body", "corrupt_length", "header", "body",
                                  "missing", "directory"])
@pytest.mark.parametrize("verify_crc", [True, False], ids=["crc", "no_crc"])
def test_native_reader_fails_as_the_python_reader_does(files, name, verify_crc):
    """The same records before the fault, then the same error: a corrupt
    CRC, a truncated header or body (a corrupt length read unchecked reads
    as one), the ``OSError`` of ``open``."""
    root = files["root"]
    bad = {"missing": root / "nope" / "x.tfrecord", "directory": root}.get(
        name, root / f"{name}.tfrecord")
    paths = [files["paths"][1], str(bad)]
    native = outcome(lambda: ttf.read_records(paths, verify_crc=verify_crc))
    python = outcome(lambda: jtf.read_records(paths, verify_crc=verify_crc, use_native=False))
    assert native == python
    if name == "corrupt_body" and not verify_crc:
        assert isinstance(native, list)  # unchecked, the records come through
    else:
        assert isinstance(native, tuple) and issubclass(native[0], OSError)


def test_native_reader_yields_records_before_the_fault(files):
    stream = ttf.read_records([files["paths"][0], str(files["root"] / "nope")])
    got = [next(stream) for _ in range(21)]
    assert got == files["records"][:21]
    with pytest.raises(FileNotFoundError, match="No such file"):
        next(stream)


@pytest.mark.parametrize("data", [
    b"", b"a", b"123456789", bytes(range(256)) * 3, bytes(7) + b"\xff" * 1001,
    np.random.default_rng(9).integers(0, 256, 353 * 1024 + 17).astype(np.uint8).tobytes()],
    ids=["empty", "one", "check", "short", "odd", "canvas_record"])
def test_native_crc_equals_both_packages(data):
    assert _native.crc32c(data) == ttf.crc32c(data) == jtf.crc32c(data)
    assert _native.masked_crc(data) == ttf.masked_crc(data) == jtf.masked_crc(data)


def test_table_crc_off_x86_is_the_same_crc(monkeypatch, tmp_path):
    """Without ``-msse4.2`` (what a machine other than x86 builds) the
    source takes its table CRC: the same values."""
    monkeypatch.setattr(_native, "machine", lambda: "aarch64")
    monkeypatch.setattr(_native, "_BUILD_DIR", str(tmp_path))
    assert "-msse4.2" not in _native.cxx_flags()
    lib = ctypes.CDLL(_native.build("tfrecord_reader"))
    lib.mbx_crc32c.restype = ctypes.c_uint32
    lib.mbx_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    for data in (b"", b"123456789", bytes(range(256)) * 40 + b"x"):
        assert lib.mbx_crc32c(data, len(data)) == jtf.crc32c(data)
    monkeypatch.setattr(_native, "machine", lambda: "x86_64")
    assert "-msse4.2" in _native.cxx_flags()


def test_stream_closed_early_stops_its_reader_thread(files):
    """A generator closed mid-file (as a shuffled or repeated dataset drops
    it) closes its stream: the reader thread is joined."""
    before = len(os.listdir("/proc/self/task"))
    for _ in range(20):
        stream = ttf.read_records(files["paths"])
        next(stream)
        stream.close()
    ds = tpipe.DetectionDataset(make_shards(files["root"], raw=True), batch_size=4,
                                canvas_size=16, max_num_bboxes=3, shuffle=True,
                                shuffle_buffer=3, repeat=True, num_decode_threads=2)
    batches = iter(ds)
    for _ in range(12):  # a few epochs of 17 records
        next(batches)
    batches.close()
    assert len(os.listdir("/proc/self/task")) <= before


def test_read_records_takes_the_native_reader_and_never_falls_back(files, monkeypatch):
    calls = []
    real = _native.read_records

    def spy(paths, verify_crc=True):
        calls.append(list(paths))
        return real(paths, verify_crc=verify_crc)

    monkeypatch.setattr(_native, "read_records", spy)
    list(ttf.read_records(files["paths"][0]))
    list(ttf.read_records(files["paths"][0], use_native=True))
    list(ttf.read_records(files["paths"][0], use_native=False))
    assert calls == [[files["paths"][0]]] * 2
    monkeypatch.setattr(_native, "read_records", real)

    def broken(name):
        raise RuntimeError(f"g++ failed on {name}.cc: (test)")

    monkeypatch.setattr(_native, "_libs", {})
    monkeypatch.setattr(_native, "build", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        list(ttf.read_records(files["paths"][0]))


def test_failed_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "tfrecord_reader.cc").write_text("int main( { return 0; }\n")
    monkeypatch.setattr(_native, "_SRC", str(src))
    monkeypatch.setattr(_native, "_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on tfrecord_reader.cc") as e:
        _native.build("tfrecord_reader")
    assert "error" in str(e.value)
    assert not os.path.exists(tmp_path / "build") or not os.listdir(tmp_path / "build")


def test_missing_jpeg_header_raises_naming_it(monkeypatch, tmp_path):
    monkeypatch.setattr(_native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_native, "jpeg_headers_present", lambda: False)
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        _native.build("jpeg_decode")


def test_concurrent_builds_end_in_one_library(tmp_path):
    """Several processes building at once (the test workers do): each gets
    the same complete library, written under a temporary name and moved
    into place."""
    code = ("import sys; from multibox_tpu_torch.data import _native; "
            f"_native._BUILD_DIR = {str(tmp_path)!r}; "
            "lib = _native.reader_library(); print(_native.build('tfrecord_reader')); "
            "print(lib.mbx_crc32c(b'123456789', 9))")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert len({o.split()[0] for o, _ in outs}) == 1
    assert {o.split()[1] for o, _ in outs} == {str(0xE3069283)}
    assert [n for n in os.listdir(tmp_path) if n.endswith(".so")] == \
        [os.path.basename(outs[0][0].split()[0])]
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


@pytest.fixture(scope="module")
def jax_decoder(tmp_path_factory):
    """The JAX package's decoder, built from its own source into this
    test's directory."""
    if not _native.jpeg_headers_present():
        pytest.skip("jpeglib.h is not installed: no native JPEG decoder to compare")
    out = tmp_path_factory.mktemp("jax_jpeg") / "libjax_jpeg.so"
    subprocess.run(["g++", *_native.cxx_flags(), "-o", str(out),
                    os.path.join(ROOT, "multibox_tpu", "native", "jpeg_decode.cc"), "-ljpeg"],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.mbx_decode_jpeg.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.mbx_decode_jpeg.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_char_p, ctypes.c_int]
    lib.mbx_free_image.argtypes = [ctypes.POINTER(ctypes.c_uint8)]

    def decode(data, canvas=None):
        h, w = ctypes.c_int(), ctypes.c_int()
        err = ctypes.create_string_buffer(256)
        ptr = lib.mbx_decode_jpeg(data, len(data), canvas or 0, ctypes.byref(h),
                                  ctypes.byref(w), err, 256)
        assert ptr, err.value
        out = np.ctypeslib.as_array(ptr, shape=(h.value * w.value * 3,)).copy()
        lib.mbx_free_image(ptr)
        return out.reshape(h.value, w.value, 3)

    return decode


def smooth_image(rng, h, w):
    """A photo-like image (gradients and blocks: JPEG's IDCT and the
    DCT-scaled decode both do real work)."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([255 * y / h, 255 * x / w, 128 + 100 * np.sin(x / 7.0 + y / 11.0)], -1)
    for _ in range(6):
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        img[y0:y0 + h // 3, x0:x0 + w // 3] = rng.integers(0, 256, 3)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("canvas", [None, 37, 299], ids=["no_canvas", "canvas_37",
                                                          "canvas_299"])
def test_native_jpeg_decode_is_the_jax_packages_bit_for_bit(jax_decoder, canvas):
    rng = np.random.default_rng(1)
    for h, w in ((375, 500), (120, 90), (33, 47)):
        data = jjpeg.encode_jpeg(smooth_image(rng, h, w), quality=90)
        got = tjpeg.decode_jpeg(data, canvas=canvas, backend="native")
        want = jax_decoder(data, canvas)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        if canvas is None:  # the full decode: libjpeg's, as PIL's (JAX test's bound)
            pil = tjpeg.decode_jpeg(data, backend="pil").astype(int)
            assert np.abs(got.astype(int) - pil).mean() < 1.0
    with pytest.raises(ValueError, match="jpeg decode failed"):
        tjpeg.decode_jpeg(b"not a jpeg at all", backend="native")
