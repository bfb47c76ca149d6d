"""ctypes binding to the C++ native layer, built with ``g++`` at first use.

Two libraries from ``multibox_tpu_torch/native``:

* ``tfrecord_reader.cc``: tfrecord streaming (mmap, CRC-32C with SSE4.2
  where the machine is x86, one background reader thread);
* ``jpeg_decode.cc``: JPEG decode and resize with libjpeg (``-ljpeg``).

They are built apart, so that a machine without libjpeg's headers still
has the reader. Each is compiled on its first use into ``.work/native/``
beside the package, under a name tagged with a hash of its source and
flags. Several processes may start at once (test workers, the ranks of a
data-parallel run): a build holds an ``fcntl`` lock on ``.work/native.lock``
(``utils.build_lock``), so one process builds and the others,
waiting, find the library and load it; the library is written to a
temporary name and moved into place with ``os.replace``. A failed build
raises with the compiler's output: nothing falls back to Python here.
Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from multibox_tpu_torch.utils.build_lock import build_lock

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_SRC)), ".work", "native")

_libs = {}
_lock = threading.Lock()


def machine() -> str:
    return platform.machine()


def cxx_flags() -> tuple:
    """The Makefile's flags; ``-msse4.2`` (the hardware CRC) only on x86,
    elsewhere the source takes its table CRC."""
    sse = ("-msse4.2",) if machine().lower() in ("x86_64", "amd64", "i686", "i386") else ()
    return ("-O3", "-fPIC", "-std=c++17", "-Wall", *sse, "-pthread", "-shared")


def find_cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError(
            "g++ not found on PATH: the native tfrecord reader and JPEG decoder of "
            "multibox_tpu_torch are built from source at first use")
    return path


def jpeg_headers_present() -> bool:
    """Whether the compiler finds ``jpeglib.h`` (the preprocessor alone)."""
    done = subprocess.run([find_cxx(), "-E", "-x", "c++", "-", "-o", os.devnull],
                          input="#include <jpeglib.h>\n", capture_output=True, text=True)
    return done.returncode == 0


def build(name: str) -> str:
    """Compile ``native/<name>.cc`` into a shared library; returns its
    path. Reuses a library built from the same source and flags, also one
    that another process built while this one waited for the lock."""
    source = os.path.join(_SRC, f"{name}.cc")
    libs = ("-ljpeg",) if name == "jpeg_decode" else ()
    flags = cxx_flags()
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(flags + libs).encode())
    lib_path = os.path.join(_BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path
    with build_lock(_BUILD_DIR):
        if os.path.exists(lib_path):  # built by another process meanwhile
            return lib_path
        cxx = find_cxx()
        if libs and not jpeg_headers_present():
            raise RuntimeError(
                "jpeglib.h not found: the native JPEG decoder needs libjpeg's headers "
                "(a libjpeg or libjpeg-turbo development package)")
        tmp = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [cxx, *flags, "-o", tmp, source, *libs]
        done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed on {name}.cc:\n$ {' '.join(cmd)}\n{done.stdout}")
        os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or nothing
    return lib_path


def _declare_reader(lib) -> None:
    lib.mbx_stream_open.restype = ctypes.c_void_p
    lib.mbx_stream_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int]
    lib.mbx_stream_next.restype = ctypes.c_int
    lib.mbx_stream_next.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
                                    ctypes.POINTER(ctypes.c_uint64)]
    lib.mbx_free_record.restype = None
    lib.mbx_free_record.argtypes = [ctypes.POINTER(ctypes.c_char)]
    lib.mbx_stream_error.restype = ctypes.c_char_p
    lib.mbx_stream_error.argtypes = [ctypes.c_void_p]
    lib.mbx_stream_errno.restype = ctypes.c_int
    lib.mbx_stream_errno.argtypes = [ctypes.c_void_p]
    lib.mbx_stream_close.restype = None
    lib.mbx_stream_close.argtypes = [ctypes.c_void_p]
    for fn in (lib.mbx_crc32c, lib.mbx_masked_crc32c):
        fn.restype = ctypes.c_uint32
        fn.argtypes = [ctypes.c_char_p, ctypes.c_uint64]


def _declare_jpeg(lib) -> None:
    lib.mbx_decode_jpeg.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.mbx_decode_jpeg.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_char_p, ctypes.c_int]
    lib.mbx_free_image.restype = None
    lib.mbx_free_image.argtypes = [ctypes.POINTER(ctypes.c_uint8)]


def _load(name: str, declare):
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            declare(lib)
            _libs[name] = lib
        return lib


def reader_library():
    """The tfrecord reader, built if needed and loaded."""
    return _load("tfrecord_reader", _declare_reader)


def jpeg_library():
    """The JPEG decoder, built if needed and loaded (raises without
    ``jpeglib.h``)."""
    return _load("jpeg_decode", _declare_jpeg)


def read_records(paths: Sequence[str], verify_crc: bool = True,
                 queue_capacity: int = 256) -> Iterator[bytes]:
    """Stream records across files through the reader thread: the records
    and errors of ``data.tfrecord.TFRecordReader`` over the same files, in
    order. The stream is closed when the generator finishes or is closed
    early (a shuffled or repeated dataset drops it mid-file)."""
    lib = reader_library()
    encoded = [os.fsencode(p) for p in paths]
    arr = (ctypes.c_char_p * len(encoded))(*encoded)
    stream = lib.mbx_stream_open(arr, len(encoded), int(bool(verify_crc)), queue_capacity)
    if not stream:
        raise IOError("failed to open tfrecord stream")
    try:
        data = ctypes.POINTER(ctypes.c_char)()
        size = ctypes.c_uint64()
        while True:
            r = lib.mbx_stream_next(stream, ctypes.byref(data), ctypes.byref(size))
            if r == 0:
                return
            if r != 1:
                message = os.fsdecode(lib.mbx_stream_error(stream))
                err = lib.mbx_stream_errno(stream)
                if err:  # the message is the path: raise what open() raises
                    raise OSError(err, os.strerror(err), message)
                raise IOError(message)
            try:
                record = ctypes.string_at(data, size.value)
            finally:
                lib.mbx_free_record(data)
            yield record
    finally:
        lib.mbx_stream_close(stream)


def crc32c(data: bytes) -> int:
    return reader_library().mbx_crc32c(data, len(data))


def masked_crc(data: bytes) -> int:
    return reader_library().mbx_masked_crc32c(data, len(data))


def decode_jpeg(data: bytes, canvas: Optional[int] = None) -> np.ndarray:
    """Decode (and with ``canvas`` resize) with libjpeg: RGB uint8
    ``[H, W, 3]``. DCT-scaled decode, then half-pixel bilinear to the
    canvas: not PIL's resize."""
    lib = jpeg_library()
    h, w = ctypes.c_int(), ctypes.c_int()
    errbuf = ctypes.create_string_buffer(256)
    ptr = lib.mbx_decode_jpeg(data, len(data), canvas or 0, ctypes.byref(h), ctypes.byref(w),
                              errbuf, len(errbuf))
    if not ptr:
        raise ValueError(f"jpeg decode failed: {errbuf.value.decode(errors='replace')}")
    try:
        out = np.ctypeslib.as_array(ptr, shape=(h.value * w.value * 3,)).copy()
    finally:
        lib.mbx_free_image(ptr)
    return out.reshape(h.value, w.value, 3)
