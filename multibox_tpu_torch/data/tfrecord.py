"""TFRecord container format: pure-Python reader, writer and CRC.

Format (each record):
  uint64 length | uint32 masked_crc32c(length) | bytes data | uint32 masked_crc32c(data)

The masked CRC is ``rot(crc32c(x), 15) + 0xa282ead8`` (TF convention).
The port's own copy of the JAX package's ``data/tfrecord.py``: the runtime
needs no TensorFlow to read the reference's data files. The CRC of a long
record is computed in 64-byte lanes with numpy, a few array passes in
place of an interpreter step per byte, with the byte loop's value.
:func:`read_records` takes the C++ reader (``data._native``: mmap, a reader
thread, hardware CRC) unless asked for the Python one.
"""

from __future__ import annotations

import functools
import os
import struct
from typing import Iterator, Optional

import numpy as np

from multibox_tpu_torch.data import _native

_MASK_DELTA = 0xA282EAD8

# CRC32C (Castagnoli) table, polynomial 0x82F63B78 (reflected).
_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        _CRC_TABLE.append(crc)


_build_table()
_CRC_TABLE_NP = np.array(_CRC_TABLE, np.uint32)
_LANE = 64  # bytes a lane of the vectorized CRC covers


def _crc_update(crc: int, data) -> int:
    """The raw CRC-32C state after ``data`` from ``crc``, a byte at a time."""
    table = _CRC_TABLE
    for b in data:
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc


@functools.lru_cache(maxsize=None)
def _zeros_operator(level: int):
    """The raw update over 64·2^level zero bytes, a linear map of the state
    over GF(2), as its 32 columns (the images of the unit states)."""
    if level == 0:
        return tuple(_crc_update(1 << i, bytes(_LANE)) for i in range(32))
    prev = _zeros_operator(level - 1)

    def apply(x):
        out = 0
        for i in range(32):
            if x >> i & 1:
                out ^= prev[i]
        return out

    return tuple(apply(c) for c in prev)


@functools.lru_cache(maxsize=None)
def _zeros_tables(level: int) -> np.ndarray:
    """``_zeros_operator(level)`` as four 256-entry tables, one a state byte."""
    cols = _zeros_operator(level)
    idx = np.arange(256)
    tables = np.zeros((4, 256), np.uint32)
    for j in range(4):
        for bit in range(8):
            tables[j] ^= np.where(idx >> bit & 1, cols[8 * j + bit], 0).astype(np.uint32)
    return tables


def _over_zeros(level: int, x):
    t = _zeros_tables(level)
    return t[0][x & 0xFF] ^ t[1][x >> 8 & 0xFF] ^ t[2][x >> 16 & 0xFF] ^ t[3][x >> 24]


def crc32c(data: bytes) -> int:
    """CRC-32C of ``data``. The update is linear over GF(2), so a long input
    is cut into 64-byte lanes that numpy advances side by side from a zero
    state, and the lanes are joined pairwise, the earlier one carried over
    the later one's length in zero bytes (precomputed maps); the bytes
    before the first lane go a byte at a time. The result is the byte loop's
    (``_crc_update``)."""
    lanes = len(data) // _LANE
    if lanes < 16:
        return _crc_update(0xFFFFFFFF, data) ^ 0xFFFFFFFF
    head = len(data) - lanes * _LANE
    state = _crc_update(0xFFFFFFFF, memoryview(data)[:head])
    width = 1 << (lanes - 1).bit_length()  # zero lanes in front change nothing
    block = np.zeros((_LANE, width), np.uint8)
    block[:, width - lanes:] = np.frombuffer(data, np.uint8, lanes * _LANE, head).reshape(
        lanes, _LANE).T
    s = np.zeros(width, np.uint32)
    for column in block:
        s = (s >> 8) ^ _CRC_TABLE_NP[(s ^ column) & 0xFF]
    level = 0
    while len(s) > 1:
        s = _over_zeros(level, s[0::2]) ^ s[1::2]
        level += 1
    level = 0
    while lanes:  # carry the head's state over the lanes' length
        if lanes & 1:
            state = int(_over_zeros(level, np.uint32(state)))
        lanes >>= 1
        level += 1
    return (state ^ int(s[0])) ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + _MASK_DELTA & 0xFFFFFFFF


class TFRecordWriter:
    """Minimal tfrecord writer (fixtures, dataset builders)."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, record: bytes) -> None:
        length = struct.pack("<Q", len(record))
        self._f.write(length)
        self._f.write(struct.pack("<I", masked_crc(length)))
        self._f.write(record)
        self._f.write(struct.pack("<I", masked_crc(record)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TFRecordReader:
    """Sequential tfrecord reader with CRC verification."""

    def __init__(self, path: str, verify_crc: bool = True):
        self.path = path
        self.verify_crc = verify_crc

    def __iter__(self) -> Iterator[bytes]:
        with open(self.path, "rb") as f:
            while True:
                header = f.read(12)
                if not header:
                    return
                if len(header) < 12:
                    raise IOError(f"truncated record header in {self.path}")
                (length,) = struct.unpack("<Q", header[:8])
                (len_crc,) = struct.unpack("<I", header[8:12])
                if self.verify_crc and masked_crc(header[:8]) != len_crc:
                    raise IOError(f"corrupt length crc in {self.path}")
                data = f.read(length)
                if len(data) < length:
                    raise IOError(f"truncated record body in {self.path}")
                (data_crc,) = struct.unpack("<I", f.read(4))
                if self.verify_crc and masked_crc(data) != data_crc:
                    raise IOError(f"corrupt record crc in {self.path}")
                yield data


def read_records(
    paths, verify_crc: bool = True, use_native: Optional[bool] = None
) -> Iterator[bytes]:
    """Iterate records across files.

    ``use_native=None`` (the default) or ``True`` reads with the C++ reader,
    built at first use; a failed build or load raises, it never gives way
    to Python. ``False`` reads in Python. Both readers yield the same
    records in the same order and raise the same errors (a corrupt CRC, a
    truncated record, the ``OSError`` of a file that cannot be opened)."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    paths = [os.fspath(p) for p in paths]
    if use_native is None or use_native:
        yield from _native.read_records(paths, verify_crc=verify_crc)
        return
    for path in paths:
        yield from TFRecordReader(path, verify_crc=verify_crc)
