"""ctypes bridge to the native C++ FASTQ parser/packer (hga_tpu/native).

The native library is optional: `available()` reports whether it could be
built/loaded, and callers fall back to the pure-Python reader
(hga_tpu/io/fastq.py), which defines the semantics.  The library is built on
first use with g++ (no pybind11 in this image; plain C ABI + ctypes).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Iterator, List, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_SRC = os.path.join(_NATIVE_DIR, "fastq_pack.cpp")
_LIB = os.path.join(_NATIVE_DIR, "libhga_native.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    # build beside the target and rename into place, so a concurrent
    # process never loads a half-written library
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp, "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        log.warning("native build failed (%s); using python parser", e)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB) or (
        os.path.exists(_SRC)
        and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
    ):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError as e:
        log.warning("native load failed (%s)", e)
        return None
    lib.hga_open.restype = ctypes.c_void_p
    lib.hga_open.argtypes = [ctypes.c_char_p]
    lib.hga_close.argtypes = [ctypes.c_void_p]
    lib.hga_read_batch.restype = ctypes.c_long
    lib.hga_read_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


NAME_CAP = 128


def read_packed_batches(
    path: str, pad_len: int, batch_reads: int = 8192
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, List[str]]]:
    """Stream (packed, bad, lengths, names) batches from one file natively.

    Semantics identical to pack_reads(iter_records(path)) with the same
    pad_len; raises RuntimeError if the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native parser unavailable")
    if pad_len % 16:
        raise ValueError("pad_len must be a multiple of 16")
    h = lib.hga_open(path.encode())
    if not h:
        raise OSError(f"cannot open {path}")
    n_words = pad_len // 16
    n_bad = (pad_len + 31) // 32
    try:
        while True:
            packed = np.zeros((batch_reads, n_words), np.uint32)
            bad = np.zeros((batch_reads, n_bad), np.uint32)
            lengths = np.zeros(batch_reads, np.int32)
            names_buf = ctypes.create_string_buffer(batch_reads * NAME_CAP)
            n = lib.hga_read_batch(
                h, batch_reads, pad_len,
                packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                bad.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                names_buf, NAME_CAP)
            if n < 0:
                raise ValueError(f"parse error in {path}")
            if n == 0:
                return
            names = [
                names_buf.raw[i * NAME_CAP:(i + 1) * NAME_CAP]
                .split(b"\0", 1)[0].decode()
                for i in range(n)
            ]
            yield packed[:n], bad[:n], lengths[:n], names
    finally:
        lib.hga_close(h)
