"""Native (C++) capture IO: packed-sample unpackers and probe statistics.

The port's own copy of softgnss_tpu.native (whose package imports JAX):
``unpack.cpp`` is compiled with ``g++`` at first use into
``softgnss_tpu_torch/_build/unpack-<source hash>/`` and loaded with
``ctypes``.  It is host IO that gives the same bytes as the NumPy
versions in softgnss_tpu_torch.io, only in one streaming pass; where no
compiler (or no build) is available every function here returns None,
and io takes its NumPy version.  :func:`used` says which one a process
took.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "unpack.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_SAMPLES_PER_BYTE = {"int4": 2, "int2": 4, "int1": 8}


def _build(lib_path: Path) -> bool:
    """g++ into a temporary file, then an atomic rename: processes that build
    at once never load a half-written library."""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib_path.parent) as tmp:
        out = Path(tmp) / lib_path.name
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", str(out), str(_SRC)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as exc:
            logger.info("native unpack build failed (%s); io uses its NumPy versions", exc)
            return False
        os.replace(out, lib_path)
    return True


@functools.cache
def load():
    """The ctypes library, built on first use; None if it cannot be built
    or loaded."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    lib_path = _BUILD / f"unpack-{digest}" / "libsgunpack.so"
    if not lib_path.exists() and not _build(lib_path):
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError as exc:
        logger.info("native unpack load failed (%s); io uses its NumPy versions", exc)
        return None
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    for name in ("unpack_int4", "unpack_int2", "unpack_int1"):
        fn = getattr(lib, name)
        fn.argtypes = [u8, i8, ctypes.c_size_t]
        fn.restype = None
    lib.narrow_int16.argtypes = [i16, i8, ctypes.c_size_t]
    lib.narrow_int16.restype = None
    lib.unbias_uint8.argtypes = [u8, i8, ctypes.c_size_t]
    lib.unbias_uint8.restype = None
    lib.probe_stats.argtypes = [i8, ctypes.c_size_t, i64, ctypes.POINTER(ctypes.c_double),
                                ctypes.POINTER(ctypes.c_double)]
    lib.probe_stats.restype = None
    logger.info("native unpack library loaded: %s", lib_path)
    return lib


def used() -> bool:
    """Whether this process's IO takes the native library (it is built and
    loaded on the first call)."""
    return load() is not None


#: the JAX package's name for :func:`used`
available = used


def unpack(raw: np.ndarray, fmt: str) -> np.ndarray | None:
    """Unpack a uint8 byte array of ``fmt`` (int4 / int2 / int1 / uint8) to
    int8 samples; None without the library."""
    lib = load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, np.uint8)
    if fmt in _SAMPLES_PER_BYTE:
        out = np.empty(len(raw) * _SAMPLES_PER_BYTE[fmt], np.int8)
        getattr(lib, f"unpack_{fmt}")(raw, out, len(raw))
        return out
    if fmt == "uint8":
        out = np.empty(len(raw), np.int8)
        lib.unbias_uint8(raw, out, len(raw))
        return out
    return None


def narrow_int16(raw: np.ndarray) -> np.ndarray | None:
    """int16 -> int8 by an arithmetic shift right of 8; None without the
    library."""
    lib = load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, np.int16)
    out = np.empty(len(raw), np.int8)
    lib.narrow_int16(raw, out, len(raw))
    return out


def probe_stats(samples: np.ndarray) -> dict | None:
    """One pass over int8 samples: 256-bin histogram (value + 128), mean and
    standard deviation; None without the library."""
    lib = load()
    if lib is None:
        return None
    samples = np.ascontiguousarray(samples, np.int8)
    hist = np.zeros(256, np.int64)
    s, s2 = ctypes.c_double(), ctypes.c_double()
    lib.probe_stats(samples, len(samples), hist, ctypes.byref(s), ctypes.byref(s2))
    n = len(samples)
    mean = s.value / n if n else 0.0
    var = max(s2.value / n - mean * mean, 0.0) if n else 0.0
    return {"hist": hist, "mean": mean, "std": var ** 0.5}
