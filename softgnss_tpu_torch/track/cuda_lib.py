"""The loader of the port's CUDA libraries: build, load, bind and launch.

A :class:`Library` is a name and CUDA C++ sources in
``softgnss_tpu_torch/csrc``.  It is compiled at first use with
:data:`NVCC_FLAGS` (``nvcc -gencode arch=compute_90a,code=sm_90a``) into
a shared library with a plain C interface under
``softgnss_tpu_torch/_build/<name>-<key>/``, where the key
(:func:`library_key`) hashes the library's sources and the flags and is
computed without building: one ``nvcc -c`` per source, all started
together, then one link, then an atomic rename.  An :class:`Entry` is one
C entry point of a library, its argument types declared once, at module
level, beside the wrapper that calls it; calling it loads the library and
returns the entry's CUDA error code.  The launch helpers (:func:`ptr`,
:func:`stream`, :func:`check`, :func:`require`, :func:`sm_count`) are
the wrappers' common calls: every launch runs on
``torch.cuda.current_stream()``.

:data:`RECEIVER` is the receiver's library: B2 (``build_frames.cu``), B1
and B3 (``track_block.cu``) and B4 (``correlate_ms.cu``), with the
compile-time ablations of those kernels that the measurement scripts
launch.  Nothing else is built into it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
              "-Xcompiler", "-fPIC")
#: SMs of an H100 SXM: the launch plans' SM count for CPU tensors (a card's
#: own count is :func:`sm_count`)
SMS = 132


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from softgnss_tpu_torch/csrc at first use")
    return found


def library_key(sources, csrc: Path = CSRC, flags=NVCC_FLAGS) -> str:
    """The build key of a library of ``sources`` (file names in ``csrc``):
    a hash of each source's name and bytes and of ``flags``.  It changes
    with the library's own sources and flags, and with nothing else."""
    digest = hashlib.sha256()
    for name in sources:
        digest.update(name.encode() + b"\0" + (Path(csrc) / name).read_bytes() + b"\0")
    digest.update(" ".join(flags).encode())
    return digest.hexdigest()[:16]


class KernelLibrary(NamedTuple):
    """A built library: the ctypes handle, its path, how long the build
    took (0 when it was already built) and nvcc's output (ptxas's
    resources of every kernel)."""
    lib: ctypes.CDLL
    path: Path
    build_s: float
    log: str


@functools.cache
def load_library(name: str, sources: tuple) -> KernelLibrary:
    """Build (once per key) and load library ``name`` of ``sources``."""
    srcs = [CSRC / s for s in sources]
    out_dir = BUILD / f"{name}-{library_key(sources)}"
    lib_path = out_dir / f"lib{name}.so"
    log_path = out_dir / "nvcc.log"
    if lib_path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return KernelLibrary(ctypes.CDLL(str(lib_path)), lib_path, 0.0, log)
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(srcs, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        log = "".join(outs)
        for c, p, out in zip(cmds, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{out}")
        so = Path(tmp) / "lib.so"
        link = [nvcc, *_ARCH, "-shared", "-o", str(so), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n{log}")
        log_path.write_text(log)
        os.replace(so, lib_path)
    return KernelLibrary(ctypes.CDLL(str(lib_path)), lib_path, time.perf_counter() - t0, log)


class Library(NamedTuple):
    """A CUDA library: ``name`` and its ``sources`` in csrc/."""
    name: str
    sources: tuple

    def load(self) -> KernelLibrary:
        """The library, built at first use (:func:`load_library`)."""
        return load_library(self.name, self.sources)

    def entry(self, name: str, argtypes) -> Entry:
        """C entry point ``name`` of this library, taking ``argtypes``."""
        return Entry(self, name, tuple(argtypes))


class Entry:
    """C entry point ``name`` of ``library``, taking ``argtypes`` and
    returning a CUDA error code (0 on success)."""

    def __init__(self, library: Library, name: str, argtypes: tuple):
        self.library = library
        self.name = name
        self.argtypes = argtypes
        self._fn = None

    def function(self):
        """The bound ctypes function; loads the library (built at first
        use), so a library that does not build raises here."""
        lib = self.library.load().lib
        if self._fn is None:
            fn = getattr(lib, self.name)
            fn.argtypes = list(self.argtypes)
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> int:
        return self.function()(*args)


RECEIVER = Library("sgtrack", ("build_frames.cu", "track_block.cu", "correlate_ms.cu"))


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


def require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name}: the kernels take CUDA tensors (CPU tensors "
                         f"take the plain versions), got {device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.cache
def sm_count(device_index: int) -> int:
    """The card's SM count, queried once per device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count
