"""S4: how fast a channel's per-ms window comes on chip, at B1's geometry.

Replaces ``scripts/dma_probe.py:34`` (``kernel``, launched by ``run`` at
:62), ``dma_probe2.py:33`` / :63, ``dma_probe3.py:31`` / :62 and
``dma_probe4.py:33`` / :68, which probed the TPU's DMA patterns for the
megakernel's frame fetch: a double-buffered (C, win) slab, per-channel
1-D copies from the capture view, and a depth-4 pipeline.  The H100
counterpart is one kernel, ``dma_probe_kernel`` in ``csrc/dma_probe.cu``:
for each of r ms in order it brings each channel's window of ``win`` int8
samples (byte 4*starts_w[c] + j*spc of the capture) on chip and writes the
exact int64 sum of its bytes to sums[j, c].  Each channel runs on one
thread-block cluster of ``ctas_per_channel`` CTAs (16 by default, B1's
:data:`~softgnss_tpu_torch.track.megakernel.CTAS_PER_CHANNEL`), rank q on
its slice ``megakernel.rank_slices(win, kN)[q]`` of every window, as B1
stages it since it runs a cluster per channel.  The patterns:

* ``direct`` — 16-byte read-only global loads on the capture's 16-byte
  grid, the slice's edge bytes masked, no staging and no barrier per ms;
* ``cp_async`` — 16-byte ``cp.async.cg`` into shared memory, 2 or 4
  windows in flight;
* ``bulk`` — one 1-D TMA bulk copy of the rank's slice per window onto an
  mbarrier, 2 or 4 windows in flight (at 16 CTAs and depth 2, B1's own
  staging).

The ranks' partials meet once per launch, at rank 0 through distributed
shared memory.  :func:`dma_plan` alone makes the launch plan (CTAs per
channel, threads, bytes per rank and per staging buffer, shared memory);
the kernel only refuses a plan past its limits.  The first design, one CTA
of 512 threads per channel with thread-strided byte loads and two CTA
barriers per ms, lost every timing to ``direct`` and was deleted.  The
kernel is in the probes' library (``pallas_probe.PROBE_LIBRARY``).

Run on a CUDA card from the repository root::

    python -m softgnss_tpu_torch.scripts.dma_probe

It holds every pattern at every cluster size bit-equal to
:func:`dma_probe_plain`, prints each kernel's ptxas resources, then each
pattern's us per ms and GB/s (window bytes brought on chip) at 1, 2, 4, 8
and 16 CTAs per channel, with the L2 flushed before each call and with
the L2 warm, at ``default_config()``'s geometry, r = 64, C = 8, each with
nvidia-smi's card line.  Without a CUDA card it raises.
"""

from __future__ import annotations

import ctypes
import re
import sys
from typing import NamedTuple

import numpy as np
import torch

from softgnss_tpu_torch.config import default_config
from softgnss_tpu_torch.scripts.inputs import SEED, assert_bit_equal
from softgnss_tpu_torch.scripts.pallas_probe import PROBE_LIBRARY, resources
from softgnss_tpu_torch.scripts.timing import card, cold_ms, cuda_ms, require_cuda
from softgnss_tpu_torch.track import cuda_lib
from softgnss_tpu_torch.track import megakernel as mk

#: (pattern, windows in flight)
PATTERNS = (("direct", 1), ("cp_async", 2), ("cp_async", 4), ("bulk", 2), ("bulk", 4))
_PATTERN_IDS = {"direct": 0, "cp_async": 1, "bulk": 2}
R = 64
N_CHANNELS = 8
#: the cluster sizes ``measure`` sweeps, and the default: B1's
KN_SWEEP = mk.CLUSTER_SIZES
CTAS_PER_CHANNEL = mk.CTAS_PER_CHANNEL
#: threads per CTA: the fastest of THREADS_SWEEP for ``direct`` at 16 CTAs
#: per channel, C = 8, r = 64 (10.5 us per call against 14.5 at 256 and
#: 13.2 at 1024 threads on an H100 80GB HBM3 at 700 W, PERF.md section 6);
#: at most the kernel's launch bounds
THREADS = 512
THREADS_SWEEP = (256, 512, 1024)
MAX_THREADS = 1024
#: dynamic shared memory a CTA can use on an H100 (227 KB)
MAX_SMEM_BYTES = 232_448
_DMA_PROBE = PROBE_LIBRARY.entry("sg_dma_probe", [ctypes.c_int] * 7 + [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4
    + [ctypes.c_void_p])


def dma_probe_plain(cap: torch.Tensor, starts_w: torch.Tensor, r: int, win: int,
                    spc: int) -> torch.Tensor:
    """(r, C) int64: sums[j, c] = the sum of the int8 bytes
    cap[4*starts_w[c] + j*spc + i], i < win, those outside the capture
    read as zero."""
    dev = cap.device
    idx = (4 * starts_w[None, :, None]
           + torch.arange(r, device=dev)[:, None, None] * spc
           + torch.arange(win, device=dev)[None, None, :])
    inside = (idx >= 0) & (idx < cap.shape[0])
    return torch.where(inside, cap[idx.clamp(0, cap.shape[0] - 1)], 0).to(torch.int64).sum(-1)


class DmaPlan(NamedTuple):
    """How ``dma_probe_kernel`` covers a launch: ``ctas_per_channel`` CTAs
    of ``threads`` threads per channel, one cluster (for ``direct``, warp
    w of a CTA takes ms w, w + warps, ...); rank q sums the
    window bytes ``megakernel.rank_slices(win, kN)[q]`` (``chunk`` bytes
    each, a multiple of 16); a staged pattern keeps ``depth`` buffers of
    ``slot`` = chunk + 16 bytes (a slice read on the capture's 16-byte
    grid spans at most one vector more); ``smem_bytes`` of dynamic shared
    memory: the buffers, then the rank's r int64 partials."""

    ctas_per_channel: int
    threads: int
    chunk: int
    slot: int
    smem_bytes: int


def dma_plan(pattern: str, depth: int, win: int, r: int,
             ctas_per_channel: int = CTAS_PER_CHANNEL, threads: int = THREADS) -> DmaPlan:
    """The launch plan of ``dma_probe_kernel``; raises ValueError on a
    pattern, cluster size, thread count or shared-memory size the kernel
    does not take."""
    if (pattern, depth) not in PATTERNS:
        raise ValueError(f"dma_probe: (pattern, depth) {(pattern, depth)} not in {PATTERNS}")
    if ctas_per_channel not in KN_SWEEP:
        raise ValueError(f"dma_probe: ctas_per_channel={ctas_per_channel}, expected one of "
                         f"{KN_SWEEP}")
    if threads % 32 or not 32 <= threads <= MAX_THREADS:
        raise ValueError(f"dma_probe: threads={threads}, a multiple of 32 up to {MAX_THREADS}")
    chunk = mk.rank_chunk(win, ctas_per_channel)
    slot = chunk + 16
    smem = (0 if pattern == "direct" else depth * slot) + 8 * r
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"dma_probe: {pattern} depth {depth} at {ctas_per_channel} CTAs per "
                         f"channel and r = {r} needs {smem} B of shared memory per CTA, more "
                         f"than {MAX_SMEM_BYTES}")
    return DmaPlan(ctas_per_channel, threads, chunk, slot, smem)


def _require_capture(name: str, cap: torch.Tensor, starts_w: torch.Tensor) -> None:
    """A contiguous, 16-byte aligned int8 capture and (C,) int64 starts on
    one card.  The windows' bounds are not looked at: the kernels read
    bytes outside the capture as zero, and a look would synchronise."""
    dev = cap.device
    cuda_lib.require(cap, "cap", torch.int8, (cap.shape[0],), dev)
    cuda_lib.require(starts_w, "starts_w", torch.int64, (starts_w.shape[0],), dev)
    if cap.data_ptr() % 16:
        raise ValueError(f"{name}: cap must start 16-byte aligned")


def dma_probe(pattern: str, depth: int, cap: torch.Tensor, starts_w: torch.Tensor, r: int,
              win: int, spc: int, ctas_per_channel: int = CTAS_PER_CHANNEL,
              threads: int = THREADS) -> torch.Tensor:
    """:func:`dma_probe_plain` by kernel ``dma_probe_kernel``
    (csrc/dma_probe.cu) with the load ``pattern`` and ``depth`` windows in
    flight (see the module docstring), ``ctas_per_channel`` CTAs of
    ``threads`` per channel at :func:`dma_plan`, on CUDA tensors; ``cap``
    (int8) must start 16-byte aligned.  On CPU tensors the plan is checked
    and :func:`dma_probe_plain` runs."""
    plan = dma_plan(pattern, depth, win, r, ctas_per_channel, threads)
    if cap.device.type == "cpu":
        return dma_probe_plain(cap, starts_w, r, win, spc)
    _require_capture("dma_probe", cap, starts_w)
    dev = cap.device
    c = starts_w.shape[0]
    sums = torch.empty((r, c), dtype=torch.int64, device=dev)
    ptr = cuda_lib.ptr
    with torch.cuda.device(dev):
        rc = _DMA_PROBE(_PATTERN_IDS[pattern], depth, *plan, ptr(cap), cap.shape[0],
                        ptr(starts_w), ptr(sums), r, c, win, spc, cuda_lib.stream(dev))
    dma_probe.launches += 1
    cuda_lib.check(rc, "dma_probe")
    return sums


dma_probe.launches = 0


def probe_args(c: int, r: int, device, edges: str = "inside"):
    """(cap, starts_w, r, win, spc) at ``default_config()``'s geometry
    (win = track_window, spc = samples_per_code) over random int8
    samples.  ``edges``: "inside", every window inside the capture; "end",
    the capture ends at the last byte of the last window; "outside", the
    first channel's windows start 1 000 bytes before the capture and the
    last window runs 1 000 bytes past its end."""
    cfg = default_config(number_of_channels=c)
    spc, win = cfg.samples_per_code, cfg.track_window
    rng = np.random.default_rng(SEED + c)
    cap = rng.integers(-128, 128, (r + 1) * spc + win, dtype=np.int8)
    starts = rng.integers(0, spc // 4, c).astype(np.int64)
    if edges == "outside":
        starts[0] = -250
    if edges in ("end", "outside"):
        end = 4 * int(starts.max()) + (r - 1) * spc + win
        cap = cap[:end - (1000 if edges == "outside" else 0)].copy()
    return torch.from_numpy(cap).to(device), torch.from_numpy(starts).to(device), r, win, spc


def check(device, c: int = N_CHANNELS, r: int = R) -> float:
    """Every pattern at every cluster size of KN_SWEEP bit-equal to the
    plain version, with every window inside the capture and with windows
    past both of its ends; raises otherwise.
    Returns the largest absolute difference (0.0)."""
    worst = 0.0
    for edges in ("inside", "outside"):
        args = probe_args(c, r, device, edges)
        want = {"sums": dma_probe_plain(*args)}
        for p, d in PATTERNS:
            for kn in KN_SWEEP:
                got = {"sums": dma_probe(p, d, *args, ctas_per_channel=kn)}
                worst = max(worst, assert_bit_equal(f"S4 {p} depth {d} kN={kn} ({edges})", got,
                                                    want))
    torch.cuda.synchronize(device)
    return worst


_KERNEL = re.compile(r"16dma_probe_kernelILi(\d+)ELi(\d+)ELi(\d+)E")


def probe_resources(log: str) -> dict:
    """{(pattern, depth, kN): resources} of every instantiation of
    ``dma_probe_kernel`` from nvcc's ``-Xptxas -v`` output (see
    :func:`~softgnss_tpu_torch.scripts.pallas_probe.resources`); raises
    KeyError when one is missing."""
    names = {v: k for k, v in _PATTERN_IDS.items()}
    out = {}
    for mangled, res in resources(log).items():
        if m := _KERNEL.search(mangled):
            out[(names[int(m.group(1))], int(m.group(2)), int(m.group(3)))] = res
    want = [(p, d, kn) for p, d in PATTERNS for kn in KN_SWEEP]
    missing = [k for k in want if k not in out]
    if missing:
        raise KeyError(f"dma_probe kernels missing from the ptxas log: {missing}")
    return {k: out[k] for k in want}


def measure(device, c: int = N_CHANNELS, r: int = R, n: int = 50) -> dict:
    """Device ms per call (r ms) of each pattern at each cluster size of
    KN_SWEEP, L2 warm and L2 flushed; the plain version's; ``direct`` at
    CTAS_PER_CHANNEL and each of THREADS_SWEEP threads per CTA (in turns:
    each, then each in reverse order); ``direct`` at r = 1 (the launch,
    the cluster barriers and one ms); the window bytes one call brings on
    chip: {(pattern, depth, kN): {"warm", "cold"}, "direct_by_threads":
    {threads: ms}, "direct_r1": ms, "plain": ms, "bytes": n}."""
    args = probe_args(c, r, device)
    res = {}
    for p, d in PATTERNS:
        for kn in KN_SWEEP:
            def fn(p=p, d=d, kn=kn):
                return dma_probe(p, d, *args, ctas_per_channel=kn)

            res[(p, d, kn)] = {"warm": cuda_ms(fn, n, busy=True), "cold": cold_ms(fn, n, device)}
    by_threads = {t: [] for t in THREADS_SWEEP}
    for t in [*THREADS_SWEEP, *reversed(THREADS_SWEEP)]:
        by_threads[t].append(cuda_ms(lambda: dma_probe("direct", 1, *args, threads=t), n,
                                     busy=True))
    res["direct_by_threads"] = {t: float(np.mean(v)) for t, v in by_threads.items()}
    one = probe_args(c, 1, device)
    res["direct_r1"] = cuda_ms(lambda: dma_probe("direct", 1, *one), n, busy=True)
    res["plain"] = cuda_ms(lambda: dma_probe_plain(*args), 5)
    res["bytes"] = r * c * args[3]
    return res


def report(res: dict, c: int = N_CHANNELS, r: int = R) -> None:
    def line(ms: float) -> str:
        return (f"{ms * 1e3 / r:8.3f} us/ms, {res['bytes'] / ms / 1e6:8.1f} GB/s "
                f"({ms:.4f} ms per call) [{card()}]")

    for p, d in PATTERNS:
        for kn in KN_SWEEP:
            for cache in ("cold", "warm"):
                print(f"S4 {p:8s} depth {d} kN={kn:2d} C={c} r={r} L2 {cache}: "
                      + line(res[(p, d, kn)][cache]))
    by_t = ", ".join(f"{t} threads {ms:.4f}" for t, ms in res["direct_by_threads"].items())
    print(f"S4 direct at kN={CTAS_PER_CHANNEL} by threads per CTA (in turns; the default is "
          f"{THREADS}), L2 warm, ms per call: {by_t} [{card()}]")
    print(f"S4 direct at kN={CTAS_PER_CHANNEL}, r=1 (the launch, its cluster barriers, one ms): "
          f"{res['direct_r1']:.4f} ms per call [{card()}]")
    print(f"S4 plain C={c} r={r}: {res['plain']:.4f} ms per call [{card()}]")


def main() -> int:
    device = require_cuda()
    print(card())
    for key, r in probe_resources(PROBE_LIBRARY.load().log).items():
        print(f"S4 {key}: {r['registers']} registers, {r['smem']} B static shared, "
              f"spills {r['spill_stores']} B stored / {r['spill_loads']} B loaded")
    print(f"worst |kernel - plain| over every pattern and cluster size: {check(device):.1f} "
          "(bit-equal)")
    report(measure(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
