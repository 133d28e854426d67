"""Timers shared by the probes and ``chip_smoke.py``, for a CUDA card.

* :func:`cuda_ms` — device ms per call by CUDA events (``busy``: the card
  is kept busy so the events time device work, not the host's launches);
* :func:`host_ms` — host ms per call, synchronized at both ends;
* :func:`graph_marginal_ms` — the marginal device ms of one more call
  inside a CUDA graph, from graphs of ``n_lo`` and ``n_hi`` calls;
* :func:`cold_ms` — device ms per call with the L2 cache flushed before
  each call (:func:`flush_l2`: none of the call's inputs in it, and no
  dirty line to write back);
* :func:`flushed_marginal_ms` — device ms per call after an L2 flush,
  flush and call back to back, less the flush alone: :func:`cold_ms`
  without the fixed cost of a call timed alone;
* :func:`card` — the card's name and power limit as nvidia-smi gives them,
  printed beside every number the probes report;
* :func:`bound_ms` — the least time an H100 SXM could take for a given
  count of bytes and operations (NVIDIA's published peaks, below).

Every timer here needs a CUDA device; :func:`require_cuda` raises
without one.
"""

from __future__ import annotations

import functools
import subprocess
import time

import torch

#: bytes written by flush_l2: above the H100's 50 MB L2
L2_FLUSH_BYTES = 256 << 20
#: H100 SXM published peaks at 700 W (NVIDIA data sheet, dense): HBM3
#: bytes/s, float32 operations/s outside the tensor cores, TF32 tensor-core
#: operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """(ms, 'bytes' or 'operations'): the larger of ``n_bytes`` over the
    HBM rate and ``n_ops`` over ``ops_per_s``, and which one it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def require_cuda() -> torch.device:
    """The first CUDA device; raises when there is none (no CPU fallback)."""
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: the probes time CUDA "
                           "kernels and need a CUDA card")
    return torch.device("cuda", 0)


@functools.cache
def card() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    first line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, n: int, busy: bool = False) -> float:
    """Mean ms per call of ``fn()`` over ``n`` calls after one warm-up,
    timed by CUDA events.  ``busy``: the card first spins
    (``torch.cuda._sleep``) for longer than the host takes to enqueue the
    calls, so they run back to back and the events time the device work
    alone, not the host's launch rate (only for ``fn`` that never waits
    for the card)."""
    fn()
    torch.cuda.synchronize()
    if busy:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(int(3e9 * (time.perf_counter() - t0)))   # cycles, <= 2 GHz clock
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def host_ms(fn, n: int) -> float:
    """Mean host ms per call of ``fn()``, synchronized at both ends."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def graph_marginal_ms(fn, n_lo: int = 50, n_hi: int = 400, reps: int = 5) -> float:
    """(t_hi - t_lo) / (n_hi - n_lo): the device ms one more call of
    ``fn()`` adds inside a CUDA graph, where t_n is the best of ``reps``
    replays of a graph that captured ``n`` calls.  The counterpart of the
    N-scaling inside a ``lax.scan`` of scripts/pallas_ablate.py.  ``fn``
    must not synchronize (no ``.item()``, no host-to-device copy)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm up off the default stream, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    best = {}
    for n in (n_lo, n_hi):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start.record()
            graph.replay()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        best[n] = min(times)
        del graph
    return (best[n_hi] - best[n_lo]) / (n_hi - n_lo)


@functools.cache
def _flush_buffer(device: torch.device) -> torch.Tensor:
    return torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=device)


def flush_l2(device: torch.device) -> None:
    """Write a buffer larger than the L2 cache, evicting what it held, then
    read it back, so that the lines left in the L2 are clean: a write alone
    leaves ~50 MB of dirty lines, whose write-back the next kernel pays as
    it evicts them (PERF.md section 6)."""
    buf = _flush_buffer(torch.device(device))
    buf.fill_(1)
    buf.max()


def cold_ms(fn, n: int, device: torch.device) -> float:
    """Mean device ms per call of ``fn()`` over ``n`` calls, each after
    :func:`flush_l2` and timed alone by CUDA events."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for _ in range(n):
        flush_l2(device)
        torch.cuda._sleep(200_000)   # ~0.1 ms: the host enqueues fn before the card reaches it
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / n


def flushed_marginal_ms(fn, n: int, device: torch.device) -> float:
    """Device ms that ``fn()`` adds after :func:`flush_l2` when the two run
    back to back: t(flush, fn) - t(flush), each the mean of ``n`` calls
    by :func:`cuda_ms` with the card kept busy, timed in turns (flush,
    both, both, flush) so that a drift cancels.  :func:`cold_ms` times
    each call alone between two events, which adds a fixed ~3.5 us on an
    H100 (PERF.md section 6); this leaves it out, at the price of the
    flush's own spread, a few tenths of a us."""
    def flush():
        flush_l2(device)

    def both():
        flush_l2(device)
        fn()

    t = {flush: [], both: []}
    for f in (flush, both, both, flush):
        t[f].append(cuda_ms(f, n, busy=True))
    return (sum(t[both]) - sum(t[flush])) / 2
