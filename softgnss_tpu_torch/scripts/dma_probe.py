"""S4: how fast one CTA brings a channel's per-ms window on chip.

Replaces ``scripts/dma_probe.py:34`` (``kernel``, launched by ``run`` at
:62), ``dma_probe2.py:33`` / :63, ``dma_probe3.py:31`` / :62 and
``dma_probe4.py:33`` / :68, which probed the TPU's DMA patterns for the
megakernel's frame fetch: a double-buffered (C, win) slab, per-channel
1-D copies from the capture view, and a depth-4 pipeline.  The H100
counterpart is one kernel, ``csrc/dma_probe.cu``: one CTA per channel
walks r ms in order as B1 does, brings each ms's window of ``win`` int8
samples (byte 4*starts_w[c] + j*spc of the capture) on chip and writes
the exact int64 sum of its bytes to sums[j, c].  Its patterns:

* ``direct`` — B1/B3's global byte loads, no staging (the baseline);
* ``cp_async`` — 16-byte ``cp.async.cg`` into shared memory, 2 or 4
  windows in flight;
* ``bulk`` — one 1-D TMA bulk copy per window onto an mbarrier, 2 or 4
  windows in flight.

Run on a CUDA card from the repository root::

    python -m softgnss_tpu_torch.scripts.dma_probe

It holds every pattern bit-equal to :func:`dma_probe_plain` and prints
each pattern's us per ms and GB/s (window bytes brought on chip), with
the L2 flushed before each call and with the L2 warm, at
``default_config()``'s geometry, r = 64, C = 8, each with nvidia-smi's
card line.  Without a CUDA card it raises.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from softgnss_tpu_torch.config import default_config
from softgnss_tpu_torch.scripts.inputs import SEED, assert_bit_equal
from softgnss_tpu_torch.scripts.timing import card, cold_ms, cuda_ms, require_cuda
from softgnss_tpu_torch.track import megakernel as mk

#: (pattern, windows in flight)
PATTERNS = (("direct", 1), ("cp_async", 2), ("cp_async", 4), ("bulk", 2), ("bulk", 4))
_PATTERN_IDS = {"direct": 0, "cp_async": 1, "bulk": 2}
R = 64
N_CHANNELS = 8


def dma_probe_plain(cap: torch.Tensor, starts_w: torch.Tensor, r: int, win: int,
                    spc: int) -> torch.Tensor:
    """(r, C) int64: sums[j, c] = the sum of the int8 bytes
    cap[4*starts_w[c] + j*spc + i], i < win."""
    dev = cap.device
    idx = (4 * starts_w[None, :, None]
           + torch.arange(r, device=dev)[:, None, None] * spc
           + torch.arange(win, device=dev)[None, None, :])
    return cap[idx].to(torch.int64).sum(-1)


def dma_probe(pattern: str, depth: int, cap: torch.Tensor, starts_w: torch.Tensor, r: int,
              win: int, spc: int) -> torch.Tensor:
    """:func:`dma_probe_plain` by kernel ``dma_probe_kernel`` (csrc/dma_probe.cu)
    with the load ``pattern`` and ``depth`` windows in flight (see the
    module docstring) on CUDA tensors; ``cap`` (int8) must start 16-byte
    aligned and hold every window with 15 bytes to spare.  On CPU tensors
    :func:`dma_probe_plain`."""
    if cap.device.type == "cpu":
        return dma_probe_plain(cap, starts_w, r, win, spc)
    if (pattern, depth) not in PATTERNS:
        raise ValueError(f"(pattern, depth) {(pattern, depth)} not in {PATTERNS}")
    dev = cap.device
    c = starts_w.shape[0]
    mk._require(cap, "cap", torch.int8, (cap.shape[0],), dev)
    mk._require(starts_w, "starts_w", torch.int64, (c,), dev)
    if cap.data_ptr() % 16:
        raise ValueError("dma_probe: cap must start 16-byte aligned")
    lo, hi = 4 * int(starts_w.min()), 4 * int(starts_w.max()) + (r - 1) * spc + win + 15
    if lo < 0 or hi > cap.shape[0]:
        raise ValueError(f"dma_probe: windows span bytes [{lo}, {hi}) outside the "
                         f"{cap.shape[0]}-byte capture")
    sums = torch.empty((r, c), dtype=torch.int64, device=dev)
    lib = mk.load_library().lib
    with torch.cuda.device(dev):
        rc = lib.sg_dma_probe(_PATTERN_IDS[pattern], depth, mk._ptr(cap), mk._ptr(starts_w),
                              mk._ptr(sums), r, c, win, spc, mk._stream(dev))
    dma_probe.launches += 1
    mk._check(rc, "dma_probe")
    return sums


dma_probe.launches = 0


def probe_args(c: int, r: int, device):
    """(cap, starts_w, r, win, spc) at ``default_config()``'s geometry
    (win = track_window, spc = samples_per_code) over random int8
    samples, every window inside the capture."""
    cfg = default_config(number_of_channels=c)
    spc, win = cfg.samples_per_code, cfg.track_window
    rng = np.random.default_rng(SEED + c)
    cap = torch.from_numpy(rng.integers(-128, 128, (r + 1) * spc + win, dtype=np.int8))
    starts = rng.integers(0, spc // 4, c).astype(np.int64)
    return cap.to(device), torch.from_numpy(starts).to(device), r, win, spc


def check(device, c: int = N_CHANNELS, r: int = R) -> float:
    """Every pattern bit-equal to the plain version; raises otherwise.
    Returns the largest absolute difference (0.0)."""
    args = probe_args(c, r, device)
    want = {"sums": dma_probe_plain(*args)}
    worst = max(assert_bit_equal(f"S4 {p} depth {d}", {"sums": dma_probe(p, d, *args)}, want)
                for p, d in PATTERNS)
    torch.cuda.synchronize(device)
    return worst


def measure(device, c: int = N_CHANNELS, r: int = R, n: int = 50) -> dict:
    """Device ms per call (r ms) of each pattern, L2 warm and L2 flushed,
    the plain version's, and the window bytes one call brings on chip:
    {(pattern, depth): {"warm", "cold"}, "plain": ms, "bytes": n}."""
    args = probe_args(c, r, device)
    res = {(p, d): {"warm": cuda_ms(lambda p=p, d=d: dma_probe(p, d, *args), n, busy=True),
                    "cold": cold_ms(lambda p=p, d=d: dma_probe(p, d, *args), n, device)}
           for p, d in PATTERNS}
    res["plain"] = cuda_ms(lambda: dma_probe_plain(*args), 5)
    res["bytes"] = r * c * args[3]
    return res


def report(res: dict, c: int = N_CHANNELS, r: int = R) -> None:
    for p, d in PATTERNS:
        for cache in ("cold", "warm"):
            ms = res[(p, d)][cache]
            print(f"S4 {p:8s} depth {d} C={c} r={r} L2 {cache}: {ms * 1e3 / r:8.3f} us/ms, "
                  f"{res['bytes'] / ms / 1e6:8.1f} GB/s ({ms:.4f} ms per call) [{card()}]")
    print(f"S4 plain C={c} r={r}: {res['plain']:.4f} ms per call [{card()}]")


def main() -> int:
    device = require_cuda()
    print(f"worst |kernel - plain| over every pattern: {check(device):.1f} (bit-equal)")
    report(measure(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
