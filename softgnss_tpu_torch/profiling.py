"""Stage timing, trace annotations and lock-quality metrics.

* :class:`StageTimer` — named wall-clock stage times (the numbers behind
  ReceiverResults.timings_s); on a CUDA device it synchronizes at both
  ends of a stage, so a stage's time includes its device work.  Each stage
  is also a ``softgnss/<name>`` range in profiler traces.
* :func:`trace` — names a region ``softgnss/<name>`` in profiler traces
  (``torch.profiler.record_function``); inside a stage it also adds the
  region's host seconds to the stage's timer under ``name`` (the
  ``<stage>.<part>`` spans), without synchronizing the device,
* :func:`profile_to` — a ``torch.profiler`` trace of a region, CPU and
  (where there is a card) CUDA activity, written under a directory,
* :func:`lock_metrics` / :func:`channel_lock_loss` — the per-ms tracking
  observables reduced to C/N0, phase-lock and code-rate metrics, and the
  lock-loss demotion rule (host NumPy, as in softgnss_tpu.profiling).
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from dataclasses import dataclass, field

import numpy as np
import torch


#: the StageTimer whose stage runs now in this context, or None
_CURRENT: contextvars.ContextVar = contextvars.ContextVar("softgnss_stage_timer",
                                                          default=None)


@dataclass
class StageTimer:
    """Accumulates named stage wall times on ``device``, and the host times
    of the :func:`trace` regions that run inside a stage."""

    device: torch.device | str = "cpu"
    timings_s: dict = field(default_factory=dict)

    def _sync(self) -> None:
        dev = torch.device(self.device)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _add(self, name: str, seconds: float) -> None:
        self.timings_s[name] = self.timings_s.get(name, 0.0) + seconds

    @contextlib.contextmanager
    def stage(self, name: str):
        self.timings_s.setdefault(name, 0.0)     # a stage's key before its parts
        with torch.profiler.record_function(f"softgnss/{name}"):
            self._sync()
            token = _CURRENT.set(self)
            t0 = time.perf_counter()
            try:
                yield
            finally:
                _CURRENT.reset(token)
                self._sync()
                self._add(name, time.perf_counter() - t0)


@contextlib.contextmanager
def trace(name: str):
    """Name the enclosed region ``softgnss/<name>`` in profiler traces;
    inside a :meth:`StageTimer.stage`, add its host seconds to that timer's
    ``timings_s[name]``.  Never waits for the device: a span holds what the
    host did in the region, not the device work queued behind it."""
    timer = _CURRENT.get()
    with torch.profiler.record_function(f"softgnss/{name}"):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if timer is not None:
                timer._add(name, time.perf_counter() - t0)


@contextlib.contextmanager
def profile_to(log_dir: str):
    """A ``torch.profiler`` trace of the enclosed region (CPU activity, and
    CUDA activity where a card is available), written under ``log_dir`` as
    a Chrome / TensorBoard trace (``*.pt.trace.json``); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def lock_metrics(config, tracking, window_ms: int = 1000,
                 hop_ms: int | None = None) -> dict:
    """Per-channel lock-quality metrics, each (C, n_windows):
    ``cn0_dbhz`` (narrowband/wideband C/N0), ``pll_lock`` (NBD/NBP in
    [-1, 1], ~1 locked) and ``code_rate_offset_hz``.  Window k covers ms
    [k*hop, k*hop + window) from each channel's nav-bit alignment."""
    i_p = np.asarray(tracking.i_p)
    q_p = np.asarray(tracking.q_p)
    c, n_ms = i_p.shape
    hop_ms = window_ms if hop_ms is None else int(hop_ms)
    if not 0 < hop_ms <= window_ms:
        raise ValueError(f"hop_ms must be in (0, window_ms], got {hop_ms}")
    if n_ms < window_ms + 20:
        raise ValueError(f"need >= {window_ms + 20} ms of tracking, got {n_ms}")

    # align the 20-ms coherent sums to each channel's nav-bit edges
    signs = np.sign(i_p)
    flips = (signs[:, 1:] * signs[:, :-1]) < 0
    offsets = np.zeros(c, np.int64)
    for ch in range(c):
        edges = np.flatnonzero(flips[ch]) + 1
        if edges.size:
            offsets[ch] = np.bincount(edges % 20, minlength=20).argmax()

    n_win = (n_ms - 20 - window_ms) // hop_ms + 1
    win_idx = (np.arange(n_win)[:, None] * hop_ms
               + np.arange(window_ms)[None, :])
    ip = np.stack([i_p[ch, offsets[ch] + win_idx] for ch in range(c)])
    qp = np.stack([q_p[ch, offsets[ch] + win_idx] for ch in range(c)])

    m = window_ms // 20
    ip20 = ip[:, :, : m * 20].reshape(c, n_win, m, 20)
    qp20 = qp[:, :, : m * 20].reshape(c, n_win, m, 20)
    nbp = ip20.sum(-1) ** 2 + qp20.sum(-1) ** 2            # narrowband power
    wbp = (ip20**2 + qp20**2).sum(-1)                       # wideband power
    mu = (nbp / np.maximum(wbp, 1e-30)).mean(-1)
    # Van Dierendonck C/N0 estimator, T = 1 ms, M = 20
    with np.errstate(divide="ignore", invalid="ignore"):
        cn0 = 10.0 * np.log10(np.maximum((mu - 1.0) / (20.0 - mu), 1e-12) * 1000.0)
    nbd = ip20.sum(-1) ** 2 - qp20.sum(-1) ** 2
    pll_lock = (nbd / np.maximum(nbp, 1e-30)).mean(-1)
    code_off = np.asarray(tracking.code_freq)[:, win_idx].mean(-1)
    return {"cn0_dbhz": cn0, "pll_lock": pll_lock,
            "code_rate_offset_hz": code_off - config.code_freq_basis}


def channel_lock_loss(config, tracking) -> np.ndarray:
    """Per-channel ms index at which lock was lost (inf = held): the start
    of the first half-window-hop ``config.lock_window_ms`` window whose
    C/N0 falls below ``lock_cn0_threshold_dbhz`` (lowered by
    10 log10(pdi_ms)) or whose phase-lock indicator falls below
    ``lock_pll_threshold``.  Idle channels and short runs report inf."""
    i_p = np.asarray(tracking.i_p)
    c, n_ms = i_p.shape
    loss = np.full(c, np.inf)
    window = int(config.lock_window_ms)
    if n_ms < window + 20:
        return loss
    hop = max(window // 2, 20)
    metrics = lock_metrics(config, tracking, window_ms=window, hop_ms=hop)
    cn0_floor = (config.lock_cn0_threshold_dbhz
                 - 10.0 * np.log10(config.pdi_ms))
    bad = ((metrics["cn0_dbhz"] < cn0_floor)
           | (metrics["pll_lock"] < config.lock_pll_threshold))
    for ch in range(c):
        if tracking.status[ch] == "-":
            continue
        idx = np.flatnonzero(bad[ch])
        if idx.size:
            loss[ch] = float(idx[0] * hop)
    return loss
