"""The plain reference: the receiver's acquisition and tracking math in
float64 (or, for the control, float32), in plain PyTorch.

It follows the receiver specification the configuration states (the
SoftGNSS loop equations, reference tracking.py:107-275, and its
acquisition, acquisition.py:55-306, in the formulation the port documents:
Q40 integer code NCO, 2^-32-turn carrier NCO, best-of-two-ms FFT search,
zoom-FFT fine frequency), written here from the equations and importing
nothing of the program.  It runs on any device and in blocks, so that it
fits after the program's state is freed.

Acquisition (:func:`acquire`) is computed from the capture alone.
Tracking cannot be: at 53 dB-Hz two closed loops of the same math part
after a few hundred ms, so :func:`track_step` follows the judged run one
millisecond at a time.  For ms k it takes the carrier and code frequency
the judged outputs give at the end of ms k - 1 and computes ms k anew
from the capture: the code and carrier NCO walk and the six correlators;
:func:`loop_filters`, fed the judged correlators and filter memory, gives
the update the judge holds the judged frequencies to.  The start (ms 0)
comes from the reference's own acquisition, and
the stage the stepping skips, the closed loop holding lock over the whole
capture, is judged against the generator's truth (``judge``).
:func:`track_closed_loop` is a whole tracker of the same math: run at
float32 it is the control, what a lower-precision receiver gives; run at
float64 over the first seconds it is the witness (:func:`holds_lock`) of
whether a satellite the receiver never locks can be locked at all from the
acquisition the reference agrees with.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from gnss_bench.codes import CODE_LENGTH, gold_codes

_Q = 40
_ONE = 1 << _Q
_U32 = 1 << 32
_CORR = ("i_e", "i_p", "i_l", "q_e", "q_p", "q_l")


@dataclass(frozen=True)
class Receiver:
    """The settings the reference needs, read from a configuration's
    ``receiver`` table."""

    sampling_freq: float
    intermediate_freq: float
    code_freq_basis: float
    ms_to_process: int
    number_of_channels: int
    acq_search_band_khz: float
    acq_doppler_step_hz: float
    acq_threshold: float
    acq_fine_freq_ms: int
    acq_fine_decimation: int
    acq_fine_fft: int
    acq_fine_band_hz: float
    dll_correlator_spacing: float
    dll_noise_bandwidth: float
    dll_damping_ratio: float
    dll_loop_gain: float
    pll_noise_bandwidth: float
    pll_damping_ratio: float
    pll_loop_gain: float
    lock_demotion: bool
    lock_window_ms: int
    lock_cn0_threshold_dbhz: float
    lock_pll_threshold: float

    @classmethod
    def from_table(cls, table: dict) -> "Receiver":
        for key, want in (("acq_noncoherent_ms", 2), ("pdi_ms", 1), ("fll_bandwidth_hz", 0.0),
                          ("carrier_aided_dll", False), ("skip_samples", 0),
                          ("code_length", CODE_LENGTH)):
            if table.get(key, want) != want:
                raise ValueError(f"the reference implements {key} = {want!r} only, "
                                 f"got {table[key]!r}")
        return cls(**{f: table[f] for f in cls.__dataclass_fields__})

    @property
    def samples_per_code(self) -> int:
        return int(round(self.sampling_freq / (self.code_freq_basis / CODE_LENGTH)))

    @property
    def samples_per_chip(self) -> int:
        return int(round(self.sampling_freq / self.code_freq_basis))

    @property
    def acquisition_ms(self) -> int:
        return max(self.acq_fine_freq_ms, 2) + 1

    def doppler_bins(self) -> list[float]:
        n = int(round(self.acq_search_band_khz * 1000.0 / self.acq_doppler_step_hz)) + 1
        lo = self.intermediate_freq - self.acq_search_band_khz / 2.0 * 1000.0
        return [lo + self.acq_doppler_step_hz * i for i in range(n)]

    def taus(self, bw: float, zeta: float, gain: float) -> tuple[float, float]:
        """(tau1, tau2) of the second-order loop filter (initialize.py:306-328)."""
        wn = bw * 8.0 * zeta / (4.0 * zeta**2 + 1.0)
        return gain / (wn * wn), 2.0 * zeta / wn


# --- acquisition ---------------------------------------------------------------

def resampled_codes(rx: Receiver) -> np.ndarray:
    """(32, spc) the code sampled once per code period: sample n holds chip
    ceil(ts (n + 1) / tc) - 1, the last pinned to chip 1022 (makeCaTable,
    initialize.py:223-226).  The expression is the specification's, operand
    for operand: where ts n / tc is a whole number in exact arithmetic its
    rounding decides the chip."""
    n = rx.samples_per_code
    ts, tc = 1.0 / rx.sampling_freq, 1.0 / rx.code_freq_basis
    idx = np.ceil(ts * np.arange(1, n + 1, dtype=np.float64) / tc).astype(np.int64) - 1
    idx[-1] = CODE_LENGTH - 1
    return gold_codes()[:, idx]


@dataclass
class Acquisition:
    """Per-PRN results, row i = PRN i + 1."""

    acquired: np.ndarray     # (32,) bool
    code_phase: np.ndarray   # (32,) int64
    doppler_bin: np.ndarray  # (32,) int64
    metric: np.ndarray       # (32,) float64
    carr_freq: np.ndarray    # (32,) float64, 0 where not acquired


def acquire(rx: Receiver, capture: torch.Tensor, prns_per_block: int = 8) -> Acquisition:
    """Acquisition of all 32 PRNs from the capture's first ms, float64."""
    dev = capture.device
    spc, fs = rx.samples_per_code, rx.sampling_freq
    sig = capture[: rx.acquisition_ms * spc].to(torch.float64)
    n = torch.arange(spc, dtype=torch.float64, device=dev)
    bins = torch.tensor(rx.doppler_bins(), dtype=torch.float64, device=dev)
    theta = 2.0 * math.pi * bins[:, None] * n[None, :] / fs
    mixer = torch.polar(torch.ones_like(theta), -theta)                  # (B, spc)
    xs = [torch.fft.fft(mixer * sig[m * spc:(m + 1) * spc]) for m in (0, 1)]
    codes = torch.from_numpy(resampled_codes(rx).astype(np.float64)).to(dev)
    code_fd = torch.conj(torch.fft.fft(codes.to(torch.complex128)))      # (32, spc)

    metric = np.zeros(32)
    phase = np.zeros(32, np.int64)
    dbin = np.zeros(32, np.int64)
    spchip = rx.samples_per_chip
    pos = torch.arange(spc, device=dev)
    for p0 in range(0, 32, prns_per_block):
        cf = code_fd[p0:p0 + prns_per_block]
        r = [torch.fft.ifft(x[None] * cf[:, None]).abs() ** 2 for x in xs]  # (p, B, spc)
        take0 = r[0].amax(-1, keepdim=True) > r[1].amax(-1, keepdim=True)
        grid = torch.where(take0, r[0], r[1])
        del r
        p = grid.shape[0]
        flat = grid.reshape(p, -1)
        top = flat.argmax(1)
        b, cp = top // spc, top % spc
        row = grid[torch.arange(p, device=dev), b]
        delta = (pos[None] - cp[:, None]) % spc
        keep = (delta >= spchip) & (delta < spc - spchip)
        second = torch.where(keep, row, -torch.inf).amax(1)
        metric[p0:p0 + p] = (flat.gather(1, top[:, None])[:, 0] / second).cpu().numpy()
        phase[p0:p0 + p] = cp.cpu().numpy()
        dbin[p0:p0 + p] = b.cpu().numpy()
    acquired = metric > rx.acq_threshold
    carr = np.zeros(32)
    prns = np.flatnonzero(acquired)
    if prns.size:
        carr[prns] = fine_frequency(rx, sig, phase[prns], dbin[prns], prns + 1)
    return Acquisition(acquired, phase, dbin, metric, carr)


def fine_frequency(rx: Receiver, sig: torch.Tensor, code_phase, dbin, prns) -> np.ndarray:
    """Zoom-FFT fine carrier frequency: ``acq_fine_freq_ms`` of the
    DC-removed signal wiped by the code, mixed to the coarse bin, summed
    in runs of ``acq_fine_decimation`` samples, FFT of ``acq_fine_fft``
    points, the strongest line within +-``acq_fine_band_hz``."""
    dev = sig.device
    spc, fs = rx.samples_per_code, rx.sampling_freq
    fine_n = rx.acq_fine_freq_ms * spc
    decim, nfft = rx.acq_fine_decimation, rx.acq_fine_fft
    n_dec = -(-fine_n // decim)
    k = torch.arange(fine_n, dtype=torch.int64, device=dev)
    ts, tc = 1.0 / fs, 1.0 / rx.code_freq_basis
    chip = torch.from_numpy(np.mod(np.floor(ts * np.arange(fine_n, dtype=np.float64) / tc),
                                   CODE_LENGTH).astype(np.int64)).to(dev)
    dc = sig - sig.mean()
    codes = torch.from_numpy(gold_codes()[np.asarray(prns) - 1].astype(np.float64)).to(dev)
    start = torch.as_tensor(np.minimum(code_phase, dc.shape[0] - fine_n), device=dev)
    x = dc[start[:, None] + k[None]] * codes[:, chip]
    coarse = torch.tensor(rx.doppler_bins(), dtype=torch.float64, device=dev)[
        torch.as_tensor(dbin, device=dev)]
    theta = 2.0 * math.pi * coarse[:, None] * k[None].to(torch.float64) / fs
    pad = n_dec * decim - fine_n
    dec_i = torch.nn.functional.pad(x * torch.cos(theta), (0, pad)).reshape(-1, n_dec, decim).sum(-1)
    dec_q = torch.nn.functional.pad(x * torch.sin(theta), (0, pad)).reshape(-1, n_dec, decim).sum(-1)
    mag = torch.fft.fft(torch.complex(dec_i, -dec_q), n=nfft).abs()
    freqs = np.fft.fftfreq(nfft, 1.0 / (fs / decim))
    band = torch.from_numpy(np.abs(freqs) <= rx.acq_fine_band_hz).to(dev)
    kk = torch.where(band, mag, -torch.inf).argmax(1).cpu().numpy()
    return coarse.cpu().numpy() + freqs[kk]


def assign(rx: Receiver, acq: Acquisition):
    """(prn, acquired freq, code phase) of each channel: the strongest
    acquired PRNs in order of metric (acquisition.py:276-305); 0 = idle."""
    c = rx.number_of_channels
    order = np.argsort(-acq.metric, kind="stable")
    n = min(c, int(acq.acquired.sum()))
    prn = np.zeros(c, np.int64)
    freq = np.zeros(c)
    phase = np.zeros(c, np.int64)
    prn[:n] = order[:n] + 1
    freq[:n] = acq.carr_freq[order[:n]]
    phase[:n] = acq.code_phase[order[:n]]
    return prn, freq, phase


# --- tracking --------------------------------------------------------------------

def padded_codes(prns) -> np.ndarray:
    """(C, 1025) the code with chip 1022 before and chip 0 after it, so a
    ceil'd chip phase c in [0, 1024] indexes the chip active over (c-1, c]."""
    codes = gold_codes()[np.asarray(prns) - 1].astype(np.float64)
    return np.concatenate([codes[:, -1:], codes, codes[:, :1]], axis=1)


def nco_words(rx: Receiver, carr_hz, code_hz):
    """(step, w): the code NCO's Q40 chips per sample, round(f / fs 2^40),
    and the carrier NCO's 2^-32 turns per sample, round(f / fs 2^32) mod 2^32."""
    fs = rx.sampling_freq
    step = np.rint(np.asarray(code_hz, np.float64) / fs * float(_ONE)).astype(np.int64)
    w = np.mod(np.rint(np.asarray(carr_hz, np.float64) / fs * float(_U32)).astype(np.int64), _U32)
    return step, w


def nco_walk(rx: Receiver, ptr0, carr_in: np.ndarray, code_in: np.ndarray):
    """The integer NCOs over n ms for C channels.  ``carr_in``/``code_in``:
    (n, C) the frequencies each ms runs at.  Returns int64 (n, C) arrays:
    ptr (first sample), blk (samples), rem (Q40 code phase at ptr), step
    (Q40 chips per sample), ph (carrier phase at ptr, 2^-32 turns) and w
    (carrier phase per sample)."""
    length = CODE_LENGTH * _ONE
    step, w = nco_words(rx, carr_in, code_in)
    n, c = step.shape
    ptr = np.empty((n, c), np.int64)
    blk = np.empty((n, c), np.int64)
    rem = np.empty((n, c), np.int64)
    ph = np.empty((n, c), np.int64)
    p = np.asarray(ptr0, np.int64).copy()
    r = np.zeros(c, np.int64)
    a = np.zeros(c, np.int64)
    for k in range(n):
        ptr[k], rem[k], ph[k] = p, r, a
        b = (length - r + step[k] - 1) // step[k]
        blk[k] = b
        r = r + step[k] * b - length
        a = np.mod(a + np.mod(w[k] * b, _U32), _U32)
        p = p + b
    return ptr, blk, rem, step, ph, w


def correlate(rx: Receiver, capture: torch.Tensor, pads: torch.Tensor, ptr, blk, rem,
              step, ph, w, dtype) -> torch.Tensor:
    """(R, 6) correlators of R (ms, channel) rows, given as int64 (R,)
    tensors, summed in ``dtype``; ``pads``: (R, 1025) each row's padded
    code."""
    dev = capture.device
    j = torch.arange(int(blk.max()), dtype=torch.int64, device=dev)
    live = j[None] < blk[:, None]
    idx = torch.clamp(ptr[:, None] + j[None], max=capture.shape[0] - 1)
    x = torch.where(live, capture.take(idx).to(dtype), 0)
    turns = torch.remainder(ph[:, None] + w[:, None] * j[None], _U32)
    theta = turns.to(dtype) * torch.tensor(2.0 * math.pi / _U32, dtype=dtype, device=dev)
    i_bb = torch.sin(theta) * x
    q_bb = torch.cos(theta) * x
    del theta, turns, x
    tq = rem[:, None] + step[:, None] * j[None]
    half = int(round(rx.dll_correlator_spacing * _ONE))
    out = []
    codes = [pads.gather(1, torch.clamp((tq + d + (_ONE - 1)) >> _Q, 0, 1024)).to(dtype)
             for d in (-half, 0, half)]
    for bb in (i_bb, q_bb):
        for code in codes:
            out.append((code * bb).sum(1))
    return torch.stack(out, 1)


def loop_filters(rx: Receiver, corr: np.ndarray, carr_basis, prev: dict, dtype=np.float64):
    """One update of the PLL and DLL from (..., 6) correlators and the
    previous filter memory ``prev`` (keys carr_nco, carr_err, code_nco,
    code_err): returns the new memory and the frequencies, in ``dtype``."""
    f = lambda v: np.asarray(v, dtype)            # noqa: E731
    i_e, i_p, i_l, q_e, q_p, q_l = (f(corr[..., i]) for i in range(6))
    tau1c, tau2c = (f(v) for v in rx.taus(rx.pll_noise_bandwidth, rx.pll_damping_ratio,
                                          rx.pll_loop_gain))
    tau1d, tau2d = (f(v) for v in rx.taus(rx.dll_noise_bandwidth, rx.dll_damping_ratio,
                                          rx.dll_loop_gain))
    pdi = f(1e-3)
    with np.errstate(divide="ignore", invalid="ignore"):
        carr_err = np.where(i_p != 0, np.arctan(q_p / np.where(i_p != 0, i_p, 1))
                            / f(2.0 * math.pi), 0).astype(dtype)
        e = np.sqrt(i_e * i_e + q_e * q_e)
        lt = np.sqrt(i_l * i_l + q_l * q_l)
        code_err = np.where(e + lt > 0, (e - lt) / np.where(e + lt > 0, e + lt, 1), 0).astype(dtype)
    carr_nco = f(prev["carr_nco"]) + tau2c / tau1c * (carr_err - f(prev["carr_err"])) \
        + carr_err * (pdi / tau1c)
    code_nco = f(prev["code_nco"]) + tau2d / tau1d * (code_err - f(prev["code_err"])) \
        + code_err * (pdi / tau1d)
    return ({"carr_nco": carr_nco, "carr_err": carr_err, "code_nco": code_nco,
             "code_err": code_err},
            f(carr_basis) + carr_nco, f(rx.code_freq_basis) - code_nco)


def track_step(rx: Receiver, capture: torch.Tensor, prn, carr_basis, ptr0, judged: dict,
               block_ms: int = 128, dtype=torch.float64) -> dict:
    """Each ms of the judged run's NCO walk and correlation recomputed from
    the frequencies its outputs give at the end of the ms before (module
    docstring; the loop update is held to them by ``judge.loop_gaps``).
    ``judged``: (C, n) arrays ``carr_freq`` and ``code_freq`` of the
    channels in ``prn`` (all active).  Returns (C, n) arrays:
    ``absolute_sample`` (the pointer after each ms) and the six
    correlators."""
    dev = capture.device
    c, n = judged["carr_freq"].shape
    first = lambda key, v0: np.concatenate(                   # noqa: E731
        [np.full((1, c), v0, np.float64), np.asarray(judged[key], np.float64).T[:-1]])
    carr_in = first("carr_freq", 0.0)
    carr_in[0] = carr_basis
    code_in = first("code_freq", rx.code_freq_basis)
    ptr, blk, rem, step, ph, w = nco_walk(rx, ptr0, carr_in, code_in)
    pads = torch.from_numpy(padded_codes(prn)).to(dev)
    corr = np.empty((n, c, 6))
    for m0 in range(0, n, block_ms):
        m1 = min(n, m0 + block_ms)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a[m0:m1].reshape(-1))).to(dev)  # noqa: E731
        rows = correlate(rx, capture, pads.repeat(m1 - m0, 1), t(ptr), t(blk), t(rem), t(step),
                         t(ph), t(w), dtype)
        corr[m0:m1] = rows.reshape(m1 - m0, c, 6).cpu().numpy()
    out = {"absolute_sample": (ptr + blk).T}
    for i, key in enumerate(_CORR):
        out[key] = corr[..., i].T
    return out


def track_closed_loop(rx: Receiver, capture: torch.Tensor, prn, carr_basis, ptr0, n_ms: int,
                      dtype=torch.float32) -> dict:
    """A whole tracker of the same math, every float in ``dtype``: the
    control, the reference in the receiver's place at a lower precision.
    Returns the judged arrays of :func:`track_step` plus the filter
    memory (``pll_discr``, ``pll_discr_filt``, ``dll_discr``,
    ``dll_discr_filt``), (C, n) each.  The first ms runs its NCOs at the
    float64 acquisition frequency, as :func:`track_step` does, so that the
    two differ in the precision of the tracking alone."""
    dev = capture.device
    c = len(prn)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    pads = torch.from_numpy(padded_codes(prn)).to(dev)
    mem = {k: np.zeros(c, np_dtype) for k in ("carr_nco", "carr_err", "code_nco", "code_err")}
    carr = np.asarray(carr_basis, np.float64)
    code = np.full(c, rx.code_freq_basis, np.float64)
    keys = ("absolute_sample", "carr_freq", "code_freq", "pll_discr", "pll_discr_filt",
            "dll_discr", "dll_discr_filt") + _CORR
    out = {k: np.zeros((c, n_ms)) for k in keys}
    p = np.asarray(ptr0, np.int64)
    rem = np.zeros(c, np.int64)
    ph = np.zeros(c, np.int64)
    length = CODE_LENGTH * _ONE
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)   # noqa: E731
    for k in range(n_ms):
        step, w = nco_words(rx, carr.astype(np.float64), code.astype(np.float64))
        blk = (length - rem + step - 1) // step
        corr = correlate(rx, capture, pads, t(p), t(blk), t(rem), t(step), t(ph), t(w),
                         dtype).cpu().numpy().astype(np_dtype)
        mem, carr, code = loop_filters(rx, corr, np.asarray(carr_basis, np.float64), mem,
                                       np_dtype)
        rem = rem + step * blk - length
        ph = np.mod(ph + np.mod(w * blk, _U32), _U32)
        p = p + blk
        out["absolute_sample"][:, k] = p
        out["carr_freq"][:, k], out["code_freq"][:, k] = carr, code
        out["pll_discr"][:, k], out["pll_discr_filt"][:, k] = mem["carr_err"], mem["carr_nco"]
        out["dll_discr"][:, k], out["dll_discr_filt"][:, k] = mem["code_err"], mem["code_nco"]
        for i, key in enumerate(_CORR):
            out[key][:, k] = corr[:, i]
    return out


def holds_lock(rx: Receiver, capture: torch.Tensor, prn, carr_basis, ptr0, n_ms: int
               ) -> np.ndarray:
    """(C,) bool: whether the float64 closed loop, started from the given
    acquisition, passes the receiver's lock rule over its first ``n_ms``
    ms.  A loop that does not pull in fails the rule's first windows, the
    same windows it fails over the whole capture."""
    trk = track_closed_loop(rx, capture, prn, carr_basis, ptr0, n_ms, dtype=torch.float64)
    return ~lock_lost(rx, trk["i_p"], trk["q_p"])


# --- lock demotion -------------------------------------------------------------

def lock_lost(rx: Receiver, i_p: np.ndarray, q_p: np.ndarray) -> np.ndarray:
    """(C,) bool: channels the receiver's lock rule demotes, from (C, n)
    prompt correlators.  Windows of ``lock_window_ms`` ms every half window,
    aligned to each channel's most frequent sign-change phase mod 20 ms (its
    nav-bit edges); per window the Van Dierendonck narrow/wideband C/N0
    over 20-ms sums and the phase-lock indicator (narrowband I^2 - Q^2 over
    I^2 + Q^2); a window under ``lock_cn0_threshold_dbhz`` or
    ``lock_pll_threshold`` demotes the channel."""
    c, n = i_p.shape
    w = int(rx.lock_window_ms)
    lost = np.zeros(c, bool)
    if not rx.lock_demotion or n < w + 20:
        return lost
    hop = max(w // 2, 20)
    n_win = (n - 20 - w) // hop + 1
    m = w // 20
    for ch in range(c):
        s = np.sign(i_p[ch])
        edges = np.flatnonzero(s[1:] * s[:-1] < 0) + 1
        off = int(np.bincount(edges % 20, minlength=20).argmax()) if edges.size else 0
        idx = off + np.arange(n_win)[:, None] * hop + np.arange(m * 20)[None, :]
        i20 = i_p[ch][idx].reshape(n_win, m, 20)
        q20 = q_p[ch][idx].reshape(n_win, m, 20)
        nbp = i20.sum(-1) ** 2 + q20.sum(-1) ** 2
        wbp = (i20 ** 2 + q20 ** 2).sum(-1)
        mu = (nbp / np.maximum(wbp, 1e-30)).mean(-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            cn0 = 10.0 * np.log10(np.maximum((mu - 1.0) / (20.0 - mu), 1e-12) * 1000.0)
        lock = ((i20.sum(-1) ** 2 - q20.sum(-1) ** 2) / np.maximum(nbp, 1e-30)).mean(-1)
        lost[ch] = bool(((cn0 < rx.lock_cn0_threshold_dbhz) | (lock < rx.lock_pll_threshold)).any())
    return lost
