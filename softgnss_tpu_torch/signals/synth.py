"""Synthetic GPS L1 IF signal generator.

The port of softgnss_tpu.signals.synth: ``synthesize_signal`` (static
satellites), ``synthesize_iq`` (the same as complex baseband I/Q pairs),
``synthesize_dynamic`` (per-ms light times from a geometry,
softgnss_tpu_torch.scenario) and ``default_scenario``: inject known PRNs /
Doppler / delays / nav bits and synthesize int8 IF samples, so every
receiver stage can be checked closed-loop against the injected truth.

Signal model (per satellite)::

    s[k] = A * CA_prn(floor(chips(k)) mod 1023) * D(bit(chips(k)))
             * sin(2*pi*(IF + fd) * k/fs + phi0)
    chips(k) = fc_eff * (k - delay_samples) / fs          (static delay)
    chips(k) = fc * (t_rx0 + k/fs - tau(k) - t_bits0)     (dynamic delay)
    fc_eff   = code_freq_basis * (1 + fd / fL1)

Each millisecond reduces to a host-built (satellite, ms) parameter table
(Q40 chip phase, uint32 carrier counts, the at-most-one nav-bit edge) and
the device work is elementwise, in chunks of ``chunk_ms`` milliseconds.
The per-sample chip index is the JAX synthesizer's own tile arithmetic
(a Q24 step inside each 128-sample tile), so noise-free captures agree
with it sample for sample up to the float32 sum order over satellites.
Noise comes from a ``torch.Generator`` seeded by ``seed``: the same
distribution as the JAX synthesizer's, not the same numbers.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from softgnss_tpu_torch.config import ReceiverConfig
from softgnss_tpu_torch.device import resolve
from softgnss_tpu_torch.signals.ca import gold_codes
from softgnss_tpu_torch.signals.nco import carrier_turns, sin_turns

_BITS_PER_PERIOD = 20  # nav bit = 20 C/A code periods
_CHIPS_PER_BIT = 1023 * _BITS_PER_PERIOD
_Q = 40
_QONE = 1 << _Q
_TILE = 128


@dataclass(frozen=True)
class SatelliteSignal:
    """Injected truth for one satellite."""

    prn: int
    #: carrier Doppler relative to the IF, Hz
    doppler_hz: float = 0.0
    #: signal delay in samples (acquisition reports it mod samples_per_code)
    delay_samples: float = 0.0
    #: scalar amplitude, or a per-ms envelope (edge-held past its end)
    amplitude: float | tuple[float, ...] = 1.0
    #: carrier phase at k=0, radians
    phase0: float = 0.0
    #: +/-1 nav bits, one per 20 ms, indexed by bit counter mod len; None = +1
    nav_bits: tuple[int, ...] | None = None
    #: override the code chipping rate; None -> Doppler-consistent
    code_freq_hz: float | None = None

    def effective_code_freq(self, config: ReceiverConfig) -> float:
        if self.code_freq_hz is not None:
            return self.code_freq_hz
        return config.code_freq_basis * (1.0 + self.doppler_hz / config.l1_freq)


def amplitude_for_cn0(config: ReceiverConfig, cn0_dbhz: float,
                      noise_std: float) -> float:
    """Signal amplitude giving C/N0 = A^2 fs / (2 sigma^2)."""
    return float(np.sqrt(2.0 * noise_std**2 * 10.0 ** (cn0_dbhz / 10.0)
                         / config.sampling_freq))


def _nav_bit_array(sat: SatelliteSignal) -> np.ndarray:
    if sat.nav_bits is None:
        return np.ones(1, np.float32)
    bits = np.asarray(sat.nav_bits, np.float32)
    if not np.all(np.abs(bits) == 1):
        raise ValueError("nav_bits must be +/-1")
    return bits


class _MsParams(NamedTuple):
    """Per-(satellite, ms) tables, (S, n_ms) each."""

    win_start: np.ndarray   # i64 code-window start chip, in [0, 1023)
    frac0_q: np.ndarray     # i64 Q40 window-relative chips at sample 0
    step_q: np.ndarray      # i64 Q40 chips/sample
    bit0: np.ndarray        # f32 nav bit before the edge
    bit1: np.ndarray        # f32 nav bit after the edge
    edge_q: np.ndarray      # i64 Q40 window-relative chips of the bit edge
    p0: np.ndarray          # i32 carrier NCO counts at sample 0
    pw: np.ndarray          # i32 carrier NCO counts/sample


def _window_geometry(config: ReceiverConfig):
    """Tile geometry of the per-ms code window (as the JAX synthesizer)."""
    spms = config.samples_per_code
    t_count = -(-spms // _TILE)
    s_nom = config.code_freq_basis / config.sampling_freq
    w = int(np.ceil(s_nom * _TILE)) + 8
    w = (w + 7) // 8 * 8
    win_chips = int(np.ceil(s_nom * t_count * _TILE)) + 8
    h_base = np.floor(s_nom * _TILE * np.arange(t_count)).astype(np.int64) - 2
    return w, win_chips, h_base


def _build_params(chips0, chip_slope, cyc0, cyc_slope,
                  bit_tables: list[np.ndarray], wrap_bits: bool = True) -> _MsParams:
    """Host-side per-ms parameter tables (float64/integer NumPy); the bit
    tables repeat (``wrap_bits``) or hold their edge bits."""
    c0 = np.floor(chips0).astype(np.int64)
    frac0_q = np.rint((chips0 - c0) * _QONE).astype(np.int64)
    carry = frac0_q >= _QONE
    c0 += carry
    frac0_q = np.where(carry, 0, frac0_q)
    step_q = np.rint(chip_slope * _QONE).astype(np.int64)
    win_start = np.mod(c0, 1023)
    b_idx = c0 // _CHIPS_PER_BIT
    edge_q = np.minimum((b_idx + 1) * _CHIPS_PER_BIT - c0, 1 << 20) * _QONE

    bit0 = np.empty(chips0.shape, np.float32)
    bit1 = np.empty(chips0.shape, np.float32)
    for i, table in enumerate(bit_tables):
        if wrap_bits:
            bit0[i] = table[np.mod(b_idx[i], len(table))]
            bit1[i] = table[np.mod(b_idx[i] + 1, len(table))]
        else:
            bit0[i] = table[np.clip(b_idx[i], 0, len(table) - 1)]
            bit1[i] = table[np.clip(b_idx[i] + 1, 0, len(table) - 1)]

    p0 = np.rint((cyc0 - np.floor(cyc0)) * 2.0**32).astype(np.int64)
    pw = np.rint(np.mod(cyc_slope, 1.0) * 2.0**32).astype(np.int64)
    to_i32 = lambda x: (np.bitwise_and(x, 0xFFFFFFFF)  # noqa: E731
                        - (np.bitwise_and(x, 0xFFFFFFFF) >> 31 << 32)).astype(np.int32)
    return _MsParams(win_start, frac0_q, step_q, bit0, bit1, edge_q,
                     to_i32(p0), to_i32(pw))


def _synth_chunk(config: ReceiverConfig, p: _MsParams, amps, codes3,
                 geometry) -> torch.Tensor:
    """Noise-free f32 samples of the ms chunk described by ``p`` ((S, n)
    device tensors) -> (n, samples_per_code)."""
    w, win_chips, h_base = geometry
    dev = codes3.device
    spms = config.samples_per_code
    k = torch.arange(spms, dtype=torch.int64, device=dev)
    t = k // _TILE
    j = k % _TILE
    hb = h_base[t]                                            # (spms,)

    col = lambda a: a[:, :, None]                             # noqa: E731
    pt = col(p.frac0_q) + col(p.step_q) * (t * _TILE)         # (S, n, spms)
    h_int = pt >> _Q
    frac24 = (pt & (_QONE - 1)) >> 16
    off = (frac24 + col(p.step_q >> 16) * j) >> 24
    loc = torch.clamp(h_int + off - hb, 0, w - 1)
    idx = col(p.win_start) + torch.clamp(hb + loc, 0, win_chips - 1)
    s, n = p.step_q.shape
    code_val = torch.gather(codes3, 1, idx.reshape(s, -1)).reshape(s, n, spms)
    bit_val = torch.where(pt + col(p.step_q) * j >= col(p.edge_q),
                          col(p.bit1), col(p.bit0))
    sin_v = sin_turns(carrier_turns(col(p.p0), col(p.pw), k))
    per_sat = col(amps) * code_val * bit_val * sin_v
    x = per_sat[0]
    for i in range(1, s):
        x = x + per_sat[i]
    return x


def _run_synth(config: ReceiverConfig, prns, params: _MsParams, amps, n_ms: int,
               noise_std: float, seed: int, device, chunk_ms: int) -> torch.Tensor:
    """int8 samples on ``device`` from the host tables, ``chunk_ms``
    milliseconds at a time.  ``amps``: (S,) constants or (S, n_ms)
    per-ms envelopes."""
    dev = resolve(device)
    s = len(prns)
    amps = np.asarray(amps, np.float32)
    if amps.ndim == 1:
        amps = np.broadcast_to(amps[:, None], (s, n_ms))
    if amps.shape != (s, int(n_ms)):
        raise ValueError(f"amplitudes must be (n_sats,) or (n_sats, n_ms), got {amps.shape}")
    codes = gold_codes()[np.asarray(prns) - 1].astype(np.float32)
    codes3 = torch.from_numpy(np.concatenate([codes, codes, codes], axis=1)).to(dev)
    w, win_chips, h_base = _window_geometry(config)
    geometry = (w, win_chips, torch.from_numpy(h_base).to(dev))
    params_d = _MsParams(*[torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                           for a in params])
    amps_d = torch.from_numpy(np.ascontiguousarray(amps)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    spms = config.samples_per_code
    out = torch.empty((n_ms, spms), dtype=torch.int8, device=dev)
    for m0 in range(0, n_ms, chunk_ms):
        m1 = min(n_ms, m0 + chunk_ms)
        x = _synth_chunk(config, _MsParams(*[a[:, m0:m1] for a in params_d]),
                         amps_d[:, m0:m1], codes3, geometry)
        if noise_std > 0.0:
            x = x + noise_std * torch.randn(x.shape, generator=gen,
                                            dtype=torch.float32, device=dev)
        out[m0:m1] = torch.clamp(torch.round(x), -128, 127).to(torch.int8)
    return out.reshape(-1)


def synthesize_signal(config: ReceiverConfig, sats: list[SatelliteSignal],
                      n_ms: int, noise_std: float = 0.0, seed: int = 0,
                      device="cuda", chunk_ms: int = 64) -> torch.Tensor:
    """Generate ``n_ms`` milliseconds of int8 IF samples on ``device`` (the
    card unless the caller names the CPU; raises without one),
    ``chunk_ms`` milliseconds at a time."""
    if config.sampling_freq % 1000:
        raise ValueError("synthesizer requires sampling_freq divisible by 1000")
    if not sats:
        raise ValueError("need at least one satellite")
    fs = config.sampling_freq
    spms = config.samples_per_code
    m = np.arange(n_ms, dtype=np.float64)[None, :] * spms       # sample at ms start

    fc = np.asarray([s.effective_code_freq(config) for s in sats])[:, None]
    d = np.asarray([s.delay_samples for s in sats])[:, None]
    chips0 = fc * (m - d) / fs
    chip_slope = np.broadcast_to(fc / fs, chips0.shape)
    fcar = np.asarray([config.intermediate_freq + s.doppler_hz for s in sats])[:, None]
    phi0 = np.asarray([s.phase0 for s in sats])[:, None]
    cyc0 = fcar * m / fs + phi0 / (2.0 * np.pi)
    cyc_slope = np.broadcast_to(fcar / fs, cyc0.shape)
    params = _build_params(chips0, chip_slope, cyc0, cyc_slope,
                           [_nav_bit_array(s) for s in sats])

    amps = np.empty((len(sats), n_ms), np.float32)
    for i, s in enumerate(sats):
        a = np.atleast_1d(np.asarray(s.amplitude, np.float32))
        k = min(len(a), n_ms)
        amps[i, :k] = a[:k]
        amps[i, k:] = a[-1]                                     # edge hold
    return _run_synth(config, [s.prn for s in sats], params, amps, n_ms, noise_std,
                      seed, device, chunk_ms)


def synthesize_dynamic(config: ReceiverConfig, prns: list[int],
                       delays_s: np.ndarray, bit_streams: np.ndarray,
                       t_rx0_minus_bits0: float, n_ms: int,
                       amplitudes: np.ndarray | None = None,
                       phase0: np.ndarray | None = None,
                       noise_std: float = 0.0, seed: int = 0,
                       clock_ppm: float = 0.0, device="cuda",
                       chunk_ms: int = 64) -> torch.Tensor:
    """Geometry-consistent IF capture with per-ms time-varying delays, on
    ``device`` (the card unless the caller names the CPU;
    softgnss_tpu.signals.synth.synthesize_dynamic).

    ``delays_s``: (S, >= n_ms+1) light times (s) at each ms boundary,
    linearly interpolated within the ms; ``bit_streams``: (S, n_bits) +/-1
    transmitted nav bits, bit 0 starting at transmit time 0;
    ``t_rx0_minus_bits0``: capture start minus bit-stream start, GPS s.
    ``amplitudes``: (S,) constants or (S, n_ms) per-ms envelopes.
    ``clock_ppm``: receiver-oscillator fractional frequency offset: the
    sampling clock runs at fs*(1+rho) and the LO at (f_L1 - f_IF)*(1+rho),
    so every signal appears with a common carrier offset of ~ -f_L1*rho Hz
    and a code-clock scale of 1/(1+rho); ``delays_s`` must be sampled at the
    true boundary times t_rx0 + k*1e-3/(1+rho) (scenario.synthesize_scenario
    does so).
    """
    if config.sampling_freq % 1000:
        raise ValueError("synthesizer requires sampling_freq divisible by 1000")
    s = len(prns)
    delays_s = np.asarray(delays_s, np.float64)
    if delays_s.shape[0] != s or delays_s.shape[1] < n_ms + 1:
        raise ValueError(f"delays_s must be (n_sats, >= n_ms+1), got {delays_s.shape}")
    bit_streams = np.asarray(bit_streams, np.float32)
    if not np.all(np.abs(bit_streams) == 1):
        raise ValueError("bit_streams must be +/-1")

    fs = config.sampling_freq
    spms = config.samples_per_code
    fc = config.code_freq_basis
    f_if = config.intermediate_freq
    f_l1 = config.l1_freq
    t0 = np.arange(n_ms, dtype=np.float64)[None, :] * (spms / fs)
    tau0 = delays_s[:, :n_ms]
    dtau = (delays_s[:, 1:n_ms + 1] - tau0) / spms              # s per sample

    # receiver-clock warp: sample k sits at true time k/(fs*(1+rho))
    rho = clock_ppm * 1e-6
    fc_x = fc / (1.0 + rho)
    f_if_x = (f_if - (f_l1 - f_if) * rho) / (1.0 + rho)

    chips0 = fc * (t_rx0_minus_bits0 - tau0) + fc_x * t0
    chip_slope = fc_x / fs - fc * dtau

    phi0 = (np.zeros(s) if phase0 is None else np.asarray(phase0))[:, None]
    cyc0 = f_if_x * t0 - f_l1 * tau0 + phi0 / (2.0 * np.pi)
    cyc_slope = f_if_x / fs - f_l1 * dtau

    params = _build_params(chips0, chip_slope, cyc0, cyc_slope, list(bit_streams),
                           wrap_bits=False)
    amps = (np.ones(s, np.float32) if amplitudes is None
            else np.asarray(amplitudes, np.float32))
    return _run_synth(config, prns, params, amps, n_ms, noise_std, seed, device, chunk_ms)


def synthesize_iq(config: ReceiverConfig, sats: list[SatelliteSignal], n_ms: int,
                  noise_std: float = 0.0, seed: int = 0, device="cuda",
                  chunk_ms: int = 64) -> torch.Tensor:
    """A complex baseband I/Q capture, (N, 2) int8 [I, Q] pairs on ``device``
    (softgnss_tpu.signals.synth.synthesize_iq).

    ``config.intermediate_freq`` is the recorded complex centre offset (0
    for a zero-IF front end); each satellite appears at
    ``intermediate_freq + doppler_hz``.  Q is the same synthesis with the
    carrier phase retarded by pi/2 and its own noise (seed + 0x5EED), so
    upconverting with :func:`softgnss_tpu_torch.io.upconvert_iq` gives the
    real capture :func:`synthesize_signal` emits at ``intermediate_freq +
    fs/4``: the test source of the iq8/iq16 front ends."""
    sats_q = [dataclasses.replace(s, phase0=s.phase0 - np.pi / 2.0) for s in sats]
    i = synthesize_signal(config, sats, n_ms, noise_std=noise_std, seed=seed, device=device,
                          chunk_ms=chunk_ms)
    q = synthesize_signal(config, sats_q, n_ms, noise_std=noise_std, seed=seed + 0x5EED,
                          device=device, chunk_ms=chunk_ms)
    return torch.stack([i, q], dim=1)


def default_scenario(config: ReceiverConfig, num_sats: int = 4, noise_std: float = 2.0,
                     seed: int = 7, device="cuda") -> tuple[list[SatelliteSignal], torch.Tensor]:
    """A reproducible multi-satellite scenario and its IF capture of
    ``ms_to_process + acquisition_ms + 2`` ms on ``device``: the JAX
    package's satellites for the same seed (its noise has the same spread,
    not the same numbers)."""
    rng = np.random.default_rng(seed)
    spc = config.samples_per_code
    sats = []
    for i in range(num_sats):
        sats.append(SatelliteSignal(
            prn=int(rng.integers(1, 33)) if i else 5,
            doppler_hz=float(rng.uniform(-4000, 4000)),
            delay_samples=float(rng.uniform(0, spc)),
            amplitude=float(rng.uniform(0.8, 1.5)),
            phase0=float(rng.uniform(0, 2 * np.pi)),
            nav_bits=tuple(rng.choice([-1, 1], size=64)),
        ))
    # distinct PRNs: a repeat takes the lowest PRN not yet handed out
    seen = set()
    uniq = []
    next_prn = 1
    for s in sats:
        prn = s.prn
        while prn in seen:
            prn = next_prn
            next_prn += 1
        seen.add(prn)
        uniq.append(dataclasses.replace(s, prn=prn))
    signal = synthesize_signal(config, uniq, config.ms_to_process + config.acquisition_ms + 2,
                               noise_std=noise_std, seed=seed, device=device)
    return uniq, signal
