"""What the probes share besides their timers: synthetic tracking inputs
(one satellite per channel, synthesized with
``signals.synth.synthesize_signal`` from a numpy seed, and the channels'
tracking state at the truth, as acquisition hands it to the tracker; the
same seed gives the same inputs on any device) and the bit-equality
check of a kernel against its plain version.

* :func:`channel_inputs` — the probes' inputs (C/N0 53 dB-Hz, random PRNs);
* :func:`sweep_inputs` — the route measurements' inputs (``profile_track``,
  ``mega_sweep``, ``trace_track``, ``glue_trace``): the one recipe that the
  JAX package's four scripts of those names each carry a copy of.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from softgnss_tpu_torch.acquire.search import Channels
from softgnss_tpu_torch.config import ReceiverConfig
from softgnss_tpu_torch.signals.synth import SatelliteSignal, amplitude_for_cn0, synthesize_signal
from softgnss_tpu_torch.track.scan import TrackState, capture_words, channel_tables, initial_state
from softgnss_tpu_torch.track.tables import build_tables

SEED = 20261016
NOISE_STD = 8.0
CN0_DBHZ = 53.0


class ChannelInputs(NamedTuple):
    signal: torch.Tensor      # (L,) int8 capture
    words: torch.Tensor       # (L/4,) int32 word view of it
    state: TrackState         # initial state of every channel
    code_pads: torch.Tensor   # (C, 1025) float32
    carr_basis: torch.Tensor  # (C,) float64
    active: torch.Tensor      # (C,) bool


def channel_inputs(config: ReceiverConfig, n_ms: int, device, seed: int = SEED,
                   n_idle: int = 0) -> ChannelInputs:
    """``n_ms`` ms of capture with ``config.number_of_channels``
    satellites (distinct PRNs, Doppler within +-4 kHz, whole-sample
    delays, C/N0 53 dB-Hz), each on its channel; the last ``n_idle``
    channels are idle."""
    rng = np.random.default_rng(seed)
    c = config.number_of_channels
    spc = config.samples_per_code
    prns = rng.choice(np.arange(1, 33), c, replace=False)
    doppler = rng.uniform(-4000.0, 4000.0, c)
    delay = rng.integers(0, spc, c)
    amp = amplitude_for_cn0(config, CN0_DBHZ, NOISE_STD)
    sats = [SatelliteSignal(prn=int(p), doppler_hz=float(d), delay_samples=float(s),
                            amplitude=amp, phase0=float(ph),
                            nav_bits=tuple(int(b) for b in rng.choice([-1, 1], 8)))
            for p, d, s, ph in zip(prns, doppler, delay, rng.uniform(0, 2 * np.pi, c))]
    sig = synthesize_signal(config, sats, n_ms, noise_std=NOISE_STD, seed=seed, device=device)
    channels = Channels(prn=prns.astype(np.int64),
                        acquired_freq=config.intermediate_freq + doppler,
                        code_phase=delay.astype(np.int64),
                        status=["T"] * (c - n_idle) + ["-"] * n_idle)
    return ChannelInputs(
        signal=sig, words=capture_words(sig),
        state=initial_state(config, channels, device),
        code_pads=build_tables(channels.prn, device),
        carr_basis=torch.as_tensor(channels.acquired_freq).to(device),
        active=torch.tensor([s == "T" for s in channels.status], device=device))


#: the route measurements' truth draws: np.random.default_rng(SWEEP_DRAWS)
SWEEP_DRAWS = 42
#: capture ms beyond the ms tracked (each JAX script synthesizes n + 3)
SWEEP_SLACK_MS = 3


class SweepInputs(NamedTuple):
    signal: torch.Tensor      # (L,) int8 capture of n_ms + SWEEP_SLACK_MS ms
    channels: Channels        # one channel per satellite at its truth, all 'T'
    tables: tuple             # scan.channel_tables(channels, device)
    sats: list                # the injected SatelliteSignal truth


def sweep_inputs(config: ReceiverConfig, n_ch: int, n_ms: int, device, seed: int = 9, *,
                 phase0: bool = True, nav_bits: bool = True,
                 noise_std: float = 1.0) -> SweepInputs:
    """The route measurements' capture: PRNs 1..``n_ch``, each drawing from
    ``np.random.default_rng(42)`` in turn a Doppler uniform in +-4 kHz, a
    whole-sample delay below ``samples_per_code``, with ``phase0`` a
    carrier phase uniform in [0, 6.28) and with ``nav_bits`` 64 nav bits;
    ``n_ms + 3`` ms synthesized at unit amplitude with ``noise_std`` and
    synthesizer seed ``seed``; the channels at the truth.  The JAX scripts
    draw: profile_track both, mega_sweep ``phase0`` only, trace_track the
    nav bits only, glue_trace neither."""
    rng = np.random.default_rng(SWEEP_DRAWS)
    spc = config.samples_per_code
    sats = []
    for prn in range(1, n_ch + 1):
        kw = dict(doppler_hz=float(rng.uniform(-4000, 4000)),
                  delay_samples=float(rng.integers(0, spc)))
        if phase0:
            kw["phase0"] = float(rng.uniform(0, 6.28))
        if nav_bits:
            kw["nav_bits"] = tuple(int(b) for b in rng.choice([-1, 1], size=64))
        sats.append(SatelliteSignal(prn=prn, **kw))
    signal = synthesize_signal(config, sats, n_ms + SWEEP_SLACK_MS, noise_std=noise_std,
                               seed=seed, device=device)
    channels = Channels(
        prn=np.arange(1, n_ch + 1, dtype=np.int64),
        acquired_freq=np.asarray([config.intermediate_freq + s.doppler_hz for s in sats]),
        code_phase=np.asarray([int(s.delay_samples) for s in sats], np.int64),
        status=["T"] * n_ch)
    return SweepInputs(signal, channels, channel_tables(channels, signal.device), sats)


def assert_bit_equal(label: str, got: dict, want: dict) -> float:
    """Raise unless every tensor of ``got`` equals its namesake in ``want``
    bit for bit (NaNs never agree); returns the largest absolute
    difference, 0.0, for the record."""
    worst = 0.0
    for name, a in got.items():
        b = want[name]
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{label}: {name} is {a.dtype} {tuple(a.shape)}, the plain "
                                 f"version's {b.dtype} {tuple(b.shape)}")
        diff = float((a.to(torch.float64) - b.to(torch.float64)).abs().max()) if a.numel() else 0.0
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: {name} differs from the plain version "
                                 f"(max abs diff {diff:.3e})")
        worst = max(worst, diff)
    return worst
