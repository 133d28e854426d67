"""What the probes share besides their timers: synthetic tracking inputs
(one satellite per channel, synthesized with
``signals.synth.synthesize_signal`` from a numpy seed, and the channels'
tracking state at the truth, as acquisition hands it to the tracker; the
same seed gives the same inputs on any device) and the bit-equality
check of a kernel against its plain version."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from softgnss_tpu_torch.acquire.search import Channels
from softgnss_tpu_torch.config import ReceiverConfig
from softgnss_tpu_torch.signals.synth import SatelliteSignal, amplitude_for_cn0, synthesize_signal
from softgnss_tpu_torch.track.scan import TrackState, capture_words, initial_state
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
