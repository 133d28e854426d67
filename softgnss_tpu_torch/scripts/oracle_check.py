"""The port's tracking routes against the float64 NumPy oracle.

Port of ``scripts/oracle_check.py``, which tracked three satellites at the
reference front end with the TPU implementations and printed each one's
deviation from ``oracle_track_channel``.  Here the three routes of the
port each track the same capture, and each is held to the oracle on the
North-star bounds (``tests/test_tracking.py:76-92``):

* ``megakernel`` — the block tracker, B2 + B1 (the main path);
* ``fused`` — the block tracker with ``mega_fused_frames=True``, B3;
* ``pallas`` — the per-ms tracker, B4 with the loop filters in torch.

Bounds, per channel: each of the six correlators' RMS deviation below
1e-3 of the oracle's prompt RMS, ``absolute_sample`` within +-1 sample,
``carr_freq`` within 0.5 Hz and ``code_freq`` within 0.05 Hz at every ms.
The JAX script tracked 96 ms (1.5 blocks of 64 ms); this tracks
:data:`N_MS` = 1 000, across 15 block boundaries and past the loops'
settling.  The oracle's float64 ``ceil`` code phase is not the port's
Q40 NCO: a +-1 ``absolute_sample`` gap is the reference's own rounding
envelope (softgnss_tpu_torch/signals/nco.py), not a fault.

Run on a CUDA card from the repository root::

    python -m softgnss_tpu_torch.scripts.oracle_check

It prints each route's figures beside nvidia-smi's card line and exits
non-zero on a missed bound; without a CUDA card it raises.
:func:`run` returns the figures (``chip_smoke.py`` and the tests call it;
the tests on the CPU, with the kernels' plain versions).
"""

from __future__ import annotations

import sys

import numpy as np

from softgnss_tpu_torch.acquire.search import Channels
from softgnss_tpu_torch.config import ReceiverConfig, default_config
from softgnss_tpu_torch.oracle import oracle_track_channel
from softgnss_tpu_torch.signals.synth import SatelliteSignal, synthesize_signal
from softgnss_tpu_torch.track.scan import track

#: (PRN, Doppler Hz, code phase samples) of the JAX script
SATS = ((5, 1200.0, 3333), (11, -2500.0, 17777), (20, 400.0, 404))
N_MS = 1000
#: route name -> config options (the JAX script's correlator_impl names)
ROUTES = {"megakernel": {"correlator_impl": "megakernel"},
          "fused": {"correlator_impl": "megakernel", "mega_fused_frames": True},
          "pallas": {"correlator_impl": "pallas"}}
#: the North-star bounds (tests/test_tracking.py:76-92)
BOUNDS = {"corr_rel_rms": 1e-3, "absolute_sample": 1, "carr_freq_hz": 0.5,
          "code_freq_hz": 0.05}
CORRELATORS = ("i_p", "q_p", "i_e", "i_l", "q_e", "q_l")


def capture(config: ReceiverConfig, n_ms: int, device):
    """The JAX script's capture, ``n_ms`` + 4 ms long: the three satellites
    with 8 random nav bits each, noise 0.8, seed 4; and its channels at the
    truth."""
    rng = np.random.default_rng(7)
    sats = [SatelliteSignal(prn=p, doppler_hz=d, delay_samples=float(s),
                            nav_bits=tuple(int(b) for b in rng.choice([-1, 1], size=8)))
            for p, d, s in SATS]
    signal = synthesize_signal(config, sats, n_ms + 4, noise_std=0.8, seed=4, device=device)
    channels = Channels(prn=np.asarray([p for p, _, _ in SATS], np.int64),
                        acquired_freq=np.asarray([config.intermediate_freq + d
                                                  for _, d, _ in SATS]),
                        code_phase=np.asarray([s for _, _, s in SATS], np.int64),
                        status=["T"] * len(SATS))
    return signal, channels


def oracle_logs(config: ReceiverConfig, signal: np.ndarray, channels: Channels,
                n_ms: int) -> list:
    """``oracle_track_channel`` of every tracking channel (None for idle
    ones), from the channel's acquired frequency and code phase."""
    return [oracle_track_channel(config, signal, int(prn), float(f), int(cp), n_ms)
            if s == "T" else None
            for prn, f, cp, s in zip(channels.prn, channels.acquired_freq,
                                     channels.code_phase, channels.status)]


def deviation(tracking, logs: list, n_ms: int) -> dict:
    """The first ``n_ms`` ms of ``tracking`` against the oracle ``logs``:
    the worst over the channels of each bounded figure, and per channel
    the worst correlator's relative RMS."""
    out = {k: 0.0 for k in BOUNDS}
    per_ch = []
    for c, ora in enumerate(logs):
        if ora is None:
            per_ch.append(None)
            continue
        scale = np.sqrt(np.mean(ora["i_p"] ** 2))
        rms = max(np.sqrt(np.mean((getattr(tracking, k)[c, :n_ms] - ora[k]) ** 2)) / scale
                  for k in CORRELATORS)
        per_ch.append(float(rms))
        figures = {
            "corr_rel_rms": rms,
            "absolute_sample": np.max(np.abs(tracking.absolute_sample[c, :n_ms]
                                             - ora["absolute_sample"])),
            "carr_freq_hz": np.max(np.abs(tracking.carr_freq[c, :n_ms] - ora["carr_freq"])),
            "code_freq_hz": np.max(np.abs(tracking.code_freq[c, :n_ms] - ora["code_freq"]))}
        out = {k: max(out[k], float(v)) for k, v in figures.items()}
    out["per_channel_rms"] = per_ch
    return out


def check(label: str, figures: dict) -> None:
    """Raise if ``figures`` (:func:`deviation`) miss a North-star bound."""
    missed = {k: figures[k] for k, bound in BOUNDS.items()
              if not (figures[k] <= bound if k == "absolute_sample" else figures[k] < bound)}
    if missed:
        raise AssertionError(f"{label} against the float64 oracle: {missed} past {BOUNDS}")


def describe(figures: dict) -> str:
    return (f"correlator rel RMS max {figures['corr_rel_rms']:.2e}, max|dAS| "
            f"{figures['absolute_sample']:.0f}, max|dcarr| {figures['carr_freq_hz']:.2e} Hz, "
            f"max|dcode| {figures['code_freq_hz']:.2e} Hz")


def run(device="cuda", n_ms: int = N_MS, routes=tuple(ROUTES)) -> dict:
    """Track the capture on each of ``routes`` over ``n_ms`` ms on
    ``device`` and hold each to the oracle; returns {route: figures} and
    raises on a missed bound."""
    config = default_config(number_of_channels=len(SATS))
    signal, channels = capture(config, n_ms, device)
    logs = oracle_logs(config, signal.cpu().numpy(), channels, n_ms)
    out = {}
    for route in routes:
        tr = track(config.with_options(**ROUTES[route]), signal, channels, n_ms=n_ms)
        out[route] = deviation(tr, logs, n_ms)
        check(route, out[route])
    return out


def main() -> int:
    from softgnss_tpu_torch.scripts.timing import card, require_cuda

    device = require_cuda()
    for route, figures in run(device).items():
        print(f"{route:10s} vs f64 oracle over {N_MS} ms, {len(SATS)} channels: "
              f"{describe(figures)} [{card()}]")
    print("every route within the North-star bounds of the oracle")
    return 0


if __name__ == "__main__":
    sys.exit(main())
