"""The per-ms tracker against the block trackers, at C channels.

Port of ``scripts/parity_check.py``, which tracked C satellites at the
reference front end on the TPU's ``onehot`` route and its ``megakernel``
route and printed how far apart they landed.  The port has no onehot
route; its independent pair is the per-ms tracker (B4, the loop filters
in torch) against the block tracker (B2 + B1, the filters inside the
kernel) and the fused block tracker (B3).  For each pair it reports, as
the JAX script printed them: whether ``absolute_sample`` is equal, the
worst relative RMS over the six correlators, and each channel's ``i_p``
relative RMS.

Bounds (``chip_smoke.py``'s ROUTE_TOL, the North-star tolerances: both
routes run the same math): ``absolute_sample`` within +-1 and the worst
correlator relative RMS below 1e-3.

Run on a CUDA card from the repository root::

    python -m softgnss_tpu_torch.scripts.parity_check [C]

C defaults to 3; ``chip_smoke.py`` runs C = 3 and 12.  Without a CUDA
card it raises.  :func:`run` returns the figures.
"""

from __future__ import annotations

import sys

import numpy as np

from softgnss_tpu_torch.acquire.search import Channels
from softgnss_tpu_torch.config import default_config
from softgnss_tpu_torch.scripts.oracle_check import CORRELATORS, ROUTES
from softgnss_tpu_torch.signals.synth import SatelliteSignal, synthesize_signal
from softgnss_tpu_torch.track.scan import track

N_MS = 96
#: the per-ms route and the block routes it is held against
REFERENCE = "pallas"
PAIRED = ("megakernel", "fused")
BOUNDS = {"absolute_sample": 1, "worst_rms": 1e-3}


def capture(n_channels: int, device):
    """The JAX script's capture: PRNs 1..C at random Doppler and code
    phase (seed 7), 8 nav bits each, noise 0.8, seed 4, 100 ms."""
    config = default_config(number_of_channels=n_channels)
    rng = np.random.default_rng(7)
    prns = list(range(1, n_channels + 1))
    dops = [float(rng.uniform(-4000, 4000)) for _ in prns]
    phs = [int(rng.integers(0, config.samples_per_code)) for _ in prns]
    sats = [SatelliteSignal(prn=p, doppler_hz=d, delay_samples=float(s),
                            nav_bits=tuple(int(b) for b in rng.choice([-1, 1], size=8)))
            for p, d, s in zip(prns, dops, phs)]
    signal = synthesize_signal(config, sats, N_MS + 4, noise_std=0.8, seed=4, device=device)
    channels = Channels(prn=np.asarray(prns, np.int64),
                        acquired_freq=np.asarray([config.intermediate_freq + d for d in dops]),
                        code_phase=np.asarray(phs, np.int64), status=["T"] * n_channels)
    return config, signal, channels


def compare(a, b) -> dict:
    """The JAX script's figures of tracking ``b`` against ``a``."""
    d_abs = int(np.abs(a.absolute_sample - b.absolute_sample).max())
    worst = max(float(np.sqrt(np.mean((getattr(a, f) - getattr(b, f)) ** 2))
                      / np.sqrt(np.mean(getattr(a, f) ** 2))) for f in CORRELATORS)
    per_ch = [float(np.sqrt(np.mean((a.i_p[c] - b.i_p[c]) ** 2))
                    / max(1e-9, np.sqrt(np.mean(a.i_p[c] ** 2)))) for c in range(len(a.prn))]
    return {"abs_sample_equal": d_abs == 0, "max_abs_sample_diff": d_abs, "worst_rms": worst,
            "per_channel_i_p_rms": per_ch}


def describe(n_channels: int, label: str, figures: dict) -> str:
    return (f"C={n_channels} {label}: abs_sample_equal={figures['abs_sample_equal']} "
            f"worst_rms={figures['worst_rms']:.2e} per-ch i_p rms="
            + " ".join("%.0e" % x for x in figures["per_channel_i_p_rms"]))


def run(n_channels: int = 3, device="cuda") -> dict:
    """Track the capture on the per-ms route and on each block route;
    returns {"<per-ms> vs <block route>": figures} and raises on a missed
    bound."""
    config, signal, channels = capture(n_channels, device)
    runs = {r: track(config.with_options(**ROUTES[r]), signal, channels, n_ms=N_MS)
            for r in (REFERENCE, *PAIRED)}
    out = {}
    for route in PAIRED:
        label = f"{REFERENCE} vs {route}"
        out[label] = f = compare(runs[REFERENCE], runs[route])
        if f["max_abs_sample_diff"] > BOUNDS["absolute_sample"] or \
                not f["worst_rms"] < BOUNDS["worst_rms"]:
            raise AssertionError(f"C={n_channels} {label}: {f} past {BOUNDS}")
    return out


def main(argv=None) -> int:
    from softgnss_tpu_torch.scripts.timing import card, require_cuda

    argv = sys.argv[1:] if argv is None else argv
    n_channels = int(argv[0]) if argv else 3
    device = require_cuda()
    for label, figures in run(n_channels, device).items():
        print(f"{describe(n_channels, label, figures)} [{card()}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
