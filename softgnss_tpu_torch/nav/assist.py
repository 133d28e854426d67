"""Acquisition assistance from a prior ephemeris set (warm start).

The port of softgnss_tpu.nav.assist: with ephemerides, an approximate
receiver position and approximate GPS time, each visible satellite's
Doppler is predictable to a few Hz; ``predict_doppler`` feeds
``acquire.acquire(doppler_hints=...)``.  The measured Doppler also carries
the front-end oscillator offset (common to all PRNs): add it to the hints
if known, or widen ``hint_halfwidth_hz`` to cover it.
"""

from __future__ import annotations

import numpy as np

from softgnss_tpu_torch.config import ReceiverConfig
from softgnss_tpu_torch.nav.message import Ephemeris
from softgnss_tpu_torch.nav.orbit import satellite_positions


def predict_doppler(config: ReceiverConfig, ephemerides: list[Ephemeris | None],
                    rx_ecef: np.ndarray, tow: float,
                    dt: float = 0.5) -> np.ndarray:
    """(32,) predicted absolute carrier frequencies (IF + Doppler), NaN
    where no complete ephemeris is supplied: range rate by central finite
    difference of the broadcast orbit over ``dt`` seconds,
    Doppler = -range_rate / c * f_L1."""
    out = np.full(32, np.nan)
    idx = [i for i, e in enumerate(ephemerides[:32])
           if e is not None and e.complete]
    if not idx:
        return out
    ephs = [ephemerides[i] for i in idx]
    pos_a, _ = satellite_positions(tow - dt / 2, ephs)      # (3, S)
    pos_b, _ = satellite_positions(tow + dt / 2, ephs)
    rx = np.asarray(rx_ecef, np.float64).reshape(3, 1)
    r_a = np.linalg.norm(pos_a - rx, axis=0)
    r_b = np.linalg.norm(pos_b - rx, axis=0)
    range_rate = (r_b - r_a) / dt                           # m/s, + = receding
    doppler = -range_rate / config.speed_of_light * config.l1_freq
    out[np.asarray(idx)] = config.intermediate_freq + doppler
    return out
