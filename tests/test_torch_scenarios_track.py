"""The JAX suite's tracking-sensitivity tests, on the port.

tests/test_weak_signal.py:109-176 (TestTrackingSensitivity): one live
channel of PRN 7 beside three idle ones (``prn=0``), at 35 and 30 dB-Hz,
with a 10-ms PDI and a 10-Hz PLL at 30 dB-Hz, and the DLL jitter against
C/N0.  Each runs on the JAX test's own capture (the JAX synthesizer,
passed to the port as NumPy) through the port's ``track`` on the CPU
(the block tracker's plain versions; PDI windows of 10 ms straddle its
64-ms blocks) with the JAX test's bounds.  For the three 3 000-ms runs
the JAX tracker also runs on the capture, and the lock detector's verdict
(whether the channel's lock loss is finite) must be the same for both.
"""

import dataclasses

import numpy as np
import torch

import softgnss_tpu as sg
from softgnss_tpu.acquire.search import Channels as JChannels
from softgnss_tpu.signals.synth import SatelliteSignal, amplitude_for_cn0, synthesize_signal
from softgnss_tpu.track import track as jtrack
from softgnss_tpu_torch import convert
from softgnss_tpu_torch.acquire.search import Channels
from softgnss_tpu_torch.profiling import channel_lock_loss, lock_metrics
from softgnss_tpu_torch.track.scan import track

torch.set_num_threads(1)

SIGMA = 2.0


def _track_at(cn0, n_ms=3000, with_jax=False, **cfg_kwargs):
    """tests/test_weak_signal.py:109-122 on the port: (port config, port
    tracking, and with ``with_jax`` whether the JAX tracker's channel lost
    lock on the same capture, else None)."""
    from softgnss_tpu.profiling import channel_lock_loss as jax_lock_loss

    jcfg = sg.fast_config(number_of_channels=4, **cfg_kwargs)
    amp = amplitude_for_cn0(jcfg, cn0, SIGMA)
    sat = SatelliteSignal(prn=7, doppler_hz=1700.0, delay_samples=900.0, amplitude=amp,
                          nav_bits=tuple(np.random.default_rng(2).choice([-1, 1], size=64)))
    sig = np.asarray(synthesize_signal(jcfg, [sat], n_ms + 2, noise_std=SIGMA, seed=11))
    args = dict(prn=np.asarray([7, 0, 0, 0], np.int64),
                acquired_freq=np.asarray([jcfg.intermediate_freq + 1700.0, 0, 0, 0]),
                code_phase=np.asarray([900, 0, 0, 0], np.int64), status=["T", "-", "-", "-"])
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    tr = track(cfg, sig, Channels(**args), n_ms=n_ms, device="cpu")
    jax_lost = None
    if with_jax:
        jax_lost = bool(np.isfinite(jax_lock_loss(jcfg, jtrack(jcfg, sig, JChannels(**args),
                                                               n_ms=n_ms))[0]))
    return cfg, tr, jax_lost


def test_lock_holds_at_35dbhz():
    cfg, tr, jax_lost = _track_at(35.0, with_jax=True)
    ip = np.abs(tr.i_p[0, 1000:]).mean()
    qp = np.abs(tr.q_p[0, 1000:]).mean()
    assert ip / qp > 1.5
    m = lock_metrics(cfg, tr, window_ms=1000)
    assert m["pll_lock"][0, -1] > 0.6
    assert np.isinf(channel_lock_loss(cfg, tr)[0])
    ferr = np.median(np.abs(tr.carr_freq[0, 1000:] - (cfg.intermediate_freq + 1700.0)))
    assert ferr < 40.0
    assert np.isfinite(channel_lock_loss(cfg, tr)[0]) == jax_lost
    # the idle channels stay zero
    assert not tr.i_p[1:].any() and not tr.q_p[1:].any()


def test_lock_lost_and_detected_at_30dbhz():
    cfg, tr, jax_lost = _track_at(30.0, with_jax=True)
    assert np.isfinite(channel_lock_loss(cfg, tr)[0])
    assert np.isfinite(channel_lock_loss(cfg, tr)[0]) == jax_lost


def test_pdi_extends_floor_to_30dbhz():
    cfg, tr, jax_lost = _track_at(30.0, with_jax=True, pdi_ms=10, pll_noise_bandwidth=10.0)
    ferr = np.median(np.abs(tr.carr_freq[0, 1000:] - (cfg.intermediate_freq + 1700.0)))
    assert ferr < 20.0
    ipk = np.abs(tr.i_p[0, 1000:3000].reshape(-1, 10).sum(1)).mean()
    qpk = np.abs(tr.q_p[0, 1000:3000].reshape(-1, 10).sum(1)).mean()
    assert ipk / qpk > 1.5, ipk / qpk
    assert np.isinf(channel_lock_loss(cfg, tr)[0])
    assert np.isfinite(channel_lock_loss(cfg, tr)[0]) == jax_lost
    # the loops update once per 10 ms, across the 64-ms block boundaries too
    changes = np.flatnonzero(np.diff(tr.carr_freq[0]) != 0)
    assert np.all(changes % 10 == 8), changes[:10]


def test_jitter_grows_monotonically():
    scatter = [np.std(_track_at(c, n_ms=1500)[1].dll_discr[0, 500:]) for c in (50.0, 40.0)]
    assert scatter[0] < scatter[1]
