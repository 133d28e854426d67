"""The JAX suite's acquisition-side scenario tests, on the port.

The non-slow tests of tests/test_nearfar.py (near-far acquisition),
tests/test_weak_signal.py (acquisition sensitivity), tests/test_clock_error.py
(the oscillator's Doppler bias and the hint-bias caveat) and
tests/test_full_model.py (the scenario's truth propagator).  Each runs on
the JAX test's own capture (the JAX synthesizer, passed to the port as
NumPy) with the JAX test's bounds, through the port's ``acquire`` on the
CPU; where it costs one more call, the port's decisions (the acquired
flags of every PRN, per trial) are also held equal to the JAX package's on
that capture.
"""

import dataclasses

import numpy as np
import pytest
import torch

import softgnss_tpu as sg
import softgnss_tpu_torch as sgt
from softgnss_tpu import scenario as jsc
from softgnss_tpu.acquire import acquire as jacquire
from softgnss_tpu.signals.synth import (
    SatelliteSignal,
    amplitude_for_cn0,
    synthesize_signal,
)
from softgnss_tpu_torch import convert
from softgnss_tpu_torch import scenario as tsc
from softgnss_tpu_torch.acquire.search import acquire as tacquire
from softgnss_tpu_torch.nav.message import build_nav_stream, decode_ephemeris
from softgnss_tpu_torch.nav.orbit import satellite_positions

torch.set_num_threads(1)

SIGMA = 2.0


def _acquire(jcfg, sig, **kw):
    """(port, JAX) acquisition of the same NumPy capture; the port's on the
    CPU at the same config.  The acquired flags agree."""
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    got = tacquire(tcfg, sig, device="cpu", **kw)
    want = jacquire(jcfg, sig, **kw)
    np.testing.assert_array_equal(got.acquired, want.acquired)
    return got


# --- tests/test_nearfar.py:35-98 ----------------------------------------------


def _nearfar(amp_strong, sats_seed, weak=True):
    cfg = sg.fast_config(number_of_channels=4, acq_noncoherent_ms=10)
    sats = [SatelliteSignal(prn=7, doppler_hz=1500.0, delay_samples=900.0, amplitude=amp_strong)]
    if weak:
        sats.append(SatelliteSignal(prn=13, doppler_hz=-2200.0, delay_samples=2600.0,
                                    amplitude=1.0))
    sig = np.asarray(synthesize_signal(cfg, sats, cfg.acquisition_ms + 1, noise_std=1.0,
                                       seed=sats_seed))
    return cfg, sig


def test_weak_prn_acquired_under_14db_interferer():
    cfg, sig = _nearfar(5.0, 21)
    acq = _acquire(cfg, sig)
    assert acq.acquired[7 - 1]
    assert acq.acquired[13 - 1], "weak PRN lost to the interferer"
    assert abs(int(acq.code_phase[13 - 1]) - 2600) <= 1
    assert abs(acq.carr_freq[13 - 1] - (cfg.intermediate_freq - 2200.0)) < 20.0


def test_weak_prn_at_20db_needs_hinted_threshold():
    cfg, sig = _nearfar(10.0, 21)
    cold = _acquire(cfg, sig)
    assert cold.acquired[7 - 1]
    assert not cold.acquired[13 - 1]
    assert abs(int(cold.code_phase[13 - 1]) - 2600) <= 1
    hints = np.full(32, np.nan)
    hints[13 - 1] = cfg.intermediate_freq - 2200.0
    assisted = _acquire(cfg.with_options(acq_threshold=1.5), sig, doppler_hints=hints)
    assert assisted.acquired[13 - 1]
    assert abs(int(assisted.code_phase[13 - 1]) - 2600) <= 1


def test_no_false_alarms_with_k10():
    cfg, sig = _nearfar(10.0, 22, weak=False)
    acq = _acquire(cfg, sig)
    absent = np.ones(32, bool)
    absent[7 - 1] = False
    assert not acq.acquired[absent].any(), 1 + np.flatnonzero(acq.acquired & absent)


# --- tests/test_weak_signal.py:36-114 -------------------------------------------


def _acq_trials(cfg_ref, cfg_nc, cn0, trials=8, seed=100):
    """tests/test_weak_signal.py:36-58: both schemes on the same captures;
    the port's detections and false alarms, its flags equal to JAX's."""
    rng = np.random.default_rng(seed)
    amp = amplitude_for_cn0(cfg_ref, cn0, SIGMA)
    det_ref = det_nc = false_alarms_nc = 0
    n_ms = max(cfg_ref.acquisition_ms, cfg_nc.acquisition_ms) + 1
    for _ in range(trials):
        prn = int(rng.integers(1, 33))
        sat = SatelliteSignal(
            prn=prn, doppler_hz=float(rng.uniform(-6000, 6000)),
            delay_samples=float(rng.uniform(0, cfg_ref.samples_per_code)),
            amplitude=amp, phase0=float(rng.uniform(0, 6.28)),
            nav_bits=tuple(rng.choice([-1, 1], size=32)))
        sig = np.asarray(synthesize_signal(cfg_ref, [sat], n_ms, noise_std=SIGMA,
                                           seed=int(rng.integers(1 << 30))))
        a_ref = _acquire(cfg_ref, sig[: cfg_ref.acquisition_ms * cfg_ref.samples_per_code])
        a_nc = _acquire(cfg_nc, sig[: cfg_nc.acquisition_ms * cfg_nc.samples_per_code])
        det_ref += int(a_ref.acquired[prn - 1])
        det_nc += int(a_nc.acquired[prn - 1])
        false_alarms_nc += int(a_nc.acquired.sum()) - int(a_nc.acquired[prn - 1])
    return det_ref, det_nc, false_alarms_nc


def test_noncoherent_beats_reference_scheme_at_43dbhz():
    det_ref, det_nc, fa_nc = _acq_trials(sg.fast_config(), sg.fast_config(acq_noncoherent_ms=10),
                                         cn0=43.0)
    assert det_nc >= 7, (det_ref, det_nc)
    assert det_ref <= 2, (det_ref, det_nc)
    assert fa_nc == 0


def test_both_detect_at_50dbhz():
    det_ref, det_nc, fa_nc = _acq_trials(sg.fast_config(), sg.fast_config(acq_noncoherent_ms=10),
                                         cn0=50.0, trials=4, seed=7)
    assert det_ref == 4 and det_nc == 4
    assert fa_nc == 0


def test_noncoherent_matches_reference_scheme_when_strong():
    cfg_ref, cfg_nc = sg.fast_config(), sg.fast_config(acq_noncoherent_ms=10)
    sat = SatelliteSignal(prn=21, doppler_hz=1234.0, delay_samples=555.0, amplitude=0.5,
                          nav_bits=tuple(np.resize([1, -1, 1, 1], 32)))
    sig = np.asarray(synthesize_signal(cfg_ref, [sat], cfg_nc.acquisition_ms + 1,
                                       noise_std=SIGMA, seed=5))
    a_ref = _acquire(cfg_ref, sig[: cfg_ref.acquisition_ms * cfg_ref.samples_per_code])
    a_nc = _acquire(cfg_nc, sig[: cfg_nc.acquisition_ms * cfg_nc.samples_per_code])
    assert a_ref.acquired[20] and a_nc.acquired[20]
    assert a_ref.code_phase[20] == a_nc.code_phase[20]
    assert abs(a_ref.carr_freq[20] - a_nc.carr_freq[20]) < 1.0
    assert a_nc.peak_metric[20] > a_ref.peak_metric[20]


def test_noise_only_no_detection_k10():
    cfg_nc = sg.fast_config(acq_noncoherent_ms=10)
    rng = np.random.default_rng(3)
    sig = rng.normal(0, SIGMA, cfg_nc.acquisition_ms * cfg_nc.samples_per_code).astype(np.int8)
    a = _acquire(cfg_nc, sig)
    assert not a.acquired.any()
    assert a.peak_metric.max() < 2.2


# --- tests/test_clock_error.py:24-45, 77-112 ------------------------------------


def test_apparent_doppler_includes_oscillator_bias():
    cfg = sg.fast_config(number_of_channels=5)
    sc0 = jsc.build_scenario(cfg, n_sats=5)
    jsc.synthesize_scenario(sc0, 2)
    geo = sc0.dopplers.copy()
    sc = jsc.build_scenario(cfg, n_sats=5, clock_ppm=2.0)
    sig = np.asarray(jsc.synthesize_scenario(sc, 40))
    acq = _acquire(cfg, sig)
    rho = 2e-6
    exp_bias = -cfg.l1_freq * rho / (1.0 + rho)
    for i, prn in enumerate(sc.prns):
        meas = acq.carr_freq[prn - 1] - cfg.intermediate_freq
        assert abs(meas - sc.dopplers[i]) < 5.0
        assert abs((meas - geo[i]) - exp_bias) < 6.0


def test_assisted_acquisition_hint_bias_caveat():
    cfg = sg.fast_config(number_of_channels=5)
    sc = jsc.build_scenario(cfg, n_sats=5, clock_ppm=2.0)
    sig = np.asarray(jsc.synthesize_scenario(sc, 40))
    cold = _acquire(cfg, sig)
    sc0 = jsc.build_scenario(cfg, n_sats=5)
    jsc.synthesize_scenario(sc0, 2)
    hints = np.full(32, np.nan)
    for i, prn in enumerate(sc.prns):
        hints[prn - 1] = cfg.intermediate_freq + sc0.dopplers[i]
    narrow = _acquire(cfg, sig, doppler_hints=hints, hint_halfwidth_hz=500.0)
    wide = _acquire(cfg, sig, doppler_hints=hints, hint_halfwidth_hz=4000.0)
    bias_fixed = _acquire(cfg, sig, doppler_hints=hints - cfg.l1_freq * 2e-6,
                          hint_halfwidth_hz=500.0)
    for prn in sc.prns:
        i = prn - 1
        assert abs(narrow.carr_freq[i] - cold.carr_freq[i]) > 1000.0 \
            or narrow.peak_metric[i] < cfg.acq_threshold
        for rec in (wide, bias_fixed):
            assert rec.peak_metric[i] > cfg.acq_threshold
            assert rec.code_phase[i] == cold.code_phase[i]
            assert abs(rec.carr_freq[i] - cold.carr_freq[i]) < 1e-6


# --- tests/test_full_model.py:31-71: the port's truth propagator ----------------


def test_truth_propagator_matches_receiver_satpos_on_decoded_ephemeris():
    sc = tsc.build_scenario(sgt.fast_config(), n_sats=5, full_model=True)
    t0 = sc.tow_count * 6.0
    for eph in sc.ephemerides:
        stream = build_nav_stream(eph, sc.tow_count - 1, 6)
        dec, _ = decode_ephemeris(stream[300:1800], stream[299])
        assert dec.complete
        for t in (t0, t0 + 17.0, t0 + 37.0):
            pos_r, clk_r = satellite_positions(t, [dec])
            pos_t = tsc.propagate_orbit(dec, np.asarray([t - clk_r[0]]))[:, 0]
            clk_t = tsc.satellite_clock_offset(dec, np.asarray([t]))[0]
            assert np.linalg.norm(pos_t - pos_r[:, 0]) < 0.02
            assert abs(clk_t - clk_r[0]) * 3e8 < 0.02


def test_truth_propagator_reduces_to_circular_closed_form():
    ce = tsc.circular_ephemeris(i_0=1.0, omega_0=1.2, m_0=0.7, t_oe=420000.0)
    ts = 420000.0 + np.asarray([0.0, 10.0, 37.0])
    np.testing.assert_allclose(tsc.propagate_orbit(ce, ts), tsc.propagate_circular(ce, ts),
                               rtol=0, atol=1e-6)
    assert np.all(tsc.satellite_clock_offset(ce, ts) == 0.0)


def test_truth_propagator_clock_offset_terms():
    eph = tsc.keplerian_ephemeris(t_oe=1000.0, e=0.01, a_f0=1e-4, a_f1=2e-11, t_gd=5e-9)
    dt = tsc.satellite_clock_offset(eph, np.asarray([1000.0 + 100.0]))[0]
    poly = 1e-4 + 2e-11 * 100.0 - 5e-9
    assert abs(dt - poly) < 25e-9
    assert dt != poly


# --- tests/test_end_to_end.py:37-43 on other noise draws (ROADMAP C.8) ----------


def test_e2e_code_phase_bound_sits_on_a_grid_tie():
    """The e2e scenario's +-1.5-sample code-phase bound against the truth:
    on the JAX test's own capture (seed 0) every PRN meets it; on seed 2
    of the JAX synthesizer PRN 3 lands one lag up, 1.556 samples from the
    truth, in the JAX package as in the port and the float64 oracle (the
    reference's code replica puts the correlation peak ~1 sample after the
    truth, between two lags).  scripts.scenarios.e2e therefore holds
    acquisition to the oracle on the card."""
    from softgnss_tpu_torch.oracle import oracle_acquire_grid

    jcfg = sg.fast_config(number_of_channels=5, ms_to_process=37000)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    sc = jsc.build_scenario(jcfg, n_sats=5, noise_std=1.5)
    need = jcfg.acquisition_ms * jcfg.samples_per_code
    worst = {}
    for seed in (0, 2):
        sig = np.asarray(jsc.synthesize_scenario(sc, jcfg.acquisition_ms + 1, seed=seed))[:need]
        got, want = tacquire(tcfg, sig, device="cpu"), jacquire(jcfg, sig)
        np.testing.assert_array_equal(got.code_phase, want.code_phase)
        offsets = []
        for i, prn in enumerate(sc.prns):
            assert got.code_phase[prn - 1] == oracle_acquire_grid(tcfg, sig, prn)[1]
            offsets.append(got.code_phase[prn - 1] - sc.expected_code_phase(i))
        worst[seed] = max(offsets, key=abs)
    assert abs(worst[0]) <= 1.5
    assert worst[2] == pytest.approx(1.556, abs=1e-3)
