"""The JAX package's closed-loop scenario suite, on the port.

One function per closed-loop scenario of the JAX suite's ``slow`` tests.
Each builds its scenario with :func:`softgnss_tpu_torch.scenario.
build_scenario` / :func:`~softgnss_tpu_torch.scenario.synthesize_scenario`
at the JAX test's configuration (``fast_config``, 37 000 ms), runs
:func:`softgnss_tpu_torch.pipeline.run_receiver` on ``device`` (the card
unless the caller names the CPU), checks the JAX test's own bounds (cited
by file and line in each function), returns its figures, and raises
AssertionError on a missed bound.  ``synth(sc, n_ms)``, where given,
supplies the capture in place of the port's synthesizer (the CPU tests
pass the JAX synthesizer's, the JAX test's own capture):

* :func:`e2e`, :func:`unhealthy`, :func:`killed` —
  ``tests/test_end_to_end.py``;
* :func:`nearfar_demotion`, :func:`tow_vote` — ``tests/test_nearfar.py``;
* :func:`weak_45dbhz` — ``tests/test_weak_signal.py``;
* :func:`high_dynamics` — ``tests/test_high_dynamics.py`` (1.5 g);
* :func:`kinematic` — ``tests/test_kinematic.py``;
* :func:`full_model` — ``tests/test_full_model.py``;
* :func:`clock_ppm` — ``tests/test_clock_error.py`` (+-ppm);
* :func:`oracle_nav_parity` — ``tests/test_oracle_parity.py``'s
  navigation-stage parity against the float64 oracle.

:data:`SCENARIOS` lists them as the CLI and ``chip_smoke.py`` run them.
The time-sharded case of ``tests/test_end_to_end.py:169`` runs on a mesh
(``tests/test_torch_scenarios_e2e.py`` on the CPU; ``chip_smoke.py``'s
mesh phase on the card).  Run every scenario on a CUDA card from the
repository root::

    python -m softgnss_tpu_torch.scripts.scenarios [name ...]

Each prints its seconds and figures beside nvidia-smi's card line;
without a CUDA card it raises.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import logging
import sys
import time

import numpy as np

from softgnss_tpu_torch.acquire.search import Channels, acquire
from softgnss_tpu_torch.config import fast_config
from softgnss_tpu_torch.nav.solve import post_navigate
from softgnss_tpu_torch.oracle import oracle_acquire_grid, oracle_navigate
from softgnss_tpu_torch.pipeline import run_receiver
from softgnss_tpu_torch.scenario import build_scenario, synthesize_scenario
from softgnss_tpu_torch.signals.synth import amplitude_for_cn0

N_MS = 37000
C_LIGHT = 299792458.0


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def scenario_config(**kwargs):
    """The JAX scenario tests' configuration: ``fast_config`` with 5
    channels over N_MS ms, ``kwargs`` overriding."""
    return fast_config(**{"number_of_channels": 5, "ms_to_process": N_MS, **kwargs})


def capture(sc, device, synth=None, n_ms: int | None = None):
    """The scenario's capture of ``n_ms`` ms (by default N_MS plus
    acquisition and slack, as the JAX tests synthesize it): the port's
    synthesizer on ``device``, or ``synth(sc, n_ms)`` where given (which
    fills ``sc.delays`` / ``sc.dopplers`` as synthesize_scenario does; the
    tests pass the JAX synthesizer's capture of the same scenario)."""
    n_ms = N_MS + sc.config.acquisition_ms + 2 if n_ms is None else n_ms
    if synth is not None:
        return synth(sc, n_ms)
    return synthesize_scenario(sc, n_ms, device=device)


def _errors(sol, truth) -> np.ndarray:
    """(E,) 3D error of every epoch's fix (NaN where none) against
    ``truth``, (3,) or (3, E)."""
    truth = np.asarray(truth, np.float64).reshape(3, -1)
    return np.sqrt((sol.x - truth[0]) ** 2 + (sol.y - truth[1]) ** 2 + (sol.z - truth[2]) ** 2)


def _epoch_times(sc, sol) -> np.ndarray:
    """GPS receive time of every epoch."""
    epoch_ms = sol.first_epoch_ms + sol._period_ms * np.arange(sol.n_epochs)
    return sc.t_rx0 + epoch_ms / 1000.0


def _check_static_fix(label, sol, sc, median_m: float, mean_m: float | None = None) -> dict:
    """>= 90 % of epochs fixed, 3D error median (and mean) under the
    bounds against the static truth."""
    err = _errors(sol, sc.receiver_ecef)
    ok = np.isfinite(sol.x)
    out = {"fixed": int(ok.sum()), "epochs": int(sol.n_epochs),
           "err_median_m": float(np.median(err[ok])), "err_mean_m": float(np.mean(err[ok]))}
    check(ok.sum() >= 0.9 * sol.n_epochs, f"{label}: {out}")
    check(out["err_median_m"] < median_m, f"{label}: {out}")
    if mean_m is not None:
        check(out["err_mean_m"] < mean_m, f"{label}: {out}")
    return out


def e2e(device="cuda", synth=None) -> dict:
    """tests/test_end_to_end.py:26-31 (scenario), :37-97 (bounds): 5
    satellites at noise 1.5, acquired, locked, ephemerides decoded, the
    fix and velocity within their bounds.  Acquisition (:37-43) is held to
    the float64 oracle's code phase and Doppler bin on this capture and to
    the truth carrier within 20 Hz; the JAX test's +-1.5-sample code-phase
    bound against the truth sits on a tie of the acquisition grid (the JAX
    package misses it on 12 of 20 noise seeds of its own synthesizer,
    ROADMAP C.8), so each PRN's code phase minus the truth is returned
    (``code_phase_minus_truth``) and the tests hold it to that bound on the
    JAX test's own capture."""
    cfg = scenario_config()
    sc = build_scenario(cfg, n_sats=5, noise_std=1.5)
    sig = capture(sc, device, synth)
    res = run_receiver(cfg, signal=sig, device=device)
    acq, tr = res.acquisition, res.tracking
    window = sig[cfg.skip_samples: cfg.skip_samples + cfg.acquisition_ms * cfg.samples_per_code]
    window = window.cpu().numpy() if hasattr(window, "cpu") else np.asarray(window)
    offsets = {}
    for i, prn in enumerate(sc.prns):                                       # :37-43
        check(acq.acquired[prn - 1], f"e2e: PRN {prn} not acquired")
        _, phase, doppler_bin, _ = oracle_acquire_grid(cfg, window, prn)
        check(acq.code_phase[prn - 1] == phase and acq.doppler_bin[prn - 1] == doppler_bin,
              f"e2e: PRN {prn} acquired at code phase {acq.code_phase[prn - 1]}, bin "
              f"{acq.doppler_bin[prn - 1]}; the oracle's {phase}, {doppler_bin}")
        check(abs(acq.carr_freq[prn - 1] - sc.expected_carrier_freq(i)) < 20.0,
              f"e2e: PRN {prn} carrier {acq.carr_freq[prn - 1]}")
        offsets[int(prn)] = float(acq.code_phase[prn - 1] - sc.expected_code_phase(i))
    ratios = []
    for c in range(len(tr.prn)):                                            # :45-53
        if tr.status[c] == "-":
            continue
        ratios.append(float(np.abs(tr.i_p[c, 2000:]).mean() / np.abs(tr.q_p[c, 2000:]).mean()))
        check(ratios[-1] > 4.0, f"e2e: channel {c} not phase locked ({ratios[-1]:.2f})")
    for i, prn in enumerate(sc.prns):                                       # :55-63
        eph, truth = res.ephemerides[prn - 1], sc.ephemerides[i]
        check(eph is not None and eph.complete, f"e2e: PRN {prn} ephemeris missing")
        check(abs(eph.sqrt_a - truth.sqrt_a) <= 2.0**-19 and eph.t_oe == truth.t_oe
              and eph.iode_sf2 == truth.iode_sf2, f"e2e: PRN {prn} ephemeris differs")
    check(res.has_fix, "e2e: no fix")                                       # :65-80
    sol = res.solutions
    check(sol.tow == sc.tow_count * 6, f"e2e: TOW {sol.tow}")
    out = _check_static_fix("e2e", sol, sc, 30.0, 40.0)
    out["lat_median_deg"] = float(np.nanmedian(np.abs(sol.latitude - 47.0)))
    out["lon_median_deg"] = float(np.nanmedian(np.abs(sol.longitude - 8.5)))
    check(out["lat_median_deg"] < 0.01 and out["lon_median_deg"] < 0.01, f"e2e: {out}")
    v = np.sqrt(sol.vx**2 + sol.vy**2 + sol.vz**2)                          # :82-90
    ok_v = np.isfinite(v)
    out["v_median_ms"] = float(np.median(v[ok_v]))
    check(ok_v.sum() >= 0.9 * sol.n_epochs and out["v_median_ms"] < 0.3, f"e2e: {out}")
    ok = np.isfinite(sol.x)                                                 # :92-97
    check(np.all(sol.dop[0][ok] > 0), "e2e: DOP not positive")
    el = sol.el[np.isfinite(sol.el)]
    check(np.all(el >= cfg.elevation_mask_deg - 1.0), "e2e: elevation under the mask")
    out["min_i_p_over_q_p"] = min(ratios)
    out["code_phase_minus_truth"] = offsets
    return out


def unhealthy(device="cuda", synth=None) -> dict:
    """tests/test_end_to_end.py:100-119: the first satellite broadcasts SV
    health 1; it never enters a solution, and the fix survives."""
    cfg = scenario_config()
    sc = build_scenario(cfg, n_sats=5, noise_std=1.5)
    sc.ephemerides = [dataclasses.replace(e) for e in sc.ephemerides]
    sc.ephemerides[0].health = 1
    sick = sc.prns[0]
    res = run_receiver(cfg, signal=capture(sc, device, synth), device=device)
    check(res.has_fix, "unhealthy: no fix")
    check(not (res.solutions.prn == sick).any(), f"unhealthy: PRN {sick} used")
    err = _errors(res.solutions, sc.receiver_ecef)
    out = {"sick_prn": int(sick), "err_median_m": float(np.nanmedian(err))}
    check(out["err_median_m"] < 30.0, f"unhealthy: {out}")
    return out


def killed(device="cuda", synth=None) -> dict:
    """tests/test_end_to_end.py:121-167: the last satellite's signal dies at
    33 s; its channel is demoted near the kill, later epochs exclude it,
    and the fix survives on four satellites.  The JAX test reuses the
    e2e run's channels; here acquisition runs on this capture, whose first
    33 s are the e2e scenario's."""
    cfg = scenario_config()
    sc = build_scenario(cfg, n_sats=5, noise_std=1.5)
    kill_ms = 33000
    n_sig = N_MS + cfg.acquisition_ms + 2
    env = np.ones((len(sc.prns), n_sig), np.float32)
    env[-1, kill_ms:] = 0.0
    sc = dataclasses.replace(sc, amplitude_ms=env)
    res = run_receiver(cfg, signal=capture(sc, device, synth, n_sig), device=device)
    tr = res.tracking
    ch = int(np.flatnonzero(tr.prn == sc.prns[-1])[0])
    check(tr.status[ch] == "L", f"killed: status {tr.status}")
    check(kill_ms - cfg.lock_window_ms <= tr.lock_loss_ms[ch] <= kill_ms + 2 * cfg.lock_window_ms,
          f"killed: lock lost at {tr.lock_loss_ms[ch]} ms")
    for c in range(len(tr.prn)):
        if c != ch and tr.status[c] != "-":
            check(np.isinf(tr.lock_loss_ms[c]), f"killed: channel {c} demoted")
    check(res.has_fix, "killed: no fix")
    sol = res.solutions
    out = _check_static_fix("killed", sol, sc, 30.0)
    ms_idx = sol.first_subframe[ch] + cfg.nav_sol_period_ms * np.arange(sol.n_epochs)
    late = np.flatnonzero(ms_idx >= tr.lock_loss_ms[ch])
    check(late.size >= 3, f"killed: {late.size} epochs after the loss")
    check(np.all(np.isnan(sol.el[ch, late])), "killed: the dead channel stays in late epochs")
    late_ok = np.isfinite(sol.x[late])
    late_err = _errors(sol, sc.receiver_ecef)[late][late_ok]
    out.update(lock_loss_ms=float(tr.lock_loss_ms[ch]), late_epochs=int(late.size),
               late_fixed_share=float(late_ok.mean()), late_err_median_m=float(np.median(late_err)))
    check(out["late_fixed_share"] >= 0.8 and out["late_err_median_m"] < 100.0, f"killed: {out}")
    return out


def nearfar_demotion(device="cuda", synth=None) -> dict:
    """tests/test_nearfar.py:102-140: a sixth channel assigned to an absent
    PRN (a near-far false alarm) tracks noise; the lock monitor demotes it
    alone, navigation never uses it, and the fix stays clean."""
    cfg = scenario_config(number_of_channels=6)
    sc = build_scenario(cfg, n_sats=5)
    sig = capture(sc, device, synth, 37020)
    acq = acquire(cfg, sig[:cfg.acquisition_ms * cfg.samples_per_code], device=device)
    absent = next(p for p in range(1, 33) if p not in sc.prns)
    prns = np.asarray(sc.prns)
    channels = Channels(
        prn=np.concatenate([prns, [absent]]).astype(np.int64),
        acquired_freq=np.concatenate([acq.carr_freq[prns - 1], [cfg.intermediate_freq + 800.0]]),
        code_phase=np.concatenate([acq.code_phase[prns - 1], [1234]]).astype(np.int64),
        status=["T"] * 6)
    res = run_receiver(cfg, signal=sig, channels=channels, device=device)
    loss = np.asarray(res.tracking.lock_loss_ms)
    check(np.isfinite(loss[5]), "nearfar: false-lock channel not demoted")
    check(not np.isfinite(loss[:5]).any(), f"nearfar: real channels demoted {loss}")
    check(res.has_fix, "nearfar: no fix")
    sol = res.solutions
    xyz = np.stack([sol.x, sol.y, sol.z], 1)
    ok = np.isfinite(xyz).all(1)
    out = {"absent_prn": int(absent), "lock_loss_ms": float(loss[5]),
           "err_median_m": float(np.median(np.linalg.norm(xyz[ok] - sc.receiver_ecef, axis=1)))}
    check(out["err_median_m"] < 30.0, f"nearfar: {out}")
    check(sol.first_subframe[5] == 0, "nearfar: the noise channel frame-synced")
    check(not np.isfinite(sol.raw_p[5]).any() or (sol.prn[5] == 0).all(),
          "nearfar: the noise channel has pseudoranges")
    return out


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def tow_vote(device="cuda", synth=None) -> dict:
    """tests/test_nearfar.py:142-169: one channel's bit stream shifted a
    whole subframe (TOW 6 s off) is dropped by the majority vote, with a
    warning from softgnss_tpu_torch.nav.solve, and the fix stays clean."""
    cfg = scenario_config()
    sc = build_scenario(cfg, n_sats=5)
    res = run_receiver(cfg, signal=capture(sc, device, synth, 37020), navigate=False,
                       device=device)
    tr = res.tracking
    ip = np.asarray(tr.i_p).copy()
    ip[4, :-6000] = ip[4, 6000:]
    ip[4, -6000:] = ip[4, -12000:-6000]
    records = _Records()
    log = logging.getLogger("softgnss_tpu_torch.nav.solve")
    log.addHandler(records)
    try:
        sol, _ = post_navigate(cfg, dataclasses.replace(tr, i_p=ip))
    finally:
        log.removeHandler(records)
    check(sol is not None, "tow vote: no solution")
    check(any("TOW" in m and "disagrees" in m for m in records.messages),
          f"tow vote: no TOW warning in {records.messages}")
    xyz = np.stack([sol.x, sol.y, sol.z], 1)
    ok = np.isfinite(xyz).all(1)
    out = {"err_median_m": float(np.median(np.linalg.norm(xyz[ok] - sc.receiver_ecef, axis=1)))}
    check(out["err_median_m"] < 50.0, f"tow vote: {out}")
    return out


def weak_45dbhz(device="cuda", synth=None) -> dict:
    """tests/test_weak_signal.py:180-204: 5 satellites at 45 dB-Hz (noise
    2.0), K=10 non-coherent acquisition finds them all, and the fix lands
    within the weak-signal budget."""
    cfg = scenario_config(acq_noncoherent_ms=10)
    amp = amplitude_for_cn0(cfg, 45.0, 2.0)
    sc = build_scenario(cfg, n_sats=5, noise_std=2.0, amplitude=amp)
    res = run_receiver(cfg, signal=capture(sc, device, synth), device=device)
    check(res.has_fix, "weak: no fix")
    for prn in sc.prns:
        check(res.acquisition.acquired[prn - 1], f"weak: PRN {prn} missed")
    return _check_static_fix("weak 45 dB-Hz", res.solutions, sc, 60.0)


def high_dynamics(device="cuda", synth=None) -> dict:
    """tests/test_high_dynamics.py:19-85: the receiver accelerates at 1.5 g
    for 37 s; tracking holds through the Doppler sweep, the least-squares
    fixes follow the curved trajectory, and the EKF tracks the velocity
    ramp."""
    cfg = scenario_config()
    sc = build_scenario(cfg, n_sats=5, noise_std=1.5, velocity_enu=(5.0, -3.0, 0.0),
                        accel_enu=(10.0, 11.0, 0.0))
    tr = run_receiver(cfg, signal=capture(sc, device, synth), navigate=False,
                      device=device).tracking
    tail = slice(-2000, None)                                               # :36-49
    active = [i for i, s in enumerate(tr.status) if s == "T"]
    ratio = (np.abs(tr.i_p[:, tail]).mean(axis=1) / np.abs(tr.q_p[:, tail]).mean(axis=1))[active]
    check((ratio > 5.0).all(), f"high dynamics: |I_P|/|Q_P| {ratio}")
    cf = tr.carr_freq
    sweep = np.abs(cf[active, -100:].mean(axis=1) - cf[active, :100].mean(axis=1))
    check(sweep.max() > 1500.0, f"high dynamics: carrier sweep {sweep}")
    sol, _ = post_navigate(cfg, tr)                                         # :51-67
    check(sol is not None, "high dynamics: no solution")
    t_rx = _epoch_times(sc, sol)
    truth = sc.receiver_ecef_at(t_rx)
    err = _errors(sol, truth)
    out = {"min_i_p_over_q_p": float(ratio.min()), "sweep_max_hz": float(sweep.max()),
           "fixed": int(np.isfinite(err).sum()), "epochs": int(sol.n_epochs),
           "err_median_m": float(np.nanmedian(err))}
    check(out["fixed"] >= 0.9 * sol.n_epochs and out["err_median_m"] < 30.0,
          f"high dynamics: {out}")
    epoch_ms = sol.first_epoch_ms + sol._period_ms * np.arange(sol.n_epochs)
    disp = truth - truth[:, :1]
    line = disp[:, -1:] * (epoch_ms - epoch_ms[0])[None, :] / (epoch_ms[-1] - epoch_ms[0])
    out["curve_m"] = float(np.max(np.linalg.norm(disp - line, axis=0)))
    check(out["curve_m"] > 500.0, f"high dynamics: {out}")
    sol, _ = post_navigate(cfg.with_options(nav_filter="ekf", ekf_accel_psd=50.0), tr)  # :69-85
    check(sol is not None, "high dynamics: no EKF solution")
    t_rx = _epoch_times(sc, sol)
    verr = np.linalg.norm(np.stack([sol.vx, sol.vy, sol.vz]) - sc.receiver_vel_at(t_rx), axis=0)
    tail = slice(sol.n_epochs // 3, None)
    out["ekf_v_err_median_ms"] = float(np.nanmedian(verr[tail]))
    out["ekf_err_median_m"] = float(np.nanmedian(_errors(sol, sc.receiver_ecef_at(t_rx))[tail]))
    check(out["ekf_v_err_median_ms"] < 2.0 and out["ekf_err_median_m"] < 40.0,
          f"high dynamics: {out}")
    return out


def kinematic(device="cuda", synth=None) -> dict:
    """tests/test_kinematic.py:19-79: the receiver moves at (15, 8, 1) m/s
    ENU; the fixes and the carrier-Doppler velocity follow it, and RAIM
    stays quiet."""
    cfg = scenario_config()
    sc = build_scenario(cfg, n_sats=5, noise_std=1.5, velocity_enu=(15.0, 8.0, 1.0))
    res = run_receiver(cfg, signal=capture(sc, device, synth), device=device)
    check(res.has_fix, "kinematic: no fix")
    sol = res.solutions
    ok = np.isfinite(sol.x)                                                 # :36-47
    err = _errors(sol, sc.receiver_ecef_at(_epoch_times(sc, sol)))
    out = {"fixed": int(ok.sum()), "epochs": int(sol.n_epochs),
           "err_median_m": float(np.nanmedian(err))}
    check(ok.sum() >= 0.9 * sol.n_epochs and out["err_median_m"] < 30.0, f"kinematic: {out}")
    idx = np.flatnonzero(ok)                                                # :49-60
    i, j = idx[0], idx[-1]
    moved = np.sqrt((sol.x[j] - sol.x[i]) ** 2 + (sol.y[j] - sol.y[i]) ** 2
                    + (sol.z[j] - sol.z[i]) ** 2)
    want = np.linalg.norm(sc.receiver_vel) * (j - i) * sol._period_ms / 1000.0
    out.update(moved_m=float(moved), truth_moved_m=float(want))
    check(abs(moved - want) <= 0.05 * want, f"kinematic: {out}")
    v = np.stack([sol.vx, sol.vy, sol.vz])                                  # :62-73
    ok_v = np.isfinite(v).all(axis=0)
    verr = np.linalg.norm(v[:, ok_v] - sc.receiver_vel[:, None], axis=0)
    speed = np.linalg.norm(v[:, ok_v], axis=0)
    out.update(v_err_median_ms=float(np.median(verr)), speed_median_ms=float(np.median(speed)))
    check(ok_v.sum() >= 0.9 * sol.n_epochs and out["v_err_median_ms"] < 0.5, f"kinematic: {out}")
    check(abs(out["speed_median_ms"] - np.linalg.norm(sc.receiver_vel)) <= 0.5, f"kinematic: {out}")
    check(np.all(sol.raim_flag == 0), "kinematic: RAIM flagged a clean epoch")   # :75-79
    return out


def full_model(device="cuda", synth=None) -> dict:
    """tests/test_full_model.py:74-123: eccentric orbits with all harmonic
    and clock terms; the ephemerides decode to their truth, and the fix
    and velocity stay within the circular scenario's budget."""
    cfg = scenario_config()
    sc = build_scenario(cfg, n_sats=5, full_model=True)
    res = run_receiver(cfg, signal=capture(sc, device, synth), device=device)
    for i, prn in enumerate(sc.prns):                                       # :85-97
        eph, truth = res.ephemerides[prn - 1], sc.ephemerides[i]
        check(eph is not None and eph.complete, f"full model: PRN {prn} ephemeris missing")
        d_omega = (eph.omega - truth.omega + np.pi) % (2 * np.pi) - np.pi
        check(truth.e > 0 and abs(eph.e - truth.e) <= 2.0**-32
              and abs(eph.a_f0 - truth.a_f0) <= 2.0**-30
              and abs(eph.a_f1 - truth.a_f1) <= 2.0**-42
              and abs(eph.t_gd - truth.t_gd) <= 2.0**-30
              and abs(eph.c_rs - truth.c_rs) <= 2.0**-4 and abs(d_omega) < 2.0**-28,
              f"full model: PRN {prn} ephemeris differs from its truth")
    check(res.has_fix, "full model: no fix")                                # :99-112
    sol = res.solutions
    out = _check_static_fix("full model", sol, sc, 30.0, 40.0)
    v = np.sqrt(sol.vx**2 + sol.vy**2 + sol.vz**2)                          # :114-123
    ok = np.isfinite(v)
    out["v_median_ms"] = float(np.median(v[ok]))
    check(ok.sum() >= 0.9 * sol.n_epochs and out["v_median_ms"] < 0.3, f"full model: {out}")
    return out


def clock_ppm(ppm: float, device="cuda", synth=None) -> dict:
    """tests/test_clock_error.py:46-75: the receiver oscillator off by
    ``ppm``; the position is unaffected, the clock bias grows at ppm * c
    and the velocity solution's clock drift reads the same."""
    cfg = scenario_config()
    sc = build_scenario(cfg, n_sats=5, clock_ppm=ppm)
    res = run_receiver(cfg, signal=capture(sc, device, synth, 37020), device=device)
    check(res.has_fix, f"clock {ppm} ppm: no fix")
    sol = res.solutions
    xyz = np.stack([sol.x, sol.y, sol.z], 1)
    ok = np.isfinite(xyz).all(1)
    err = np.linalg.norm(xyz[ok] - sc.receiver_ecef, axis=1)
    exp = ppm * 1e-6 * C_LIGHT
    dt = np.asarray(sol.dt)[ok]
    t = np.arange(len(sol.dt))[ok] * cfg.nav_sol_period_ms / 1e3
    drift = np.asarray(sol.clock_drift)
    good = np.isfinite(drift)
    out = {"ppm": ppm, "fixed": int(ok.sum()), "epochs": int(sol.n_epochs),
           "err_median_m": float(np.median(err)), "expected_drift_ms": exp,
           "bias_slope_ms": float(np.polyfit(t, dt, 1)[0]),
           "clock_drift_median_ms": float(np.median(drift[good]))}
    check(ok.sum() >= sol.n_epochs - 1 and out["err_median_m"] < 30.0, f"clock: {out}")
    check(abs(out["bias_slope_ms"] - exp) < max(5.0, 0.02 * abs(exp)), f"clock: {out}")
    check(good.sum() > sol.n_epochs // 2 and abs(out["clock_drift_median_ms"] - exp) < 5.0,
          f"clock: {out}")
    return out


#: tests/test_oracle_parity.py:38-44: pure per-epoch least squares, no
#: atmosphere, RAIM, smoothing or demotion (the reference's navigation)
PARITY_KNOBS = dict(use_trop_corr=False, use_iono_corr=False, raim=False,
                    carrier_smoothing_epochs=0, nav_filter="lsq", lock_demotion=False,
                    elevation_mask_deg=0.0)


def nav_parity(config, tracking, min_epochs: int = 50) -> dict:
    """tests/test_oracle_parity.py:56-87: post_navigate against
    oracle_navigate on the same integer observables of ``tracking`` (a
    TrackResults or any object with its fields; ``sample_frac`` dropped):
    TOW exact, raw pseudoranges within 1e-6 m, fixes within
    1e-3 m, the receiver clock within 1e-3 m (and numpy's default rtol
    1e-7), DOP to rtol 1e-6; the comparisons of numpy.testing.assert_allclose,
    NaN equal to NaN."""
    track_int = copy.copy(tracking)
    track_int.sample_frac = None
    sol, ephs = post_navigate(config, track_int)
    check(sol is not None, "nav parity: no solution")
    ora = oracle_navigate(config, np.asarray(track_int.absolute_sample),
                          np.asarray(track_int.i_p), np.asarray(track_int.prn), ephs)
    check(ora["tow"] == float(sol.tow), f"nav parity: TOW {ora['tow']} != {sol.tow}")
    n_ep = min(sol.n_epochs, ora["fix"].shape[0])
    check(n_ep >= min_epochs, f"nav parity: {n_ep} epochs")
    act = np.flatnonzero(ora["first_subframe"] >= 0)
    raw_p, ora_raw_p = np.asarray(sol.raw_p)[act, :n_ep], ora["raw_p"][act, :n_ep]
    rx_fix = np.stack([sol.x, sol.y, sol.z, sol.dt], 1)[:n_ep]
    d_fix = np.linalg.norm(rx_fix[:, :3] - ora["fix"][:n_ep, :3], axis=1)
    dop, ora_dop = np.asarray(sol.dop).T[:n_ep], ora["dop"][:n_ep]
    out = {"epochs": n_ep, "channels": int(act.size), "tow": float(sol.tow),
           "raw_p_max_diff_m": float(np.nanmax(np.abs(raw_p - ora_raw_p))),
           "fix_max_diff_m": float(np.nanmax(d_fix)),
           "dt_max_diff_m": float(np.nanmax(np.abs(rx_fix[:, 3] - ora["fix"][:n_ep, 3]))),
           "dop_max_rel_diff": float(np.nanmax(np.abs(dop - ora_dop) / np.abs(ora_dop)))}
    check(np.allclose(raw_p, ora_raw_p, rtol=0, atol=1e-6, equal_nan=True)
          and out["fix_max_diff_m"] < 1e-3
          and np.allclose(rx_fix[:, 3], ora["fix"][:n_ep, 3], rtol=1e-7, atol=1e-3,
                          equal_nan=True)
          and np.allclose(dop, ora_dop, rtol=1e-6, atol=1e-9, equal_nan=True),
          f"nav parity: {out}")
    return out


def oracle_nav_parity(device="cuda", synth=None) -> dict:
    """tests/test_oracle_parity.py:36-87: the receiver at the
    reference-parity knobs, its tracking navigated by post_navigate and by
    the float64 oracle on integer observables (:func:`nav_parity`)."""
    cfg = scenario_config(**PARITY_KNOBS)
    sc = build_scenario(cfg, n_sats=5)
    res = run_receiver(cfg, signal=capture(sc, device, synth, 37020), device=device)
    check(res.has_fix, "oracle nav parity: no fix")
    return nav_parity(cfg, res.tracking)


#: every scenario by name, as chip_smoke.py and main() run them
SCENARIOS = {
    "e2e": e2e, "unhealthy": unhealthy, "killed": killed,
    "nearfar_demotion": nearfar_demotion, "tow_vote": tow_vote, "weak_45dbhz": weak_45dbhz,
    "high_dynamics": high_dynamics, "kinematic": kinematic, "full_model": full_model,
    "clock_ppm_+2": functools.partial(clock_ppm, 2.0),
    "clock_ppm_-1": functools.partial(clock_ppm, -1.0),
    "oracle_nav_parity": oracle_nav_parity,
}


def main(argv=None) -> int:
    from softgnss_tpu_torch.scripts.timing import card, require_cuda

    argv = sys.argv[1:] if argv is None else argv
    device = require_cuda()
    for name in argv or SCENARIOS:
        t0 = time.perf_counter()
        figures = SCENARIOS[name](device)
        print(f"{name}: {time.perf_counter() - t0:.3f} s, {figures} [{card()}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
