"""The port's float64 oracle, and the port held against it.

* softgnss_tpu_torch.oracle against softgnss_tpu.oracle, function by
  function, on the same NumPy inputs: tests/test_tracking.py's capture, a
  tests/test_torch_nav.py ``nav_case`` and one PRN's acquisition grid.
  Every output is array_equal (the same float64 NumPy code on the same
  inputs; nothing is summed in another order).
* The port against its oracle: ``track`` (the kernels' plain versions on
  the CPU) on tests/test_tracking.py's capture at the default config,
  ``pdi_ms=2`` and ``dll_correlator_spacing=0.25``, on the North-star
  bounds of tests/test_tracking.py:76-92; ``acquire``'s code phase and
  Doppler bin against ``oracle_acquire_grid``; ``post_navigate`` against
  ``oracle_navigate`` on nav_case's integer observables at the bounds of
  tests/test_oracle_parity.py:56-87 (fixes within 1e-3 m).
* The scripts that run the same checks on the card (oracle_check,
  parity_check, scenarios): their functions on the CPU, their entry points
  refusing to run without CUDA, and the port's modules importing nothing
  of JAX or of the JAX package.
"""

import copy
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import softgnss_tpu as sg
import softgnss_tpu_torch as sgt
from softgnss_tpu.nav import parity as jpar
from softgnss_tpu.oracle import numpy_rx as jor
from softgnss_tpu.signals.synth import SatelliteSignal, synthesize_signal
from softgnss_tpu_torch import convert
from softgnss_tpu_torch.acquire.search import Channels, acquire
from softgnss_tpu_torch.nav import message as tmsg
from softgnss_tpu_torch.oracle import numpy_rx as tor
from softgnss_tpu_torch.scripts import oracle_check, parity_check, scenarios
from softgnss_tpu_torch.track.scan import track
from tests.test_postnav import TOW_COUNT
from tests.test_torch_nav import _eph, nav_case  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
N_MS = 400            # tests/test_tracking.py's run


@pytest.fixture(scope="module")
def tracking_case():
    """tests/test_tracking.py's capture (JAX synthesizer, as NumPy) and its
    channels at the truth, with the port's config."""
    nav_bits = tuple((-1) ** i for i in range(40))
    jcfg = sg.fast_config(number_of_channels=2)
    sats = [SatelliteSignal(prn=9, doppler_hz=1200.0, delay_samples=500.0, amplitude=1.0,
                            phase0=1.0, nav_bits=nav_bits),
            SatelliteSignal(prn=23, doppler_hz=-800.0, delay_samples=2000.0, amplitude=1.1,
                            phase0=2.5, nav_bits=nav_bits)]
    signal = np.asarray(synthesize_signal(jcfg, sats, N_MS + 3, noise_std=1.0, seed=11))
    channels = Channels(prn=np.array([9, 23], np.int64),
                        acquired_freq=np.array([jcfg.intermediate_freq + 1200.0,
                                                jcfg.intermediate_freq - 800.0]),
                        code_phase=np.array([500, 2000], np.int64), status=["T", "T"])
    return jcfg, sgt.fast_config(number_of_channels=2), signal, channels


def _port_config(jcfg, **kw):
    return convert.config_from_dict(dataclasses.asdict(jcfg.with_options(**kw)))


# --- the port's oracle against the JAX oracle: array_equal -------------------


@pytest.mark.parametrize("opts", [{}, {"pdi_ms": 4}], ids=["default", "pdi4"])
def test_oracle_track_channel_equals_jax(tracking_case, opts):
    jcfg, _, signal, ch = tracking_case
    jc, tc = jcfg.with_options(**opts), _port_config(jcfg, **opts)
    for c in range(2):
        args = (signal, int(ch.prn[c]), float(ch.acquired_freq[c]), int(ch.code_phase[c]), N_MS)
        want, got = jor.oracle_track_channel(jc, *args), tor.oracle_track_channel(tc, *args)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def acq_case():
    """Three satellites over the acquisition window of the fast config."""
    jcfg = sg.fast_config()
    sats = [SatelliteSignal(prn=7, doppler_hz=1830.0, delay_samples=901.0),
            SatelliteSignal(prn=19, doppler_hz=-3170.0, delay_samples=2222.0, amplitude=0.8),
            SatelliteSignal(prn=30, doppler_hz=420.0, delay_samples=17.0, amplitude=0.9)]
    signal = np.asarray(synthesize_signal(jcfg, sats, jcfg.acquisition_ms + 1, noise_std=1.5,
                                          seed=3))
    return jcfg, _port_config(jcfg), sats, signal


def test_oracle_acquire_grid_and_fine_freq_equal_jax(acq_case):
    jcfg, tcfg, sats, signal = acq_case
    want = jor.oracle_acquire_grid(jcfg, signal, 19)
    got = tor.oracle_acquire_grid(tcfg, signal, 19)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert tor.oracle_fine_freq(tcfg, signal, got[1], 19) == \
        jor.oracle_fine_freq(jcfg, signal, want[1], 19)


def test_oracle_parity_equals_jax():
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2, size=(40, 24)).astype(np.int8)
    tx = 2 * jpar.encode_stream(words).astype(np.int64) - 1
    ndat = rng.choice([-1, 1], size=(300, 32))
    ndat[:39] = np.stack([tx[w * 30 - 2: w * 30 + 30] for w in range(1, 40)])
    ndat[39:78] = -ndat[:39]                                  # inverted polarity
    got = [tor.oracle_parity(row) for row in ndat]
    assert got == [jor.oracle_parity(row) for row in ndat]
    assert all(got[:78]) and not all(got[78:])


def test_oracle_find_preamble_equals_jax(nav_case):  # noqa: F811
    _, _, _, tr = nav_case
    noisy = tr.i_p + np.random.default_rng(6).normal(0, 2000.0, tr.i_p.shape)
    for i_p in (*tr.i_p, *noisy, np.random.default_rng(7).normal(size=8000)):
        assert tor.oracle_find_preamble(i_p) == jor.oracle_find_preamble(i_p)


def test_oracle_satpos_and_least_squares_equal_jax():
    rng = np.random.default_rng(8)
    ephs = [_eph(tmsg, rng) for _ in range(6)]
    t = 417792.0 + np.array([-7000.0, 0.0, 13.5, 3600.0, 302400.0])
    for eph in ephs:
        for tt in t:
            (gp, gc), (wp, wc) = tor.oracle_satpos(tt, eph), jor.oracle_satpos(tt, eph)
            np.testing.assert_array_equal(gp, wp)
            assert gc == wc
    sat_pos = np.stack([tor.oracle_satpos(t[2], e)[0] for e in ephs])
    rx = np.array([4_275_000.0, 638_000.0, 4_678_000.0])
    obs = np.linalg.norm(sat_pos - rx, axis=1) + 1500.0 + rng.normal(0, 3.0, len(ephs))
    for got, want in zip(tor.oracle_least_squares(sat_pos, obs),
                         jor.oracle_least_squares(sat_pos, obs)):
        np.testing.assert_array_equal(got, want)


def _integer_track(tr):
    """nav_case's observables with whole-sample counters."""
    out = copy.copy(tr)
    out.absolute_sample = np.round(tr.absolute_sample)
    return out


def test_oracle_navigate_equals_jax(nav_case):  # noqa: F811
    jcfg, _, ephs, tr = nav_case
    jc = jcfg.with_options(**scenarios.PARITY_KNOBS)
    tc = _port_config(jc)
    by_prn = [None] * 32
    for prn, eph in zip(tr.prn, ephs):
        by_prn[prn - 1] = eph
    tr = _integer_track(tr)
    args = (tr.absolute_sample, tr.i_p, np.asarray(tr.prn), by_prn)
    want, got = jor.oracle_navigate(jc, *args), tor.oracle_navigate(tc, *args)
    assert got.keys() == want.keys() and got["tow"] == want["tow"]
    for k in ("first_subframe", "raw_p", "fix", "dop"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.isfinite(got["fix"]).all() and got["fix"].shape[0] >= 50


# --- the port against its oracle ---------------------------------------------


@pytest.mark.parametrize("opts", [{}, {"pdi_ms": 2}, {"dll_correlator_spacing": 0.25}],
                         ids=["default", "pdi2", "spacing0.25"])
def test_track_within_oracle_bounds(tracking_case, opts):
    """tests/test_tracking.py:76-92's bounds on the port's tracker (block
    route, plain versions): every correlator's RMS deviation < 1e-3 of the
    prompt scale, absolute_sample within 1, carr_freq within 0.5 Hz,
    code_freq within 0.05 Hz."""
    _, tcfg, signal, ch = tracking_case
    cfg = tcfg.with_options(**opts)
    tr = track(cfg, signal, ch, n_ms=N_MS, device="cpu")
    figures = oracle_check.deviation(tr, oracle_check.oracle_logs(cfg, signal, ch, N_MS), N_MS)
    oracle_check.check(str(opts), figures)
    # far inside the bounds: the port's sums are float64 like the oracle's
    assert figures["corr_rel_rms"] < 1e-4, figures


def test_acquire_matches_oracle_code_phase_and_bin(acq_case):
    _, tcfg, sats, signal = acq_case
    acq = acquire(tcfg, signal, device="cpu")
    for sat in sats:
        _, phase, bin_index, metric = tor.oracle_acquire_grid(tcfg, signal, sat.prn)
        assert metric > tcfg.acq_threshold and acq.acquired[sat.prn - 1]
        assert acq.code_phase[sat.prn - 1] == phase
        assert acq.doppler_bin[sat.prn - 1] == bin_index


def test_post_navigate_matches_oracle_navigate(nav_case):  # noqa: F811
    """tests/test_oracle_parity.py:56-87's bounds on nav_case's integer
    observables: TOW exact, raw pseudoranges within 1e-6 m, fixes within
    1e-3 m, DOP to rtol 1e-6."""
    jcfg, _, _, tr = nav_case
    tc = _port_config(jcfg, **scenarios.PARITY_KNOBS)
    figures = scenarios.nav_parity(tc, _integer_track(tr))
    assert figures["tow"] == TOW_COUNT * 6 and figures["channels"] == 5


# --- the scripts ----------------------------------------------------------------


def test_oracle_check_routes_on_the_cpu():
    """The three routes of scripts.oracle_check at the reference front end,
    130 ms (two block boundaries), within the oracle's bounds."""
    out = oracle_check.run("cpu", n_ms=130)
    assert set(out) == set(oracle_check.ROUTES)
    for figures in out.values():
        assert figures["corr_rel_rms"] < 1e-4 and len(figures["per_channel_rms"]) == 3


def test_parity_check_on_the_cpu():
    """On the CPU the per-ms and block routes agree bit for bit
    (tests/test_torch_track_routes.py), so every figure is exact."""
    out = parity_check.run(3, "cpu")
    assert set(out) == {"pallas vs megakernel", "pallas vs fused"}
    for figures in out.values():
        assert figures["abs_sample_equal"] and figures["worst_rms"] == 0.0
        assert figures["per_channel_i_p_rms"] == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("name", ["oracle_check", "parity_check", "scenarios"])
def test_script_exits_nonzero_without_cuda(name):
    proc = subprocess.run([sys.executable, "-m", f"softgnss_tpu_torch.scripts.{name}"],
                          cwd=REPO, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                               "PYTHONPATH": str(REPO)})
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
    assert "oracle" not in proc.stdout and "C=" not in proc.stdout and proc.stdout == ""


def test_port_imports_no_jax():
    """With jax and the JAX package made unimportable, the oracle and the
    scripts that run it import."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['softgnss_tpu'] = None\n"
            "import softgnss_tpu_torch.oracle, softgnss_tpu_torch.scripts.scenarios\n"
            "import softgnss_tpu_torch.scripts.oracle_check\n"
            "import softgnss_tpu_torch.scripts.parity_check\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'softgnss_tpu.'))\n"
            "               for m in sys.modules if sys.modules[m] is not None)\n"
            "print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
