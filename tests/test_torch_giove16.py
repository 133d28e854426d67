"""The port at the front end of SoftGNSS's second documented data set:
fs 16.3676 MHz, IF 4.1304 MHz, int8 (``gnss_bench/configs/giove16.json``,
the benchmark's cell ``giove16.obs``).

Its geometry against the JAX package's config at the same front end
(16 368 samples a code, not a power of two and not the ms grid: the
nominal period is 16 367.6 samples); the port's acquisition, channels and
per-ms tracking against the JAX package's on one capture of the cell's
traffic; a short run of the receiver judged against the plain reference
(``gnss_bench/reference.py``) under the configuration's own limits; and
faults planted at this front end that the judge refuses.  Only
``ms_to_process`` is cut (37 000 to 400 ms); sampling, IF, channels,
traffic and limits are the configuration's.  The kernels' plain versions
run here; on the card the cell runs itself:
    python3 -m gnss_bench.run --workload giove16.obs --seed 7 --seconds 51 --trace 0
"""

from __future__ import annotations

import copy
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import softgnss_tpu as sg
from gnss_bench import control, generator, judge, reference, registry
from gnss_bench.run import outputs_of, receiver_config
from softgnss_tpu.acquire import acquire as jacquire
from softgnss_tpu.acquire import assign_channels as jassign_channels
from softgnss_tpu.acquire.search import _corr_fft_len as _jax_corr_fft_len
from softgnss_tpu.track import track as jtrack
from softgnss_tpu_torch.acquire import acquire, assign_channels
from softgnss_tpu_torch.acquire.search import _corr_fft_len
from softgnss_tpu_torch.config import ReceiverConfig
from softgnss_tpu_torch.pipeline import run_receiver
from softgnss_tpu_torch.track import track

ROOT = Path(__file__).resolve().parent.parent
SEED = 2_147_483_675          # past 32 signed bits, as the benchmark's seeds are
MS = 400


@pytest.fixture(scope="module")
def cell():
    """The cell's configuration at ``MS`` ms, one capture of its traffic on
    the CPU, the reference receiver and the port's sound outputs on it."""
    bench = registry.benchmark(ROOT)
    workload = registry.workload(bench, "giove16.obs")
    table = copy.deepcopy(registry.config(bench, workload["config"], ROOT))
    table["receiver"]["ms_to_process"] = MS
    traffic = registry.traffic(workload["traffic"])
    scene = generator.draw_scene(table["receiver"], traffic, SEED)
    capture = generator.synthesize(scene, "cpu")
    config = receiver_config(table["receiver"])
    res = run_receiver(config, signal=capture, navigate=False, device="cpu")
    return SimpleNamespace(table=table, scene=scene, capture=capture, config=config,
                           out=outputs_of(res),
                           rx=reference.Receiver.from_table(table["receiver"]))


def _jax_config(table: dict):
    """The JAX package's ReceiverConfig for a receiver table, on its
    'gather' tracker (the float64 filter lineage the port's follows)."""
    opts = {k: tuple(v) if isinstance(v, list) else v for k, v in table.items()}
    return sg.default_config(**{**opts, "correlator_impl": "gather"})


def _judged(cell, out) -> dict:
    numbers, _, _ = judge.judge(cell.rx, [(cell.scene, cell.capture, [out])])
    return numbers


def test_port_geometry_at_the_giove16_front_end():
    """The port's config from giove16.json has the JAX package's geometry
    at the same front end: 16 368 samples a code and 16 a chip; 31 samples
    of frame margin (a chip, 7 of drift over a 64-ms block, 8); the folded
    acquisition FFT of 32 768.  Its frames are the JAX package's frame
    span rounded up to whole capture words (16 440 bytes), where the JAX
    package rounds to its TPU tiles.  It takes the block route, since
    16 368 % 4 == 0."""
    bench = registry.benchmark(ROOT)
    table = registry.config(bench, registry.workload(bench, "giove16.obs")["config"], ROOT)
    cfg, jcfg = receiver_config(table["receiver"]), _jax_config(table["receiver"])

    def geometry(c, fft_len):
        return dict(fs=c.sampling_freq, fi=c.intermediate_freq, spc=c.samples_per_code,
                    chip=c.samples_per_chip, pre=c.track_frame_pre,
                    span=c.samples_per_code + c.track_window_extra + 2 * c.track_frame_pre,
                    fft=fft_len(c), block_ms=c.track_block_ms, channels=c.number_of_channels,
                    ms=c.ms_to_process)

    want = geometry(jcfg, _jax_corr_fft_len)
    assert geometry(cfg, _corr_fft_len) == want
    assert cfg.track_window == -(-want["span"] // 4) * 4 <= jcfg.track_window
    assert (want["spc"], want["chip"], want["pre"], cfg.track_window, want["fft"]) == (
        16_368, 16, 31, 16_440, 32_768)
    assert cfg.correlator_impl == "auto" and cfg.tracker == "block"
    assert not cfg.mega_fused_frames
    # the code period is not whole: ms boundaries walk against the sample grid
    assert cfg.sampling_freq / 1000.0 != cfg.samples_per_code


def test_acquisition_and_tracking_match_the_jax_package_at_giove16(cell):
    """One capture of the cell's traffic through the JAX package's and the
    port's acquisition, channel assignment and tracker (``MS`` ms, 8
    channels): the same flags, code phases and channels, fine frequencies
    within a mHz, and per ms the same code period boundaries, the
    correlators and the loops' frequencies within float32 sums taken in
    another order (read: 1.0e-6 of the RMS, 4.0e-6 Hz, 1.2e-6 of a
    sample over 400 ms)."""
    jcfg = _jax_config(cell.table["receiver"])
    sig = cell.capture.numpy()
    ja = jacquire(jcfg, sig)
    jch = jassign_channels(jcfg, ja)
    jt = jtrack(jcfg, sig, jch, n_ms=MS)
    ta = acquire(cell.config, cell.capture)
    tch = assign_channels(cell.config, ta)
    tt = track(cell.config, cell.capture, tch, n_ms=MS)

    np.testing.assert_array_equal(ta.acquired, ja.acquired)
    np.testing.assert_array_equal(ta.code_phase, ja.code_phase)
    assert np.max(np.abs(ta.carr_freq - ja.carr_freq)) < 1e-3
    np.testing.assert_allclose(ta.peak_metric, ja.peak_metric, rtol=1e-4)
    np.testing.assert_array_equal(tch.prn, jch.prn)
    np.testing.assert_array_equal(tch.code_phase, jch.code_phase)
    np.testing.assert_array_equal(tch.acquired_freq, jch.acquired_freq)
    assert list(tch.status) == list(jch.status) == ["T"] * 8

    assert tt.i_p.shape == (8, MS)
    np.testing.assert_array_equal(tt.absolute_sample, jt.absolute_sample)
    for f in ("i_p", "i_e", "i_l", "q_e", "q_p", "q_l"):
        a, b = getattr(tt, f), np.asarray(getattr(jt, f))
        assert np.max(np.abs(a - b)) / np.sqrt(np.mean(b.astype(np.float64) ** 2)) < 1e-5, f
    for f, tol in (("carr_freq", 1e-4), ("code_freq", 1e-4), ("sample_frac", 1e-5)):
        assert np.max(np.abs(getattr(tt, f) - np.asarray(getattr(jt, f)))) < tol, f
    # locked: the data on I
    assert np.mean(np.abs(tt.i_p[:, 200:])) > 4 * np.mean(np.abs(tt.q_p[:, 200:]))


def test_a_short_judged_run_at_giove16_is_correct(cell):
    """Every channel on an injected satellite, each judged number within the
    configuration's limits, the exact ones at 0."""
    got = _judged(cell, cell.out)
    assert judge.passes(got, cell.table["limits"]), got
    for k in ("acq_mismatch", "sample_mismatch", "status_mismatch", "truth_mismatch"):
        assert got[k] == 0, (k, got)
    assert got["corr_rel"] < 1e-5 and got["carr_freq_hz"] < 1e-9 and got["code_freq_hz"] < 1e-9
    assert set(cell.out["prn"].tolist()) == set(cell.scene.prn.tolist())
    assert all(s == "T" for s in cell.out["status"])


def _pll_gain_of_the_wrong_sign(cell, monkeypatch):
    taus = ReceiverConfig.pll_taus.fget
    monkeypatch.setattr(ReceiverConfig, "pll_taus",
                        property(lambda self: (-taus(self)[0], taus(self)[1])))
    res = run_receiver(cell.config, signal=cell.capture, navigate=False, device="cpu")
    return outputs_of(res)


def _one_correlator_off(cell, monkeypatch):
    out = dict(cell.out)
    out["i_p"] = out["i_p"].copy()
    out["i_p"][0, MS - 100] *= 1.01
    return out


@pytest.mark.parametrize("fault, caught_by", [(_pll_gain_of_the_wrong_sign, "carr_freq_hz"),
                                              (_one_correlator_off, "corr_rel")],
                         ids=["pll_gain_wrong_sign", "one_correlator_off_1pct"])
def test_a_planted_fault_at_giove16_is_not_correct(cell, monkeypatch, fault, caught_by):
    got = _judged(cell, fault(cell, monkeypatch))
    limits = cell.table["limits"]
    assert not judge.passes(got, limits), got
    assert got[caught_by] > limits[caught_by], got


def test_the_float32_control_fails_at_giove16(cell):
    """The reference's tracker in float32 in the program's place, judged the
    same way: its loop gaps lie past their limits here as at the reference
    front end."""
    out = control.control_outputs(cell.rx, cell.capture)
    got = _judged(cell, out)
    limits = cell.table["limits"]
    assert not judge.passes(got, limits), got
    assert got["carr_freq_hz"] > limits["carr_freq_hz"]
    assert np.array_equal(out["prn"], cell.out["prn"])
