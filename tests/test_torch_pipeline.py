"""Port parity for the whole slice: run_receiver(navigate=False) of
softgnss_tpu_torch against softgnss_tpu on one capture, checkpoints that
cross between the packages, and the port's device policy."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import softgnss_tpu as sg
import softgnss_tpu_torch as sgt
from softgnss_tpu import pipeline as jpipe
from softgnss_tpu.signals.synth import SatelliteSignal, synthesize_signal
from softgnss_tpu_torch import convert
from softgnss_tpu_torch import pipeline as tpipe
from softgnss_tpu_torch.profiling import StageTimer, profile_to, trace

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parent.parent
_OPTS = dict(number_of_channels=5, ms_to_process=1100, lock_window_ms=400)


@pytest.fixture(scope="module")
def runs():
    """4 satellites over 1 100 ms; PRN 31 dies at 600 ms, so lock demotion
    fires (400-ms windows, 200-ms hops)."""
    rng = np.random.default_rng(1)
    sats = [SatelliteSignal(prn=p, doppler_hz=d, delay_samples=dl, amplitude=a,
                            phase0=ph, nav_bits=tuple(int(b) for b in rng.choice([-1, 1], 30)))
            for p, d, dl, a, ph in [(4, 1500.0, 1000.0, 1.0, 0.3),
                                    (13, -2200.0, 3000.0, 0.9, 1.3),
                                    (22, 700.0, 200.0, 1.1, 2.0),
                                    (31, -3900.0, 2500.0, (1.0,) * 600 + (0.0,), 0.5)]]
    sig = synthesize_signal(sg.fast_config(), sats, 1113, noise_std=2.0, seed=3)
    ref = jpipe.run_receiver(sg.fast_config(**_OPTS), signal=sig, navigate=False, probe=True)
    port = tpipe.run_receiver(sgt.fast_config(**_OPTS), signal=sig, navigate=False,
                              probe=True, device="cpu")
    return sig, ref, port


def _summary_lines(res):
    return [ln for ln in res.summary().splitlines()
            if not any(ln.strip().startswith(k) for k in res.timings_s)]


def test_whole_slice_matches(runs):
    _, ref, port = runs
    ja, ta = ref.acquisition, port.acquisition
    np.testing.assert_array_equal(ta.acquired, ja.acquired)
    np.testing.assert_array_equal(ta.code_phase, ja.code_phase)
    assert np.max(np.abs(ta.carr_freq - ja.carr_freq)) < 1e-3
    np.testing.assert_allclose(ta.peak_metric, ja.peak_metric, rtol=1e-4)
    np.testing.assert_array_equal(port.channels.prn, ref.channels.prn)
    assert port.tracking.status == ref.tracking.status
    assert "L" in port.tracking.status                     # demotion exercised
    np.testing.assert_array_equal(port.tracking.lock_loss_ms, ref.tracking.lock_loss_ms)
    assert _summary_lines(port) == _summary_lines(ref)
    assert set(port.timings_s) == {"acquire", "acquire.tables", "acquire.wait", "track",
                                   "track.loop", "track.wait", "track.to_host", "track.demote"}
    for k in ref.probe:
        np.testing.assert_array_equal(port.probe[k], ref.probe[k], err_msg=k)
    # tracking itself: the gather-lineage tolerances on the locked channels
    held = np.isinf(ref.tracking.lock_loss_ms) & (np.asarray(ref.tracking.status) == "T")
    np.testing.assert_array_equal(port.tracking.absolute_sample[held],
                                  ref.tracking.absolute_sample[held])


def test_checkpoints_cross_packages(runs, tmp_path):
    sig, ref, port = runs
    tpipe.save_tracking(str(tmp_path / "port"), port.tracking)
    jpipe.save_tracking(str(tmp_path / "jax"), ref.tracking)
    in_jax = jpipe.load_tracking(str(tmp_path / "port"))
    in_port = tpipe.load_tracking(str(tmp_path / "jax"))
    for f in ("absolute_sample", "i_p", "carr_freq", "lock_loss_ms"):
        np.testing.assert_array_equal(getattr(in_jax, f), getattr(port.tracking, f))
        np.testing.assert_array_equal(getattr(in_port, f), getattr(ref.tracking, f))
    assert in_jax.status == port.tracking.status and in_port.status == ref.tracking.status
    for f in in_port.final_state._fields:
        a = in_port.final_state._asdict()[f].numpy()
        b = np.asarray(getattr(ref.tracking.final_state, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    # a checkpoint supersedes acquisition and tracking
    res = tpipe.run_receiver(sgt.fast_config(**_OPTS), signal=sig, navigate=False,
                             checkpoint=str(tmp_path / "jax.npz"), device="cpu")
    assert res.acquisition is None
    np.testing.assert_array_equal(res.tracking.i_p, ref.tracking.i_p)


def test_port_imports_no_jax():
    code = ("import sys; import softgnss_tpu_torch.pipeline, softgnss_tpu_torch.convert, "
            "softgnss_tpu_torch.track.megakernel, softgnss_tpu_torch.signals.synth, "
            "softgnss_tpu_torch.cli, softgnss_tpu_torch.plots, softgnss_tpu_torch.native, "
            "softgnss_tpu_torch.parallel.stream, softgnss_tpu_torch.nav.ekf, "
            "softgnss_tpu_torch.scripts.pallas_probe; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
            "'softgnss_tpu.')) or m == 'softgnss_tpu']; assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_silent_fallback(runs):
    """navigate=True runs navigation (on too short a capture it finds no
    fix, as the JAX package does), with either filter; a missing card
    raises."""
    sig, _, _ = runs
    cfg = sgt.fast_config(**_OPTS)
    for nav_filter in ("lsq", "ekf"):
        res = tpipe.run_receiver(cfg.with_options(nav_filter=nav_filter), signal=sig,
                                 device="cpu")
        assert res.solutions is None and not res.has_fix
        assert res.ephemerides == [None] * 32 and "navigate" in res.timings_s
        assert "PVT: navigation solution not computed" in res.summary()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.run_receiver(cfg, signal=sig, navigate=False, device="cuda")


def test_convert_config_and_channels():
    jc = sg.fast_config(pdi_ms=2, track_tile=64, mega_fused_frames=True)
    tc = convert.config_from_dict(dataclasses.asdict(jc))
    assert tc == sgt.fast_config(pdi_ms=2, mega_fused_frames=True)
    with pytest.raises(ValueError, match="unknown config fields"):
        convert.config_from_dict(dict(dataclasses.asdict(jc), bogus=1))
    ch = convert.channels_from_numpy([3, 0], [1.0e6, 0.0], [12, 0], "T-")
    assert ch.status == ["T", "-"] and ch.prn.dtype == np.int64 and len(ch) == 2


def test_convert_carries_the_mesh_fields():
    """config_from_dict keeps the mesh dimension names and the time-shard
    warm-up of a JAX config."""
    opts = dict(time_axis="t", channel_axis="ch", time_shard_warmup_ms=75)
    tc = convert.config_from_dict(dataclasses.asdict(sg.fast_config(**opts)))
    assert (tc.time_axis, tc.channel_axis, tc.time_shard_warmup_ms) == ("t", "ch", 75)
    assert tc == sgt.fast_config(**opts)


def test_profile_to_writes_the_stages(runs, tmp_path):
    """A profile_to window around run_receiver writes one trace whose events
    name the receiver's stages (StageTimer), their parts (the program's
    trace() spans) and a trace() region."""
    sig = runs[0]
    with profile_to(str(tmp_path)):
        with trace("probe_region"):
            pass
        tpipe.run_receiver(sgt.fast_config(**_OPTS), signal=sig, n_ms=200, navigate=False,
                           device="cpu")
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"softgnss/acquire", "softgnss/track", "softgnss/probe_region"} <= names
    parts = ("acquire.tables", "acquire.wait", "track.loop", "track.wait", "track.to_host",
             "track.demote")
    assert {f"softgnss/{p}" for p in parts} <= names


def test_stage_timer_accumulates():
    t = StageTimer("cpu")
    for _ in range(2):
        with t.stage("a"):
            pass
    assert set(t.timings_s) == {"a"} and t.timings_s["a"] >= 0.0
