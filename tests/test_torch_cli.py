"""The port's command line (softgnss_tpu_torch.cli) and plots
(softgnss_tpu_torch.plots), on the CPU.

``build_config`` is held to the JAX CLI's for the same arguments (through
convert.config_from_dict); the CLI runs in process on small synthetic
captures with ``--cpu``; every ``plot_*`` writes a PNG under matplotlib's
Agg backend, and a missing matplotlib raises instead of skipping.
"""

import argparse
import dataclasses
import sys

import numpy as np
import pytest
import torch

import softgnss_tpu_torch as sgt
from softgnss_tpu import cli as jcli
from softgnss_tpu_torch import cli, convert, plots
from softgnss_tpu_torch.io import write_if_samples
from softgnss_tpu_torch.pipeline import run_receiver
from softgnss_tpu_torch.signals.synth import default_scenario

torch.set_num_threads(1)


def _args(**kw):
    base = dict(fast=False, set=None, file=None, ms=None)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("kw", [
    {},
    {"fast": True, "set": ["number_of_channels=5", "nav_filter=ekf", "acq_satellite_list=1,2,3",
                           "carrier_aided_dll=true", "pll_noise_bandwidth=18.5",
                           "data_format=iq8", "raim_sigma_m=4"]},
    {"file": "capture.bin", "ms": 1200, "set": ["skip_samples=1000", "mega_fused_frames=True"]},
], ids=["default", "fast_overrides", "file_ms"])
def test_build_config_matches_jax(kw):
    want = jcli.build_config(_args(**kw))
    got = cli.build_config(_args(**kw))
    assert got == convert.config_from_dict(dataclasses.asdict(want))


def test_build_config_rejects_what_jax_rejects():
    for bad in (["bogus=1"], ["number_of_channels"]):
        with pytest.raises(SystemExit):
            jcli.build_config(_args(set=bad))
        with pytest.raises(SystemExit):
            cli.build_config(_args(set=bad))
    assert cli._parse_value("1,2,") == jcli._parse_value("1,2,") == (1, 2)
    assert cli._parse_value("FALSE") is False and cli._parse_value("2.5e3") == 2500.0


def test_synthetic_fast_cpu_run(capsys):
    """--synthetic --fast --cpu: every injected PRN acquired, the channels
    tracked; --stream (128-ms chunks) gives the same table."""
    assert cli.main(["--synthetic", "--fast", "--cpu", "--ms", "600", "--no-nav"]) == 0
    out = capsys.readouterr().out
    assert "softgnss_tpu_torch v" in out and "Acquired 5 satellites" in out
    assert "Tracked 600 ms on 4 channels" in out
    assert cli.main(["--synthetic", "--fast", "--cpu", "--ms", "300", "--no-nav", "--stream",
                     "--set", "track_stream_chunk_ms=128"]) == 0
    streamed = capsys.readouterr().out
    table = lambda s: [ln for ln in s.splitlines() if ln.startswith("|")]   # noqa: E731
    assert table(streamed) == table(out) and "Tracked 300 ms on 4 channels" in streamed


def test_probe_only_on_a_file(tmp_path, capsys):
    _, sig = default_scenario(sgt.fast_config(ms_to_process=20), device="cpu")
    path = tmp_path / "cap.bin"
    write_if_samples(str(path), sig.numpy())
    assert cli.main(["--file", str(path), "--fast", "--cpu", "--probe-only", "--plot",
                     "--plot-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"Probed {10 * sgt.fast_config().samples_per_code} samples" in out
    assert (tmp_path / "probe.png").stat().st_size > 0


def test_checkpoint_written_then_reused(tmp_path, capsys):
    ckpt = str(tmp_path / "track.npz")
    argv = ["--synthetic", "--fast", "--cpu", "--ms", "200", "--no-nav", "--checkpoint", ckpt]
    assert cli.main(argv) == 0
    first = capsys.readouterr().out
    assert "Acquired" in first and (tmp_path / "track.npz").exists()
    assert cli.main(argv) == 0
    second = capsys.readouterr().out
    assert "Acquired" not in second and "Tracked 200 ms on 4 channels" in second


def test_bare_shard_channel_runs(capsys):
    """--shard channel without --mesh is the JAX CLI's default: it runs."""
    assert cli.main(["--synthetic", "--fast", "--cpu", "--ms", "200", "--no-nav",
                     "--shard", "channel"]) == 0
    assert "Tracked 200 ms on 4 channels" in capsys.readouterr().out


def test_mesh_1x1_runs_in_one_process(capsys):
    """--mesh 1x1 needs no launcher (a one-process gloo group) and tracks
    what the unsharded run tracks."""
    argv = ["--synthetic", "--fast", "--cpu", "--ms", "200", "--no-nav"]
    assert cli.main(argv) == 0
    plain = capsys.readouterr().out
    assert cli.main(argv + ["--mesh", "1x1", "--shard", "time-exact"]) == 0
    meshed = capsys.readouterr().out
    table = lambda s: [ln for ln in s.splitlines() if ln.startswith(("|", "Tracked"))]  # noqa: E731
    assert table(meshed) == table(plain) and "Tracked 200 ms on 4 channels" in meshed


def test_mesh_larger_than_the_world_is_refused(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--synthetic", "--fast", "--cpu", "--no-nav", "--mesh", "2x4"])
    assert exc.value.code == 2
    assert "needs 8 ranks, but the world size is 1" in capsys.readouterr().err


def test_stream_with_mesh_is_refused(capsys):
    """As in the JAX CLI: --stream is single-device."""
    for argv in (["--synthetic", "--fast", "--cpu", "--stream", "--mesh", "1x1"],
                 ["--synthetic", "--fast", "--cpu", "--mesh", "nope"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--stream is single-device" in err and "TIMExCHANNEL" in err


def test_runs_on_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--synthetic", "--fast", "--ms", "100", "--no-nav"])


# --- plots ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_run():
    cfg = sgt.fast_config(ms_to_process=600, lock_window_ms=200, plot_tracking=True)
    _, sig = default_scenario(cfg, device="cpu")
    return cfg, run_receiver(cfg, signal=sig, probe=True, navigate=False, device="cpu")


@pytest.fixture(scope="module")
def nav_solution():
    """A fix from the fabricated observables of tests/test_postnav.py,
    through the port's EKF (its lsq_* overlay is drawn too)."""
    import softgnss_tpu as sg
    from softgnss_tpu.nav import geodesy as jgeo
    from softgnss_tpu_torch.nav.solve import post_navigate
    from tests.test_postnav import N_MS, TOW_COUNT, build_track, visible_constellation

    jcfg = sg.fast_config(number_of_channels=5, ms_to_process=N_MS, use_trop_corr=False)
    rx = np.asarray(jgeo.geo2cart(np.array([47.0, 0, 0]), np.array([8.5, 0, 0]), 500.0, 4))
    track = build_track(jcfg, rx, visible_constellation(rx, 5, TOW_COUNT * 6.0),
                        TOW_COUNT * 6.0 - 0.35)
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg)).with_options(nav_filter="ekf")
    sol, _ = post_navigate(cfg, track)
    return cfg, sol


def test_every_plot_writes_a_png(small_run, nav_solution, tmp_path):
    cfg, res = small_run
    paths = [plots.plot_probe(cfg, res.probe, str(tmp_path)),
             plots.plot_acquisition(cfg, res.acquisition, str(tmp_path)),
             plots.plot_tracking(cfg, res.tracking, 0, str(tmp_path)),
             plots.plot_lock(cfg, res.tracking, str(tmp_path)),
             plots.plot_navigation(*nav_solution, out_dir=str(tmp_path))]
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", p
    out = tmp_path / "all"
    out.mkdir()
    every = plots.plot_all(cfg, res, out_dir=str(out))
    assert {p.rsplit("/", 1)[1] for p in every} == {
        "probe.png", "acquisition.png", "lock_quality.png",
        *(f"tracking_ch{c}.png" for c in range(len(res.tracking.prn))
          if res.tracking.status[c] != "-")}


def test_plots_without_matplotlib_raise(small_run, monkeypatch, tmp_path):
    cfg, res = small_run
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        plots.plot_probe(cfg, res.probe, str(tmp_path))
