"""The JAX suite's closed-loop scenarios on the port, on the CPU (slow).

Every function of softgnss_tpu_torch.scripts.scenarios runs with
``device="cpu"`` (the kernels' plain versions) at the JAX test's
configuration and checks that test's bounds, on the JAX test's own
capture: the JAX synthesizer's samples of the same scenario (its noise
too), passed to the port as NumPy.  ``chip_smoke.py`` runs the same
functions on the card, on the port's synthesizer's captures.  The
time-sharded case of tests/test_end_to_end.py:169-187 runs here on a CPU
mesh of 4 gloo ranks (2 time shards x 2 channel shards): its tracking
feeds navigation, which must fix >= 90 % of epochs with a median 3D error
under 60 m.  Each closed loop takes minutes on one thread; the tier-1 run
skips them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from softgnss_tpu_torch import convert
from softgnss_tpu_torch.scripts import scenarios

torch.set_num_threads(1)

WORLD_TIMEOUT_S = 1200.0


def jax_synth(sc, n_ms: int) -> np.ndarray:
    """The JAX synthesizer's capture of the port's scenario ``sc`` (the same
    fields; tests/test_torch_scenario.py holds the two builders equal), as
    NumPy; fills ``sc.delays`` and ``sc.dopplers`` from it."""
    from softgnss_tpu import scenario as jsc
    from softgnss_tpu.config import ReceiverConfig
    from softgnss_tpu.nav.message import Ephemeris

    fields = {f.name: getattr(sc, f.name) for f in dataclasses.fields(sc)}
    jax_names = {f.name for f in dataclasses.fields(ReceiverConfig)}
    fields["config"] = ReceiverConfig(**{k: v for k, v in dataclasses.asdict(sc.config).items()
                                         if k in jax_names})
    fields["ephemerides"] = [Ephemeris(**convert.ephemeris_to_dict(e)) for e in sc.ephemerides]
    jsc_ = jsc.Scenario(**fields)
    signal = np.asarray(jsc.synthesize_scenario(jsc_, n_ms))
    sc.delays, sc.dopplers = jsc_.delays, jsc_.dopplers
    return signal


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(scenarios.SCENARIOS))
def test_scenario_on_the_cpu(name):
    figures = scenarios.SCENARIOS[name](device="cpu", synth=jax_synth)
    assert figures
    if name == "e2e":
        # tests/test_end_to_end.py:41 on its own capture
        assert all(abs(d) <= 1.5 for d in figures["code_phase_minus_truth"].values()), figures


def _time_sharded_rank(cap_path: str, channels_path: str, out_path: str) -> None:
    """One rank: track_time_sharded over the e2e capture at 2 x 2; rank 0
    writes the tracking checkpoint."""
    import torch.distributed as dist

    from softgnss_tpu_torch.acquire.search import Channels
    from softgnss_tpu_torch.parallel import receiver_mesh, track_time_sharded
    from softgnss_tpu_torch.pipeline import save_tracking

    torch.set_num_threads(1)
    cfg = scenarios.scenario_config()
    d = np.load(channels_path)
    channels = Channels(d["prn"], d["freq"], d["phase"], [str(s) for s in d["status"]])
    mesh = receiver_mesh(cfg, n_time=2, n_channel=2)
    tr = track_time_sharded(cfg, np.load(cap_path, mmap_mode="r"), channels, mesh,
                            n_ms=scenarios.N_MS, device="cpu")
    if dist.get_rank() == 0:
        save_tracking(out_path, tr)


@pytest.mark.slow
def test_time_sharded_tracking_feeds_navigation(tmp_path):
    """tests/test_end_to_end.py:169-187 on a 4-rank CPU mesh."""
    from softgnss_tpu_torch.acquire.search import acquire, assign_channels
    from softgnss_tpu_torch.nav.solve import post_navigate
    from softgnss_tpu_torch.parallel.mesh import spawn_world
    from softgnss_tpu_torch.pipeline import load_tracking
    from softgnss_tpu_torch.scenario import build_scenario

    cfg = scenarios.scenario_config()
    sc = build_scenario(cfg, n_sats=5, noise_std=1.5)
    sig = scenarios.capture(sc, "cpu", jax_synth)
    channels = assign_channels(cfg, acquire(cfg, sig[:cfg.acquisition_ms * cfg.samples_per_code],
                                            device="cpu"))
    cap, chans, out = (str(tmp_path / n) for n in ("capture.npy", "channels.npz", "time.npz"))
    np.save(cap, sig)
    np.savez(chans, prn=channels.prn, freq=channels.acquired_freq, phase=channels.code_phase,
             status=np.asarray(channels.status))
    spawn_world(_time_sharded_rank, 4, (cap, chans, out), device="cpu",
                timeout=WORLD_TIMEOUT_S)
    sol, _ = post_navigate(cfg, load_tracking(out))
    assert sol is not None
    rx = sc.receiver_ecef
    ok = np.isfinite(sol.x)
    assert ok.sum() >= 0.9 * sol.n_epochs
    err = np.sqrt((sol.x[ok] - rx[0]) ** 2 + (sol.y[ok] - rx[1]) ** 2
                  + (sol.z[ok] - rx[2]) ** 2)
    assert np.median(err) < 60.0


@pytest.mark.slow
def test_closed_loop_capture_parts_from_the_oracle_as_jax_does():
    """chip_smoke.py's closed-loop scenario (default_config, 8 satellites
    at 53 dB-Hz; here the JAX synthesizer's capture), 4 channels at the
    truth over 1 000 ms: the JAX package's tracker misses a North-star
    bound of tests/test_tracking.py:76-92 against the float64 oracle, so
    chip_smoke.py holds the port there to the +-1-sample envelope and the
    oracle's nav-bit signs (ROADMAP C.8), which both trackers meet."""
    from softgnss_tpu import default_config as jax_default_config
    from softgnss_tpu.acquire.search import Channels as JaxChannels
    from softgnss_tpu.track import track as jax_track

    from softgnss_tpu_torch import default_config
    from softgnss_tpu_torch.acquire.search import Channels
    from softgnss_tpu_torch.scenario import build_scenario
    from softgnss_tpu_torch.scripts import oracle_check
    from softgnss_tpu_torch.signals.synth import amplitude_for_cn0
    from softgnss_tpu_torch.track.scan import track

    n_ms, n_ch = 1000, 4
    cfg = default_config(number_of_channels=n_ch)
    sc = build_scenario(default_config(), n_sats=8, noise_std=8.0,
                        amplitude=amplitude_for_cn0(cfg, 53.0, 8.0))
    sig = jax_synth(sc, n_ms + 20)
    spc = cfg.samples_per_code
    args = dict(prn=np.asarray(sc.prns[:n_ch], np.int64),
                acquired_freq=np.asarray([sc.expected_carrier_freq(i) for i in range(n_ch)]),
                code_phase=np.asarray([int(round(sc.expected_code_phase(i))) % spc
                                       for i in range(n_ch)], np.int64),
                status=["T"] * n_ch)
    logs = oracle_check.oracle_logs(cfg, sig, Channels(**args), n_ms)
    port = track(cfg, sig, Channels(**args), n_ms=n_ms, device="cpu")
    jtr = jax_track(jax_default_config(number_of_channels=n_ch), sig, JaxChannels(**args),
                    n_ms=n_ms)
    jax_tr = type("JaxTracking", (), {f: np.asarray(getattr(jtr, f), np.float64) for f in
                                      ("absolute_sample", "carr_freq", "code_freq",
                                       *oracle_check.CORRELATORS)})
    signs = np.sign(np.stack([log["i_p"] for log in logs]))[:, 50:]
    for label, tr in (("port", port), ("JAX", jax_tr)):
        figures = oracle_check.deviation(tr, logs, n_ms)
        print(f"{label} against the oracle: {oracle_check.describe(figures)}")
        assert figures["absolute_sample"] <= 1
        assert np.min(np.mean(np.sign(tr.i_p[:, 50:]) == signs, axis=1)) > 0.99
    with pytest.raises(AssertionError, match="against the float64 oracle"):
        oracle_check.check("JAX", oracle_check.deviation(jax_tr, logs, n_ms))
