"""Driver entry points of the port: the receiver step as one callable, and
a dry run of the sharded receiver in a world of n ranks (the counterparts
of the repository's ``__graft_entry__.py``)."""

from __future__ import annotations

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, example_args): the receiver step on ``device`` (the card unless
    the caller names the CPU).  The step acquires over all 32 PRNs, picks
    the strongest, and tracks it for 20 ms on the block tracker (B2 + B1);
    it returns (metric, code_phase, carr_freq, i_p, q_p)."""
    from softgnss_tpu_torch import fast_config
    from softgnss_tpu_torch.acquire.search import Channels, _acquire_device
    from softgnss_tpu_torch.signals.synth import SatelliteSignal, synthesize_signal
    from softgnss_tpu_torch.track.scan import channel_tables, initial_state, track_on_device

    config = fast_config()
    n_track_ms = 20
    signal = synthesize_signal(
        config,
        [SatelliteSignal(prn=7, doppler_hz=1800.0, delay_samples=901.0),
         SatelliteSignal(prn=23, doppler_hz=-2400.0, delay_samples=2501.0)],
        config.acquisition_ms + n_track_ms + 3, noise_std=1.0, seed=1, device=device)

    def step(sig: torch.Tensor):
        need = config.acquisition_ms * config.samples_per_code
        carr, phase, metric = _acquire_device(config, sig[:need])
        best = int(torch.argmax(metric))
        ch = Channels(prn=np.array([best + 1]), acquired_freq=np.array([float(carr[best])]),
                      code_phase=np.array([int(phase[best])]), status=["T"])
        _, ys, _ = track_on_device(config, sig, channel_tables(ch, sig.device),
                                   initial_state(config, ch, sig.device), n_track_ms, 0)
        return metric, phase, carr, ys.i_p[:, 0], ys.q_p[:, 0]

    return step, (signal,)


def _dryrun_rank(n_devices: int, device) -> None:
    """One rank of :func:`dryrun_multichip`: the checks of
    ``__graft_entry__.dryrun_multichip`` on this world's mesh."""
    import torch.distributed as dist

    from softgnss_tpu_torch import fast_config
    from softgnss_tpu_torch.acquire.search import assign_channels
    from softgnss_tpu_torch.parallel import (
        acquire_sharded,
        make_mesh,
        track_channels_sharded,
        track_time_sharded,
    )
    from softgnss_tpu_torch.pipeline import run_receiver
    from softgnss_tpu_torch.scenario import build_scenario, synthesize_scenario
    from softgnss_tpu_torch.signals.synth import SatelliteSignal, synthesize_signal

    # the rank's device, made current by spawn_world
    dev = (torch.device("cpu") if torch.device(device).type == "cpu"
           else torch.device("cuda", torch.cuda.current_device()))
    n_time = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_channel = n_devices // n_time
    config = fast_config(number_of_channels=max(2, n_channel), time_shard_warmup_ms=4)
    mesh = make_mesh({config.time_axis: n_time, config.channel_axis: n_channel})

    n_ms = 8 * n_time
    signal = synthesize_signal(
        config,
        [SatelliteSignal(prn=5, doppler_hz=1500.0, delay_samples=400.0),
         SatelliteSignal(prn=14, doppler_hz=-2000.0, delay_samples=1700.0)],
        config.acquisition_ms + n_ms + 3, noise_std=1.0, seed=2, device=dev)

    acq = acquire_sharded(config, signal, mesh)
    channels = assign_channels(config, acq)
    sh_t = track_time_sharded(config, signal, channels, mesh, n_ms=n_ms)
    sh_c = track_channels_sharded(config, signal, channels, mesh, n_ms=n_ms)
    for res in (sh_t, sh_c):
        if res.i_p.shape != (config.number_of_channels, n_ms) or not np.isfinite(res.i_p).all():
            raise AssertionError(f"sharded tracking gave {res.i_p.shape}, finite "
                                 f"{np.isfinite(res.i_p).all()}")

    res = run_receiver(config, signal=signal, n_ms=n_ms, navigate=False, mesh=mesh,
                       shard="channel", device=dev)
    if res.tracking is None or not np.isfinite(res.tracking.i_p).all():
        raise AssertionError("run_receiver(shard='channel') tracked nothing finite")
    # the short capture reaches navigation, which declines it
    res_t = run_receiver(config, signal=signal, n_ms=n_ms, navigate=True, mesh=mesh,
                         shard="time", device=dev)
    if (res_t.tracking is None or not np.isfinite(res_t.tracking.i_p).all()
            or res_t.solutions is not None or not res_t.timings_s.get("track", 0) > 0):
        raise AssertionError("run_receiver(shard='time') on a short capture")

    # a 12-s scenario warm-started from its ephemerides, tracked under both
    # shardings, must reach a metres-scale fix
    ncfg = fast_config(number_of_channels=max(5, 2 * n_channel), ms_to_process=12000,
                       time_shard_warmup_ms=150)
    sc = build_scenario(ncfg, n_sats=5)
    nav_sig = synthesize_scenario(sc, 12020, device=dev)
    ephs = [None] * 32
    for prn, eph in zip(sc.prns, sc.ephemerides):
        ephs[prn - 1] = eph
    fix_err = {}
    for shard in ("time", "channel"):
        res_n = run_receiver(ncfg, signal=nav_sig, mesh=mesh, shard=shard, ephemerides=ephs,
                             assist_position=np.asarray(sc.receiver_ecef) + 2000.0,
                             assist_tow=sc.t_rx0 + 0.2, device=dev)
        if not res_n.has_fix:
            raise AssertionError(f"no mesh PVT fix (shard={shard})")
        sol = res_n.solutions
        err = np.linalg.norm(np.stack([sol.x, sol.y, sol.z], 1) - np.asarray(sc.receiver_ecef),
                             axis=1)
        fix_err[shard] = float(np.nanmedian(err))
        if not fix_err[shard] < 40.0:
            raise AssertionError(f"mesh fix error {fix_err[shard]:.1f} m (shard={shard})")
    if dist.get_rank() == 0:
        print(f"dryrun_multichip OK: mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"on {dev}, {int(acq.acquired.sum())} PRNs acquired, tracked {n_ms} ms (direct "
              f"+ pipeline shard=channel/time); warm-start mesh PVT fix median 3D error "
              f"time={fix_err['time']:.2f} m / channel={fix_err['channel']:.2f} m vs injected "
              "truth", flush=True)


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 900.0) -> None:
    """The sharded receiver in a world of ``n_devices`` ranks on this host
    (parallel.mesh.spawn_world): PRN-sharded acquisition, time x channel
    sharded tracking called directly and through ``run_receiver``, and the
    12-s warm-start fix under both shardings (median 3D error < 40 m).
    ``device``: each rank's card (ranks share cards round robin) unless the
    caller names the CPU.  Raises if any rank fails."""
    from softgnss_tpu_torch.device import resolve
    from softgnss_tpu_torch.parallel.mesh import spawn_world

    resolve(device)
    spawn_world(_dryrun_rank, n_devices, (n_devices, device), device=device, timeout=timeout)
