"""Receiver pipeline: probe -> acquire -> track -> lock demotion -> navigate.

The port of softgnss_tpu.pipeline.  The capture is loaded once (file or
in-memory array) and moved to ``device`` in one copy; acquisition and
tracking run there; tracking results come back as NumPy arrays and
navigation runs on the host CPU in float64, as in the JAX package.  With
``mesh=`` every rank of the mesh runs the chain with the same arguments:
acquisition and tracking are sharded (softgnss_tpu_torch.parallel), every
rank gets the whole result and navigates it, and rank 0 alone writes the
checkpoint.  Tracking results checkpoint to .npz with the JAX package's
keys, so a checkpoint from either package loads in the other.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from softgnss_tpu_torch import io as sio
from softgnss_tpu_torch.acquire.search import (
    AcquisitionResults,
    Channels,
    acquire,
    assign_channels,
    format_channel_status,
)
from softgnss_tpu_torch.config import ReceiverConfig
from softgnss_tpu_torch.convert import track_state_from_numpy, track_state_to_numpy
from softgnss_tpu_torch.device import place, resolve
from softgnss_tpu_torch.nav.message import Ephemeris
from softgnss_tpu_torch.nav.solve import NavSolutions, post_navigate
from softgnss_tpu_torch.parallel import (
    acquire_sharded,
    track_channels_sharded,
    track_streamed,
    track_time_exact,
    track_time_sharded,
)
from softgnss_tpu_torch.profiling import StageTimer, channel_lock_loss, trace
from softgnss_tpu_torch.track.scan import TrackResults, track

logger = logging.getLogger(__name__)

_OUTPUT_KEYS = ("absolute_sample", "sample_frac", "code_freq", "carr_freq", "i_p",
                "i_e", "i_l", "q_e", "q_p", "q_l", "dll_discr", "dll_discr_filt",
                "pll_discr", "pll_discr_filt")


@dataclass
class ReceiverResults:
    """Everything a receiver run produces."""

    config: ReceiverConfig
    probe: dict | None = None
    acquisition: AcquisitionResults | None = None
    channels: Channels | None = None
    tracking: TrackResults | None = None
    solutions: NavSolutions | None = None
    ephemerides: list[Ephemeris | None] = field(default_factory=lambda: [None] * 32)
    timings_s: dict = field(default_factory=dict)

    @property
    def has_fix(self) -> bool:
        return self.solutions is not None and np.isfinite(self.solutions.x).any()

    def summary(self) -> str:
        lines = []
        if self.acquisition is not None:
            n_acq = int(self.acquisition.acquired.sum())
            lines.append(f"Acquired {n_acq} satellites: "
                         f"{[i + 1 for i in np.flatnonzero(self.acquisition.acquired)]}")
        if self.channels is not None:
            lines.append(format_channel_status(self.config, self.channels))
        if self.tracking is not None:
            lines.append(f"Tracked {self.tracking.n_ms} ms on "
                         f"{sum(1 for s in self.tracking.status if s != '-')} channels")
            if self.tracking.lock_loss_ms is not None:
                for ch in np.flatnonzero(np.isfinite(self.tracking.lock_loss_ms)):
                    lines.append(f"  lock lost: channel {ch} "
                                 f"(PRN {int(self.tracking.prn[ch])}) at "
                                 f"{self.tracking.lock_loss_ms[ch] / 1000.0:.1f} s "
                                 f"-> status 'L', demoted from navigation")
        sol = self.solutions
        if sol is not None:
            ok = np.isfinite(sol.latitude)
            if ok.any():
                tag = " (EKF)" if sol.nav_filter == "ekf" else ""
                if tag and sol.n_used is not None and (fin_lt4 := ok & (sol.n_used < 4)).any():
                    tag += f", {int(fin_lt4.sum())} epochs bridged with < 4 usable satellites"
                lines.append(
                    f"PVT{tag}: {int(ok.sum())}/{sol.n_epochs} fixes, mean "
                    f"lat {np.nanmean(sol.latitude):.6f} deg, "
                    f"lon {np.nanmean(sol.longitude):.6f} deg, "
                    f"hgt {np.nanmean(sol.height):.1f} m, "
                    f"mean PDOP {np.nanmean(sol.dop[1]):.2f}, "
                    f"TTFF {sol.ttff_ms / 1000.0:.1f} s")
                if sol.vx is not None:
                    v = np.sqrt(sol.vx**2 + sol.vy**2 + sol.vz**2)
                    if np.isfinite(v).any():
                        lines.append(f"Velocity: median |v| {np.nanmedian(v):.3f} m/s, "
                                     f"clock drift {np.nanmedian(sol.clock_drift):.3f} m/s")
                utc_off = sol.utc_offset_s()
                if utc_off is not None:
                    lines.append(f"UTC: GPS-UTC offset {utc_off:.9f} s (leap seconds "
                                 f"{int(sol.utc_params.delta_t_ls)}; week {sol.week_number})")
                flags = sol.raim_flag
                if flags is not None and (flags > 0).any():
                    n_ex = int((flags == 1).sum())
                    n_bad = int((flags == 2).sum())
                    prns = sorted(set(sol.raim_excluded_prn[flags == 1].tolist()))
                    lines.append(
                        f"RAIM: {n_ex} epoch(s) with a satellite excluded"
                        + (f" (PRNs {prns})" if prns else "")
                        + (f", {n_bad} epoch(s) invalidated (non-isolable fault)"
                           if n_bad else ""))
            else:
                lines.append("PVT: no fixes")
        elif self.tracking is not None:
            lines.append("PVT: navigation solution not computed")
        for stage, dt in self.timings_s.items():
            lines.append(f"  {stage:14s} {dt:8.3f} s")
        return "\n".join(lines)


def _checkpoint_path(path: str) -> str:
    """np.savez appends .npz; normalize so save/exists/load agree."""
    return path if path.endswith(".npz") else path + ".npz"


def _demote_unlocked(config: ReceiverConfig, tracking: TrackResults) -> None:
    """Flag channels that lost lock mid-capture (config.lock_demotion):
    fills ``tracking.lock_loss_ms`` and flips their status 'T' -> 'L'."""
    if not config.lock_demotion or tracking.n_ms < config.lock_window_ms + 20:
        return
    loss = channel_lock_loss(config, tracking)
    tracking.lock_loss_ms = loss
    for ch in np.flatnonzero(np.isfinite(loss)):
        if tracking.status[ch] == "T":
            tracking.status[ch] = "L"
        logger.warning("Channel %d (PRN %d) lost lock at %.0f ms "
                       "(C/N0 or phase-lock below threshold); demoted.",
                       ch, int(tracking.prn[ch]), loss[ch])


def save_tracking(path: str, tracking: TrackResults) -> None:
    """Checkpoint tracking output (and the final loop state) to .npz."""
    state = {}
    if tracking.final_state is not None:
        state = {f"state_{k}": v
                 for k, v in track_state_to_numpy(tracking.final_state).items()}
    if tracking.lock_loss_ms is not None:
        state["lock_loss_ms"] = np.asarray(tracking.lock_loss_ms)
    np.savez_compressed(
        _checkpoint_path(path), prn=tracking.prn, status=np.asarray(tracking.status),
        **{k: getattr(tracking, k) for k in _OUTPUT_KEYS}, **state)


def load_tracking(path: str) -> TrackResults:
    """Load a checkpoint written by either package; the state comes back
    as CPU tensors (``track`` moves it to the capture's device)."""
    data = np.load(_checkpoint_path(path), allow_pickle=False)
    state = None
    if "state_ptr" in data:
        state = track_state_from_numpy(
            {k[len("state_"):]: data[k] for k in data.files if k.startswith("state_")})
    return TrackResults(
        prn=data["prn"], status=[str(s) for s in data["status"]],
        final_state=state,
        lock_loss_ms=data["lock_loss_ms"] if "lock_loss_ms" in data else None,
        **{k: data[k] for k in _OUTPUT_KEYS})


def run_receiver(config: ReceiverConfig, signal=None, file_name: str | None = None,
                 n_ms: int | None = None, probe: bool = False,
                 navigate: bool = True, checkpoint: str | None = None,
                 channels: Channels | None = None,
                 ephemerides: list | None = None, iono=None, utc=None,
                 assist_position: np.ndarray | None = None,
                 assist_tow: float | None = None, stream: bool = False,
                 mesh=None, shard: str = "channel", device="cuda") -> ReceiverResults:
    """Run the receiver chain on ``device``.

    ``signal``: in-memory int8 capture (NumPy array, ``np.memmap`` or
    tensor; absolute sample indexing including ``config.skip_samples``),
    or ``file_name`` to read one.  It is moved to ``device`` once; with
    ``stream`` only the acquisition window is, and tracking streams the
    capture up in ``config.track_stream_chunk_ms`` chunks
    (parallel.stream.track_streamed; every output equal to the monolithic
    run's).  ``mesh``: a DeviceMesh (softgnss_tpu_torch.parallel.make_mesh)
    that every rank calls this with: acquisition shards its PRN axis and
    tracking shards per ``shard`` — 'channel' (exact), 'time' (time blocks
    with warm-up re-lock; the capture stays on the host and each rank
    uploads its own span) or 'time-exact' (sequential-carry time blocks);
    ``stream`` composes with ``shard='channel'`` only.  ``n_ms`` overrides
    ``config.ms_to_process``.  ``checkpoint``: .npz tracking checkpoint,
    loaded if it exists, written after tracking otherwise.  ``channels``:
    pre-assigned tracking channels (skips acquisition).  ``navigate``:
    decode the nav message and solve PVT on the host
    (nav.solve.post_navigate).

    ``ephemerides``: per-PRN list of 32 for a warm start (a previous run's
    ``results.ephemerides`` or ``nav.message.load_ephemerides``):
    navigation then needs ~8 s of capture instead of the 36 s frame
    decode; ``iono``/``utc``: Klobuchar coefficients and UTC parameters to
    use in place of subframe 4.  With ``assist_position`` (approximate
    receiver ECEF) and ``assist_tow`` (approximate GPS time of week at
    capture start) too, acquisition is Doppler-hinted from the
    ephemerides (nav.assist.predict_doppler)."""
    if shard not in ("channel", "time", "time-exact"):
        raise ValueError(f"shard must be 'channel', 'time', or 'time-exact', got {shard!r}")
    if stream and mesh is not None and shard != "channel":
        raise ValueError("stream=True composes with mesh= only for shard='channel' "
                         "(time sharding partitions the capture itself)")
    dev = resolve(device)
    results = ReceiverResults(config=config)
    timer = StageTimer(dev, results.timings_s)
    if signal is None:
        if not (file_name or config.file_name):
            raise ValueError("provide signal= or file_name=")
        with timer.stage("read"):
            # complex I/Q captures come back upconverted with the IF moved
            # up by fs/4: the returned config governs everything downstream
            signal, config = sio.load_capture(file_name or config.file_name, config)
        results.config = config
    on_host = stream or (mesh is not None and shard == "time")
    sig = signal if on_host else place(signal, dev)

    n_ms = int(config.ms_to_process if n_ms is None else n_ms)
    skip = config.skip_samples
    spc = config.samples_per_code
    if probe:
        head = sig[skip: skip + 10 * spc]
        results.probe = sio.probe_data(
            config, head.cpu().numpy() if isinstance(head, torch.Tensor) else np.asarray(head))

    def navigation():
        if navigate:
            with timer.stage("navigate"):
                results.solutions, results.ephemerides = post_navigate(
                    config, results.tracking, ephemerides=ephemerides, iono=iono, utc=utc)
        return results

    # a loaded checkpoint supersedes acquisition and tracking
    if checkpoint is not None and os.path.exists(_checkpoint_path(checkpoint)):
        logger.info("Loading tracking checkpoint %s", _checkpoint_path(checkpoint))
        with timer.stage("track"):
            results.tracking = load_tracking(checkpoint)
            if results.tracking.lock_loss_ms is None:
                with trace("track.demote"):
                    _demote_unlocked(config, results.tracking)
        return navigation()

    # --- acquisition (reference: initialize.py:481-492) --------------------
    if channels is not None:
        results.channels = channels
    elif config.skip_acquisition:
        raise ValueError("config.skip_acquisition requires channels= "
                         "(pre-assigned tracking channels)")
    else:
        acq_need = config.acquisition_ms * spc
        if sig.shape[0] < skip + acq_need:
            raise ValueError(f"capture too short for acquisition: need "
                             f"{skip + acq_need} samples, got {sig.shape[0]}")
        hints = None
        if (ephemerides is not None and assist_position is not None
                and assist_tow is not None):
            from softgnss_tpu_torch.nav.assist import predict_doppler

            hints = predict_doppler(config, ephemerides, np.asarray(assist_position),
                                    float(assist_tow))
        with timer.stage("acquire"):
            if mesh is not None:
                results.acquisition = acquire_sharded(config, sig[skip: skip + acq_need], mesh,
                                                      doppler_hints=hints, device=dev)
            else:
                results.acquisition = acquire(config, sig[skip: skip + acq_need],
                                              doppler_hints=hints, device=dev)
        if not results.acquisition.acquired.any():
            logger.warning("No GNSS signals detected, signal processing finished.")
            return results
        results.channels = assign_channels(config, results.acquisition)

    # --- tracking -----------------------------------------------------------
    with timer.stage("track"):
        if stream:
            results.tracking = track_streamed(config, sig, results.channels, n_ms=n_ms,
                                              device=dev, mesh=mesh)
        elif mesh is not None:
            track_fn = {"channel": track_channels_sharded, "time": track_time_sharded,
                        "time-exact": track_time_exact}[shard]
            results.tracking = track_fn(config, sig, results.channels, mesh, n_ms=n_ms,
                                        device=dev)
        else:
            results.tracking = track(config, sig, results.channels, n_ms=n_ms)
        with trace("track.demote"):
            _demote_unlocked(config, results.tracking)
        if checkpoint is not None:
            if mesh is None or dist.get_rank() == 0:
                save_tracking(checkpoint, results.tracking)
            if mesh is not None:
                dist.barrier()
    return navigation()
