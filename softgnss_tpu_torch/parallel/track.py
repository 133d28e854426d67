"""Mesh-sharded tracking: channels data-parallel, time blocks
sequence-parallel (softgnss_tpu.parallel.track).

* **Channel sharding** (exact): each rank tracks its rows of the channel
  set, padded to a multiple of the channel dimension with idle rows, over
  the whole capture on its own device (``track.scan.track_on_device``: B2 +
  B1, B3, or B4 as ``config.tracker`` says; B1's idle clusters exit whole,
  so pad rows cost no work).  A channel's arithmetic does not depend on
  which channels share its launch, so every output is bit-equal to
  ``track.scan.track``.

* **Time-block sharding** (re-lock approximation): the capture is cut into
  ``n_t`` contiguous blocks along the time dimension.  Shard 0 starts from
  the exact acquisition state; shard b > 0 from a state propagated
  analytically from acquisition (:func:`propagate_state`) to
  ``b*block - warmup`` ms, and re-locks over ``config.time_shard_warmup_ms``
  before its outputs count.  A vote over the warm-up overlap reconciles the
  PLL's half-turn ambiguity between neighbours, and the blocks are
  stitched.

* **Exact time blocking** (:func:`track_time_exact`): sequential
  channel-sharded blocks that carry the loop state.

The JAX package exchanges overlap-save halos between time shards with
``lax.ppermute`` because its capture is a device array sharded over time.
Here every rank receives the whole host capture and slices its own span,
``[base, base + halo_prev + block_len + halo_next)`` with
``base = skip + b*block_len - halo_prev``, from it, uploading only that span
to its device: the bytes are those JAX's ppermute assembles
(tests/test_torch_parallel.py holds them equal), but for two things.  The
span starts at ``base`` rounded down to a multiple of 4 samples, so that the
block tracker's int32 word view (``scan.capture_words``) frames every
millisecond on the same word grid as the unsharded run.  And shard 0's
previous halo, which in JAX wraps around the ring to the last shard's tail,
holds the capture's real samples before ``skip_samples`` (zeros before
sample 0); no pointer reads them.

Outputs go to host memory and are gathered over gloo
(parallel.mesh.all_gather_host): channel-sharded outputs over the channel
dimension, time-sharded ones over the whole mesh.  Every input check runs
on every rank before any collective, and a failure or frame overflow on one
rank raises on all of them (parallel.mesh.run_together).
"""

from __future__ import annotations

import numpy as np
import torch

from softgnss_tpu_torch.acquire.search import Channels
from softgnss_tpu_torch.config import ReceiverConfig
from softgnss_tpu_torch.device import place, resolve
from softgnss_tpu_torch.parallel.mesh import (
    all_gather_host,
    mesh_position,
    rank_grid,
    run_together,
)
from softgnss_tpu_torch.track.scan import (
    _F32_FIELDS,
    MsOutputs,
    TrackResults,
    TrackState,
    _check_overflow,
    channel_tables,
    initial_state,
    track_on_device,
)

_SIGNED = ("i_p", "q_p", "i_e", "q_e", "i_l", "q_l")


def _pad_channels(channels: Channels, multiple: int) -> Channels:
    """``channels`` with idle rows appended up to a multiple of ``multiple``."""
    pad = (-len(channels)) % multiple
    if pad == 0:
        return channels
    return Channels(
        prn=np.concatenate([channels.prn, np.zeros(pad, np.int64)]),
        acquired_freq=np.concatenate([channels.acquired_freq, np.zeros(pad)]),
        code_phase=np.concatenate([channels.code_phase, np.zeros(pad, np.int64)]),
        status=list(channels.status) + ["-"] * pad)


def _rows(channels: Channels, c: int, n_c: int) -> tuple[slice, Channels]:
    """Shard ``c`` of ``n_c``'s rows of the padded ``channels``."""
    per = len(channels) // n_c
    sl = slice(c * per, (c + 1) * per)
    return sl, Channels(prn=channels.prn[sl], acquired_freq=channels.acquired_freq[sl],
                        code_phase=channels.code_phase[sl], status=channels.status[sl])


def _state_rows(state: TrackState, sl: slice) -> TrackState:
    return TrackState(*[v[sl] for v in state])


def _host(ys: MsOutputs) -> MsOutputs:
    return MsOutputs(*[torch.as_tensor(v).cpu() for v in ys])


def _results(channels: Channels, ys: MsOutputs, final: TrackState, n_channels: int,
             dev) -> TrackResults:
    """TrackResults of the first ``n_channels`` rows from (n_ms, C) outputs
    and a (C,) final state."""
    return TrackResults(
        prn=np.asarray(channels.prn)[:n_channels], status=list(channels.status)[:n_channels],
        final_state=TrackState(*[v[:n_channels].to(dev) for v in final]),
        **{f: v[:, :n_channels].numpy().T for f, v in zip(MsOutputs._fields, ys)})


def compute_device(signal, device) -> torch.device:
    """Where a rank tracks: ``device``; else the device a tensor lies on,
    and the card for anything else (raising without one)."""
    if device is not None:
        return resolve(device)
    return signal.device if isinstance(signal, torch.Tensor) else resolve("cuda")


# --------------------------------------------------------------------------
# channel sharding (exact)
# --------------------------------------------------------------------------

def channel_sharded(config: ReceiverConfig, channels: Channels, mesh, state, dev, run):
    """The channel-sharded frame shared by :func:`track_channels_sharded`
    and ``parallel.stream.track_streamed(mesh=)``: pad the channels to the
    channel dimension, graft a resumed ``state`` (rows of the unpadded
    channels) onto the padded template, run
    ``run(local channels, local state, start_ms) -> ((final state, host
    MsOutputs of (n_ms, C_local)), overflow)`` on this rank's rows, and
    gather the rows over the channel dimension."""
    pos = mesh_position(config, mesh)
    n_channels = len(channels)
    padded = _pad_channels(channels, pos.n_c)
    st = initial_state(config, padded, dev)
    start_ms = 0
    if state is not None:
        st = TrackState(*[torch.cat([torch.as_tensor(live).to(dev), pad[n_channels:]])
                          for pad, live in zip(st, state)])
        start_ms = int(torch.as_tensor(state.ms).max())
    sl, mine = _rows(padded, pos.c, pos.n_c)
    (final, ys), ovf = run_together(lambda: run(mine, _state_rows(st, sl), start_ms))
    _check_overflow(torch.tensor(ovf))
    if pos.n_c > 1:
        parts = all_gather_host([*ys, *final], pos.channel_group)
        leaves = [torch.cat(leaf, dim=-1) for leaf in zip(*parts)]
        ys, final = MsOutputs(*leaves[:len(ys)]), TrackState(*leaves[len(ys):])
    return _results(padded, ys, final, n_channels, dev)


def _check_length(config: ReceiverConfig, signal, n_ms: int, state) -> None:
    if n_ms <= 0:
        raise ValueError(f"n_ms must be positive, got {n_ms}")
    start = config.skip_samples if state is None else int(torch.as_tensor(state.ptr).max())
    needed = start + (n_ms + 2) * config.samples_per_code
    if signal.shape[0] < needed:
        raise ValueError(f"capture too short for tracking: need >= {needed} samples, "
                         f"got {signal.shape[0]}")


def track_channels_sharded(config: ReceiverConfig, signal, channels: Channels, mesh,
                           n_ms: int | None = None, state: TrackState | None = None,
                           device=None) -> TrackResults:
    """Channel-sharded tracking over ``mesh``; every rank of the mesh calls
    it with the same arguments and gets the same TrackResults, every output
    bit-equal to :func:`softgnss_tpu_torch.track.track`'s.  ``signal``: the
    whole capture (NumPy, memmap or tensor), placed whole on this rank's
    ``device`` (by ``track``'s rule).  ``state``: a previous run's
    ``final_state`` (rows of the unpadded channels) to resume from."""
    n_ms = int(config.ms_to_process if n_ms is None else n_ms)
    _check_length(config, signal, n_ms, state)
    dev = compute_device(signal, device)
    sig = place(signal, dev)

    def run(mine, st, start_ms):
        final, ys, ovf = track_on_device(config, sig, channel_tables(mine, dev), st, n_ms,
                                         start_ms)
        return (final, _host(ys)), int(ovf.max()) if ovf.numel() else 0

    return channel_sharded(config, channels, mesh, state, dev, run)


# --------------------------------------------------------------------------
# time-block sharding (warm-up re-lock)
# --------------------------------------------------------------------------

def propagate_state(config: ReceiverConfig, channels: Channels, start_ms: int,
                    device="cpu") -> TrackState:
    """Loop state estimate at tracked millisecond ``start_ms``: the code
    phase advanced analytically at the Doppler-consistent chip rate, the DLL
    seeded at that rate (host float64, exact integer sample estimates;
    softgnss_tpu.parallel.track.propagate_state)."""
    if start_ms == 0:
        return initial_state(config, channels, device)
    c = len(channels)
    active = np.asarray([s == "T" for s in channels.status])
    acq = np.asarray(channels.acquired_freq, np.float64)
    fc = config.code_freq_basis
    fc_eff = np.where(active, fc * (1.0 + (acq - config.intermediate_freq) / config.l1_freq), fc)
    spp = config.sampling_freq / (fc_eff / config.code_length)      # samples per period
    phase0 = np.asarray(channels.code_phase, np.float64)
    # the sequential tracker completes one code period per tracked ms, so
    # the period index at start_ms is start_ms itself
    ptr = config.skip_samples + np.rint(phase0 + start_ms * spp).astype(np.int64)
    t = lambda a: torch.as_tensor(a).to(device)                     # noqa: E731
    z64 = t(np.zeros(c))
    return TrackState(
        ptr=t(ptr), carr_phase=t(np.zeros(c, np.int32)), code_rem_q=t(np.zeros(c, np.int64)),
        carr_freq=t(acq), code_freq=t(fc_eff), carr_nco=z64, carr_err=z64,
        code_nco=t(fc - fc_eff), code_err=z64, ms=t(np.full(c, start_ms, np.int64)),
        block_base=t(ptr - config.track_frame_pre),
        **{f: t(np.zeros(c, np.float32)) for f in _F32_FIELDS})


def time_plan(config: ReceiverConfig, n_ms: int, n_t: int, signal_len: int) -> tuple[int, int]:
    """(block_ms, warmup_ms) of ``n_t`` time shards over ``n_ms`` ms; raises
    where the JAX package raises."""
    if n_ms % n_t:
        raise ValueError(f"n_ms={n_ms} not divisible by time shards={n_t}")
    block_ms = n_ms // n_t
    if n_t > 1 and block_ms < 3:
        raise ValueError(f"time blocks of {block_ms} ms cannot host a warm-up")
    # warmup <= block - 2 keeps both halos inside a neighbour's block; >= 1
    # keeps the polarity vote non-empty; one time shard needs no warm-up
    warmup = int(np.clip(config.time_shard_warmup_ms, 1, block_ms - 2)) if n_t > 1 else 0
    needed = config.skip_samples + (n_ms + 2) * config.samples_per_code
    if signal_len < needed:
        raise ValueError(f"capture too short: need >= {needed} samples, got {signal_len}")
    return block_ms, warmup


def time_span(config: ReceiverConfig, signal, b: int, n_t: int, block_ms: int,
              warmup: int) -> tuple[int, int, torch.Tensor]:
    """(JAX's assembled base, this span's first sample ``lo``, the int8 span
    as a CPU tensor) of time shard ``b``: samples ``[lo, base + halo_prev +
    block_len + halo_next)`` with ``lo`` = base rounded down to a multiple
    of 4; zeros before sample 0 and, for the last shard, past the 2 code
    periods that follow the tracked body (JAX's zero-padded tail)."""
    spc = config.samples_per_code
    skip = config.skip_samples
    halo_prev, halo_next = (warmup + 1) * spc, (warmup + 2) * spc
    base = skip + b * block_ms * spc - halo_prev
    lo = base // 4 * 4
    end = base + halo_prev + block_ms * spc + halo_next
    real_end = skip + (n_t * block_ms + 2) * spc if b == n_t - 1 else end
    a, z = max(lo, 0), min(real_end, end, signal.shape[0])
    span = torch.zeros(end - lo, dtype=torch.int8)
    piece = signal[a:z]
    if isinstance(piece, torch.Tensor):
        span[a - lo:z - lo] = piece.cpu()
    else:
        span[a - lo:z - lo] = torch.from_numpy(np.require(piece, np.int8, ["C", "W"]))
    return base, lo, span


def track_time_sharded(config: ReceiverConfig, signal, channels: Channels, mesh,
                       n_ms: int | None = None, device=None) -> TrackResults:
    """Time-block and channel sharded tracking over ``mesh``.

    ``n_ms`` must split evenly into the time dimension's blocks.  Each rank
    tracks ``warmup + block`` steps of its rows over its own span of the
    capture (:func:`time_span`); shard 0 from the exact acquisition state,
    shard b > 0 from :func:`propagate_state` at ``b*block - warmup``, each
    with its block grid starting at its first step, as in the JAX package.
    The first ``config.time_shard_warmup_ms`` after each interior boundary
    are re-locked, not carried, so loop-filter transients there may differ
    slightly from a sequential run while correlators and nav bits agree.
    ``final_state`` is the last shard's, with its pointers in capture
    coordinates (the JAX package leaves ``block_base`` relative to the last
    shard's span)."""
    n_ms = int(config.ms_to_process if n_ms is None else n_ms)
    pos = mesh_position(config, mesh)
    block_ms, warmup = time_plan(config, n_ms, pos.n_t, signal.shape[0])
    dev = compute_device(signal, device)
    n_channels = len(channels)
    padded = _pad_channels(channels, pos.n_c)
    sl, mine = _rows(padded, pos.c, pos.n_c)
    steps = warmup + block_ms

    def local():
        st = _state_rows(propagate_state(config, padded, max(0, pos.t * block_ms - warmup),
                                         dev), sl)
        _, lo, span = time_span(config, signal, pos.t, pos.n_t, block_ms, warmup)
        st = st._replace(ptr=st.ptr - lo, block_base=st.block_base - lo)
        final, ys, ovf = track_on_device(config, span.to(dev), channel_tables(mine, dev), st,
                                         steps, 0)
        ys = _host(ys)
        ys = ys._replace(absolute_sample=torch.where(ys.absolute_sample != 0,
                                                     ys.absolute_sample + lo, 0))
        final = final._replace(ptr=final.ptr + lo, block_base=final.block_base + lo)
        return (final, ys), int(ovf.max()) if ovf.numel() else 0

    (final, ys), ovf = run_together(local)
    _check_overflow(torch.tensor(ovf))
    parts = all_gather_host([*ys, *final])
    grid = rank_grid(config, mesh)
    n_y = len(MsOutputs._fields)
    # (n_t, steps, C_pad) per output, (C_pad,) per leaf of the last shard's state
    ys = MsOutputs(*[np.stack([np.concatenate([parts[r][i].numpy() for r in row], axis=-1)
                               for row in grid]) for i in range(n_y)])
    final = TrackState(*[torch.cat([parts[r][n_y + i] for r in grid[-1]])
                         for i in range(len(TrackState._fields))])

    # polarity: a re-locked Costas PLL settles with a half-turn ambiguity, so
    # shard b's correlators may be sign-flipped against shard b-1's.  Shard
    # b's warm-up re-tracks the milliseconds [b*block - half, b*block) that
    # shard b-1 tracked late; the overlap votes the relative polarity and
    # flips accumulate across shards.  (Shard 0's step m is ms m; shard b > 0
    # starts warmup early.)
    flips = np.ones((pos.n_t, len(padded)))
    half = max(1, warmup // 2)
    for b in range(1, pos.n_t):
        prev_off = block_ms if b == 1 else block_ms + warmup
        prev = ys.i_p[b - 1, prev_off - half: prev_off]
        cur = ys.i_p[b, warmup - half: warmup]
        vote = np.sum(np.sign(prev) * np.sign(cur), axis=0)
        flips[b] = flips[b - 1] * np.where(vote < 0, -1.0, 1.0)

    # stitch: shard 0's steps [0, block), shard b > 0's [warmup, warmup + block)
    def stitch(name, a):
        out = []
        for b in range(pos.n_t):
            off = 0 if b == 0 else warmup
            part = a[b, off:off + block_ms]
            out.append(part * flips[b][None, :].astype(a.dtype) if name in _SIGNED else part)
        return torch.from_numpy(np.concatenate(out))

    ys = MsOutputs(*[stitch(f, v) for f, v in zip(MsOutputs._fields, ys)])
    # a last shard stitched with a flip: turn its carrier phase by half a
    # cycle, so a resumed run keeps the stitched streams' polarity
    half_turn = torch.from_numpy(np.where(flips[-1] < 0, 1 << 31, 0).astype(np.int64))
    ph = (final.carr_phase.to(torch.int64) + half_turn) & 0xFFFFFFFF
    final = final._replace(carr_phase=torch.where(ph >= 1 << 31, ph - (1 << 32),
                                                  ph).to(torch.int32))
    return _results(padded, ys, final, n_channels, dev)


# --------------------------------------------------------------------------
# exact time blocking (sequential carry)
# --------------------------------------------------------------------------

def track_time_exact(config: ReceiverConfig, signal, channels: Channels, mesh,
                     n_ms: int | None = None, device=None) -> TrackResults:
    """Time-blocked tracking with the exact sequential loop-state carry: the
    capture in as many blocks as the mesh's time dimension has shards, each
    channel-sharded over the mesh (every time index replicates), block b
    starting from block b-1's final state.  The carry serializes the blocks;
    this is the exact anchor the re-lock mode is measured against.  Every
    output is bit-equal to :func:`softgnss_tpu_torch.track.track`'s (the
    tracker resumes bit-exactly; the JAX package's float64 loop-filter
    streams may differ by an ulp across its per-block compiles)."""
    n_ms = int(config.ms_to_process if n_ms is None else n_ms)
    n_t = mesh_position(config, mesh).n_t
    if n_ms % n_t:
        raise ValueError(f"n_ms={n_ms} not divisible by time blocks={n_t}")
    _check_length(config, signal, n_ms, None)
    dev = compute_device(signal, device)
    sig = place(signal, dev)                   # placed once for every block
    state, parts = None, []
    for _ in range(n_t):
        r = track_channels_sharded(config, sig, channels, mesh, n_ms=n_ms // n_t,
                                   state=state, device=dev)
        state = r.final_state
        parts.append(r)
    return TrackResults(
        prn=parts[0].prn, status=parts[0].status, final_state=state,
        **{f: np.concatenate([getattr(p, f) for p in parts], axis=1)
           for f in MsOutputs._fields})
