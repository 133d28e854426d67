"""Software-pipelined tracking over sequential time chunks of the capture.

The port of softgnss_tpu.parallel.stream, on one device or, with
``mesh=``, channel-sharded over a mesh (each rank streams its own rows).  The monolithic
tracker moves the whole capture to the card before it tracks (1.4 GB at
the reference workload) and brings every output back after.  Here the
capture stays in host memory (a NumPy array, an ``np.memmap`` or a CPU
tensor) and goes up one time chunk at a time, so that on the card

    copy stream:     upload k+1 (host -> device, from pinned memory)
    compute stream:  chunk k (B2 + B1 launches, or B3, or B4)
    readback:        chunk k-1's outputs (device -> pinned host memory)

overlap.  The device holds two chunk buffers, never the whole capture.
The loop-filter state still serializes the compute of consecutive chunks.

Chunk starts lie on the ``track_block_ms`` grid and every chunk resumes
from the previous chunk's state through the tracker's own resume
(``scan.track_on_device``), with ``ptr`` and ``block_base`` rebased into
the chunk's window and restored at the end, so every chunk builds the
same frames as the uninterrupted run: every output is bit-equal to
``scan.track``'s (the port runs the same kernels on the same frames; the
JAX package's streamed floats can differ by an ulp across its per-chunk
compiles, which the port does not have).

Each chunk's window is deterministic (a code-Doppler bound around the
nominal ms grid, :func:`_chunk_span`), so chunk k+1 is cut and uploaded
before chunk k has run; after the fact every pointer is checked against
its chunk's window, and a violation raises.  On the CPU (a CPU tensor, or
``device="cpu"``) the same chunks run one after the other, without
streams.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from softgnss_tpu_torch.acquire.search import Channels
from softgnss_tpu_torch.config import ReceiverConfig
from softgnss_tpu_torch.parallel.track import (
    channel_sharded,
    compute_device,
    track_channels_sharded,
)
from softgnss_tpu_torch.track.scan import (
    MsOutputs,
    TrackResults,
    TrackState,
    _check_overflow,
    channel_tables,
    initial_state,
    track,
    track_on_device,
)

#: relative code-rate envelope of a chunk's window: the true per-ms
#: pointer advance leaves the nominal grid by the code Doppler (< 4e-6 of
#: the chip rate for |Doppler| < 6 kHz on L1) plus DLL transients; 1e-4 is
#: ~25x that (softgnss_tpu.parallel.stream._DRIFT_REL)
_DRIFT_REL = 1e-4


def _chunk_span(config: ReceiverConfig, m0: int, m1: int) -> tuple[int, int]:
    """Unclamped [base, end) capture-sample window that holds every frame
    of tracked milliseconds [m0, m1): the nominal grid +- the drift
    envelope, +- the initial code phase (< 1 period) and the frame slack."""
    spc = config.samples_per_code
    guard = 2 * spc + config.track_window
    base = config.skip_samples + math.floor(m0 * spc * (1 - _DRIFT_REL)) - guard
    end = config.skip_samples + math.ceil((m1 + 2) * spc * (1 + _DRIFT_REL)) + guard
    return base, end


def _source(signal):
    """(host source, its length, whether it lies in pinned memory, its
    device): a tensor stays a tensor; anything else is taken as an int8
    array-like (np.memmap included), read only where a chunk needs it."""
    if isinstance(signal, torch.Tensor):
        pinned = signal.device.type == "cpu" and signal.is_pinned()
        return signal, signal.shape[0], pinned, signal.device
    return signal, signal.shape[0], False, torch.device("cpu")


class _Uploader:
    """Chunks of a host capture into two device buffers on a copy stream.

    Chunk k goes into buffer k % 2, from the pinned source itself or through
    pinned staging buffer k % 2; the copy waits for the compute that last
    read that device buffer, and the compute of chunk k waits for its copy
    (events, no host synchronisation but for a staging buffer's reuse)."""

    def __init__(self, src, pinned: bool, length: int, device: torch.device):
        self.src, self.pinned = src, pinned
        self.stream = torch.cuda.Stream(device)
        self.dev = [torch.empty(length, dtype=torch.int8, device=device) for _ in range(2)]
        self.stage = None if pinned else [torch.empty(length, dtype=torch.int8,
                                                      pin_memory=True) for _ in range(2)]
        self.copied = [None, None]       # event: the copy into buffer i has landed
        self.consumed = [None, None]     # event: the compute reading buffer i is done

    def upload(self, k: int, base: int, end: int) -> int:
        i, n = k % 2, end - base
        if self.pinned:
            host = self.src[base:end]
        else:
            if self.copied[i] is not None:
                self.copied[i].synchronize()          # staging buffer i is free again
            host = self.stage[i][:n]
            piece = self.src[base:end]
            host.numpy()[:] = piece.numpy() if isinstance(piece, torch.Tensor) else piece
        with torch.cuda.stream(self.stream):
            if self.consumed[i] is not None:
                self.stream.wait_event(self.consumed[i])
            self.dev[i][:n].copy_(host, non_blocking=True)
            self.copied[i] = torch.cuda.Event()
            self.copied[i].record(self.stream)
        return i

    def chunk(self, i: int, n: int) -> torch.Tensor:
        """Buffer ``i`` for the compute stream, once its copy has landed."""
        torch.cuda.current_stream().wait_event(self.copied[i])
        return self.dev[i][:n]

    def release(self, i: int) -> None:
        self.consumed[i] = torch.cuda.Event()
        self.consumed[i].record(torch.cuda.current_stream())


def _readback(ys: MsOutputs, ovf: torch.Tensor, device: torch.device):
    """Start the copy of a chunk's outputs into pinned host memory on the
    compute stream without waiting; returns (host tensors, overflow, event)."""
    if device.type != "cuda":
        return ys, ovf, None
    host = MsOutputs(*[torch.empty(v.shape, dtype=v.dtype, pin_memory=True) for v in ys])
    for h, v in zip(host, ys):
        h.copy_(v, non_blocking=True)
    ovf_h = torch.empty(ovf.shape, dtype=ovf.dtype, pin_memory=True)
    ovf_h.copy_(ovf, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream())
    return host, ovf_h, done


def track_streamed(config: ReceiverConfig, signal, channels: Channels, n_ms: int | None = None,
                   chunk_ms: int | None = None, state: TrackState | None = None,
                   device=None, mesh=None) -> TrackResults:
    """Track ``n_ms`` milliseconds in pipelined ``chunk_ms`` time chunks
    (``config.track_stream_chunk_ms`` by default).

    Takes what :func:`softgnss_tpu_torch.track.scan.track` takes, plus
    ``chunk_ms``; ``signal`` may be any int8 array-like, an ``np.memmap``
    included (a chunk is read from it only when its upload is issued), or a
    tensor.  ``device``: where the tracking runs — by default the device a
    tensor lies on, and the card for anything else (raising without one);
    a CPU tensor runs on the host unless ``device`` names the card.  A
    capture in pinned host memory is uploaded straight from it; any other
    host capture goes through two pinned staging buffers.

    ``mesh``: every chunk is channel-sharded over it
    (parallel.track.track_channels_sharded): each rank streams the chunks
    for its own rows, and the rows are gathered at the end; every output is
    still bit-equal to ``track``'s."""
    n_ms = int(config.ms_to_process if n_ms is None else n_ms)
    B = max(1, config.track_block_ms)
    chunk_ms = config.track_stream_chunk_ms if chunk_ms is None else chunk_ms
    src, sig_len, pinned, src_dev = _source(signal)
    dev = compute_device(signal, device)
    if n_ms <= 0 or chunk_ms <= 0 or chunk_ms >= n_ms:
        # nothing to pipeline: one chunk would only re-slice the window
        sig = src if isinstance(src, torch.Tensor) else torch.from_numpy(
            np.require(src, np.int8, ["C", "W"]))
        if mesh is not None:
            return track_channels_sharded(config, sig, channels, mesh, n_ms=n_ms, state=state,
                                          device=dev)
        return track(config, sig, channels, n_ms=n_ms, state=state, device=dev)
    chunk_ms = max(B, int(chunk_ms) // B * B)       # chunk starts on the block grid
    spc = config.samples_per_code
    start = config.skip_samples if state is None else int(torch.as_tensor(state.ptr).max())
    needed = start + (n_ms + 2) * spc
    if sig_len < needed:
        raise ValueError(f"capture too short for tracking: need >= {needed} samples, "
                         f"got {sig_len}")
    start_ms = 0 if state is None else int(torch.as_tensor(state.ms).max())
    if start_ms % B:
        raise ValueError(f"track_streamed resumes only on the {B}-ms block grid, "
                         f"got start_ms={start_ms}")

    def run(chans, st, start_ms):
        final, ys = _stream(config, src, sig_len, pinned, src_dev, dev, chans, st, start_ms,
                            n_ms, chunk_ms)
        return (final, MsOutputs(*[torch.from_numpy(v) for v in ys])), 0

    if mesh is not None:
        return channel_sharded(config, channels, mesh, state, dev, run)
    st = (initial_state(config, channels, dev) if state is None
          else TrackState(*[torch.as_tensor(v).to(dev) for v in state]))
    final, ys = _stream(config, src, sig_len, pinned, src_dev, dev, channels, st, start_ms,
                        n_ms, chunk_ms)
    return TrackResults(final_state=final, prn=np.asarray(channels.prn),
                        status=list(channels.status),
                        **{f: v.T for f, v in zip(MsOutputs._fields, ys)})


def _stream(config: ReceiverConfig, src, sig_len: int, pinned: bool, src_dev, dev,
            channels: Channels, st: TrackState, start_ms: int, n_ms: int, chunk_ms: int):
    """The pipelined chunks of :func:`track_streamed` for ``channels`` from
    state ``st`` at absolute ms ``start_ms``: (final state, MsOutputs of
    (n_ms, C) NumPy arrays)."""
    spc = config.samples_per_code
    tables = channel_tables(channels, dev)

    bounds = list(range(0, n_ms, chunk_ms)) + [n_ms]
    spans = list(zip(bounds[:-1], bounds[1:]))
    # one window length for every chunk (the drift envelope widens the
    # needed span slightly with time); the tail past a chunk's need is unused
    length = min(sig_len, max(b - a for a, b in (_chunk_span(config, start_ms + m0,
                                                              start_ms + m1)
                                                 for m0, m1 in spans)))

    def window(k: int) -> tuple[int, int]:
        m0, m1 = spans[k]
        base, _ = _chunk_span(config, start_ms + m0, start_ms + m1)
        base = max(0, min(base, sig_len - length)) // 4 * 4   # word-aligned chunk start
        return base, min(base + length, sig_len)

    on_card = dev.type == "cuda" and src_dev.type == "cpu"
    up = _Uploader(src, pinned, length, dev) if on_card else None

    def chunk_tensor(k: int):
        base, end = window(k)
        if on_card:
            return base, end, up.upload(k, base, end)
        piece = src[base:end]
        if not isinstance(piece, torch.Tensor):
            piece = torch.from_numpy(np.require(piece, np.int8, ["C", "W"]))
        return base, end, piece.to(dev)

    prev_base = 0
    inflight: list[tuple] = []      # (base, end, host outputs, host overflow, event)
    fetched: list[MsOutputs] = []

    def drain_one() -> None:
        base, end, ys, ovf, done = inflight.pop(0)
        if done is not None:
            done.synchronize()
        _check_overflow(ovf)
        ys = MsOutputs(*[v.numpy() for v in ys])
        ys = ys._replace(absolute_sample=np.where(ys.absolute_sample != 0,
                                                  ys.absolute_sample + base, 0))
        # every active pointer's frames stayed inside [base, end); the bound
        # binds only where the window is interior (at the capture's ends
        # the frames read zeros exactly as the monolithic tracker's do)
        a = ys.absolute_sample[ys.absolute_sample != 0]
        if a.size:
            lo = int(a.min()) - 2 * spc - config.track_frame_pre
            hi = int(a.max()) + 2 * spc
            if (lo < base and base > 0) or (hi > end and end < sig_len):
                raise RuntimeError(
                    "streamed-tracking chunk window violated: pointers "
                    f"[{a.min()}, {a.max()}] vs window [{base}, {end}) — code-rate "
                    "drift exceeded the _DRIFT_REL envelope")
        fetched.append(ys)

    next_up = chunk_tensor(0)
    for k, (m0, m1) in enumerate(spans):
        base, end, held = next_up
        sig = up.chunk(held, end - base) if on_card else held
        # rebase the carried state into this chunk's window (device-side
        # integer ops: no host synchronisation)
        delta = base - prev_base
        if delta:
            st = st._replace(ptr=st.ptr - delta, block_base=st.block_base - delta)
        prev_base = base
        st, ys, ovf = track_on_device(config, sig, tables, st, m1 - m0, start_ms + m0)
        if on_card:
            up.release(held)
        inflight.append((base, end, *_readback(ys, ovf, dev)))
        if k + 1 < len(spans):
            next_up = chunk_tensor(k + 1)            # overlaps chunk k's compute
        if len(inflight) > 1:
            drain_one()                              # chunk k-1, also overlapped
    while inflight:
        drain_one()

    final = st._replace(ptr=st.ptr + prev_base, block_base=st.block_base + prev_base)
    return final, MsOutputs(*[np.concatenate([getattr(y, f) for y in fetched])
                              for f in MsOutputs._fields])
