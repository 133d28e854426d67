"""Multi-channel DLL/PLL tracking: the block tracker and the per-ms tracker.

The port of softgnss_tpu.track.scan on its megakernel and pallas
branches; ``config.tracker`` picks one.  The capture lies on the device
as int8.

* **Block tracker** (:func:`track_segments`): the capture is read through
  its int32 word view; blocks of ``track_block_ms`` milliseconds sit on
  the ABSOLUTE ms grid (a resumed run first finishes the block it stopped
  in, the "lead" segment), each anchored at
  ``block_base = ptr - track_frame_pre`` carried in the state, so a
  resumed run frames every millisecond exactly as the uninterrupted run
  does.  For each segment :func:`megakernel.build_frames` (B2) cuts the
  per-ms, per-channel frames and :func:`megakernel.track_block` (B1) runs
  the milliseconds, loop filters included — or
  :func:`megakernel.track_block_fused` (B3) does both in one kernel.  On
  the card a call's full blocks after the first replay one CUDA graph.
* **Per-ms tracker** (:func:`track_ms`), for any front end: each
  millisecond computes the NCO steps and block length in torch,
  launches :func:`pallas_kernel.correlate_ms` (B4) on the capture itself,
  and runs :func:`_filters_and_outputs` in float64 torch.

The per-ms math is the JAX 'gather' formulation: exact integer NCOs (Q40
code phase, uint32 carrier turns), per-sample E/P/L lookups in the padded
code, float32 correlator sums and float64 loop filters
(reference: tracking.py:132-275):

    PLL:  err = atan(Q_P / I_P) / 2pi
          nco += (tau2/tau1)(err - err_prev) + err * PDI/tau1
          carrFreq = acquiredFreq + nco
    DLL:  err = (|E| - |L|) / (|E| + |L|),  |X| = sqrt(I_X^2 + Q_X^2)
          nco += (tau2/tau1)(err - err_prev) + err * PDI/tau1
          codeFreq = codeFreqBasis - nco
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from softgnss_tpu_torch.acquire.search import Channels
from softgnss_tpu_torch.config import ReceiverConfig
from softgnss_tpu_torch.device import place
from softgnss_tpu_torch.profiling import trace
from softgnss_tpu_torch.signals.nco import (
    CODE_ONE,
    carrier_step_u32,
    ceil_chip_index,
    chips_to_q,
    code_step_q,
    true_divide,
    wrap_u32_to_i32,
)
from softgnss_tpu_torch.track.tables import build_tables


class TrackState(NamedTuple):
    """Per-channel tracking loop state; leaves are (C,) tensors with the
    dtypes of softgnss_tpu.track.scan.TrackState."""

    ptr: torch.Tensor          # i64: absolute sample index of next read
    carr_phase: torch.Tensor   # i32: carrier NCO counts (uint32 semantics)
    code_rem_q: torch.Tensor   # i64: remainder code phase, Q40 chips
    carr_freq: torch.Tensor    # f64: current carrier frequency, Hz
    code_freq: torch.Tensor    # f64: current code frequency, Hz
    carr_nco: torch.Tensor     # f64: PLL filter accumulator
    carr_err: torch.Tensor     # f64: previous PLL discriminator
    code_nco: torch.Tensor     # f64: DLL filter accumulator
    code_err: torch.Tensor     # f64: previous DLL discriminator
    ms: torch.Tensor           # i64: milliseconds tracked so far
    #: i64: frame anchor (ptr - track_frame_pre at block entry) of the
    #: ms-grid block this state sits in (bit-exact resume)
    block_base: torch.Tensor
    #: f32: partial coherent sums (zero when config.pdi_ms == 1)
    acc_i_e: torch.Tensor
    acc_i_p: torch.Tensor
    acc_i_l: torch.Tensor
    acc_q_e: torch.Tensor
    acc_q_p: torch.Tensor
    acc_q_l: torch.Tensor
    #: f32: previous update's prompt sums (FLL discriminator memory)
    fll_ip: torch.Tensor
    fll_qp: torch.Tensor


#: the six coherent-accumulator leaves of TrackState, in corr-tuple order
_ACC_FIELDS = ("acc_i_e", "acc_i_p", "acc_i_l",
               "acc_q_e", "acc_q_p", "acc_q_l")
_F32_FIELDS = _ACC_FIELDS + ("fll_ip", "fll_qp")


class MsOutputs(NamedTuple):
    """Per-ms logged observables (reference: tracking.py:253-275), plus
    ``sample_frac``, the sub-sample fraction of the code-period boundary."""

    absolute_sample: torch.Tensor  # i64
    sample_frac: torch.Tensor      # f64 in [0, 1)
    code_freq: torch.Tensor        # f64
    carr_freq: torch.Tensor        # f64
    i_p: torch.Tensor              # f32
    i_e: torch.Tensor
    i_l: torch.Tensor
    q_e: torch.Tensor
    q_p: torch.Tensor
    q_l: torch.Tensor
    dll_discr: torch.Tensor        # f64
    dll_discr_filt: torch.Tensor
    pll_discr: torch.Tensor
    pll_discr_filt: torch.Tensor


#: TrackState as kernel B1 reads and writes it (csrc/track_block.cu): (4, C)
#: int64 rows (carr_phase widened), (6, C) float64 rows and the (8, C)
#: float32 rows of _F32_FIELDS; block_base stays apart
STATE_I64 = ("ptr", "code_rem_q", "ms", "carr_phase")
STATE_F64 = ("carr_freq", "code_freq", "carr_nco", "carr_err", "code_nco", "code_err")
#: B1's outputs beside absolute_sample (r, C): (7, r, C) float64 and (6, r,
#: C) float32 planes
OUT_F64 = ("sample_frac", "code_freq", "carr_freq", "dll_discr", "dll_discr_filt",
           "pll_discr", "pll_discr_filt")
OUT_F32 = ("i_p", "i_e", "i_l", "q_e", "q_p", "q_l")


class Stack(NamedTuple):
    """A TrackState stacked as B1 reads and writes it (STATE_I64, STATE_F64,
    _F32_FIELDS rows); ``flat``: the byte buffer the three share, if any."""

    si: torch.Tensor
    sf: torch.Tensor
    sa: torch.Tensor
    flat: torch.Tensor | None = None


class BlockOut(NamedTuple):
    """A segment's outputs as B1 writes them: absolute_sample (r, C), the
    OUT_F64 and OUT_F32 planes and the (C,) overflow; ``flat``: the byte
    buffer the first three share, if any."""

    abs_sample: torch.Tensor
    of64: torch.Tensor
    of32: torch.Tensor
    ovf: torch.Tensor
    flat: torch.Tensor | None = None


def _packed(parts, lead: tuple, device):
    """(buffer, views): one uint8 buffer of shape ``lead + (bytes,)`` holding,
    at each leading index, the (shape, dtype) ``parts`` back to back, and a
    view of shape ``lead + shape`` of each part."""
    sizes = [math.prod(shape) * dtype.itemsize for shape, dtype in parts]
    flat = torch.empty((*lead, sum(sizes)), dtype=torch.uint8, device=device)
    views, off = [], 0
    for (shape, dtype), n in zip(parts, sizes):
        views.append(flat[..., off:off + n].view(dtype).view(*lead, *shape))
        off += n
    return flat, views


def _out_parts(r: int, c: int) -> list:
    return [((r, c), torch.int64), ((len(OUT_F64), r, c), torch.float64),
            ((len(OUT_F32), r, c), torch.float32)]


def new_stack(c: int, device) -> Stack:
    flat, views = _packed([((len(STATE_I64), c), torch.int64),
                           ((len(STATE_F64), c), torch.float64),
                           ((len(_F32_FIELDS), c), torch.float32)], (), device)
    return Stack(*views, flat=flat)


def new_block_out(r: int, c: int, device) -> BlockOut:
    flat, views = _packed(_out_parts(r, c), (), device)
    return BlockOut(*views, torch.empty(c, dtype=torch.int64, device=device), flat=flat)


#: the dtype of each TrackState leaf
_STATE_DTYPES = {**dict.fromkeys(TrackState._fields, torch.int64), "carr_phase": torch.int32,
                 **dict.fromkeys(STATE_F64, torch.float64),
                 **dict.fromkeys(_F32_FIELDS, torch.float32)}


def stack_state(state: TrackState, s: Stack) -> Stack:
    """Write ``state`` into ``s``; a leaf of another dtype than
    TrackState's raises ValueError (the stack would cast it)."""
    bad = [f for f, v in zip(TrackState._fields, state) if v.dtype != _STATE_DTYPES[f]]
    if bad:
        raise ValueError(f"state leaves {bad}: expected {[_STATE_DTYPES[f] for f in bad]}")
    torch.stack([getattr(state, f).to(torch.int64) for f in STATE_I64], out=s.si)
    torch.stack([getattr(state, f) for f in STATE_F64], out=s.sf)
    torch.stack([getattr(state, f) for f in _F32_FIELDS], out=s.sa)
    return s


def unstack_state(s: Stack, block_base: torch.Tensor) -> TrackState:
    leaves = dict(zip(STATE_I64, s.si))
    leaves["carr_phase"] = leaves["carr_phase"].to(torch.int32)
    leaves.update(zip(STATE_F64, s.sf))
    leaves.update(zip(_F32_FIELDS, s.sa))
    return TrackState(block_base=block_base, **leaves)


def ms_outputs(abs_sample, of64, of32) -> MsOutputs:
    """MsOutputs of B1's outputs (views; the planes on axis -3)."""
    outs = dict(zip(OUT_F64, of64.unbind(-3)))
    outs.update(zip(OUT_F32, of32.unbind(-3)))
    return MsOutputs(absolute_sample=abs_sample, **outs)


@dataclass
class TrackResults:
    """Tracking output; array fields are (channels, ms) NumPy arrays."""

    prn: np.ndarray
    status: list[str]
    absolute_sample: np.ndarray
    sample_frac: np.ndarray
    code_freq: np.ndarray
    carr_freq: np.ndarray
    i_p: np.ndarray
    i_e: np.ndarray
    i_l: np.ndarray
    q_e: np.ndarray
    q_p: np.ndarray
    q_l: np.ndarray
    dll_discr: np.ndarray
    dll_discr_filt: np.ndarray
    pll_discr: np.ndarray
    pll_discr_filt: np.ndarray
    #: loop state after the last tracked ms (tensors on the tracking
    #: device); pass as ``state=`` to :func:`track` to resume exactly
    final_state: "TrackState | None" = None
    #: per-channel ms at which lock was lost (inf = held), see pipeline
    lock_loss_ms: np.ndarray | None = None

    @property
    def n_ms(self) -> int:
        return self.i_p.shape[1]


def initial_state(config: ReceiverConfig, channels: Channels,
                  device="cpu") -> TrackState:
    """Loop state at the first millisecond (reference: tracking.py:107-130)."""
    c = len(channels)
    ptr = torch.as_tensor(config.skip_samples + np.asarray(channels.code_phase),
                          dtype=torch.int64).to(device)
    z64 = torch.zeros(c, dtype=torch.float64, device=device)
    return TrackState(
        ptr=ptr,
        carr_phase=torch.zeros(c, dtype=torch.int32, device=device),
        code_rem_q=torch.zeros(c, dtype=torch.int64, device=device),
        carr_freq=torch.as_tensor(np.asarray(channels.acquired_freq, np.float64)).to(device),
        code_freq=torch.full((c,), config.code_freq_basis, dtype=torch.float64,
                             device=device),
        carr_nco=z64, carr_err=z64, code_nco=z64, code_err=z64,
        ms=torch.zeros(c, dtype=torch.int64, device=device),
        block_base=ptr - config.track_frame_pre,
        **{f: torch.zeros(c, dtype=torch.float32, device=device) for f in _F32_FIELDS},
    )


def _correlate_gather(config: ReceiverConfig, code_pads, tq, i_bb, q_bb):
    """Six float32 correlator sums over the last axis: per-sample E/P/L
    lookups in the padded code at the ceil'd chip phase of ``tq`` (Q40)
    and ``tq -/+ spacing`` (reference: tracking.py:164-190, 209-219).

    The float32 products accumulate in float64 and round once to float32,
    so a sum does not depend on the order it is taken in: kernel B1 and
    this plain version agree to the last bit (JAX's float32 sums differ
    from both by their own rounding, ~1e-7 relative)."""
    half_q = chips_to_q(config.dll_correlator_spacing)
    early, prompt, late = (
        code_pads.gather(-1, ceil_chip_index(tq + d).clamp(0, 1024).to(torch.int64))
        for d in (-half_q, 0, half_q))
    return tuple((code * bb).to(torch.float64).sum(-1).to(torch.float32)
                 for bb in (i_bb, q_bb) for code in (early, prompt, late))


def _filters_and_outputs(config: ReceiverConfig, carr_basis, active, st: TrackState,
                         step_q, blk, w, corr):
    """Loop-filter updates and logged outputs from the six correlator sums,
    channel-batched, float64 (softgnss_tpu.track.scan._filters_and_outputs,
    reference tracking.py:221-275).  With ``config.pdi_ms`` K > 1 the sums
    accumulate in the state and the filters run on every K-th code period."""
    code_len_q = config.code_length * CODE_ONE
    tau1c, tau2c = config.pll_taus
    tau1d, tau2d = config.dll_taus
    pdi = config.pdi_s
    K = config.pdi_ms
    i_e, i_p, i_l, q_e, q_p, q_l = corr
    f64 = torch.float64

    if K > 1:
        a_ie, a_ip, a_il, a_qe, a_qp, a_ql = (
            getattr(st, f) + c for f, c in zip(_ACC_FIELDS, corr))
        upd = (st.ms % K) == (K - 1)
    else:
        a_ie, a_ip, a_il, a_qe, a_qp, a_ql = corr

    # --- PLL (reference: tracking.py:221-235) -------------------------------
    i_p64, q_p64 = a_ip.to(f64), a_qp.to(f64)
    safe_ip = torch.where(i_p64 != 0, i_p64, 1.0)
    carr_err = true_divide(torch.where(i_p64 != 0, torch.atan(q_p64 / safe_ip), 0.0),
                           2.0 * math.pi)
    carr_nco = st.carr_nco + tau2c / tau1c * (carr_err - st.carr_err) + carr_err * (pdi / tau1c)
    if config.fll_bandwidth_hz > 0:
        ip_prev = st.fll_ip.to(f64)
        qp_prev = st.fll_qp.to(f64)
        cross = ip_prev * q_p64 - qp_prev * i_p64
        dot = ip_prev * i_p64 + qp_prev * q_p64
        safe_dot = torch.where(dot != 0, dot, 1.0)
        ferr = true_divide(torch.where(dot != 0, torch.atan(cross / safe_dot), 0.0),
                           2.0 * math.pi * pdi)
        carr_nco = carr_nco + (4.0 * config.fll_bandwidth_hz) * pdi * ferr
    carr_freq = carr_basis + carr_nco

    # --- DLL (reference: tracking.py:237-251) -------------------------------
    e_mag = torch.sqrt(a_ie.to(f64) ** 2 + a_qe.to(f64) ** 2)
    l_mag = torch.sqrt(a_il.to(f64) ** 2 + a_ql.to(f64) ** 2)
    denom = torch.where(e_mag + l_mag > 0, e_mag + l_mag, 1.0)
    code_err = torch.where(e_mag + l_mag > 0, (e_mag - l_mag) / denom, 0.0)
    code_nco = st.code_nco + tau2d / tau1d * (code_err - st.code_err) + code_err * (pdi / tau1d)
    code_freq = config.code_freq_basis - code_nco
    if config.carrier_aided_dll:
        code_freq = code_freq + (config.code_freq_basis / config.l1_freq) * (
            carr_freq - config.intermediate_freq)

    if K > 1:
        carr_err = torch.where(upd, carr_err, st.carr_err)
        carr_nco = torch.where(upd, carr_nco, st.carr_nco)
        carr_freq = torch.where(upd, carr_freq, st.carr_freq)
        code_err = torch.where(upd, code_err, st.code_err)
        code_nco = torch.where(upd, code_nco, st.code_nco)
        code_freq = torch.where(upd, code_freq, st.code_freq)
        accs = {f: torch.where(upd, 0.0, a)
                for f, a in zip(_ACC_FIELDS, (a_ie, a_ip, a_il, a_qe, a_qp, a_ql))}
        accs["fll_ip"] = torch.where(upd, a_ip, st.fll_ip)
        accs["fll_qp"] = torch.where(upd, a_qp, st.fll_qp)
    else:
        accs = {f: getattr(st, f) for f in _ACC_FIELDS}
        accs["fll_ip"] = a_ip
        accs["fll_qp"] = a_qp

    # --- state update (frozen when inactive) --------------------------------
    new = TrackState(
        ptr=st.ptr + blk,
        carr_phase=wrap_u32_to_i32(st.carr_phase.to(torch.int64) + w.to(torch.int64) * blk),
        code_rem_q=st.code_rem_q + step_q * blk - code_len_q,
        carr_freq=carr_freq,
        code_freq=code_freq,
        carr_nco=carr_nco,
        carr_err=carr_err,
        code_nco=code_nco,
        code_err=code_err,
        ms=st.ms + 1,
        block_base=st.block_base,
        **accs,
    )
    new = TrackState(*[torch.where(active, n, o) for n, o in zip(new, st)])

    frac = new.code_rem_q.to(f64) / step_q.to(f64)
    z = lambda x: torch.where(active, x, 0)                   # noqa: E731
    outs = MsOutputs(
        absolute_sample=z(new.ptr), sample_frac=z(frac),
        code_freq=z(code_freq), carr_freq=z(carr_freq),
        i_p=z(i_p), i_e=z(i_e), i_l=z(i_l), q_e=z(q_e), q_p=z(q_p), q_l=z(q_l),
        dll_discr=z(code_err), dll_discr_filt=z(code_nco),
        pll_discr=z(carr_err), pll_discr_filt=z(carr_nco),
    )
    return new, outs


def _check_overflow(ovf: torch.Tensor) -> None:
    """Raise if any frame failed to contain its ms span."""
    n = int(ovf.max()) if ovf.numel() else 0
    if n > 0:
        raise RuntimeError(
            f"tracking frame overflowed its static window by {n} samples — "
            "code-phase drift within a block exceeded the frame slack; "
            "increase config.track_frame_margin or reduce track_block_ms")


def capture_words(signal: torch.Tensor) -> torch.Tensor:
    """(L,) int32 little-endian word view of an int8 capture (free when
    the capture starts on a 4-byte boundary; trailing samples dropped)."""
    n = signal.shape[0] // 4 * 4
    sig = signal[:n]
    if sig.storage_offset() % 4:
        sig = sig.clone()
    return sig.view(torch.int32)


def _kernel_entry(build, block):
    """The stacked launcher of the main path's kernel wrappers: megakernel's
    ``track_block_stacked`` where (build, block) is (build_frames,
    track_block), ``track_block_fused_stacked`` where it is (None,
    track_block_fused), with the keyword options ``block`` may carry (a
    ``functools.partial``); None for anything else."""
    from softgnss_tpu_torch.track import megakernel as mk

    kw = {}
    if isinstance(block, functools.partial) and not block.args:
        block, kw = block.func, block.keywords
    entry = {(mk.build_frames, mk.track_block): mk.track_block_stacked,
             (None, mk.track_block_fused): mk.track_block_fused_stacked}.get((build, block))
    return entry and functools.partial(entry, **kw)


def _through(block, block_base: torch.Tensor):
    """``block`` (a state in, a state out) as a stacked launcher, with the
    signature of megakernel.track_block_stacked."""
    def entry(src, starts, s_in: Stack, s_out: Stack, out: BlockOut, *args):
        st, ys, ovf = block(src, starts, unstack_state(s_in, block_base), *args)
        stack_state(st, s_out)
        out.abs_sample.copy_(ys.absolute_sample)
        torch.stack([getattr(ys, f) for f in OUT_F64], out=out.of64)
        torch.stack([getattr(ys, f) for f in OUT_F32], out=out.of32)
        out.ovf.copy_(ovf)

    return entry


class _GraphPool:
    """Per CUDA device, kept across calls: the side stream the block graphs
    are captured on, the pool of their memory and the event after the last
    replay from it.  The pool is that of ``anchor``, a graph of one fill
    captured once and never replayed: while it lives, torch's allocators
    keep the pool, so that each capture reuses the memory the last one's
    graph held, and asks the card for none."""

    def __init__(self, index: int):
        self.side = torch.cuda.Stream(index)
        self.anchor = torch.cuda.CUDAGraph()
        with torch.cuda.device(index), torch.cuda.stream(self.side):
            self.anchor.capture_begin(capture_error_mode="thread_local")
            torch.zeros(1, device=torch.device("cuda", index))
            self.anchor.capture_end()
        self.id = self.anchor.pool()
        self.last = None


_GRAPH_POOLS: dict = {}


class _BlockGraph:
    """``step`` captured once in a CUDA graph on ``device``'s side stream,
    from its pool (:class:`_GraphPool`).  :meth:`replay` launches it on the
    current stream and counts its kernels on their wrappers' ``launches``
    and, for B1 and B3, the path counters beside it (the capture itself
    launches nothing)."""

    COUNTERS = ("launches", "short_launches", "general_launches")

    def __init__(self, step, device):
        from softgnss_tpu_torch.track import megakernel as mk

        index = device.index if device.index is not None else torch.cuda.current_device()
        if index not in _GRAPH_POOLS:
            _GRAPH_POOLS[index] = _GraphPool(index)
        self.pool = _GRAPH_POOLS[index]
        wrappers = (mk.build_frames, mk.track_block, mk.track_block_fused)
        before = [(w, a, getattr(w, a)) for w in wrappers for a in self.COUNTERS
                  if hasattr(w, a)]
        self.stream = torch.cuda.current_stream(index)
        self.graph = torch.cuda.CUDAGraph()
        self.pool.side.wait_stream(self.stream)
        with torch.cuda.device(index), torch.cuda.stream(self.pool.side):
            self.graph.capture_begin(pool=self.pool.id, capture_error_mode="thread_local")
            try:
                step()
            finally:
                self.graph.capture_end()
        self.counts = [(w, a, getattr(w, a) - n) for w, a, n in before if getattr(w, a) != n]
        for w, a, n in self.counts:
            setattr(w, a, getattr(w, a) - n)
        if self.pool.last is not None:     # the pool's last graph may still run elsewhere
            self.stream.wait_event(self.pool.last)

    def replay(self) -> None:
        self.graph.replay()
        for w, a, n in self.counts:
            setattr(w, a, getattr(w, a) + n)

    def done(self) -> None:
        """Mark the pool's memory free once the replays issued so far end."""
        self.pool.last = torch.cuda.Event()
        self.pool.last.record(self.stream)


def track_segments(config: ReceiverConfig, words, state: TrackState, code_pads,
                  carr_basis, active, n_ms: int, start_ms: int,
                  build, block):
    """Run ``n_ms`` ms as lead / full / tail segments on the absolute ms
    grid, each one ``build`` (frames) + ``block`` (tracker) call pair —
    megakernel.build_frames / track_block in :func:`track`, or their plain
    versions when a check holds the kernels against them.  ``build=None``:
    ``block`` is a fused tracker (megakernel.track_block_fused or its plain
    version) that takes the word view and the (C,) frame word offsets in
    place of frames and frame starts.  ``words``: the capture's int32 word
    view (:func:`capture_words`).

    Every segment runs one step on the state stacked as B1 reads it
    (:class:`Stack`), kept in buffers made before the first segment.  On
    CUDA tensors with the main path's kernel wrappers (``block`` may carry
    keyword options) the step launches their stacked entries
    (:func:`_kernel_entry`); anything else (CPU tensors, the plain
    versions) runs through ``block`` itself.  A full block's step writes
    its outputs at a block counter kept on the device.  Where the kernel
    wrappers run at least two full blocks, the first runs eagerly, the step
    is captured once in a CUDA graph (:class:`_BlockGraph`) and every other
    full block is a replay of it; the graph is dropped at the end of the
    call, and nothing returned lies in its memory.
    Returns (final_state, MsOutputs of (n_ms, C) leaves, (C,) overflow).
    ``track_segments.calls`` counts calls, ``.segments`` the segments they
    issued (lead, full and tail) and ``.graph_blocks`` the full blocks
    issued by graph replays; the loop is the ``track.loop`` span
    (profiling.trace) and a capture the ``track.capture`` span inside it."""
    spc_w = config.samples_per_code // 4
    win_w = config.track_window // 4
    pre = config.track_frame_pre
    B = max(1, config.track_block_ms)
    phase = start_ms % B
    lead = min(B - phase, n_ms) if phase else 0
    n_full = (n_ms - lead) // B
    r_tail = n_ms - lead - n_full * B
    dev, c = words.device, state.ptr.shape[0]

    block_base = state.block_base.clone()     # the frame anchor of the segment in progress
    s_in, s_out = stack_state(state, new_stack(c, dev)), new_stack(c, dev)
    entry = _kernel_entry(build, block) if dev.type == "cuda" else None
    graphed = entry is not None and n_full >= 2
    entry = entry or _through(block, block_base)
    ys = new_block_out(n_ms, c, dev)          # ys.ovf: the largest overflow so far
    ys.ovf.zero_()

    def segment(p0: int, r: int, out: BlockOut):
        # frame (j, c) starts at word base//4 + (p0+j)*spc/4: a function of
        # the absolute ms, so a resumed run rebuilds the same frames
        start_w = torch.div(block_base, 4, rounding_mode="floor")
        if p0:
            start_w = start_w + p0 * spc_w
        # inactive channels' pointers freeze: keep their (never read)
        # frames on an active channel's span
        any_act = torch.where(active, start_w, 0).max()
        start_w = torch.where(active, start_w, any_act)
        if build is None:
            entry(words, start_w, s_in, s_out, out, code_pads, carr_basis, active, config, r)
        else:
            entry(build(words, start_w, r, win_w, spc_w), 4 * start_w, s_in, s_out, out,
                  code_pads, carr_basis, active, config, r)
        s_in.flat.copy_(s_out.flat)
        torch.maximum(ys.ovf, out.ovf, out=ys.ovf)

    def place(out: BlockOut, at: int, r: int):
        ys.abs_sample[at:at + r].copy_(out.abs_sample)
        ys.of64[:, at:at + r].copy_(out.of64)
        ys.of32[:, at:at + r].copy_(out.of32)

    track_segments.calls += 1
    track_segments.segments += (lead > 0) + n_full + (r_tail > 0)
    with trace("track.loop"):
        if lead:     # finish the grid block a resumed run stopped in
            out = new_block_out(lead, c, dev)
            segment(phase, lead, out)
            place(out, 0, lead)
        if n_full:
            blk = new_block_out(B, c, dev)
            hist, (h_abs, h64, h32) = _packed(_out_parts(B, c), (n_full,), dev)
            k = torch.zeros(1, dtype=torch.int64, device=dev)

            def full_block():
                torch.sub(s_in.si[0], pre, out=block_base)
                segment(0, B, blk)
                hist.index_copy_(0, k, blk.flat[None])
                k.add_(1)

            full_block()          # eagerly: it also warms every path a capture records
            step = full_block
            if graphed:
                with trace("track.capture"):
                    graph = _BlockGraph(full_block, dev)
                step = graph.replay
            for _ in range(n_full - 1):
                step()
            if graphed:
                graph.done()
                track_segments.graph_blocks += n_full - 1
                del graph, step
            rows = slice(lead, lead + n_full * B)
            ys.abs_sample[rows].view(n_full, B, c).copy_(h_abs)
            ys.of64[:, rows].view(len(OUT_F64), n_full, B, c).copy_(h64.transpose(0, 1))
            ys.of32[:, rows].view(len(OUT_F32), n_full, B, c).copy_(h32.transpose(0, 1))
        if r_tail:
            torch.sub(s_in.si[0], pre, out=block_base)
            out = new_block_out(r_tail, c, dev)
            segment(0, r_tail, out)
            place(out, n_ms - r_tail, r_tail)
    return (unstack_state(s_in, block_base), ms_outputs(ys.abs_sample, ys.of64, ys.of32),
            ys.ovf)


track_segments.calls = 0
track_segments.segments = 0
track_segments.graph_blocks = 0


def track_ms(config: ReceiverConfig, signal, state: TrackState, code_pads, carr_basis,
             active, n_ms: int, start_ms: int, correlate):
    """Run ``n_ms`` ms one millisecond at a time: the NCO steps and the exact
    block length ``blk = ceil((1023*2^40 - rem)/step)`` in torch, the six
    sums from ``correlate`` (pallas_kernel.correlate_ms in :func:`track`, or
    its plain version when a check holds the kernel against it) over
    capture samples ``[ptr, ptr + blk)``, then the float64 loop filters
    (softgnss_tpu.track.scan._frame_ms_pallas without the packed frame).
    ``block_base`` is re-anchored on the absolute ``track_block_ms`` grid as
    the block tracker does, so a final state resumes on either tracker.
    Returns (final_state, MsOutputs of (n_ms, C) leaves)."""
    fs = config.sampling_freq
    code_len_q = config.code_length * CODE_ONE
    B = max(1, config.track_block_ms)
    st = state
    outs = []
    for j in range(n_ms):
        if (start_ms + j) % B == 0:
            st = st._replace(block_base=st.ptr - config.track_frame_pre)
        step_q = code_step_q(st.code_freq, fs)
        blk = torch.div(code_len_q - st.code_rem_q + step_q - 1, step_q,
                        rounding_mode="floor")
        w = carrier_step_u32(st.carr_freq, fs)
        corr = correlate(config, signal, st.ptr, st.carr_phase, w, st.code_rem_q, step_q,
                         blk, code_pads, active)
        st, out = _filters_and_outputs(config, carr_basis, active, st, step_q, blk, w,
                                       corr.unbind(1))
        outs.append(out)
    return st, MsOutputs(*[torch.stack(leaf) for leaf in zip(*outs)])


def track(config: ReceiverConfig, signal, channels: Channels,
          n_ms: int | None = None, state: TrackState | None = None,
          device=None) -> TrackResults:
    """Track all channels over ``n_ms`` milliseconds of the capture with the
    tracker ``config.tracker`` selects, on ``device``: by default the
    device a tensor lies on, and the card for a NumPy capture (raising
    without one); a CPU tensor or ``device="cpu"`` runs on the host.

    ``signal`` is the full raw int8 capture, *including* any skipped
    prefix — channel pointers are absolute sample indices
    (reference: tracking.py:107,255).  ``state``: a previous run's
    ``final_state`` (tensors on any device, or NumPy via
    convert.track_state_from_numpy) to resume from, on either tracker."""
    signal = place(signal, device)
    dev = signal.device
    spc = config.samples_per_code
    n_ms = int(config.ms_to_process if n_ms is None else n_ms)
    if n_ms <= 0:
        raise ValueError(f"n_ms must be positive, got {n_ms}")
    # anchor the length check at the resume pointer, not the capture start
    start = (config.skip_samples if state is None else int(state.ptr.max()))
    needed = start + (n_ms + 2) * spc
    if signal.shape[0] < needed:
        raise ValueError(
            f"capture too short for tracking: need >= {needed} samples, got {signal.shape[0]}"
        )

    tables = channel_tables(channels, dev)
    if state is None:
        state = initial_state(config, channels, dev)
        start_ms = 0
    else:
        state = TrackState(*[torch.as_tensor(v).to(dev) for v in state])
        start_ms = int(state.ms.max())
    final, ys, ovf = track_on_device(config, signal, tables, state, n_ms, start_ms)
    with trace("track.wait"):           # the first sync: the queued blocks drain
        _check_overflow(ovf)
    with trace("track.to_host"):
        host = {f: getattr(ys, f).cpu().numpy().T for f in MsOutputs._fields}
    return TrackResults(final_state=final, prn=np.asarray(channels.prn),
                        status=list(channels.status), **host)


def channel_tables(channels: Channels, device):
    """(code_pads, carr_basis, active) of ``channels`` on ``device``: the
    padded codes, the acquired carrier frequencies and the active mask."""
    return (build_tables(np.asarray(channels.prn), device),
            torch.as_tensor(np.asarray(channels.acquired_freq, np.float64)).to(device),
            torch.tensor([s == "T" for s in channels.status], device=device))


def track_on_device(config: ReceiverConfig, signal: torch.Tensor, tables, state: TrackState,
                    n_ms: int, start_ms: int):
    """``n_ms`` ms from ``state`` at absolute ms ``start_ms`` (the largest
    ``state.ms``, which places the block grid) on the device ``signal``
    lies on, with the tracker ``config.tracker`` selects, without waiting
    for the device: returns (final state,
    MsOutputs of (n_ms, C) device tensors, (C,) overflow: > 0 where a frame
    failed to hold its ms).  ``tables``: :func:`channel_tables`.
    :func:`track` and the streamed tracker (parallel.stream) run this."""
    from softgnss_tpu_torch.track import megakernel as mk
    from softgnss_tpu_torch.track.pallas_kernel import correlate_ms

    code_pads, carr_basis, active = tables
    if config.tracker == "per_ms":
        final, ys = track_ms(config, signal, state, code_pads, carr_basis, active, n_ms,
                             start_ms, correlate_ms)
        return final, ys, torch.zeros_like(final.ptr)
    build, block = ((None, mk.track_block_fused) if config.mega_fused_frames
                    else (mk.build_frames, mk.track_block))
    return track_segments(config, capture_words(signal), state, code_pads, carr_basis, active,
                          n_ms, start_ms, build, block)
