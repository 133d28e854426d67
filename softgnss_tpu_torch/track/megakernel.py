"""The block tracker's kernels: B2 (frames builder), B1 (block tracker)
and B3 (B1 reading the capture itself).

For each ``track_block_ms`` block, ``scan.track`` gathers every channel's
per-ms sample windows with :func:`build_frames` and then runs the block's
milliseconds of DLL/PLL tracking, loop filters included, in one
:func:`track_block` launch; with ``config.mega_fused_frames`` one
:func:`track_block_fused` launch does both.  B1 and B3 run one
thread-block cluster of ``ctas_per_channel`` CTAs per channel, each CTA
on its slice of every ms window (:func:`rank_slices`); the size is the
largest up to :data:`CTAS_PER_CHANNEL` at which every cluster has SMs of
its own (:func:`choose_ctas_per_channel`), and a ``ctas_per_channel=``
keyword forces one.  They port
softgnss_tpu.track.megakernel's ``_builder_kernel`` and ``_kernel``
(unfused and fused, with ``mega_track_segment`` / ``mega_finalize``):
what those compute, not their Mosaic layout.  The CUDA C++ sources are
``softgnss_tpu_torch/csrc/build_frames.cu`` and ``track_block.cu``; each
opens with the TPU kernel it replaces, what bounds it on the H100 and its
design.

Each wrapper runs its kernel for CUDA tensors and its plain PyTorch
version (``*_plain``, same module) for CPU tensors, and for nothing else:
a CUDA tensor either launches the kernel or raises.  B1 and B3 also have
an entry on the stacked state (:func:`track_block_stacked`,
:func:`track_block_fused_stacked`: CUDA tensors only, into buffers the
caller made), which the block loop issues and captures in a CUDA graph.
``wrapper.launches`` counts kernel launches, a graph's replays included;
B1's and B3's ``short_launches`` and ``general_launches`` split them by the
path their sample loop takes to the E/P/L chips (:data:`HALF_CHIP_Q`).
The kernels live in the receiver's library (``cuda_lib.RECEIVER``, built
at first use); each C entry is declared once, beside its wrapper.
"""

from __future__ import annotations

import ctypes
import functools
import math
import warnings
from typing import NamedTuple

import torch

from softgnss_tpu_torch.config import ReceiverConfig
from softgnss_tpu_torch.signals.nco import (
    CODE_ONE,
    carrier_step_u32,
    carrier_turns,
    chips_to_q,
    code_step_q,
    sin_turns,
)
from softgnss_tpu_torch.track import cuda_lib
from softgnss_tpu_torch.track.cuda_lib import SMS, sm_count
from softgnss_tpu_torch.track.scan import (
    _F32_FIELDS,
    OUT_F32,
    OUT_F64,
    STATE_F64,
    STATE_I64,
    BlockOut,
    MsOutputs,
    Stack,
    TrackState,
    _correlate_gather,
    _filters_and_outputs,
    ms_outputs,
    unstack_state,
)
_vp, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

# --- B2: frames builder ----------------------------------------------------

#: the bulk design's plan at the reference front end, 8 channels
#: (:func:`frames_plan`): about FRAMES_CTAS_PER_SM CTAs per SM over a
#: 64-ms block, each staging the hull of its columns once for every
#: channel (FRAMES_UNION) by bulk copies of about FRAMES_PART_W words,
#: FRAMES_THREADS threads per CTA; chosen by ``scripts.builder_time``'s plan
#: sweep (PERF.md section 6)
FRAMES_CTAS_PER_SM = 1
FRAMES_PART_W = 1024
FRAMES_THREADS = 256
FRAMES_UNION = True
#: dynamic shared memory a CTA can use on an H100 (csrc/build_frames.cu
#: kMaxSmem), and the bulk copies (mbarriers) of one hull (kMaxParts)
MAX_SMEM = 232_448
MAX_PARTS = 16
MAX_THREADS = 1024
#: the narrowest column group a plan makes (words), and the most ms a launch
#: takes (the grid's second dimension)
MIN_GROUP_W = 1024
MAX_R = 65_535
#: device name of B2's kernel as a profiler shows it (with its template
#: arguments): match a kernel event by :func:`is_frames_kernel`
FRAMES_KERNEL = "build_frames_bulk_kernel"


def is_frames_kernel(name: str) -> bool:
    """Whether a profiler's kernel name is B2's kernel."""
    return FRAMES_KERNEL in name


class FramesPlan(NamedTuple):
    """A launch of the bulk design: one CTA of ``threads`` threads per ms and
    column group of ``group_w`` words (``groups`` of them) with a staging
    buffer of ``buf_w`` words in ``smem_bytes`` of dynamic shared memory;
    ``union``: the hull of the channels' source words for the group staged
    once when it fits the buffer, by bulk copies of about ``part_w`` words
    (else each channel's columns on their own)."""
    union: bool
    groups: int
    group_w: int
    buf_w: int
    part_w: int
    threads: int
    smem_bytes: int


def frames_smem(n_ch: int, buf_w: int) -> int:
    """Dynamic shared memory of a launch (csrc/build_frames.cu bulk_smem):
    the staging buffer, MAX_PARTS mbarriers and the starts."""
    return 4 * buf_w + 8 * MAX_PARTS + 8 * n_ch


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def frames_plan(r: int, n_ch: int, win_w: int, spc_w: int, *, union: bool = FRAMES_UNION,
                ctas_per_sm: float = FRAMES_CTAS_PER_SM, part_w: int = FRAMES_PART_W,
                threads: int = FRAMES_THREADS, spread_w: int | None = None,
                n_sm: int = SMS) -> FramesPlan:
    """The launch plan of B2's bulk design for ``r`` ms of ``n_ch`` frames
    of ``win_w`` words, ``spc_w`` words per ms, on a card of ``n_sm`` SMs:
    the window cut into column groups (multiples of 4 words, at least
    MIN_GROUP_W unless the window is narrower) so that the ``r`` x groups
    CTAs make ``ctas_per_sm`` per SM as near as whole groups allow.  With
    ``union`` the buffer holds a group's hull for starts up to
    ``spread_w`` words apart (default a code period and a quarter: the
    channels' code phases lie within one, and a quarter more leaves room
    for their drift apart), else each channel's columns of a group side by
    side; either is cut to what a CTA's shared memory holds, one channel's
    columns at least (a wider hull then takes the channels in rounds).
    Raises ValueError for an empty shape, more than MAX_R ms, threads not a
    multiple of 32 up to 1024, parts under 16 words, or a group whose
    columns do not fit a CTA's shared memory."""
    r, n_ch, win_w, spc_w, part_w, threads = map(int, (r, n_ch, win_w, spc_w, part_w, threads))
    if r <= 0 or n_ch <= 0 or win_w <= 0:
        raise ValueError(f"build_frames: empty shape r={r}, C={n_ch}, win_w={win_w}")
    if r > MAX_R:
        raise ValueError(f"build_frames: r={r} ms in one launch, at most {MAX_R}")
    if part_w < 16:
        raise ValueError(f"build_frames: part_w={part_w}: at least 16 words")
    if threads % 32 or not 32 <= threads <= MAX_THREADS:
        raise ValueError(f"build_frames: threads={threads}: a multiple of 32 up to "
                         f"{MAX_THREADS}")
    if not ctas_per_sm > 0 or n_sm < 1:
        raise ValueError(f"build_frames: ctas_per_sm={ctas_per_sm}, n_sm={n_sm}")
    widest = max(1, win_w // MIN_GROUP_W)
    want = min(max(1, round(ctas_per_sm * n_sm / r)), widest)
    group_w = _round4(-(-win_w // want))
    stride = _round4(min(group_w, win_w) + 8)
    room = (MAX_SMEM - frames_smem(n_ch, 0)) // 16 * 4
    if room < stride:
        raise ValueError(f"build_frames: {frames_smem(n_ch, stride)} B of shared memory for "
                         f"{n_ch} channels and {group_w}-word groups: past the {MAX_SMEM} B a "
                         "CTA has")
    spread = spc_w + spc_w // 4 if spread_w is None else int(spread_w)
    buf_w = _round4(spread + group_w + 8) if union else n_ch * stride
    buf_w = max(min(buf_w, room), stride)
    return FramesPlan(bool(union), -(-win_w // group_w), group_w, buf_w, part_w, threads,
                      frames_smem(n_ch, buf_w))


class FramesWrite(NamedTuple):
    """Frame (j, ``d``)'s columns [g_lo, g_hi) as a CTA writes them in step
    ``step``, from the span [v0, v1) of source words staged at buffer word
    ``off`` + ``lead``: ``head`` words one by one up to the first 16-byte
    aligned destination word, ``n4`` int4s built at shift ``sh``, then the
    ``tail`` words one by one."""
    step: int
    d: int
    v0: int
    v1: int
    lead: int
    off: int
    head: int
    n4: int
    tail: int
    sh: int


class FramesCopy(NamedTuple):
    """One bulk copy of a CTA: ``bytes`` from capture word ``copy_w`` (a
    16-byte boundary: up to 3 words before the capture, its end up to 3
    past it) into buffer word ``off``, landed before the writes of step
    ``step`` (the round's; a hull has one step)."""
    step: int
    off: int
    copy_w: int
    bytes: int


class FramesUnit(NamedTuple):
    """CTA (g, j) of the bulk design: columns [g_lo, g_hi) of ms ``j``'s
    frames; ``hull``: the channels' hull staged once (else channel by
    channel in rounds); its copies and writes."""
    j: int
    g: int
    g_lo: int
    g_hi: int
    hull: bool
    copies: tuple
    writes: tuple


def _span(cap_lead: int, n_words: int, lo: int, hi: int) -> tuple:
    """(v0, v1, lead, copy_w, bytes) of source words [lo, hi)
    (csrc/build_frames.cu span_of)."""
    v0 = max(lo, 0)
    v1 = max(min(hi, n_words), v0)
    if v1 == v0:
        return v0, v1, 0, 0, 0
    lead = (cap_lead + v0) % 4
    return v0, v1, lead, v0 - lead, 4 * (_round4(cap_lead + v1) - cap_lead - (v0 - lead))


def _write(step: int, d: int, span: tuple, off: int, dst0: int, sd: int, g_lo: int,
           g_hi: int) -> FramesWrite:
    """csrc/build_frames.cu write_cols."""
    length = g_hi - g_lo
    head = min((4 - (dst0 + g_lo) % 4) % 4, length)
    n4 = (length - head) // 4
    return FramesWrite(step, d, *span[:3], off, head, n4, length - head - 4 * n4,
                       (sd + g_lo + head - span[0] + span[2]) % 4)


def frames_walk(plan: FramesPlan, starts, n_words: int, cap_lead: int, r: int, win_w: int,
                spc_w: int) -> list[FramesUnit]:
    """Every CTA of one launch of the bulk design, as the kernel computes
    them on the card from ``starts`` (C word offsets of ms 0) over a
    capture of ``n_words`` words whose first word lies ``cap_lead`` words
    (0-3) past a 16-byte boundary: csrc/build_frames.cu
    ``build_frames_bulk_kernel``, ``span_of`` and ``write_cols`` line for
    line, in Python integers.  The wrapper never calls it (the starts stay
    on the card); the CPU tests replay it against
    :func:`build_frames_plain`."""
    st = [int(s) for s in starts]
    n_ch = len(st)
    units = []
    for j in range(r):
        base = j * spc_w
        for g in range(plan.groups):
            g_lo, g_hi = g * plan.group_w, min((g + 1) * plan.group_w, win_w)
            h_lo, h_hi = min(st) + base + g_lo, max(st) + base + g_hi
            copies, writes = [], []
            hull = plan.union and h_hi - h_lo + 8 <= plan.buf_w
            if hull:
                span = _span(cap_lead, n_words, h_lo, h_hi)
                parts = max(1, min(-(-span[4] // 4 // plan.part_w), MAX_PARTS))
                pb = -(-(span[4] // parts) // 16) * 16
                for k in range(parts):
                    n_b = max(min(pb, span[4] - k * pb), 0)
                    if n_b:
                        copies.append(FramesCopy(0, k * pb // 4, span[3] + k * pb // 4, n_b))
                writes = [_write(0, d, span, 0, (j * n_ch + d) * win_w, st[d] + base, g_lo, g_hi)
                          for d in range(n_ch)]
            else:
                stride = _round4(g_hi - g_lo + 8)
                per_round = plan.buf_w // stride
                for rnd, c0 in enumerate(range(0, n_ch, per_round)):
                    for c in range(c0, min(c0 + per_round, n_ch)):
                        span = _span(cap_lead, n_words, st[c] + base + g_lo, st[c] + base + g_hi)
                        if span[4]:
                            copies.append(FramesCopy(rnd, (c - c0) * stride, span[3], span[4]))
                        writes.append(_write(rnd, c, span, (c - c0) * stride,
                                             (j * n_ch + c) * win_w, st[c] + base, g_lo, g_hi))
            units.append(FramesUnit(j, g, g_lo, g_hi, hull, tuple(copies), tuple(writes)))
    return units


def build_frames_plain(cap_words: torch.Tensor, starts_w: torch.Tensor, r: int,
                       win_w: int, spc_w: int) -> torch.Tensor:
    """frames[j, c, i] = cap_words[starts_w[c] + j*spc_w + i] (i < win_w),
    0 outside the capture: (r, C, win_w) int32."""
    dev = cap_words.device
    idx = (starts_w[None, :, None]
           + torch.arange(r, device=dev)[:, None, None] * spc_w
           + torch.arange(win_w, device=dev)[None, None, :])
    inside = (idx >= 0) & (idx < cap_words.shape[0])
    return torch.where(inside, cap_words[idx.clamp(0, cap_words.shape[0] - 1)], 0)


_BUILD_FRAMES_BULK = cuda_lib.RECEIVER.entry(
    "sg_build_frames_bulk", [_vp, _ll, _vp, _vp, _i, _i, _i, _ll] + [_i] * 6 + [_vp])


def build_frames(cap_words: torch.Tensor, starts_w: torch.Tensor, r: int,
                 win_w: int, spc_w: int, *, plan: FramesPlan | None = None) -> torch.Tensor:
    """Per-ms frames of every channel, (r, C, win_w) int32 (see
    :func:`build_frames_plain`).  ``cap_words``: (L,) int32 little-endian
    word view of the int8 capture (4-byte aligned; any 16-byte lead);
    ``starts_w``: (C,) int64 word offsets of millisecond 0.  Kernel B2's
    bulk design (csrc/build_frames.cu ``build_frames_bulk_kernel``) on
    CUDA tensors, at ``plan`` (default :func:`frames_plan` at the card's SM
    count); ``plan`` is ignored for CPU tensors."""
    if cap_words.device.type == "cpu":
        return build_frames_plain(cap_words, starts_w, r, win_w, spc_w)
    dev = cap_words.device
    if plan is None:
        plan = frames_plan(r, starts_w.shape[0], win_w, spc_w,
                           n_sm=sm_count(dev.index if dev.index is not None
                                         else torch.cuda.current_device()))
    frames = launch_frames("build_frames", _BUILD_FRAMES_BULK.function(), cap_words, starts_w,
                           r, win_w, spc_w, int(plan.union), plan.group_w, plan.buf_w,
                           plan.part_w, plan.threads, plan.smem_bytes)
    build_frames.launches += 1
    return frames


build_frames.launches = 0


def ragged_rows(base: int, rows: int, win_w: int) -> int:
    """Of ``rows`` frames of ``win_w`` words laid end to end from byte
    address ``base``, how many start or end off a 16-byte line.  B2
    writes such a frame's words before its first and after its last line
    edge one by one (the scalar head and tail of ``write_cols``), and B1
    stages its windows through the lines it shares with its neighbours
    (``span_of``'s offset and rounded end).  None where the window is
    whole int4s on an aligned buffer (38 192 samples a ms: 9 580 words);
    every frame at 4 110 words (16 367.6 samples a ms)."""
    row = 4 * win_w
    return sum((base + k * row) % 16 != 0 or (base + (k + 1) * row) % 16 != 0
               for k in range(rows))


def launch_frames(name: str, entry, cap_words, starts_w, r: int, win_w: int,
                  spc_w: int, *plan) -> torch.Tensor:
    """Check the inputs of :func:`build_frames`, allocate the frames and
    call ``entry`` (a C entry point that takes (capture, its words, starts,
    frames, r, C, win_w, spc_w), then ``plan``'s integers, then the
    stream) on the current stream."""
    dev = cap_words.device
    c = starts_w.shape[0]
    cuda_lib.require(cap_words, "cap_words", torch.int32, (cap_words.shape[0],), dev)
    cuda_lib.require(starts_w, "starts_w", torch.int64, (c,), dev)
    frames = torch.empty((r, c, win_w), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = entry(cuda_lib.ptr(cap_words), cap_words.shape[0], cuda_lib.ptr(starts_w),
                   cuda_lib.ptr(frames), r, c, win_w, spc_w, *plan, cuda_lib.stream(dev))
    cuda_lib.check(rc, name)
    return frames


# --- B1: block tracker -----------------------------------------------------


def overflow(o, blk, win: int, active):
    """>0 where the true span [o, o+blk) leaves the frame (active channels)."""
    bad = torch.maximum(-o, o + blk - win)
    return torch.where(active, bad.clamp(min=0), 0)


def track_block_plain(frames, fb0, state: TrackState, code_pads, carr_basis,
                      active, config: ReceiverConfig, r: int):
    """``r`` ms of tracking for all channels, one millisecond at a time:
    the gather correlator of softgnss_tpu.track.scan._frame_ms over each
    frame, then the float64 loop filters.  Returns (state, MsOutputs of
    (r, C) leaves, (C,) int64 overflow)."""
    dev = frames.device
    fs = config.sampling_freq
    spc = config.samples_per_code
    win = frames.shape[2] * 4
    code_len_q = config.code_length * CODE_ONE
    samples = frames.view(torch.int8)                     # (r, C, win)
    k = torch.arange(win, dtype=torch.int64, device=dev)
    st = state
    ovf = torch.zeros_like(fb0)
    outs = []
    for j in range(r):
        step_q = code_step_q(st.code_freq, fs)
        blk = torch.div(code_len_q - st.code_rem_q + step_q - 1, step_q,
                        rounding_mode="floor")
        o = st.ptr - (fb0 + j * spc)
        ovf = torch.maximum(ovf, overflow(o, blk, win, active))
        mask = (k >= o[:, None]) & (k < (o + blk)[:, None])
        raw = torch.where(mask, samples[j].to(torch.float32), 0.0)

        w = carrier_step_u32(st.carr_freq, fs)
        turns = carrier_turns((st.carr_phase.to(torch.int64) - w.to(torch.int64) * o)[:, None],
                              w[:, None], k)
        i_bb = sin_turns(turns) * raw
        q_bb = sin_turns(turns + 0.25) * raw

        tq = (st.code_rem_q - step_q * o)[:, None] + step_q[:, None] * k
        corr = _correlate_gather(config, code_pads, tq, i_bb, q_bb)
        st, out = _filters_and_outputs(config, carr_basis, active, st, step_q,
                                       blk, w, corr)
        outs.append(out)
    ys = MsOutputs(*[torch.stack(leaf) for leaf in zip(*outs)])
    return st, ys, ovf


#: CTAs per channel of B1 and B3: the largest cluster size the wrapper
#: takes (see :func:`choose_ctas_per_channel`), and threads per CTA.  From
#: the size-by-threads sweep at both benchmark front ends on an NVIDIA H100
#: 80GB HBM3 at 700 W (PERF.md section 6): with each cluster on SMs of its
#: own, 16 x 256 is fastest (ref38, 7 channels: 2.93 us per ms, against
#: 3.71 at 8 x 256); at 8 channels only 7 clusters of 16 get SMs of their
#: own, and 8 x 256 (3.71) beats 16 x 256 (3.91), 384 and 512 threads
#: losing at both sizes.  An H100 holds 14 clusters of 16 such CTAs at
#: once, 7 with no two sharing an SM.
CTAS_PER_CHANNEL = 16
THREADS_PER_CTA = 256
#: the cluster sizes the kernels are built for (16 is a non-portable size)
CLUSTER_SIZES = (1, 2, 4, 8, 16)


def rank_chunk(win: int, kn: int) -> int:
    """Window bytes each of ``kn`` ranks owns: ``win / kn`` rounded up to
    16 bytes, so that every slice but the last starts and ends on a
    16-byte edge of the window."""
    return -(-win // (16 * kn)) * 16


def rank_slices(win: int, kn: int) -> list[tuple[int, int]]:
    """[lo, hi) of the window that each rank 0 .. kn-1 of a channel's
    cluster sums (csrc/track_block.cu): consecutive, together exactly
    [0, win); a trailing rank may get an empty slice."""
    chunk = rank_chunk(win, kn)
    return [(min(q * chunk, win), min((q + 1) * chunk, win)) for q in range(kn)]


def choose_ctas_per_channel(n_ch: int, max_clusters, preferred: int = CTAS_PER_CHANNEL,
                            alone=None) -> int:
    """The cluster size for ``n_ch`` channels: the largest size up to
    ``preferred`` whose ``n_ch`` clusters each get SMs of their own at once
    (``alone(kn)`` >= ``n_ch``: the clusters that fit at one CTA per SM);
    else (or without ``alone``) ``preferred`` when all ``n_ch`` clusters of
    it fit at once (``max_clusters(kn)`` >= ``n_ch``; some may then share
    SMs), else the next smaller size that fits, with a warning naming both.
    A cluster sharing its SMs runs its sample loop on half their issue
    slots, and the launch waits for it (at 8 channels of 16 CTAs, the two
    clusters on 16 shared SMs took 23-37 % longer than the six alone).  It
    never steps down to one CTA per channel: when no cluster fits it
    raises, and ``ctas_per_channel=1`` is the caller's explicit choice."""
    if preferred not in CLUSTER_SIZES:
        raise ValueError(f"preferred={preferred}: cluster sizes are {CLUSTER_SIZES}")
    if preferred == 1:
        return 1
    sizes = sorted((k for k in CLUSTER_SIZES if 1 < k <= preferred), reverse=True)
    if alone is not None:
        for kn in sizes:
            if alone(kn) >= n_ch:
                return kn
    for kn in sizes:
        if max_clusters(kn) >= n_ch:
            if kn != preferred:
                warnings.warn(f"B1/B3: {n_ch} clusters of {preferred} CTAs do not fit on the "
                              f"card at once; launching {kn} CTAs per channel", stacklevel=3)
            return kn
    raise RuntimeError(f"B1/B3: {n_ch} channels do not fit on the card as clusters of 2 or "
                       "more CTAs; pass ctas_per_channel=1 to run one CTA per channel")


_MAX_CLUSTERS = cuda_lib.RECEIVER.entry("sg_track_block_max_clusters",
                                        [_i] * 5 + [ctypes.POINTER(_i)])


@functools.cache
def max_active_clusters(device_index: int, fused: bool, kn: int, threads: int, chunk: int,
                        alone: bool = False) -> int:
    """How many clusters of ``kn`` CTAs of B1 (or B3) the card holds at
    once (cudaOccupancyMaxActiveClusters), with ``alone`` how many with no
    two sharing an SM (one CTA per SM); queried once per size."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = _MAX_CLUSTERS(int(fused), kn, threads, chunk, int(alone), ctypes.byref(out))
    cuda_lib.check(rc, "track_block occupancy query")
    return out.value


def check_launch_size(ctas_per_channel, threads_per_cta) -> None:
    """Raise ValueError on a forced cluster size or CTA width B1 and B3
    are not built for."""
    if ctas_per_channel is not None and ctas_per_channel not in CLUSTER_SIZES:
        raise ValueError(f"ctas_per_channel={ctas_per_channel}: expected one of {CLUSTER_SIZES}")
    if threads_per_cta is not None and (threads_per_cta not in range(32, 513, 32)):
        raise ValueError(f"threads_per_cta={threads_per_cta}: a multiple of 32 up to 512")


def launch_size(dev, fused: bool, n_ch: int, win: int, ctas_per_channel=None,
                threads_per_cta=None) -> tuple[int, int]:
    """(CTAs per channel, threads per CTA) of a B1 (or B3) launch on
    ``dev``: the forced values, else :func:`choose_ctas_per_channel` of the
    card's occupancy and :data:`THREADS_PER_CTA`."""
    check_launch_size(ctas_per_channel, threads_per_cta)
    threads = threads_per_cta or THREADS_PER_CTA
    if ctas_per_channel is not None:
        return ctas_per_channel, threads
    index = dev.index if dev.index is not None else torch.cuda.current_device()

    def fits(alone: bool):
        return lambda k: max_active_clusters(index, fused, k, threads, rank_chunk(win, k), alone)

    return choose_ctas_per_channel(n_ch, fits(False), alone=fits(True)), threads


def _kernel_params(config: ReceiverConfig, r: int, c: int, win: int, kn: int):
    tau1c, tau2c = config.pll_taus
    tau1d, tau2d = config.dll_taus
    pdi = config.pdi_s
    hf = (ctypes.c_double * 10)(
        config.sampling_freq, config.code_freq_basis, config.intermediate_freq,
        tau2c / tau1c, pdi / tau1c, tau2d / tau1d, pdi / tau1d,
        (4.0 * config.fll_bandwidth_hz) * pdi, 2.0 * math.pi * pdi,
        config.code_freq_basis / config.l1_freq)
    hi = (ctypes.c_longlong * 10)(
        config.code_length * CODE_ONE, chips_to_q(config.dll_correlator_spacing),
        config.pdi_ms, int(config.fll_bandwidth_hz > 0),
        int(config.carrier_aided_dll), config.samples_per_code, win, r, c,
        rank_chunk(win, kn))
    return hf, hi


#: the arguments of B1's and B3's C entries after their source's (frames;
#: or capture, its words and frame starts) up to the stream:
#: :func:`launch_stacked`'s
BLOCK_ARGS = [_vp] * 14 + [_i, _i, ctypes.POINTER(ctypes.c_double),
                           ctypes.POINTER(ctypes.c_longlong), _vp]


def launch_stacked(name: str, launch, dev, fb0, s_in: Stack, s_out: Stack, out: BlockOut,
                    code_pads, carr_basis, active, config: ReceiverConfig, r: int, kn: int,
                    threads: int) -> None:
    """Check the common inputs of B1/B3 and call ``launch`` (the C entry
    point, given the trailing common arguments) at ``kn`` CTAs per channel
    of ``threads`` threads: it reads the stacked state ``s_in`` and writes
    ``s_out`` and ``out``.  Launches only: nothing waits for the card."""
    c = fb0.shape[0]
    require = cuda_lib.require
    require(fb0, "fb0", torch.int64, (c,), dev)
    require(code_pads, "code_pads", torch.float32, (c, 1025), dev)
    require(carr_basis, "carr_basis", torch.float64, (c,), dev)
    require(active, "active", torch.bool, (c,), dev)
    for s, which in ((s_in, "state"), (s_out, "state out")):
        require(s.si, f"{which} (int64 leaves)", torch.int64, (len(STATE_I64), c), dev)
        require(s.sf, f"{which} (float64 leaves)", torch.float64, (len(STATE_F64), c), dev)
        require(s.sa, f"{which} (float32 leaves)", torch.float32, (len(_F32_FIELDS), c), dev)
    require(out.abs_sample, "absolute_sample", torch.int64, (r, c), dev)
    require(out.of64, "float64 outputs", torch.float64, (len(OUT_F64), r, c), dev)
    require(out.of32, "float32 outputs", torch.float32, (len(OUT_F32), r, c), dev)
    require(out.ovf, "overflow", torch.int64, (c,), dev)
    hf, hi = _kernel_params(config, r, c, config.track_window, kn)
    ptr = cuda_lib.ptr
    with torch.cuda.device(dev):
        # a bool tensor is one byte of 0 or 1 per channel: the kernel reads it as is
        rc = launch(ptr(fb0), ptr(code_pads), ptr(carr_basis), ptr(active),
                    ptr(s_in.si), ptr(s_in.sf), ptr(s_in.sa), ptr(s_out.si), ptr(s_out.sf),
                    ptr(s_out.sa), ptr(out.abs_sample), ptr(out.of64), ptr(out.of32),
                    ptr(out.ovf), kn, threads, hf, hi, cuda_lib.stream(dev))
    cuda_lib.check(rc, f"{name} ({kn} CTAs per channel, {threads} threads each)")


def launch_block(name: str, launch, dev, fb0, state: TrackState, code_pads,
                 carr_basis, active, config: ReceiverConfig, r: int, kn: int, threads: int):
    """:func:`launch_stacked` on ``state`` stacked into new buffers;
    returns (state, MsOutputs of (r, C) leaves, (C,) overflow)."""
    c = fb0.shape[0]
    si = torch.stack([getattr(state, f).to(torch.int64) for f in STATE_I64])
    sf = torch.stack([getattr(state, f) for f in STATE_F64])
    sa = torch.stack([getattr(state, f) for f in _F32_FIELDS])
    s_out = Stack(torch.empty_like(si), torch.empty_like(sf), torch.empty_like(sa))
    out = BlockOut(torch.empty((r, c), dtype=torch.int64, device=dev),
                   torch.empty((len(OUT_F64), r, c), dtype=torch.float64, device=dev),
                   torch.empty((len(OUT_F32), r, c), dtype=torch.float32, device=dev),
                   torch.empty(c, dtype=torch.int64, device=dev))
    launch_stacked(name, launch, dev, fb0, Stack(si, sf, sa), s_out, out, code_pads,
                   carr_basis, active, config, r, kn, threads)
    return (unstack_state(s_out, state.block_base),
            ms_outputs(out.abs_sample, out.of64, out.of32), out.ovf)


_TRACK_BLOCK = cuda_lib.RECEIVER.entry("sg_track_block", [_vp] + BLOCK_ARGS)


def _b1_launch(frames, fb0, config: ReceiverConfig, r: int, ctas_per_channel, threads_per_cta):
    """(C entry, CTAs per channel, threads per CTA) of B1 over ``frames``."""
    check_launch_size(ctas_per_channel, threads_per_cta)
    dev = frames.device
    cuda_lib.require(frames, "frames", torch.int32, (r, fb0.shape[0], config.track_window // 4),
                     dev)
    kn, threads = launch_size(dev, False, fb0.shape[0], config.track_window, ctas_per_channel,
                              threads_per_cta)
    fn = _TRACK_BLOCK.function()
    return (lambda *a: fn(cuda_lib.ptr(frames), *a)), kn, threads


#: Q40 of the spacing whose launches take the short path of B1's and B3's
#: sample loop (csrc/track_block.cu): at half a chip E and L are adjacent
#: chips read from one phase word, with no clamp where every chip of a ms
#: lies in the table (every ms of a track from an acquisition); any other
#: spacing takes the general path, three clamped lookups a sample
HALF_CHIP_Q = CODE_ONE // 2


def _counted(wrapper, kn: int, config: ReceiverConfig) -> None:
    wrapper.launches += 1
    wrapper.ctas_per_channel = kn
    if chips_to_q(config.dll_correlator_spacing) == HALF_CHIP_Q:
        wrapper.short_launches += 1
    else:
        wrapper.general_launches += 1


def track_block(frames, fb0, state: TrackState, code_pads, carr_basis, active,
                config: ReceiverConfig, r: int, *, ctas_per_channel: int | None = None,
                threads_per_cta: int | None = None):
    """Track ``r`` ms of every channel over ``frames`` ((r, C, win/4) int32
    from :func:`build_frames`; frame (j, c) starts at absolute sample
    ``fb0[c] + j*samples_per_code``).  Returns (state, MsOutputs of (r, C)
    leaves, (C,) int64 overflow: > 0 where a ms span left its frame).
    Kernel B1 (csrc/track_block.cu) on CUDA tensors, at ``ctas_per_channel``
    CTAs per channel of ``threads_per_cta`` threads (default:
    :func:`launch_size`); ``track_block.ctas_per_channel`` records the size
    last launched."""
    check_launch_size(ctas_per_channel, threads_per_cta)
    if frames.device.type == "cpu":
        return track_block_plain(frames, fb0, state, code_pads, carr_basis,
                                 active, config, r)
    launch, kn, threads = _b1_launch(frames, fb0, config, r, ctas_per_channel, threads_per_cta)
    out = launch_block("track_block", launch, frames.device, fb0, state, code_pads, carr_basis,
                       active, config, r, kn, threads)
    _counted(track_block, kn, config)
    return out


track_block.launches = track_block.short_launches = track_block.general_launches = 0
track_block.ctas_per_channel = None


def track_block_stacked(frames, fb0, s_in: Stack, s_out: Stack, out: BlockOut, code_pads,
                        carr_basis, active, config: ReceiverConfig, r: int, *,
                        ctas_per_channel: int | None = None,
                        threads_per_cta: int | None = None) -> None:
    """:func:`track_block` on the stacked state (CUDA tensors only): B1
    reads ``s_in`` and writes ``s_out`` and ``out`` (scan.Stack,
    scan.BlockOut of ``r`` ms).  It launches and allocates nothing else,
    so a CUDA graph can capture it once B1's size was chosen
    (scan.track_segments runs a block eagerly first); counted on
    ``track_block``."""
    launch, kn, threads = _b1_launch(frames, fb0, config, r, ctas_per_channel, threads_per_cta)
    launch_stacked("track_block", launch, frames.device, fb0, s_in, s_out, out, code_pads,
                   carr_basis, active, config, r, kn, threads)
    _counted(track_block, kn, config)


# --- B3: fused block tracker -----------------------------------------------


def track_block_fused_plain(cap_words, starts_w, state: TrackState, code_pads,
                            carr_basis, active, config: ReceiverConfig, r: int):
    """:func:`build_frames_plain` followed by :func:`track_block_plain`."""
    frames = build_frames_plain(cap_words, starts_w, r, config.track_window // 4,
                                config.samples_per_code // 4)
    return track_block_plain(frames, 4 * starts_w, state, code_pads, carr_basis,
                             active, config, r)


_TRACK_BLOCK_FUSED = cuda_lib.RECEIVER.entry("sg_track_block_fused",
                                              [_vp, _ll, _vp] + BLOCK_ARGS)


def _b3_launch(cap_words, starts_w, config: ReceiverConfig, ctas_per_channel, threads_per_cta):
    """(C entry, CTAs per channel, threads per CTA) of B3 over ``cap_words``."""
    check_launch_size(ctas_per_channel, threads_per_cta)
    dev = cap_words.device
    c = starts_w.shape[0]
    cuda_lib.require(cap_words, "cap_words", torch.int32, (cap_words.shape[0],), dev)
    cuda_lib.require(starts_w, "starts_w", torch.int64, (c,), dev)
    kn, threads = launch_size(dev, True, c, config.track_window, ctas_per_channel,
                              threads_per_cta)
    fn = _TRACK_BLOCK_FUSED.function()
    n_words = cap_words.shape[0]
    return ((lambda *a: fn(cuda_lib.ptr(cap_words), n_words, cuda_lib.ptr(starts_w), *a)),
            kn, threads)


def track_block_fused(cap_words, starts_w, state: TrackState, code_pads, carr_basis,
                      active, config: ReceiverConfig, r: int, *,
                      ctas_per_channel: int | None = None, threads_per_cta: int | None = None):
    """:func:`build_frames` + :func:`track_block` in one kernel: each ms
    window is read from ``cap_words`` ((L,) int32 word view of the capture)
    at word ``starts_w[c] + j*samples_per_code/4`` (0 outside the capture),
    and no frames array exists.  Same returns and keywords as
    :func:`track_block`.  Kernel B3 (csrc/track_block.cu, fused) on CUDA
    tensors."""
    check_launch_size(ctas_per_channel, threads_per_cta)
    if cap_words.device.type == "cpu":
        return track_block_fused_plain(cap_words, starts_w, state, code_pads,
                                       carr_basis, active, config, r)
    launch, kn, threads = _b3_launch(cap_words, starts_w, config, ctas_per_channel,
                                     threads_per_cta)
    out = launch_block("track_block_fused", launch, cap_words.device, 4 * starts_w, state,
                       code_pads, carr_basis, active, config, r, kn, threads)
    _counted(track_block_fused, kn, config)
    return out


track_block_fused.launches = 0
track_block_fused.short_launches = track_block_fused.general_launches = 0
track_block_fused.ctas_per_channel = None


def track_block_fused_stacked(cap_words, starts_w, s_in: Stack, s_out: Stack, out: BlockOut,
                              code_pads, carr_basis, active, config: ReceiverConfig, r: int, *,
                              ctas_per_channel: int | None = None,
                              threads_per_cta: int | None = None) -> None:
    """:func:`track_block_fused` on the stacked state, as
    :func:`track_block_stacked` is :func:`track_block`."""
    launch, kn, threads = _b3_launch(cap_words, starts_w, config, ctas_per_channel,
                                     threads_per_cta)
    launch_stacked("track_block_fused", launch, cap_words.device, 4 * starts_w, s_in, s_out,
                   out, code_pads, carr_basis, active, config, r, kn, threads)
    _counted(track_block_fused, kn, config)
