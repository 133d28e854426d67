"""B4, the per-ms correlator of the per-ms tracker.

:func:`correlate_ms` gives the six E/P/L sums of one millisecond for all
channels; ``scan.track_ms`` computes the NCO steps and the block length
before it and runs the float64 loop filters after it, in torch.  That is
the split of softgnss_tpu.track.pallas_kernel.fused_correlate_ms and
``scan._frame_ms_pallas``; the CUDA source is
``softgnss_tpu_torch/csrc/correlate_ms.cu``: one launch per call, each
channel over several CTAs whose float64 rows the last of them sums, in
CTA order, from a scratch allocated once per device (:func:`scratch`).
The kernel lives in the receiver's library (``cuda_lib.RECEIVER``).

The kernel reads the samples straight from the device capture at
``[ptr, ptr + blk)``, so the JAX path's block framing (per-block buffers,
packed frames, frame slack) and its frame-overflow check have nothing to
guard here; ``scan.track``'s capture-length check still bounds every read
of a run (a read outside the capture would be a zero sample).

:func:`correlate_plan` is the only owner of the launch plan (CTAs per
channel, threads per CTA, 16-sample vectors per CTA): the C entry launches
with it and refuses (cudaErrorInvalidValue) a plan past the kernel's
limits.  :func:`correlate_ms` launches the kernel for CUDA tensors and
runs :func:`correlate_ms_plain` for CPU tensors, and for nothing else;
``correlate_ms.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from softgnss_tpu_torch.config import ReceiverConfig
from softgnss_tpu_torch.signals.nco import carrier_turns, chips_to_q, sin_turns
from softgnss_tpu_torch.track import cuda_lib
from softgnss_tpu_torch.track.cuda_lib import SMS
from softgnss_tpu_torch.track.scan import _correlate_gather

#: samples one 16-byte copy brings
VECTOR = 16
#: samples each thread correlates per pass: one 32-bit word
SAMPLES_PER_THREAD = 4
#: CTAs per channel at most (the kernel's limit)
MAX_CTAS_PER_CHANNEL = 64
#: the kernel's launch bounds, and the vectors its shared buffer holds
MAX_THREADS = 1024
MAX_VECTORS_PER_CTA = 512
#: a CTA gets at least one warp's worth of samples (small front ends take
#: fewer CTAs per channel, not idle lanes)
_MIN_VECTORS_PER_CTA = 32 * SAMPLES_PER_THREAD // VECTOR


class CorrelatePlan(NamedTuple):
    """How ``correlate_ms_kernel`` covers one ms: ``ctas_per_channel`` CTAs
    of ``threads`` threads per channel; CTA r stages the 16-sample vectors
    [r vpc, (r + 1) vpc) of the window (vpc = ``vectors_per_cta``) into
    shared memory, 4 samples per thread, then the next
    ``ctas_per_channel * vpc`` on, so any block length is covered."""

    ctas_per_channel: int
    threads: int
    vectors_per_cta: int

    @property
    def samples_per_cta(self) -> int:
        return VECTOR * self.vectors_per_cta


@functools.lru_cache(maxsize=None)
def _plan(window: int, n_ch: int, ctas: int | None, n_sm: int) -> CorrelatePlan:
    if n_ch < 1:
        raise ValueError(f"correlate_ms: {n_ch} channels")
    if window < 1:
        raise ValueError(f"correlate_ms: a window of {window} samples")
    if ctas is not None and not 1 <= ctas <= MAX_CTAS_PER_CHANNEL:
        raise ValueError(f"correlate_ms: {ctas} CTAs per channel, not in "
                         f"[1, {MAX_CTAS_PER_CHANNEL}]")
    n_vec = -(-(window + VECTOR - 1) // VECTOR)       # at any alignment of ptr
    if ctas is None:
        ctas = min(MAX_CTAS_PER_CHANNEL, max(n_sm // n_ch, -(-n_vec // MAX_VECTORS_PER_CTA)))
    kn = max(1, min(ctas, -(-n_vec // _MIN_VECTORS_PER_CTA)))
    vpc = -(-n_vec // kn)
    kn = -(-n_vec // vpc)                              # no CTA left without vectors
    if vpc > MAX_VECTORS_PER_CTA:
        raise ValueError(f"correlate_ms: a window of {window} samples needs {n_vec} 16-sample "
                         f"vectors, more than {kn} CTAs stage in one pass "
                         f"({MAX_VECTORS_PER_CTA} each)")
    threads = min(MAX_THREADS, -(-vpc * VECTOR // SAMPLES_PER_THREAD // 32) * 32)
    return CorrelatePlan(kn, threads, vpc)


def correlate_plan(config: ReceiverConfig, n_ch: int, ctas_per_channel: int | None = None,
                   n_sm: int = SMS) -> CorrelatePlan:
    """The launch plan of B4 for ``n_ch`` channels at ``config`` on a card
    of ``n_sm`` SMs: the window ``samples_per_code + track_window_extra``
    (the longest code period the loops hand it) in 16-sample vectors at
    any alignment, over ``ctas_per_channel`` CTAs per channel (default:
    n_sm // n_ch, one CTA per SM, at most 64; fewer where a CTA would get
    less than a warp's worth), 4 samples per thread (up to 1024 threads).
    Raises ValueError for no channels, a CTA count outside [1, 64], or a
    window those CTAs do not stage in one pass (512 vectors each)."""
    return _plan(config.samples_per_code + config.track_window_extra, int(n_ch),
                 None if ctas_per_channel is None else int(ctas_per_channel), int(n_sm))


_SCRATCH: dict = {}


def scratch(device: torch.device, n_ch: int, ctas: int) -> tuple[torch.Tensor, torch.Tensor]:
    """B4's float64 partial rows (n_ch, ctas, 6) and its per-channel
    tickets (n_ch,), allocated once per device and shape, never per call:
    every launch leaves the tickets zero.  Launches on one device share
    them, so B4 runs on one stream of a device at a time (the per-ms route
    does)."""
    key = (device, n_ch, ctas)
    if key not in _SCRATCH:
        _SCRATCH[key] = (torch.empty((n_ch, ctas, 6), dtype=torch.float64, device=device),
                         torch.zeros(n_ch, dtype=torch.int32, device=device))
    return _SCRATCH[key]


def correlate_ms_plain(config: ReceiverConfig, cap, ptr, carr_phase, w, code_rem_q,
                       step_q, blk, code_pads, active) -> torch.Tensor:
    """(C, 6) float32 [i_e, i_p, i_l, q_e, q_p, q_l]: the gather correlator
    over capture samples [ptr, ptr + blk) of every active channel, 0 for
    inactive ones (see :func:`correlate_ms`)."""
    dev = cap.device
    n = int(torch.where(active, blk, 0).max()) if active.numel() else 0
    k = torch.arange(max(n, 0), dtype=torch.int64, device=dev)
    idx = ptr[:, None] + k
    inside = (idx >= 0) & (idx < cap.shape[0]) & (k < blk[:, None])
    raw = torch.where(inside, cap[idx.clamp(0, cap.shape[0] - 1)].to(torch.float32), 0.0)
    turns = carrier_turns(carr_phase[:, None], w[:, None], k)
    i_bb = sin_turns(turns) * raw
    q_bb = sin_turns(turns + 0.25) * raw
    tq = code_rem_q[:, None] + step_q[:, None] * k
    corr = torch.stack(_correlate_gather(config, code_pads, tq, i_bb, q_bb), dim=1)
    return torch.where(active[:, None], corr, 0.0)


#: the arguments of B4's C entries from the capture up to the stream
#: (:func:`launch_correlate`'s; the plan's three integers, the scratch and
#: the tickets among them)
CORRELATE_ARGS = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 8
                  + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4)
_CORRELATE_MS = cuda_lib.RECEIVER.entry("sg_correlate_ms", CORRELATE_ARGS)


def launch_correlate(name: str, entry, config: ReceiverConfig, cap, ptr, carr_phase, w,
                     code_rem_q, step_q, blk, code_pads, active, *plan) -> torch.Tensor:
    """Check the inputs of :func:`correlate_ms`, allocate its output, and
    call ``entry`` (a C entry point that takes the arguments of
    ``sg_correlate_ms`` up to ``n_ch``, then ``plan``'s integers and
    pointers, then ``out`` and the stream) on the current stream.  Never
    synchronizes, so a CUDA graph can capture it."""
    dev = cap.device
    c = ptr.shape[0]
    cuda_lib.require(cap, "cap", torch.int8, (cap.shape[0],), dev)
    for arg, t, dtype in (("ptr", ptr, torch.int64), ("carr_phase", carr_phase, torch.int32),
                          ("w", w, torch.int32), ("code_rem_q", code_rem_q, torch.int64),
                          ("step_q", step_q, torch.int64), ("blk", blk, torch.int64),
                          ("active", active, torch.bool)):
        cuda_lib.require(t, arg, dtype, (c,), dev)
    cuda_lib.require(code_pads, "code_pads", torch.float32, (c, 1025), dev)
    out = torch.empty((c, 6), dtype=torch.float32, device=dev)
    p = cuda_lib.ptr
    with torch.cuda.device(dev):
        # a bool tensor is one byte of 0 or 1 per channel: the kernel reads it as is
        rc = entry(p(cap), cap.shape[0], p(ptr), p(carr_phase), p(w), p(code_rem_q), p(step_q),
                   p(blk), p(code_pads), p(active), chips_to_q(config.dll_correlator_spacing), c,
                   *[p(x) if isinstance(x, torch.Tensor) else x for x in plan],
                   p(out), cuda_lib.stream(dev))
    cuda_lib.check(rc, name)
    return out


def correlate_ms(config: ReceiverConfig, cap, ptr, carr_phase, w, code_rem_q, step_q,
                 blk, code_pads, active) -> torch.Tensor:
    """Six correlator sums of one millisecond, all channels.

    ``cap``: (L,) int8 capture; ``ptr``, ``code_rem_q``, ``step_q``,
    ``blk``: (C,) int64 (first sample, Q40 code phase there, Q40 chips per
    sample, samples in this code period); ``carr_phase``, ``w``: (C,) int32
    carrier NCO counts and counts per sample; ``code_pads``: (C, 1025)
    float32; ``active``: (C,) bool.  Returns (C, 6) float32
    [i_e, i_p, i_l, q_e, q_p, q_l].  Kernel B4 (csrc/correlate_ms.cu), one
    launch at :func:`correlate_plan` for the card's SM count, on CUDA
    tensors."""
    if cap.device.type == "cpu":
        return correlate_ms_plain(config, cap, ptr, carr_phase, w, code_rem_q, step_q,
                                  blk, code_pads, active)
    dev = cap.device
    plan = correlate_plan(config, ptr.shape[0], n_sm=cuda_lib.sm_count(
        dev.index if dev.index is not None else torch.cuda.current_device()))
    out = launch_correlate("correlate_ms", _CORRELATE_MS.function(), config, cap, ptr,
                           carr_phase, w, code_rem_q, step_q, blk, code_pads, active, *plan,
                           *scratch(dev, ptr.shape[0], plan.ctas_per_channel))
    correlate_ms.launches += 1
    return out


correlate_ms.launches = 0
