"""B4, the per-ms correlator of the per-ms tracker.

:func:`correlate_ms` gives the six E/P/L sums of one millisecond for all
channels; ``scan.track_ms`` computes the NCO steps and the block length
before it and runs the float64 loop filters after it, in torch.  That is
the split of softgnss_tpu.track.pallas_kernel.fused_correlate_ms and
``scan._frame_ms_pallas``; the CUDA source is
``softgnss_tpu_torch/csrc/correlate_ms.cu``.

The kernel reads the samples straight from the device capture at
``[ptr, ptr + blk)``, so the JAX path's block framing (per-block buffers,
packed frames, frame slack) and its frame-overflow check have nothing to
guard here; ``scan.track``'s capture-length check still bounds every read
of a run (a read outside the capture would be a zero sample).

:func:`correlate_ms` launches the kernel for CUDA tensors and runs
:func:`correlate_ms_plain` for CPU tensors, and for nothing else;
``correlate_ms.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from softgnss_tpu_torch.config import ReceiverConfig
from softgnss_tpu_torch.signals.nco import carrier_turns, chips_to_q, sin_turns
from softgnss_tpu_torch.track.megakernel import _check, _ptr, _require, _stream, load_library
from softgnss_tpu_torch.track.scan import _correlate_gather

#: samples of one channel per CTA and ms (256 threads x 8): 19 CTAs per
#: channel at the reference front end
_SAMPLES_PER_CTA = 2048


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


def _launch_correlate(name: str, entry, config: ReceiverConfig, cap, ptr, carr_phase, w,
                      code_rem_q, step_q, blk, code_pads, active) -> torch.Tensor:
    """Check the inputs of :func:`correlate_ms`, allocate its output and
    scratch, and call ``entry`` (a C entry point that takes the arguments
    of ``sg_correlate_ms``) on the current stream.  Never synchronizes,
    so a CUDA graph can capture it."""
    dev = cap.device
    c = ptr.shape[0]
    _require(cap, "cap", torch.int8, (cap.shape[0],), dev)
    for arg, t, dtype in (("ptr", ptr, torch.int64), ("carr_phase", carr_phase, torch.int32),
                          ("w", w, torch.int32), ("code_rem_q", code_rem_q, torch.int64),
                          ("step_q", step_q, torch.int64), ("blk", blk, torch.int64),
                          ("active", active, torch.bool)):
        _require(t, arg, dtype, (c,), dev)
    _require(code_pads, "code_pads", torch.float32, (c, 1025), dev)
    n_cta = -(-(config.samples_per_code + config.track_window_extra) // _SAMPLES_PER_CTA)
    partial = torch.empty((c, n_cta, 6), dtype=torch.float64, device=dev)
    out = torch.empty((c, 6), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        # a bool tensor is one byte of 0 or 1 per channel: the kernel reads it as is
        rc = entry(_ptr(cap), cap.shape[0], _ptr(ptr), _ptr(carr_phase), _ptr(w),
                   _ptr(code_rem_q), _ptr(step_q), _ptr(blk), _ptr(code_pads), _ptr(active),
                   chips_to_q(config.dll_correlator_spacing), c, n_cta, _ptr(partial),
                   _ptr(out), _stream(dev))
    _check(rc, name)
    return out


def correlate_ms(config: ReceiverConfig, cap, ptr, carr_phase, w, code_rem_q, step_q,
                 blk, code_pads, active) -> torch.Tensor:
    """Six correlator sums of one millisecond, all channels.

    ``cap``: (L,) int8 capture; ``ptr``, ``code_rem_q``, ``step_q``,
    ``blk``: (C,) int64 (first sample, Q40 code phase there, Q40 chips per
    sample, samples in this code period); ``carr_phase``, ``w``: (C,) int32
    carrier NCO counts and counts per sample; ``code_pads``: (C, 1025)
    float32; ``active``: (C,) bool.  Returns (C, 6) float32
    [i_e, i_p, i_l, q_e, q_p, q_l].  Kernel B4 (csrc/correlate_ms.cu) on
    CUDA tensors."""
    if cap.device.type == "cpu":
        return correlate_ms_plain(config, cap, ptr, carr_phase, w, code_rem_q, step_q,
                                  blk, code_pads, active)
    out = _launch_correlate("correlate_ms", load_library().lib.sg_correlate_ms, config, cap,
                            ptr, carr_phase, w, code_rem_q, step_q, blk, code_pads, active)
    correlate_ms.launches += 1
    return out


correlate_ms.launches = 0
