"""S2: B1, the block tracker, stage by stage — where its time per ms goes.

Replaces ``scripts/mega_vmem_bisect.py:45`` (``kern``, launched at :112),
which built the TPU megakernel up stage by stage (noop / bb / full) to
find the stage that broke Mosaic's VMEM limit and timed each per ms.
Here the stages are compile-time instantiations of B1 itself,
``track_block_kernel<false, kStage, kN>`` in ``csrc/track_block.cu``:

* ``filters`` — no sample loop: the per-ms blk/o step, the barriers (the
  cluster's among them), the float64 filter step and the output writes;
* ``load`` — adds the window staging and the sample loads, summed into
  i_p;
* ``carrier`` — adds the carrier NCO and both sin_turns, I/Q sums into i_p
  and q_p;
* ``full`` — B1, the very instantiation the main path launches.

Every stage but ``full`` runs open loop: the filters run on its sums and
are written out, but the state keeps its block-input carr_freq and
code_freq, so each stage reads the windows ``full`` reads.  Each stage
launches at the cluster size B1 launches at (``ctas_per_channel``, chosen
as :func:`megakernel.launch_size` chooses it), or at a forced one.

Run on a CUDA card from the repository root::

    python -m softgnss_tpu_torch.scripts.mega_vmem_bisect

It holds every stage bit-equal to :func:`track_block_stage_plain` and
prints each stage's us per ms, and the difference to the stage before it,
at ``default_config()``, r = 64 ms per block, C = 8 and 12 channels, one
CTA of 512 threads per channel and B1's own launch, each with
nvidia-smi's card line.  Without a CUDA card it raises.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from softgnss_tpu_torch.config import ReceiverConfig, default_config
from softgnss_tpu_torch.scripts.inputs import assert_bit_equal, channel_inputs
from softgnss_tpu_torch.scripts.timing import card, cuda_ms, require_cuda
from softgnss_tpu_torch.signals.nco import (CODE_ONE, carrier_step_u32, carrier_turns,
                                            code_step_q, sin_turns)
from softgnss_tpu_torch.track import cuda_lib
from softgnss_tpu_torch.track import megakernel as mk
from softgnss_tpu_torch.track.scan import MsOutputs, TrackState, _filters_and_outputs

STAGES = ("filters", "load", "carrier", "full")
R = 64
N_CHANNELS = (8, 12)
#: threads of the one-CTA-per-channel B1 (kN = 1), the design S2 first split
ONE_CTA_THREADS = 512
_TRACK_BLOCK_STAGE = cuda_lib.RECEIVER.entry("sg_track_block_stage",
                                             [ctypes.c_int, ctypes.c_void_p] + mk.BLOCK_ARGS)


def _sum32(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis, accumulated in float64 (B1's sums)."""
    return x.to(torch.float64).sum(-1).to(torch.float32)


def track_block_stage_plain(stage: str, frames, fb0, state: TrackState, code_pads,
                            carr_basis, active, config: ReceiverConfig, r: int):
    """B1 stripped to ``stage`` (see the module docstring), one ms at a
    time; ``full`` is :func:`megakernel.track_block_plain`.  Returns what
    :func:`megakernel.track_block` returns."""
    if stage == "full":
        return mk.track_block_plain(frames, fb0, state, code_pads, carr_basis, active,
                                    config, r)
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r} not in {STAGES}")
    dev = frames.device
    fs = config.sampling_freq
    spc = config.samples_per_code
    win = frames.shape[2] * 4
    code_len_q = config.code_length * CODE_ONE
    samples = frames.view(torch.int8)
    k = torch.arange(win, dtype=torch.int64, device=dev)
    st = state
    ovf = torch.zeros_like(fb0)
    zero = torch.zeros(fb0.shape[0], dtype=torch.float32, device=dev)
    outs = []
    for j in range(r):
        step_q = code_step_q(st.code_freq, fs)
        blk = torch.div(code_len_q - st.code_rem_q + step_q - 1, step_q, rounding_mode="floor")
        o = st.ptr - (fb0 + j * spc)
        ovf = torch.maximum(ovf, mk.overflow(o, blk, win, active))
        w = carrier_step_u32(st.carr_freq, fs)
        i_p = q_p = zero
        if stage != "filters":
            mask = (k >= o[:, None]) & (k < (o + blk)[:, None])
            raw = torch.where(mask, samples[j].to(torch.float32), 0.0)
            if stage == "load":
                i_p = _sum32(raw)
            else:
                turns = carrier_turns(
                    (st.carr_phase.to(torch.int64) - w.to(torch.int64) * o)[:, None],
                    w[:, None], k)
                i_p = _sum32(sin_turns(turns) * raw)
                q_p = _sum32(sin_turns(turns + 0.25) * raw)
        corr = (zero, i_p, zero, zero, q_p, zero)
        new, out = _filters_and_outputs(config, carr_basis, active, st, step_q, blk, w, corr)
        st = new._replace(carr_freq=st.carr_freq, code_freq=st.code_freq)   # open loop
        outs.append(out)
    ys = MsOutputs(*[torch.stack(leaf) for leaf in zip(*outs)])
    return st, ys, ovf


def track_block_stage(stage: str, frames, fb0, state: TrackState, code_pads, carr_basis,
                      active, config: ReceiverConfig, r: int, *,
                      ctas_per_channel: int | None = None, threads_per_cta: int | None = None):
    """:func:`megakernel.track_block` stripped to ``stage``: kernel
    ``track_block_kernel<false, kStage, kN>`` (csrc/track_block.cu) on
    CUDA tensors, at B1's launch size or the forced one (the keywords of
    :func:`megakernel.track_block`); :func:`track_block_stage_plain` on
    CPU tensors."""
    mk.check_launch_size(ctas_per_channel, threads_per_cta)
    if frames.device.type == "cpu":
        return track_block_stage_plain(stage, frames, fb0, state, code_pads, carr_basis,
                                       active, config, r)
    dev = frames.device
    cuda_lib.require(frames, "frames", torch.int32, (r, fb0.shape[0], config.track_window // 4),
                     dev)
    s = STAGES.index(stage)
    kn, threads = mk.launch_size(dev, False, fb0.shape[0], config.track_window,
                                 ctas_per_channel, threads_per_cta)
    fn = _TRACK_BLOCK_STAGE.function()
    out = mk.launch_block(
        "track_block_stage", lambda *a: fn(s, cuda_lib.ptr(frames), *a),
        dev, fb0, state, code_pads, carr_basis, active, config, r, kn, threads)
    track_block_stage.launches += 1
    track_block_stage.ctas_per_channel = kn
    return out


track_block_stage.launches = 0
track_block_stage.ctas_per_channel = None


def block_args(config: ReceiverConfig, r: int, device, n_idle: int = 0):
    """The arguments of :func:`track_block_stage` after ``stage`` for the
    block of ms 0 .. r-1 of a :func:`inputs.channel_inputs` capture."""
    inp = channel_inputs(config, r + 3, device, n_idle=n_idle)
    start_w = torch.div(inp.state.ptr - config.track_frame_pre, 4, rounding_mode="floor")
    frames = mk.build_frames_plain(inp.words, start_w, r, config.track_window // 4,
                                   config.samples_per_code // 4)
    return (frames, 4 * start_w, inp.state, inp.code_pads, inp.carr_basis, inp.active,
            config, r)


def _leaves(out) -> dict:
    st, ys, ovf = out
    return {**{f"state.{f}": v for f, v in zip(TrackState._fields, st)},
            **dict(zip(MsOutputs._fields, ys)), "overflow": ovf}


def launch_sizes(device, c: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """The (CTAs per channel, threads per CTA) S2 runs at, ``c`` channels:
    one CTA of ONE_CTA_THREADS, and B1's own launch."""
    own = mk.launch_size(device, False, c, default_config(number_of_channels=c).track_window)
    return ((1, ONE_CTA_THREADS), own)


def check(device, n_channels=N_CHANNELS, r: int = R) -> float:
    """Every stage bit-equal to its plain version at ``default_config()``
    with one idle channel, at one CTA per channel and at B1's cluster
    size, and ``full`` bit-equal to :func:`megakernel.track_block` at the
    same launch; raises otherwise.  Returns the largest absolute difference
    (0.0)."""
    worst = 0.0
    for c in n_channels:
        args = block_args(default_config(number_of_channels=c), r, device, n_idle=1)
        plains = {stage: _leaves(track_block_stage_plain(stage, *args)) for stage in STAGES}
        for kn, t in launch_sizes(device, c):
            size = {"ctas_per_channel": kn, "threads_per_cta": t}
            for stage in STAGES:
                got = _leaves(track_block_stage(stage, *args, **size))
                if int(got["overflow"].max()) != 0:
                    raise AssertionError(f"S2 {stage} C={c} kN={kn}: a ms span left its frame")
                worst = max(worst, assert_bit_equal(f"S2 {stage} C={c} kN={kn}", got,
                                                    plains[stage]))
            assert_bit_equal(f"S2 full C={c} kN={kn} vs track_block",
                             _leaves(track_block_stage("full", *args, **size)),
                             _leaves(mk.track_block(*args, **size)))
    torch.cuda.synchronize(device)
    return worst


def measure(device, n_channels=N_CHANNELS, r: int = R, n: int = 20) -> dict:
    """Device ms per block of each stage (all channels active) at the
    launches of :func:`launch_sizes`, and of the plain ``full``:
    {C: {(kN, threads): {stage: ms}, "plain": ms}}."""
    res = {}
    for c in n_channels:
        args = block_args(default_config(number_of_channels=c), r, device)
        res[c] = {(kn, t): {stage: cuda_ms(lambda s=stage, k=kn, t=t: track_block_stage(
                                s, *args, ctas_per_channel=k, threads_per_cta=t), n, busy=True)
                            for stage in STAGES}
                  for kn, t in launch_sizes(device, c)}
        res[c]["plain"] = cuda_ms(lambda: track_block_stage_plain("full", *args), 2)
    return res


def report(res: dict, r: int = R) -> None:
    for c, by_kn in res.items():
        for size, times in by_kn.items():
            if size == "plain":
                continue
            prev = 0.0
            for stage in STAGES:
                us = times[stage] * 1e3 / r
                print(f"S2 B1 stage {stage:8s} C={c:2d} kN={size[0]:2d} x {size[1]:3d} r={r}: "
                      f"{us:8.3f} us/ms "
                      f"(+{us - prev:7.3f} over the stage before; {times[stage]:.4f} ms per "
                      f"block) [{card()}]")
                prev = us
        print(f"S2 B1 plain full   C={c:2d} r={r}: {by_kn['plain']:.3f} ms per block [{card()}]")


def main() -> int:
    device = require_cuda()
    print(f"worst |kernel - plain| over every stage: {check(device):.1f} (bit-equal)")
    report(measure(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
