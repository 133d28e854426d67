"""S1: B4, the per-ms correlator, stage by stage — and what a launch costs.

Replaces ``scripts/pallas_ablate.py:49`` (``make_fn``, its kernels
launched at :118), which stripped the TPU per-ms kernel to stages
(noop / bb / phase / oh / vpu / mxu) and timed the marginal cost of one
call inside a ``lax.scan`` from scans of 50 and 400 calls.  Here the
stages are compile-time instantiations of B4 itself,
``correlate_ms_kernel<kStage>`` in ``csrc/correlate_ms.cu``:

* ``noop`` — the launch and the reductions (the CTA's, then the last
  CTA's over the channel's rows) of zero sums, no sample loop;
* ``carrier`` — the sample loads, the carrier NCO and both sin_turns, I/Q
  sums into i_p and q_p;
* ``phase`` — adds the Q40 code phase and the three chip indices, summed
  as integers into i_e (early), q_e (prompt) and i_l (late), no lookup;
* ``full`` — B4, the very instantiation the per-ms route launches.

Each stage is the kernel the route launches (one launch per ms: each CTA
stages its slice of the window by cp.async and the last CTA of a channel
sums the channel's rows) at its own plan.  B4's first design (two
launches per ms: CTA partial rows in a float64 scratch allocated per
call, then a reduce kernel) lost every timing to it and was deleted.

For each stage it reports three figures: the device time per launch
(CUDA events on a busy card), the host time per wrapper call (the eager
per-ms route pays this), and the marginal device time per call inside a
CUDA graph of 50 and of 400 calls (what a graph-captured route would
pay).

Run on a CUDA card from the repository root::

    python -m softgnss_tpu_torch.scripts.pallas_ablate

It holds every stage bit-equal to
:func:`correlate_ms_stage_plain` and prints the three figures in us at
``default_config()``, C = 8 and 12 channels, each with nvidia-smi's card
line.  Without a CUDA card it raises.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from softgnss_tpu_torch.config import ReceiverConfig, default_config
from softgnss_tpu_torch.scripts.inputs import assert_bit_equal, channel_inputs
from softgnss_tpu_torch.scripts.timing import (card, cuda_ms, graph_marginal_ms, host_ms,
                                               require_cuda)
from softgnss_tpu_torch.signals.nco import (CODE_ONE, carrier_step_u32, carrier_turns,
                                            ceil_chip_index, chips_to_q, code_step_q, sin_turns)
from softgnss_tpu_torch.track import cuda_lib
from softgnss_tpu_torch.track import pallas_kernel as pk

STAGES = ("noop", "carrier", "phase", "full")
N_CHANNELS = (8, 12)
_CORRELATE_MS_STAGE = cuda_lib.RECEIVER.entry("sg_correlate_ms_stage",
                                              [ctypes.c_int] + pk.CORRELATE_ARGS)


def _stage_index(stage: str) -> int:
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r} not in {STAGES}")
    return STAGES.index(stage)


def correlate_ms_stage_plain(stage: str, config: ReceiverConfig, cap, ptr, carr_phase, w,
                             code_rem_q, step_q, blk, code_pads, active) -> torch.Tensor:
    """B4 stripped to ``stage`` (see the module docstring): (C, 6) float32
    in the slots of [i_e, i_p, i_l, q_e, q_p, q_l], 0 for idle channels;
    ``full`` is :func:`pallas_kernel.correlate_ms_plain`."""
    _stage_index(stage)             # raises on a stage not in STAGES
    if stage == "full":
        return pk.correlate_ms_plain(config, cap, ptr, carr_phase, w, code_rem_q, step_q,
                                     blk, code_pads, active)
    dev = cap.device
    out = torch.zeros((ptr.shape[0], 6), dtype=torch.float32, device=dev)
    if stage == "noop":
        return out
    n = int(torch.where(active, blk, 0).max()) if active.numel() else 0
    k = torch.arange(max(n, 0), dtype=torch.int64, device=dev)
    idx = ptr[:, None] + k
    inside = (idx >= 0) & (idx < cap.shape[0]) & (k < blk[:, None])
    raw = torch.where(inside, cap[idx.clamp(0, cap.shape[0] - 1)].to(torch.float32), 0.0)
    turns = carrier_turns(carr_phase[:, None], w[:, None], k)
    out[:, 1] = (sin_turns(turns) * raw).to(torch.float64).sum(-1).to(torch.float32)
    out[:, 4] = (sin_turns(turns + 0.25) * raw).to(torch.float64).sum(-1).to(torch.float32)
    if stage == "phase":
        tq = code_rem_q[:, None] + step_q[:, None] * k
        half_q = chips_to_q(config.dll_correlator_spacing)
        for slot, d in ((0, -half_q), (3, 0), (2, half_q)):
            chip = ceil_chip_index(tq + d).clamp(0, 1024).to(torch.int64)
            out[:, slot] = torch.where(inside, chip, 0).sum(-1).to(torch.float64).to(torch.float32)
    return torch.where(active[:, None], out, 0.0)


def correlate_ms_stage(stage: str, config: ReceiverConfig, cap, ptr, carr_phase, w,
                       code_rem_q, step_q, blk, code_pads, active,
                       ctas_per_channel: int | None = None) -> torch.Tensor:
    """:func:`pallas_kernel.correlate_ms` stripped to ``stage``: kernel
    ``correlate_ms_kernel<kStage>`` (csrc/correlate_ms.cu) at
    :func:`pallas_kernel.correlate_plan` for the card's SM count
    (``ctas_per_channel`` to time another size) on CUDA tensors, never
    synchronizing; :func:`correlate_ms_stage_plain` on CPU tensors."""
    if cap.device.type == "cpu":
        return correlate_ms_stage_plain(stage, config, cap, ptr, carr_phase, w, code_rem_q,
                                        step_q, blk, code_pads, active)
    s = _stage_index(stage)
    dev = cap.device
    plan = pk.correlate_plan(config, ptr.shape[0], ctas_per_channel,
                             n_sm=cuda_lib.sm_count(dev.index or 0))
    fn = _CORRELATE_MS_STAGE.function()
    out = pk.launch_correlate("correlate_ms_stage", lambda *a: fn(s, *a), config, cap, ptr,
                              carr_phase, w, code_rem_q, step_q, blk, code_pads, active, *plan,
                              *pk.scratch(dev, ptr.shape[0], plan.ctas_per_channel))
    correlate_ms_stage.launches += 1
    return out


correlate_ms_stage.launches = 0


def ms_args(config: ReceiverConfig, device, n_idle: int = 0):
    """The arguments of :func:`correlate_ms_stage` after ``stage``: the
    first ms of every channel of a :func:`inputs.channel_inputs` capture."""
    inp = channel_inputs(config, 4, device, n_idle=n_idle)
    st = inp.state
    step_q = code_step_q(st.code_freq, config.sampling_freq)
    blk = torch.div(config.code_length * CODE_ONE - st.code_rem_q + step_q - 1, step_q,
                    rounding_mode="floor")
    w = carrier_step_u32(st.carr_freq, config.sampling_freq)
    return (config, inp.signal, st.ptr, st.carr_phase, w, st.code_rem_q, step_q, blk,
            inp.code_pads, inp.active)


def check(device, n_channels=N_CHANNELS) -> float:
    """Every stage bit-equal to its plain version at ``default_config()``
    with one idle channel, and ``full`` bit-equal to
    :func:`pallas_kernel.correlate_ms`; raises otherwise.  Returns the
    largest absolute difference (0.0)."""
    worst = 0.0
    for c in n_channels:
        args = ms_args(default_config(number_of_channels=c), device, n_idle=1)
        for stage in STAGES:
            worst = max(worst, assert_bit_equal(
                f"S1 {stage} C={c}", {"out": correlate_ms_stage(stage, *args)},
                {"out": correlate_ms_stage_plain(stage, *args)}))
        assert_bit_equal(f"S1 full C={c} vs correlate_ms",
                         {"out": correlate_ms_stage("full", *args)},
                         {"out": pk.correlate_ms(*args)})
    torch.cuda.synchronize(device)
    return worst


def time_stages(args, n: int = 200) -> dict:
    """{stage: {"device", "host", "graph"}} on ``args``: device ms per
    launch, host ms per wrapper call and the marginal device ms per call
    in a CUDA graph."""
    res = {}
    for stage in STAGES:
        def fn(stage=stage):
            return correlate_ms_stage(stage, *args)

        res[stage] = {"device": cuda_ms(fn, n, busy=True), "host": host_ms(fn, n),
                      "graph": graph_marginal_ms(fn)}
    return res


def measure(device, n_channels=N_CHANNELS, n: int = 200) -> dict:
    """Per C: the stages (:func:`time_stages`) and the plain ``full``'s
    device ms: {C: {stage: {...}, "plain": ms}}."""
    res = {}
    for c in n_channels:
        args = ms_args(default_config(number_of_channels=c), device)
        res[c] = time_stages(args, n)
        res[c]["plain"] = cuda_ms(lambda: correlate_ms_stage_plain("full", *args), 20)
    return res


def report(res: dict) -> None:
    for c, times in res.items():
        for stage in STAGES:
            t = times[stage]
            print(f"S1 B4 {stage:7s} C={c:2d}: device {t['device'] * 1e3:8.3f} us/launch, host "
                  f"{t['host'] * 1e3:8.3f} us/call, in a CUDA graph {t['graph'] * 1e3:8.3f} "
                  f"us/call [{card()}]")
        print(f"S1 B4 plain full C={c:2d}: {times['plain'] * 1e3:.3f} us/ms [{card()}]")


def main() -> int:
    device = require_cuda()
    print(f"worst |kernel - plain| over every stage: {check(device):.1f} (bit-equal)")
    report(measure(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
