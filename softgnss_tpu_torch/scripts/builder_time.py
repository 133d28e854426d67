"""S3: B2, the frames builder, timed with its variants, L2 cold and warm.

Replaces ``scripts/builder_time.py:60`` (``_builder_var``, launched by
``run_var`` at :101-103 and at :144), which timed the TPU frames builder
against variants of its roll width (W = 1024 / 2048 / 4096 words) and
checked each exact against ``build_frames``.  On the H100 no roll exists;
the variants are the designs of ``csrc/build_frames.cu``:

* ``bulk`` — B2 itself (:func:`megakernel.build_frames`,
  ``build_frames_bulk_kernel``): a persistent grid whose CTAs stage pieces
  of the capture into a shared-memory ring by 1-D TMA bulk copies and
  write the frames as int4 (:func:`megakernel.frames_plan`);
* ``vec4`` — ``build_frames_vec4_kernel``: one CTA per (ms, channel), as
  B2's first design (one int32 word per thread and access; it lost every
  timing to the bulk design and was deleted), but one int4 (16 bytes) per
  thread and access, a scalar head and tail (a frame starts 4-byte aligned
  only) and a zero fill at both capture edges; it needs a 16-byte aligned
  capture;
* ``direct`` — ``build_frames_direct_kernel``: the bulk design's CTAs (one
  per ms and column group, every channel's columns), each int4 built from
  two 16-byte read-only loads of the capture in place of the staged hull
  (the channels' overlapping windows then hit in L1); it needs a 16-byte
  aligned capture.

Run on a CUDA card from the repository root::

    python -m softgnss_tpu_torch.scripts.builder_time          # check, time
    python -m softgnss_tpu_torch.scripts.builder_time sweep    # + bulk plans

It holds every variant bit-equal to :func:`megakernel.build_frames_plain`
at ``default_config()``'s geometry, C = 8 and 12, r = 64, 1 and a tail
(TAIL_R), frames inside the capture and running past both of its ends,
with the capture view at word offsets 0-3 from a 16-byte boundary (vec4
and direct at 0 only), and at ``fast_config()``'s (a window of 1 033 words, not whole
int4s).  Then it prints each variant's us per ms and GB/s (bytes read +
written) at r = 64 with the L2 flushed (:func:`timing.flushed_marginal_ms`,
the capture cold as the main path finds it; and timed alone,
:func:`timing.cold_ms`) and warm, the variants in turns, the plain
version's time, and a contiguous ``copy_`` and a ``fill_`` of the
frames' byte count: the card's practical copy and write ceilings beside
the bound, not calls that compute B2's function.  ``sweep`` also times the bulk design at each plan of
:data:`SWEEP`, L2 flushed.  Every line carries nvidia-smi's card line.
Without a CUDA card it raises.
"""

from __future__ import annotations

import ctypes
import itertools
import sys

import numpy as np
import torch

from softgnss_tpu_torch.config import default_config, fast_config
from softgnss_tpu_torch.scripts.inputs import SEED, assert_bit_equal
from softgnss_tpu_torch.scripts.timing import (card, cold_ms, cuda_ms, flushed_marginal_ms,
                                               require_cuda)
from softgnss_tpu_torch.track import cuda_lib
from softgnss_tpu_torch.track import megakernel as mk

VARIANTS = ("bulk", "vec4", "direct")
#: the variants that need a 16-byte aligned capture
ALIGNED_ONLY = ("vec4", "direct")
#: threads per CTA of the direct variant
DIRECT_THREADS = 1024
R = 64
#: the tail segment of the main path's 37 000 ms at 64-ms blocks
TAIL_R = 37_000 % 64
N_CHANNELS = (8, 12)
#: the capture view's word offsets from a 16-byte boundary
LEADS = (0, 1, 2, 3)
#: the bulk design's plan points of ``sweep``: (union, part_w, threads,
#: CTAs per SM)
SWEEP = tuple(itertools.product((True, False), (512, 1024, 4096), (256, 512), (1, 2, 4)))
#: the direct variant's points of ``sweep``: (CTAs per SM, threads)
DIRECT_SWEEP = tuple(itertools.product((1, 2, 4), (256, 512, 1024)))


_vp, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_FRAMES_ARGS = [_vp, _ll, _vp, _vp, _i, _i, _i, _ll]
_BUILD_FRAMES_VEC4 = cuda_lib.RECEIVER.entry("sg_build_frames_vec4", _FRAMES_ARGS + [_vp])
_BUILD_FRAMES_DIRECT = cuda_lib.RECEIVER.entry("sg_build_frames_direct",
                                               _FRAMES_ARGS + [_i, _i, _vp])


def build_frames_vec4(cap_words: torch.Tensor, starts_w: torch.Tensor, r: int, win_w: int,
                      spc_w: int) -> torch.Tensor:
    """:func:`megakernel.build_frames` by 16-byte accesses: kernel
    ``build_frames_vec4_kernel`` (csrc/build_frames.cu) on CUDA tensors,
    whose ``cap_words`` must start 16-byte aligned;
    :func:`megakernel.build_frames_plain` on CPU tensors."""
    if cap_words.device.type == "cpu":
        return mk.build_frames_plain(cap_words, starts_w, r, win_w, spc_w)
    if cap_words.data_ptr() % 16:
        raise ValueError("build_frames_vec4: cap_words must start 16-byte aligned")
    frames = mk.launch_frames("build_frames_vec4", _BUILD_FRAMES_VEC4.function(), cap_words,
                              starts_w, r, win_w, spc_w)
    build_frames_vec4.launches += 1
    return frames


build_frames_vec4.launches = 0


def build_frames_direct(cap_words: torch.Tensor, starts_w: torch.Tensor, r: int, win_w: int,
                        spc_w: int, *, plan: mk.FramesPlan | None = None,
                        threads: int = DIRECT_THREADS) -> torch.Tensor:
    """:func:`megakernel.build_frames` by direct 16-byte loads at the bulk
    design's column groups (``plan``, default :func:`megakernel.frames_plan`):
    kernel ``build_frames_direct_kernel`` (csrc/build_frames.cu) on CUDA
    tensors, whose ``cap_words`` must start 16-byte aligned;
    :func:`megakernel.build_frames_plain` on CPU tensors."""
    if cap_words.device.type == "cpu":
        return mk.build_frames_plain(cap_words, starts_w, r, win_w, spc_w)
    if cap_words.data_ptr() % 16:
        raise ValueError("build_frames_direct: cap_words must start 16-byte aligned")
    if plan is None:
        plan = mk.frames_plan(r, starts_w.shape[0], win_w, spc_w,
                              n_sm=cuda_lib.sm_count(cap_words.device.index or 0))
    frames = mk.launch_frames("build_frames_direct", _BUILD_FRAMES_DIRECT.function(), cap_words,
                              starts_w, r, win_w, spc_w, plan.group_w, threads)
    build_frames_direct.launches += 1
    return frames


build_frames_direct.launches = 0


def variant(name: str):
    return {"bulk": mk.build_frames, "vec4": build_frames_vec4,
            "direct": build_frames_direct}[name]


def frame_args(c: int, r: int, device, edges: bool = False, lead: int = 0, config=None):
    """(cap_words, starts_w, r, win_w, spc_w) at ``config``'s geometry
    (default ``default_config()``) over random capture words, the starts
    spread over one code period (the channels at random code phases, as
    acquisition hands them to the tracker); the view starts ``lead`` words
    past the allocation's start (a 16-byte boundary), the words the same at
    every lead; ``edges``: channel 0's frames start before the capture and
    channel 1's last frames run past its end."""
    cfg = (config or default_config()).with_options(number_of_channels=c)
    spc_w, win_w = cfg.samples_per_code // 4, cfg.track_window // 4
    rng = np.random.default_rng(SEED + c)
    n_words = r * spc_w + win_w + 3000
    words = rng.integers(-2**31, 2**31, n_words).astype(np.int32)
    buf = torch.zeros(n_words + 4, dtype=torch.int32, device=device)
    cap = buf[lead:lead + n_words]
    cap.copy_(torch.from_numpy(words))
    starts = rng.integers(0, spc_w, c)
    if edges:
        starts[0] = -7
        starts[1] = n_words - (r - 1) * spc_w - win_w // 2
    return cap, torch.from_numpy(starts.astype(np.int64)).to(device), r, win_w, spc_w


def check_cases(n_channels=N_CHANNELS) -> list[tuple]:
    """(label, C, r, edges, lead, config) of every case :func:`check`
    holds the variants at."""
    cases = [(f"C={c} r={r} {'edges' if e else 'interior'} lead {lead}", c, r, e, lead, None)
             for c in n_channels for r in (R, 1, TAIL_R) for e in (False, True) for lead in LEADS]
    cases += [(f"fast C=8 r={r} edges lead {lead}", 8, r, True, lead, fast_config())
              for r in (R, TAIL_R) for lead in LEADS]
    return cases


def check(device, n_channels=N_CHANNELS, variants=VARIANTS) -> float:
    """Every variant in ``variants`` bit-equal to the plain version in
    every case of :func:`check_cases` (vec4 and direct on a 16-byte
    aligned capture only; bulk also at a hull budget of four code periods,
    so that the edge cases, whose starts lie further apart than the
    default budget, take the hull path as well as the per-channel rounds);
    raises otherwise.  Returns the largest absolute difference (0.0)."""
    worst = 0.0
    for label, c, r, edges, lead, cfg in check_cases(n_channels):
        args = frame_args(c, r, device, edges, lead, cfg)
        want = {"frames": mk.build_frames_plain(*args)}
        for name in variants:
            if name in ALIGNED_ONLY and lead:
                continue
            worst = max(worst, assert_bit_equal(f"S3 {name} {label}",
                                                {"frames": variant(name)(*args)}, want))
        if "bulk" in variants:    # a hull budget wide enough for the edge starts too
            wide = mk.frames_plan(r, c, args[3], args[4], spread_w=4 * args[4],
                                  n_sm=cuda_lib.sm_count(args[0].device.index or 0))
            assert_bit_equal(f"S3 bulk {label}, hull budget {wide.buf_w} words",
                             {"frames": mk.build_frames(*args, plan=wide)}, want)
    torch.cuda.synchronize(device)
    return worst


#: timers of :func:`measure`: the L2 flushed before the call, back to back
#: and alone, and warm
TIMERS = ("cold", "cold_alone", "warm")


def _timer(label: str, device, n: int):
    return {"cold": lambda fn: flushed_marginal_ms(fn, n, device),
            "cold_alone": lambda fn: cold_ms(fn, n, device),
            "warm": lambda fn: cuda_ms(fn, n, busy=True)}[label]


def measure(device, n_channels=N_CHANNELS, r: int = R, n: int = 50,
            variants=VARIANTS) -> dict:
    """Device ms per block of each variant under each of :data:`TIMERS`,
    the variants in turns (in order, then reversed: two figures each), the
    plain version's, a contiguous ``copy_`` of the frames' bytes and a
    ``fill_`` of them (write only; each under every timer) and the bytes
    one block moves: {C: {variant: {timer: [ms, ms]}, "plain": ms,
    "copy": {timer: ms}, "fill": {timer: ms}, "bytes": n, "frame_bytes": n}}."""
    res = {}
    for c in n_channels:
        args = frame_args(c, r, device)
        res[c] = {name: {t: [] for t in TIMERS} for name in variants}
        for t in TIMERS:
            timer = _timer(t, device, n)
            for name in [*variants, *reversed(variants)]:
                res[c][name][t].append(timer(lambda v=name: variant(v)(*args)))
        res[c]["plain"] = cuda_ms(lambda: mk.build_frames_plain(*args), 10)
        frame_bytes = r * c * args[3] * 4
        src = torch.empty(frame_bytes // 4, dtype=torch.int32, device=device)
        dst = torch.empty_like(src)
        res[c]["copy"] = {t: _timer(t, device, n)(lambda: dst.copy_(src)) for t in TIMERS}
        res[c]["fill"] = {t: _timer(t, device, n)(lambda: dst.fill_(7)) for t in TIMERS}
        res[c]["bytes"] = 2 * frame_bytes
        res[c]["frame_bytes"] = frame_bytes
    return res


def report(res: dict, r: int = R) -> None:
    for c, times in res.items():
        names = [v for v in VARIANTS if v in times]
        for name in names:
            for t in TIMERS:
                ms = float(np.mean(times[name][t]))
                turns = ", ".join(f"{x * 1e3 / r:.4f}" for x in times[name][t])
                print(f"S3 B2 {name:4s} C={c:2d} r={r} L2 {t:10s}: {ms * 1e3 / r:7.4f} us/ms "
                      f"(in turns {turns}), {times['bytes'] / ms / 1e6:8.1f} GB/s "
                      f"({ms:.5f} ms per block) [{card()}]")
        print(f"S3 B2 plain C={c:2d} r={r}: {times['plain']:.4f} ms per block [{card()}]")
        for op, moved in (("copy_", "read + written"), ("fill_", "written")):
            k = 2 if op == "copy_" else 1
            print(f"S3 contiguous {op} of the frames' {times['frame_bytes']} B (C={c}): "
                  + ", ".join(f"L2 {t} {ms:.5f} ms ({k * times['frame_bytes'] / ms / 1e6:.1f} "
                              f"GB/s {moved})" for t, ms in times[op.rstrip('_')].items())
                  + f" [{card()}]")


def sweep(device, points=SWEEP, c: int = 8, r: int = R, n: int = 20) -> dict:
    """The bulk design at each plan point (union, part_w, threads, CTAs per
    SM) of ``points``, and the direct variant at each point of
    :data:`DIRECT_SWEEP` (CTAs per SM, threads; under the key ("direct",
    CTAs per SM, threads)): bit-equal to the plain version at the
    capture's edges (the bulk design on a capture 4 bytes past a 16-byte
    boundary, the direct variant on an aligned one), then timed with the L2 flushed
    (:func:`timing.flushed_marginal_ms`, ``n`` calls) on
    :func:`frame_args` at ``c`` channels: {point: ms per block}."""
    edge = frame_args(c, r, device, edges=True, lead=1)
    args = frame_args(c, r, device)
    want = mk.build_frames_plain(*edge)
    n_sm = cuda_lib.sm_count(device.index or 0)
    out = {}
    for point in points:
        union, part_w, threads, per_sm = point
        plan = mk.frames_plan(r, c, args[3], args[4], union=union, part_w=part_w,
                              threads=threads, ctas_per_sm=per_sm, n_sm=n_sm)
        assert_bit_equal(f"S3 bulk at {plan}", {"frames": mk.build_frames(*edge, plan=plan)},
                         {"frames": want})
        out[point] = flushed_marginal_ms(lambda p=plan: mk.build_frames(*args, plan=p), n,
                                         device)
    aligned = frame_args(c, r, device, edges=True)
    want = mk.build_frames_plain(*aligned)
    for per_sm, threads in DIRECT_SWEEP:
        plan = mk.frames_plan(r, c, args[3], args[4], ctas_per_sm=per_sm, n_sm=n_sm)
        assert_bit_equal(f"S3 direct at {plan.groups} groups, {threads} threads",
                         {"frames": build_frames_direct(*aligned, plan=plan, threads=threads)},
                         {"frames": want})
        out[("direct", per_sm, threads)] = flushed_marginal_ms(
            lambda p=plan, t=threads: build_frames_direct(*args, plan=p, threads=t), n, device)
    return out


def report_sweep(out: dict, c: int = 8, r: int = R) -> None:
    for point, ms in sorted(out.items(), key=lambda kv: kv[1]):
        if point[0] == "direct":
            label = f"S3 direct ctas_per_sm={point[1]} threads={point[2]}"
        else:
            union, part_w, threads, per_sm = point
            label = (f"S3 bulk plan union={int(union)} part_w={part_w} threads={threads} "
                     f"ctas_per_sm={per_sm}")
        print(f"{label}: C={c} r={r} L2 cold {ms * 1e3:.4f} us per block [{card()}]")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = require_cuda()
    print(f"worst |kernel - plain| over every variant and case: {check(device):.1f} "
          "(bit-equal)")
    cfg = default_config()
    plan = mk.frames_plan(R, 8, cfg.track_window // 4, cfg.samples_per_code // 4,
                          n_sm=cuda_lib.sm_count(device.index or 0))
    print(f"bulk plan at C=8: {plan}")
    report(measure(device))
    if "sweep" in argv:
        report_sweep(sweep(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
