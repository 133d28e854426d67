#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (softgnss_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed with its seconds; the first failure raises and the
script exits non-zero:

1. card       — device name and nvidia-smi's name / power limit
2. build      — nvcc builds every kernel from softgnss_tpu_torch/csrc (the
                receiver's B1-B4, the probes' S1-S5); ptxas's registers,
                shared memory and spills per entry
3. nco        — signals.nco on CUDA tensors bit-equal to the same on CPU
4. B2         — build_frames kernel bit-equal to its plain version at the
                default geometry, frames past the capture ends included
5. synthesize — build_scenario(default_config(), n_sats=8) (circular
                orbits, real nav subframes, C/N0 53 dB-Hz) synthesized on
                the card by synthesize_scenario: 37 020 ms, 1.41 GB int8
6. B1, B3, B4 — track_block, track_block_fused and correlate_ms against
                their plain versions over 256 ms of that capture, with a
                resume (lead segment) and an idle channel, at default and
                in a variant config (pdi_ms=4, FLL, carrier-aided DLL,
                spacing 0.25); B1 and B3 at every cluster size whose 8
                clusters fit on the card at once, and at 3, 5, 8 and 12
                channels at the chosen size; B3 bit-equal to B2 + B1 at the
                capture edges; ptxas's registers, shared memory and spills
                of every B1/B3 instantiation; each cluster size, and 128,
                256 and 512 threads per CTA at the chosen size, timed in
                turns; B4's time per launch
6b. probes    — the measurement probes softgnss_tpu_torch.scripts (S1
                pallas_ablate, S2 mega_vmem_bisect, S3 builder_time, S4
                dma_probe, S5 pallas_probe): every stage, variant, load
                pattern and construct against its plain version (bit-equal;
                S5's tensor-core products within their TF32 bound; S4 at
                every cluster size and its first design, every S5 construct
                in each design, S5 conv and onehot also at the receiver's
                geometry), S5's library calls against the same plain
                versions, ptxas's resources of every S4 and S5 kernel (no
                spills), then each probe's timings (S4's patterns at 1-16
                CTAs per channel, its first design and ``direct`` at 16 in
                turns; S5's designs in turns, its tensor-core library calls
                with TF32 allowed and at the default precision, each acc
                design's per-rep handoff, conv and onehot L2-flushed and in
                a CUDA graph at the script's shape and warm and flushed at
                the receiver's, with their targets) (its own path: the
                counts are zeroed before the timings and read after)
7. main path  — run_receiver(default_config(), navigate=True,
                device="cuda") over the reference's 37 000 ms (block
                tracker, B2 + B1): every satellite acquired and locked,
                ephemerides decoded equal to truth, TOW equal, >= 90 % of
                epochs fixed, 3D error median < 30 m and mean < 40 m,
                static |v| median < 0.3 m/s
7b. profile   — one torch.profiler window over the main path's track
                stage: the card's idle share, B1's and B2's share of device
                time
8. fused      — the same channels with mega_fused_frames=True (B3):
                every tracking output bit-equal to the main path's
9. per-ms     — the same channels with correlator_impl='pallas' (B4,
                loop filters in torch) and navigation: the closed-loop
                bounds of the main path, and against the block tracker
                absolute_sample within +-1, correlator relative RMS < 1e-3,
                carr_freq within 0.5 Hz
10. stream    — the main path's capture copied once into pinned host
                memory, then parallel.stream.track_streamed in 4 096-ms
                chunks (upload, B2 + B1, readback overlapped): every output
                bit-equal to the main path's; seconds and peak device
                memory beside the main path's
10b. mesh     — the distribution layer with 2 ranks sharing the one card
                (parallel.mesh.spawn_world, gloo, every rank on cuda:0; the
                library built above is loaded, not rebuilt): the capture
                written to a file once, then in one world run_receiver(
                file_name=..., mesh=...) at 1x2 shard='channel' (every
                output and the final state bit-equal to the main path),
                1x2 'time-exact' (absolute_sample, sample_frac, the i_p
                signs, final ptr and code_rem_q bit-equal) and 2x1 'time'
                (warm-up 250 ms: absolute_sample within +-1, nav-bit signs
                agreeing > 0.99 past 50 ms, the closed-loop fix bounds);
                acquisition with the main path's code phases and Doppler
                bins; B2 and B1 launched on every rank, every rank's
                tracking equal to rank 0's; track-stage seconds per rank and
                the card's busy share over the block loops (the union of
                the ranks' kernel spans from a CUDA-only profiler, an upper
                bound).  Then python -m torch.distributed.run
                --standalone --nproc-per-node 2 -m softgnss_tpu_torch.cli
                --file <capture> --mesh 1x2: exit 0, rank 0's mean fix
                within 1e-3 m of the channel-sharded run's
10c. oracle   — the float64 NumPy oracle (softgnss_tpu_torch.oracle) against
                the main path: every injected PRN's acquisition (cuFFT)
                at the oracle_acquire_grid code phase and Doppler bin; the
                block (B2 + B1), fused (B3) and per-ms (B4) routes over the
                first 1 000 ms of all 8 channels against
                oracle_track_channel: absolute_sample within +-1 and the
                oracle's nav-bit signs past 50 ms, each North-star figure
                printed (at 53 dB-Hz two closed loops of the same math part
                by more than those bounds; ROADMAP C.8); post_navigate
                against oracle_navigate on the main path's integer
                observables at tests/test_oracle_parity.py's knobs and
                bounds (fixes within 1e-3 m); then scripts.oracle_check
                (3 satellites, 1 000 ms, each route on the North-star
                bounds: correlators < 1e-3 relative RMS, absolute_sample
                within +-1, carr_freq within 0.5 Hz, code_freq within 0.05
                Hz) and scripts.parity_check at 3 and 12 channels (per-ms
                against block and fused)
11. front end — 'auto' at fs = 38.194 MHz (samples_per_code % 4 != 0):
                8 channels over 2 000 ms on the per-ms tracker, locked
12. ekf       — post_navigate(nav_filter='ekf') on the main path's tracking:
                >= 90 % of epochs fixed, 3D error median < 30 m
13. cli       — softgnss_tpu_torch.cli.main(["--synthetic", "--stream",
                "--set", "nav_filter=ekf"]) in process at default_config():
                exit 0, a 3D-error mean < 30 m, B2 and B1 launched
14. scenarios — every closed loop of softgnss_tpu_torch.scripts.scenarios
                (the JAX suite's slow scenarios: end to end, an unhealthy and
                a killed satellite, a false lock demoted, the TOW vote,
                45 dB-Hz, 1.5 g, constant velocity, the full orbit model,
                +2 and -1 ppm, navigation parity with the oracle) at
                fast_config over 37 000 ms on the card, each at its JAX
                test's bounds, with its seconds, figures and B2 / B1
                launches

Each tracking phase zeroes every kernel's launch count just before it and
checks the counts just after (the kernels line sums each kernel's
launches over the main path or its route, the oracle phase and the
scenarios), and that B1 (or B3) ran as a cluster of
more than one CTA per channel (the size is printed with the counts).  Each kernel's record carries its time, its
plain version's, one PyTorch call's that computes the same function where
there is one, and its bound: the least time an H100 could take for the
same work on this run's inputs (bytes over 3.35 TB/s, operations over 67
TFLOP/s float32 or 495 TFLOP/s TF32, the larger).  The line before the last is nvidia-smi's
card name and power limit, the one before it the kernels' JSON record;
the last line is {"ok": true, "device": {...}}.  Exits non-zero, printing
no result, when no CUDA device is available.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import sys
import time

import numpy as np

from softgnss_tpu_torch.scripts.timing import bound_ms
from softgnss_tpu_torch.scripts.timing import card as smi_line
from softgnss_tpu_torch.scripts.timing import cuda_ms, host_ms

SEED = 20261016
N_SATS = 8
NOISE_STD = 8.0
#: C/N0 range, dB-Hz: at acq_noncoherent_ms=2 a 50-51 dB-Hz satellite's
#: peak metric sits near the 2.5 threshold (~2.3-3.9 on the fast front
#: end), so the upper part of the 50-54 dB-Hz band keeps acquisition sure
CN0_DBHZ = (52.0, 54.0)
#: the closed-loop scenario's C/N0 (one amplitude for all satellites)
SCENARIO_CN0_DBHZ = 53.0
#: a front end whose code period is not whole int32 words (38194 samples)
ODD_FS = 38_194_000.0
ODD_MS = 2_000
#: capture ms: the reference's ms_to_process plus acquisition and slack
CAPTURE_MS = 37_020
MAIN_MS = 37_000
PARITY_MS = (100, 156)     # two track calls: the second resumes mid-block
TOL_CORR = 1e-4            # max |kernel - plain| / RMS, each correlator
TOL_FREQ_HZ = 1e-3         # carr/code freq, a tenth of the NCO step fs/2^32
TOL_FRAC = 1e-6            # sample_frac
#: per-ms tracker against the block tracker over 37 000 ms (the oracle
#: tolerances of ROADMAP's north star: the routes run the same math, the
#: filters in torch on one and in B1 on the other)
ROUTE_TOL = {"absolute_sample": 1, "corr_rel_rms": 1e-3, "carr_freq_hz": 0.5}
#: the streamed route's chunk (config.track_stream_chunk_ms's default)
STREAM_CHUNK_MS = 4096
#: operations per correlated sample in B1, B3 and B4 (and S1's and S2's
#: ``full``), counted from the sample loops of csrc/track_block.cu and
#: csrc/correlate_ms.cu: the byte load, its bounds and convert (~5), the
#: carrier NCO counts and turns (~5), two sin_turns with their products
#: (~39), the Q40 code phase, three chip indices and lookups (~22), six
#: products widened and summed in float64 (~18)
OPS_PER_SAMPLE = 90


@contextlib.contextmanager
def phase(name: str):
    print(f"[{name}] ...", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"[{name}] ok ({time.perf_counter() - t0:.3f} s)", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def make_scenario(cfg):
    """Static satellites for a synthesize_signal capture at ``cfg``."""
    from softgnss_tpu_torch.signals.synth import SatelliteSignal, amplitude_for_cn0

    rng = np.random.default_rng(SEED)
    prns = rng.choice(np.arange(1, 33), N_SATS, replace=False)
    sats = []
    for prn in prns:
        sats.append(SatelliteSignal(
            prn=int(prn), doppler_hz=float(rng.uniform(-5000, 5000)),
            # whole-sample delays: the acquisition grid has one-sample lags
            delay_samples=float(rng.integers(0, cfg.samples_per_code)),
            amplitude=amplitude_for_cn0(cfg, float(rng.uniform(*CN0_DBHZ)), NOISE_STD),
            phase0=float(rng.uniform(0, 2 * np.pi)),
            nav_bits=tuple(int(b) for b in rng.choice([-1, 1], 64))))
    return sats


def truth_channels(sc, status):
    """Tracking channels at the scenario's truth (acquisition's values):
    channel i tracks satellite i % n_sats, one channel per entry of
    ``status``."""
    from softgnss_tpu_torch.acquire.search import Channels

    spc = sc.config.samples_per_code
    sats = [i % len(sc.prns) for i in range(len(status))]
    return Channels(
        prn=np.asarray([sc.prns[i] for i in sats], np.int64),
        acquired_freq=np.asarray([sc.expected_carrier_freq(i) for i in sats]),
        code_phase=np.asarray([int(round(sc.expected_code_phase(i))) % spc for i in sats],
                              np.int64),
        status=list(status))


def _kernel_wrappers():
    """(the receiver's kernel wrappers B2, B1, B3, B4; the probes' S1-S5)"""
    from softgnss_tpu_torch.scripts import (builder_time, dma_probe, mega_vmem_bisect,
                                            pallas_ablate, pallas_probe)
    from softgnss_tpu_torch.track import megakernel as mk
    from softgnss_tpu_torch.track import pallas_kernel as pk

    return ((mk.build_frames, mk.track_block, mk.track_block_fused, pk.correlate_ms),
            (*pallas_ablate.VARIANTS.values(), mega_vmem_bisect.track_block_stage,
             builder_time.build_frames_vec4, dma_probe.dma_probe, dma_probe.dma_probe_cta,
             *pallas_probe.VARIANTS.values()))


def union_len(starts, length: int, limit: int) -> int:
    """Elements covered by the intervals [s, s + length), s in ``starts``,
    clipped to [0, limit): what a kernel must read at least once."""
    total, hi = 0, 0
    for s in sorted(int(v) for v in starts):
        lo, end = max(s, hi, 0), min(s + length, limit)
        if end > lo:
            total += end - lo
            hi = end
    return total


def block_bound(samples: int, n_bytes: int) -> tuple[float, str]:
    """Bound of B1 / B3 / B4 work: ``samples`` correlated samples at
    OPS_PER_SAMPLE float32 operations, ``n_bytes`` moved."""
    return bound_ms(n_bytes, samples * OPS_PER_SAMPLE)


def record(kid: str, name: str, source: str, replaces: str, max_abs_err: float, ms: float,
           plain_ms: float, bound: tuple[float, str], library_ms: float | None) -> dict:
    """One kernel's entry of the ``kernels`` line (``launches`` is filled
    in from its main-path phase)."""
    return {"id": kid, "name": name, "route": "cuda", "source": f"softgnss_tpu_torch/csrc/{source}",
            "replaces": replaces, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms}


def reset_launches():
    for fns in _kernel_wrappers():
        for fn in fns:
            fn.launches = 0
            if hasattr(fn, "ctas_per_channel"):
                fn.ctas_per_channel = None
            if hasattr(fn, "smem_bytes"):
                fn.smem_bytes = None


def read_launches(probes: bool = False) -> dict:
    return {fn.__name__: fn.launches for fn in _kernel_wrappers()[probes]}


def cluster_size(label: str, wrapper: str) -> int:
    """The CTAs per channel the block-tracker wrapper ``wrapper`` last
    launched at in this phase: a cluster, never one CTA per channel."""
    from softgnss_tpu_torch.track import megakernel as mk

    kn = getattr(mk, wrapper).ctas_per_channel
    check(kn is not None and kn > 1, f"{label}: {wrapper} launched at {kn} CTAs per channel")
    return kn


def phase_nco(dev) -> None:
    import torch

    from softgnss_tpu_torch.signals import nco

    rng = np.random.default_rng(SEED)
    p0 = torch.from_numpy(rng.integers(-2**31, 2**31, 100_000).astype(np.int32))
    w = torch.from_numpy(rng.integers(-2**31, 2**31, 100_000).astype(np.int32))
    k = torch.from_numpy(rng.integers(0, 400_000, 100_000).astype(np.int32))
    f = torch.from_numpy(np.concatenate([rng.uniform(-2e7, 2e7, 10_000), [0.0, -1.0]]))
    q = torch.from_numpy(rng.integers(-2**52, 2**52, 10_000))
    x = torch.from_numpy(rng.uniform(-3, 3, 100_000).astype(np.float32))
    cases = {
        "carrier_turns": lambda d: nco.carrier_turns(p0.to(d), w.to(d), k.to(d)),
        "carrier_sin_cos": lambda d: torch.stack(nco.carrier_sin_cos(p0.to(d), w.to(d), k.to(d))),
        "sin_turns": lambda d: nco.sin_turns(x.to(d)),
        "carrier_step_u32": lambda d: nco.carrier_step_u32(f.to(d), 38_192_000.0),
        "code_step_q": lambda d: nco.code_step_q(f.abs().to(d), 38_192_000.0),
        "ceil_chip_index": lambda d: nco.ceil_chip_index(q.to(d)),
    }
    for name, fn in cases.items():
        check(torch.equal(fn(dev).cpu(), fn("cpu")), f"nco.{name}: CUDA != CPU")
    print(f"  {len(cases)} NCO functions bit-equal on CUDA and CPU")


def phase_b2(cfg, dev) -> dict:
    import torch

    from softgnss_tpu_torch.track import megakernel as mk

    r, c = cfg.track_block_ms, cfg.number_of_channels
    spc_w, win_w = cfg.samples_per_code // 4, cfg.track_window // 4
    rng = np.random.default_rng(SEED)
    n_words = r * spc_w + win_w + 3000
    cap = torch.from_numpy(rng.integers(-2**31, 2**31, n_words).astype(np.int32)).to(dev)
    starts = rng.integers(0, 2000, c)
    starts[0] = -7                                   # frames before the capture start
    starts[1] = n_words - (r - 1) * spc_w - win_w // 2   # the last frames run past the end
    starts = torch.from_numpy(starts.astype(np.int64)).to(dev)
    got = mk.build_frames(cap, starts, r, win_w, spc_w)
    want = mk.build_frames_plain(cap, starts, r, win_w, spc_w)
    torch.cuda.synchronize()
    check(got.shape == (r, c, win_w), f"B2 shape {tuple(got.shape)}")
    check(torch.equal(got, want), "B2 frames differ from the plain version")
    check(bool((got[0, 0, :2] == 0).all()) and bool((got[-1, 1, -2:] == 0).all()),
          "B2 zero fill")
    ms = cuda_ms(lambda: mk.build_frames(cap, starts, r, win_w, spc_w), 50, busy=True)
    plain_ms = cuda_ms(lambda: mk.build_frames_plain(cap, starts, r, win_w, spc_w), 10)
    lib_ms = frames_library_ms(cap, starts, r, win_w, spc_w)
    bound = frames_bound(cap, starts, r, win_w, spc_w)
    print(f"  frames {tuple(got.shape)} int32 bit-equal; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, one indexing call {lib_ms:.4f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]}) per block")
    return record("B2", "build_frames", "build_frames.cu", "softgnss_tpu/track/megakernel.py:818",
                  float((got.to(torch.int64) - want).abs().max()), ms, plain_ms, bound, lib_ms)


def frames_bound(cap, starts, r: int, win_w: int, spc_w: int) -> tuple[float, str]:
    """B2's (and S3's) bound: every capture word some frame holds, read
    once, and the frames written."""
    span = (r - 1) * spc_w + win_w
    read = union_len(starts.tolist(), span, cap.shape[0]) * 4
    return bound_ms(read + r * starts.shape[0] * win_w * 4, 0)


def frames_library_ms(cap, starts, r: int, win_w: int, spc_w: int) -> float:
    """One advanced-indexing gather with a prebuilt index computing B2's
    function: the capture with one zero word appended, indexed there for
    the words outside it."""
    import torch

    from softgnss_tpu_torch.track import megakernel as mk

    n = cap.shape[0]
    padded = torch.cat([cap, cap.new_zeros(1)])
    idx = (starts[None, :, None] + torch.arange(r, device=cap.device)[:, None, None] * spc_w
           + torch.arange(win_w, device=cap.device)[None, None, :])
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    check(torch.equal(padded[idx], mk.build_frames_plain(cap, starts, r, win_w, spc_w)),
          "the indexing call differs from B2's plain version")
    return cuda_ms(lambda: padded[idx], 50, busy=True)


def run_split(cfg, sig, channels, build, block):
    """PARITY_MS[0] ms, then a resumed PARITY_MS[1] ms (lead segment) on
    the block tracker (``build=None``: fused) or, with ``build='per_ms'``,
    on the per-ms tracker with ``block`` as its correlator."""
    import torch

    from softgnss_tpu_torch.track.scan import (MsOutputs, capture_words, initial_state,
                                               track_ms, track_segments)
    from softgnss_tpu_torch.track.tables import build_tables

    dev = sig.device
    pads = build_tables(channels.prn, dev)
    active = torch.tensor([s == "T" for s in channels.status], device=dev)
    cb = torch.as_tensor(channels.acquired_freq).to(dev)
    st0 = initial_state(cfg, channels, dev)
    if build == "per_ms":
        st1, ys1 = track_ms(cfg, sig, st0, pads, cb, active, PARITY_MS[0], 0, block)
        st2, ys2 = track_ms(cfg, sig, st1, pads, cb, active, PARITY_MS[1], PARITY_MS[0],
                            block)
    else:
        words = capture_words(sig)
        st1, ys1, ov1 = track_segments(cfg, words, st0, pads, cb, active,
                                       PARITY_MS[0], 0, build, block)
        st2, ys2, ov2 = track_segments(cfg, words, st1, pads, cb, active,
                                       PARITY_MS[1], PARITY_MS[0], build, block)
        check(int(torch.maximum(ov1, ov2).max()) == 0, "frame overflow")
    ys = MsOutputs(*[torch.cat(p).cpu().numpy() for p in zip(ys1, ys2)])
    return st0, st2, ys


VARIANT = dict(pdi_ms=4, fll_bandwidth_hz=10.0, carrier_aided_dll=True,
               dll_correlator_spacing=0.25)


def hold_against_plain(name, cfg, sig, channels, kernel, plain, plains=None) -> float:
    """Run ``kernel`` and ``plain`` ((build, block) pairs for run_split)
    over the PARITY_MS split at default and VARIANT configs; check the
    tolerances, the idle channel and finiteness.  ``plains``: a dict that
    keeps the plain runs of these channels for the next call.  Returns the
    worst absolute correlator difference at the default config."""
    import torch

    act = np.asarray([s == "T" for s in channels.status])
    plains = {} if plains is None else plains
    worst = 0.0
    for label, c in (("default", cfg), ("variant", cfg.with_options(**VARIANT))):
        st0, stk, yk = run_split(c, sig, channels, *kernel)
        if (label, plain) not in plains:
            plains[(label, plain)] = run_split(c, sig, channels, *plain)
        _, stp, yp = plains[(label, plain)]
        check(np.array_equal(yk.absolute_sample, yp.absolute_sample),
              f"{name} {label}: absolute_sample differs")
        errs = {}
        for f in ("i_p", "i_e", "i_l", "q_e", "q_p", "q_l"):
            a, b = getattr(yk, f)[:, act], getattr(yp, f)[:, act]
            errs[f] = float(np.abs(a - b).max() / np.sqrt(np.mean(b.astype(np.float64) ** 2)))
            check(errs[f] < TOL_CORR, f"{name} {label}: {f} rel err {errs[f]:.3e}")
            if label == "default":
                worst = max(worst, float(np.abs(a - b).max()))
        for f, tol in (("carr_freq", TOL_FREQ_HZ), ("code_freq", TOL_FREQ_HZ),
                       ("sample_frac", TOL_FRAC)):
            errs[f] = float(np.abs(getattr(yk, f) - getattr(yp, f)).max())
            check(errs[f] < tol, f"{name} {label}: {f} err {errs[f]:.3e}")
        n_diff = sum(int(np.any(getattr(yk, f) != getattr(yp, f), axis=1).sum())
                     for f in yk._fields)
        # the inactive channel: zero outputs, state frozen
        for f in yk._fields:
            check(not np.any(getattr(yk, f)[:, ~act]), f"{name} {label}: idle {f} not zero")
        idle = ~torch.from_numpy(act).to(sig.device)
        for f, v0, v in zip(st0._fields, st0, stk):
            check(torch.equal(v0[idle], v[idle]), f"{name} {label}: idle channel state {f} moved")
        check(all(np.isfinite(getattr(yk, f)).all() for f in yk._fields),
              f"{name} {label}: non-finite outputs")
        print(f"  {name} {label}: {sum(PARITY_MS)} ms x {len(act)} ch, absolute_sample equal, "
              f"{n_diff} (ms, output) rows not bit-equal; "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    return worst


#: channel counts B1 and B3 are held at, at the chosen cluster size
#: (ROADMAP section B's acceptance for B1, the set of the JAX package's
#: scripts/parity_check.py)
PARITY_CHANNELS = (3, 5, 8, 12)
#: threads per CTA timed at every cluster size
THREAD_SWEEP = (128, 256, 512)


def fitting_sizes(dev, fused: bool, n_ch: int, win: int, threads: int | None = None) -> list[int]:
    """The cluster sizes at which all ``n_ch`` clusters of ``threads``
    (default THREADS_PER_CTA) threads per CTA are resident at once (and 1,
    one CTA per channel)."""
    from softgnss_tpu_torch.track import megakernel as mk

    return [kn for kn in mk.CLUSTER_SIZES if kn == 1 or mk.max_active_clusters(
        dev.index or 0, fused, kn, threads or mk.THREADS_PER_CTA, mk.rank_chunk(win, kn)) >= n_ch]


def in_turns(fn, keys, n: int = 20) -> dict:
    """Device ms per call of ``fn(key)`` for each key, timed in turns
    (keys, then reversed): {key: [first, second]}."""
    out = {k: [] for k in keys}
    for k in [*keys, *reversed(keys)]:
        out[k].append(cuda_ms(lambda: fn(k), n, busy=True))
    return out


def block_resources(log: str) -> dict:
    """{(fused, stage, kN): ptxas resources} of every track_block_kernel
    instantiation in the build log."""
    from softgnss_tpu_torch.scripts.pallas_probe import resources

    out = {}
    for name, res in resources(log).items():
        m = re.search(r"track_block_kernelILb([01])ELi(\d+)ELi(\d+)E", name)
        if m:
            out[(bool(int(m.group(1))), int(m.group(2)), int(m.group(3)))] = res
    return out


def phase_block_kernels(cfg, sig, sc, dev, log: str) -> tuple[dict, dict]:
    """B1 and B3 against their plain versions at every cluster size that
    fits and at PARITY_CHANNELS channels; the capture edges; each size
    and thread count timed in turns at the main path's shapes."""
    import functools

    import torch

    from softgnss_tpu_torch.scripts import mega_vmem_bisect as s2
    from softgnss_tpu_torch.track import megakernel as mk
    from softgnss_tpu_torch.track.scan import capture_words, initial_state
    from softgnss_tpu_torch.track.tables import build_tables

    spc = cfg.samples_per_code
    win = cfg.track_window
    channels = truth_channels(sc, ["T"] * (N_SATS - 1) + ["-"])
    sizes = fitting_sizes(dev, False, N_SATS, win)
    check(sizes == fitting_sizes(dev, True, N_SATS, win), "B1 and B3 fit different sizes")
    chosen, threads = mk.launch_size(dev, False, N_SATS, win)
    check(chosen > 1 and chosen in sizes, f"chosen cluster size {chosen}, fitting {sizes}")
    print(f"  cluster sizes whose {N_SATS} clusters fit at once: {sizes}; chosen {chosen} CTAs "
          f"per channel, {threads} threads each (default {mk.CTAS_PER_CHANNEL})")
    res = block_resources(log)
    for (fused, stage, kn), r in sorted(res.items()):
        print(f"  ptxas track_block_kernel<{str(fused).lower()}, {stage}, {kn}>: "
              f"{r['registers']} registers, {r['smem']} B shared, spills {r['spill_stores']} B "
              f"stored / {r['spill_loads']} B loaded")
    check(all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in res.values()),
          "a track_block_kernel instantiation spills")

    b1_plain, b3_plain = (mk.build_frames_plain, mk.track_block_plain), \
        (None, mk.track_block_fused_plain)
    plains = {}
    worst_b1 = worst_b3 = 0.0
    for kn in sizes:
        b1 = functools.partial(mk.track_block, ctas_per_channel=kn)
        b3 = functools.partial(mk.track_block_fused, ctas_per_channel=kn)
        w1 = hold_against_plain(f"B1 kN={kn}", cfg, sig, channels, (mk.build_frames, b1),
                                b1_plain, plains)
        w3 = hold_against_plain(f"B3 kN={kn}", cfg, sig, channels, (None, b3), b3_plain, plains)
        if kn == chosen:
            worst_b1, worst_b3 = w1, w3
    b1 = functools.partial(mk.track_block, ctas_per_channel=chosen)
    b3 = functools.partial(mk.track_block_fused, ctas_per_channel=chosen)
    for n in PARITY_CHANNELS:
        if n == N_SATS:
            continue                                    # held above
        chans = truth_channels(sc, ["T"] * (n - 1) + ["-"])
        c_plains = {}
        hold_against_plain(f"B1 kN={chosen} C={n}", cfg, sig, chans, (mk.build_frames, b1),
                           b1_plain, c_plains)
        hold_against_plain(f"B3 kN={chosen} C={n}", cfg, sig, chans, (None, b3), b3_plain,
                           c_plains)

    # one full block at the main path's shapes: every channel active
    busy = truth_channels(sc, ["T"] * N_SATS)
    words = capture_words(sig)
    pads = build_tables(busy.prn, dev)
    active = torch.tensor([s == "T" for s in busy.status], device=dev)
    cb = torch.as_tensor(busy.acquired_freq).to(dev)
    st = initial_state(cfg, busy, dev)
    r = cfg.track_block_ms
    start_w = torch.div(st.ptr - cfg.track_frame_pre, 4, rounding_mode="floor")
    frames = mk.build_frames(words, start_w, r, cfg.track_window // 4, spc // 4)
    args = (frames, 4 * start_w, st, pads, cb, active, cfg, r)
    fargs = (words, start_w, st, pads, cb, active, cfg, r)
    # capture edges: frames before its start and past its end read as
    # zeros in B3 as B2 fills them (B2 + B1 on the card, and plain)
    n_words = words.shape[0]
    edge_w = start_w.clone()
    edge_w[0], edge_w[1] = -3, n_words - 2 * (spc // 4)
    st_e = st._replace(ptr=4 * edge_w + cfg.track_frame_pre)
    e_frames = mk.build_frames(words, edge_w, 4, cfg.track_window // 4, spc // 4)
    e_args = (st_e, pads, cb, active, cfg, 4)
    want = mk.track_block_fused_plain(words, edge_w, *e_args)
    for kn in sizes:
        outs = [mk.track_block_fused(words, edge_w, *e_args, ctas_per_channel=kn),
                mk.track_block(e_frames, 4 * edge_w, *e_args, ctas_per_channel=kn), want]
        for got in outs[1:]:
            for x, y in zip(outs[0][1], got[1]):
                check(torch.equal(x, y), f"B3 kN={kn} at the capture edges differs from B2 + B1")
    print(f"  capture edges: B3 bit-equal to B2 + B1 (kernels and plain) at kN in {sizes}")

    # each size at the default threads per CTA, one CTA per channel at its own width
    pairs = [(kn, s2.ONE_CTA_THREADS if kn == 1 else threads) for kn in sizes]
    t_b1 = in_turns(lambda kt: mk.track_block(*args, ctas_per_channel=kt[0],
                                              threads_per_cta=kt[1]), pairs)
    t_b3 = in_turns(lambda kt: mk.track_block_fused(*fargs, ctas_per_channel=kt[0],
                                                    threads_per_cta=kt[1]), pairs)
    # every (cluster size, threads per CTA) whose clusters all fit at once
    grid = [(kn, t) for t in THREAD_SWEEP for kn in fitting_sizes(dev, False, N_SATS, win, t)]
    t_thr = in_turns(lambda kt: mk.track_block(*args, ctas_per_channel=kt[0],
                                               threads_per_cta=kt[1]), grid)
    us = lambda ts: [round(t * 1e3 / r, 4) for t in ts]   # noqa: E731
    for kt in pairs:
        print(f"  [{smi_line()}] kN={kt[0]:2d} x {kt[1]} threads: B1 {us(t_b1[kt])} us per ms, "
              f"B3 {us(t_b3[kt])} us per ms (in turns: {pairs} then reversed; {r}-ms block, "
              f"{N_SATS} ch)")
    for kn, t in grid:
        print(f"  [{smi_line()}] kN={kn:2d}, {t:3d} threads per CTA: B1 {us(t_thr[(kn, t)])} us "
              "per ms")
    best = min(grid, key=lambda kt: np.mean(t_thr[kt]))
    print(f"  fastest B1 launch: {best[0]} CTAs per channel of {best[1]} threads; the default "
          f"is {chosen} of {threads}")
    one = (1, s2.ONE_CTA_THREADS)
    b1_ms, b3_ms = float(np.mean(t_b1[(chosen, threads)])), float(np.mean(t_b3[(chosen, threads)]))
    b1_plain_ms = cuda_ms(lambda: mk.track_block_plain(*args), 3)
    b3_plain_ms = cuda_ms(lambda: mk.track_block_fused_plain(*fargs), 3)
    # the bounds: the samples this block correlates (active channels), the
    # frames (B1) or the capture span (B3) read once, tables and outputs
    samples = int((mk.track_block(*args)[0].ptr - st.ptr)[active].sum())
    n_act = int(active.sum())
    side = n_act * 1025 * 4 + r * N_SATS * 88      # code tables; outputs per (ms, ch)
    b1_bound = block_bound(samples, r * n_act * cfg.track_window + side)
    span_w = (r - 1) * (spc // 4) + cfg.track_window // 4
    b3_bound = block_bound(samples, 4 * union_len(start_w[active].tolist(), span_w, n_words) + side)
    print(f"  block r={r} x {N_SATS} ch at kN={chosen}: B1 {b1_ms:.4f} ms (kN=1 "
          f"{np.mean(t_b1[one]):.4f} ms; plain {b1_plain_ms:.3f} ms, bound {b1_bound[0]:.4f} ms "
          f"by {b1_bound[1]}), B3 {b3_ms:.4f} ms (kN=1 {np.mean(t_b3[one]):.4f} ms; plain: build "
          f"+ track {b3_plain_ms:.3f} ms, bound {b3_bound[0]:.4f} ms by {b3_bound[1]}); "
          f"{samples} samples")
    sweep = {"us_per_ms_by_kn": {f"{k}x{t}": us(v) for (k, t), v in t_b1.items()},
             "us_per_ms_by_kn_threads": {f"{k}x{t}": us(v) for (k, t), v in t_thr.items()}}
    rec_b1 = {**record("B1", "track_block", "track_block.cu",
                       "softgnss_tpu/track/megakernel.py:254", worst_b1, b1_ms, b1_plain_ms,
                       b1_bound, None),
              "ctas_per_channel": chosen, "threads_per_cta": threads,
              "ms_kn1": float(np.mean(t_b1[one])), **sweep}
    rec_b3 = {**record("B3", "track_block_fused", "track_block.cu",
                       "softgnss_tpu/track/megakernel.py:749", worst_b3, b3_ms, b3_plain_ms,
                       b3_bound, None),
              "ctas_per_channel": chosen, "threads_per_cta": threads,
              "ms_kn1": float(np.mean(t_b3[one])),
              "us_per_ms_by_kn": {f"{k}x{t}": us(v) for (k, t), v in t_b3.items()}}
    return rec_b1, rec_b3


def b4_args(cfg, sig, channels, dev) -> tuple:
    """The arguments of one correlate_ms call: the first ms of ``channels``
    at their truth state."""
    import torch

    from softgnss_tpu_torch.signals.nco import CODE_ONE, carrier_step_u32, code_step_q
    from softgnss_tpu_torch.track.scan import initial_state
    from softgnss_tpu_torch.track.tables import build_tables

    st = initial_state(cfg, channels, dev)
    step_q = code_step_q(st.code_freq, cfg.sampling_freq)
    blk = torch.div(cfg.code_length * CODE_ONE - st.code_rem_q + step_q - 1, step_q,
                    rounding_mode="floor")
    w = carrier_step_u32(st.carr_freq, cfg.sampling_freq)
    active = torch.tensor([s == "T" for s in channels.status], device=dev)
    return (cfg, sig, st.ptr, st.carr_phase, w, st.code_rem_q, step_q, blk,
            build_tables(channels.prn, dev), active)


def b4_cases(cfg, sig, sc, dev) -> dict:
    """{label: correlate_ms arguments}: every shape B4 is held bit-equal at."""
    import torch

    from softgnss_tpu_torch import default_config
    from softgnss_tpu_torch.scripts import pallas_ablate as s1

    main = b4_args(cfg, sig, truth_channels(sc, ["T"] * N_SATS), dev)
    edges = list(main)
    edges[2] = main[2].clone()
    edges[2][0] = -777                                  # starts before the capture
    edges[2][1] = sig.shape[0] - 5000                   # runs past its end
    edges[2][2] = sig.shape[0] + 100                    # wholly past it
    idle = list(main)
    idle[9] = torch.zeros_like(main[9])
    one_idle = b4_args(cfg, sig, truth_channels(sc, ["T"] * (N_SATS - 1) + ["-"]), dev)
    cases = {f"C={N_SATS}, all active (the main path's shape)": main,
             f"C={N_SATS}, one idle": one_idle,
             "ptr before the capture, past its end": tuple(edges),
             "every channel idle": tuple(idle),
             f"fs {ODD_FS / 1e6:.3f} MHz, C=8, one idle":
                 s1.ms_args(default_config(sampling_freq=ODD_FS, number_of_channels=8), dev, 1)}
    for c in PARITY_CHANNELS:
        cases[f"C={c}, one idle (seeded capture)"] = s1.ms_args(
            default_config(number_of_channels=c), dev, n_idle=1)
    return cases


#: CTAs per channel B4 is timed at (the plan's 16 at 8 channels among them)
B4_SIZES = (8, 12, 16, 24)
#: ms of the per-ms route under the profiler, and timed with each B4 design
B4_PROFILE_MS = 200
B4_ROUTE_MS = 1000


def warm_per_ms(cfg, sig, channels, dev, correlate):
    """The per-ms route (scan.track_ms) with ``correlate`` as its
    correlator, after 20 ms of warm-up: a function that tracks the next
    ``n`` ms and synchronizes."""
    import torch

    from softgnss_tpu_torch.track.scan import initial_state, track_ms
    from softgnss_tpu_torch.track.tables import build_tables

    pads = build_tables(channels.prn, dev)
    active = torch.tensor([s == "T" for s in channels.status], device=dev)
    cb = torch.as_tensor(channels.acquired_freq).to(dev)
    st, _ = track_ms(cfg, sig, initial_state(cfg, channels, dev), pads, cb, active, 20, 0,
                     correlate)
    torch.cuda.synchronize()

    def run(n: int) -> None:
        track_ms(cfg, sig, st, pads, cb, active, n, 20, correlate)
        torch.cuda.synchronize()

    return run


def per_ms_route_s(cfg, sig, channels, dev, correlate) -> float:
    """Host seconds of B4_ROUTE_MS ms of the per-ms route with
    ``correlate`` as its correlator."""
    run = warm_per_ms(cfg, sig, channels, dev, correlate)
    t0 = time.perf_counter()
    run(B4_ROUTE_MS)
    return time.perf_counter() - t0


def phase_b4(cfg, sig, sc, dev, log: str) -> dict:
    """B4 against its plain version through the per-ms route and call by
    call (bit-equal at every shape of b4_cases, over two launches and two
    replays of a CUDA graph); ptxas's resources of the correlate kernels
    (no spills); B4 and its other designs timed in turns at the main
    path's shapes (device, host and in-graph time per call, each S1 stage,
    each cluster size); one profiler window over the per-ms route."""
    import functools

    import torch

    from softgnss_tpu_torch.scripts import pallas_ablate as s1
    from softgnss_tpu_torch.scripts.pallas_probe import resources
    from softgnss_tpu_torch.scripts.timing import graph_marginal_ms
    from softgnss_tpu_torch.track import pallas_kernel as pk

    channels = truth_channels(sc, ["T"] * (N_SATS - 1) + ["-"])
    worst = hold_against_plain("B4", cfg, sig, channels, ("per_ms", pk.correlate_ms),
                               ("per_ms", pk.correlate_ms_plain))
    for label, a in b4_cases(cfg, sig, sc, dev).items():
        got, want = pk.correlate_ms(*a), pk.correlate_ms_plain(*a)
        check(torch.equal(got, want), f"B4 {label}: differs from the plain version (max abs "
                                      f"diff {float((got - want).abs().max()):.3e})")
        check(torch.equal(pk.correlate_ms(*a), got), f"B4 {label}: two launches differ")
        for v, fn in s1.VARIANTS.items():
            check(torch.equal(fn("full", *a), want), f"S1 {v} full, {label}: differs")
        print(f"  B4 bit-equal to its plain version, twice, {label} "
              f"(plan {tuple(pk.correlate_plan(a[0], a[2].shape[0]))}); S1 "
              f"{'/'.join(s1.VARIANTS)} full too")
    args = b4_args(cfg, sig, truth_channels(sc, ["T"] * N_SATS), dev)
    want = pk.correlate_ms_plain(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pk.correlate_ms(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pk.correlate_ms(*args)
    for rep in range(2):
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(out, want), f"B4 in a CUDA graph, replay {rep}: differs")
    del graph
    print("  B4 captured in a CUDA graph: two replays bit-equal to the plain version")

    res = {k: v for k, v in resources(log).items() if "correlate" in k}
    for k, r in sorted(res.items()):
        print(f"  ptxas {k}: {r['registers']} registers, {r['smem']} B shared, spills "
              f"{r['spill_stores']} B stored / {r['spill_loads']} B loaded")
    check(len(res) >= 9 and all(r["spill_stores"] == 0 and r["spill_loads"] == 0
                                 for r in res.values()), "a correlate kernel spills")
    b4_res = [r for k, r in res.items() if "correlate_ms_kernelILi3E" in k]
    check(len(b4_res) == 1, f"B4's instantiation in the ptxas log: {len(b4_res)}")

    # B4 and its first design, full, in turns: device, host, in a graph
    designs = {"b4": pk.correlate_ms,
               "two_pass": functools.partial(s1.correlate_ms_two_pass, "full")}
    fulls = {v: (lambda f=f: f(*args)) for v, f in designs.items()}
    t_dev = in_turns(lambda v: fulls[v](), list(fulls), 200)
    t_host = {v: host_ms(fulls[v], 200) for v in fulls}
    t_graph = {v: graph_marginal_ms(fulls[v]) for v in fulls}
    for v in fulls:
        print(f"  [{smi_line()}] {v:8s} one ms x {N_SATS} ch: device {us_list(t_dev[v])} us per "
              f"call (in turns), host {t_host[v] * 1e3:.3f} us per wrapper call, in a CUDA graph "
              f"{t_graph[v] * 1e3:.3f} us per call")
    stages = s1.time_stages(args)
    for v, per in stages.items():
        print(f"  [{smi_line()}] S1 {v:8s} stages at the main path's shape, device / host / "
              "graph us: " + "; ".join(
                  f"{s} {t['device'] * 1e3:.3f} / {t['host'] * 1e3:.3f} / {t['graph'] * 1e3:.3f}"
                  for s, t in per.items()))
    sizes = in_turns(lambda kn: s1.correlate_ms_stage("full", *args, ctas_per_channel=kn),
                     list(B4_SIZES), 200)
    for kn in B4_SIZES:
        print(f"  [{smi_line()}] {kn:2d} CTAs per channel "
              f"{tuple(pk.correlate_plan(cfg, N_SATS, kn))}: B4 {us_list(sizes[kn])} us per call")

    t_route = {v: [] for v in designs}
    for v in [*designs, *reversed(designs)]:
        t_route[v].append(per_ms_route_s(cfg, sig, channels, dev, designs[v]))
    print(f"  [{smi_line()}] per-ms route, {B4_ROUTE_MS} ms x {N_SATS} ch (scan.track_ms, host "
          "clock, in turns): " + ", ".join(f"{v} {[round(t, 3) for t in ts]} s"
                                          for v, ts in t_route.items()))
    prof = b4_profile(cfg, sig, channels, dev)
    ms = float(np.mean(t_dev["b4"]))
    plain_ms = cuda_ms(lambda: pk.correlate_ms_plain(*args), 20)
    bound = ms_bound(args[2], args[7], args[9])
    print(f"  one ms x {N_SATS} ch, all active: B4 {ms * 1e3:.3f} us of device time per launch, "
          f"plain {plain_ms:.4f} ms, bound {bound[0] * 1e3:.4f} us ({bound[1]})")
    rec = record("B4", "correlate_ms", "correlate_ms.cu", "softgnss_tpu/track/pallas_kernel.py:98",
                 worst, ms, plain_ms, bound, None)
    rec.update(ms_turns=t_dev["b4"], host_ms=t_host["b4"], graph_ms=t_graph["b4"],
               plan=list(pk.correlate_plan(cfg, N_SATS)), registers=b4_res[0]["registers"],
               designs={v: {"ms": float(np.mean(t_dev[v])), "host_ms": t_host[v],
                            "graph_ms": t_graph[v]} for v in fulls if v != "b4"},
               stages_us={v: {s: {k: t * 1e3 for k, t in st.items()} for s, st in per.items()}
                          for v, per in stages.items()},
               us_by_ctas={kn: us_list(sizes[kn]) for kn in B4_SIZES},
               per_ms_route_s={v: ts for v, ts in t_route.items()}, per_ms_ms=B4_ROUTE_MS,
               per_ms_profile=prof)
    return rec


def us_list(ts) -> list:
    return [round(t * 1e3, 4) for t in ts]


def b4_profile(cfg, sig, channels, dev) -> dict:
    """One torch.profiler window over B4_PROFILE_MS ms of the per-ms route
    (scan.track_ms with B4): every correlate kernel on the card is B4's,
    one launch per ms; the card's idle share."""
    from torch.profiler import ProfilerActivity, profile

    from softgnss_tpu_torch.track import pallas_kernel as pk

    run = warm_per_ms(cfg, sig, channels, dev, pk.correlate_ms)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(B4_PROFILE_MS)
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = device_spans(prof)
    names = {}
    for _, _, n in spans:
        if "correlate" in n:
            names[n] = names.get(n, 0) + 1
    check(len(names) == 1 and "correlate_ms_kernel" in next(iter(names))
          and sum(names.values()) == B4_PROFILE_MS,
          f"per-ms route: correlate kernels on the card {names}, expected one "
          f"correlate_ms_kernel launch per ms ({B4_PROFILE_MS})")
    busy = busy_us(spans)
    out = {"wall_s": wall_us / 1e6, "busy_s": busy / 1e6, "idle_share": 1.0 - busy / wall_us,
           "device_events": len(spans), "correlate_kernels": names}
    print(f"  per-ms route under the profiler, {B4_PROFILE_MS} ms x {len(channels.prn)} ch: "
          f"{out['wall_s']:.3f} s, device busy {out['busy_s'] * 1e3:.3f} ms, idle share "
          f"{out['idle_share']:.4f}, {len(spans)} device events; correlate kernels {names}")
    return out


def ms_bound(ptr, blk, active) -> tuple[float, str]:
    """B4's (and S1's) bound for one ms: the active channels' samples
    [ptr, ptr + blk) read once (blk differs between channels by a sample at
    most: the longest is taken) and correlated, code tables, outputs."""
    act = active.cpu().numpy()
    p, b = ptr.cpu().numpy()[act], blk.cpu().numpy()[act]
    read = union_len(p.tolist(), int(b.max()), 1 << 62) if len(p) else 0
    return block_bound(int(b.sum()), read + int(act.sum()) * 1025 * 4 + act.size * 6 * 4)


def phase_probes(dev, log: str) -> list[dict]:
    """S1-S5 through their modules: each stage, variant, pattern and
    construct (S5 grid and dot in both designs) against its plain version,
    S5's library calls against the same plain versions, ptxas's resources
    of every S5 kernel (no spills), then the timings with the launch counts
    zeroed before and read after."""
    import torch

    from softgnss_tpu_torch import default_config
    from softgnss_tpu_torch.scripts import builder_time as s3
    from softgnss_tpu_torch.scripts import dma_probe as s4
    from softgnss_tpu_torch.scripts import mega_vmem_bisect as s2
    from softgnss_tpu_torch.scripts import pallas_ablate as s1
    from softgnss_tpu_torch.scripts import pallas_probe as s5

    probes = (s1, s2, s3, s4, s5)
    errs = [m.check(dev) for m in probes]
    print("  every S1-S4 stage, variant and load pattern bit-equal to its plain version (S4 at "
          f"every cluster size and its first design); S5 constructs: max |kernel - plain| "
          f"{errs[4]} (grid, each acc design at 1, 2, 3 and {s5.ACC_REPS} reps, each conv and "
          "onehot design on the script's, seeded and receiver inputs, onehot at every warp "
          "count: bit-equal; bdot, dot within the TF32 bound; two launches of dot, bdot, each "
          "acc design and each conv and onehot design bit-equal)")
    print(f"  S5 library calls equal to the plain versions on the script's inputs; max |library "
          f"- plain| {s5.check_library(dev)} (bdot, dot on seeded inputs, TF32 allowed / "
          "default; conv, onehot at the receiver's geometry, sentinels included)")
    s4_res = s4.probe_resources(log)
    s5_res = s5.probe_resources(log)
    ptxas = {**{f"dma_probe_kernel{k}" if k != "cta" else "dma_probe_cta_kernel": r
                for k, r in s4_res.items()},
             **{f"{s5.kernel_of(label)} ({label})": r for label, r in s5_res.items()}}
    for kernel, r in ptxas.items():
        print(f"  ptxas {kernel}: {r['registers']} registers, {r['smem']} B static shared, "
              f"spills {r['spill_stores']} B stored / {r['spill_loads']} B loaded")
    check(all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in ptxas.values()),
          "an S4 or S5 kernel spills")
    reset_launches()
    res = [m.measure(dev) for m in probes]
    launches = read_launches(probes=True)
    check(all(n > 0 for n in launches.values()), f"probe launches {launches}")
    # what the timed launches of dot and bdot were given
    dyn_smem = {"dot": s5.probe_dot.smem_bytes, "bdot": s5.probe_bdot.smem_bytes,
                "onehot": s5.probe_onehot.smem_bytes}
    check(None not in dyn_smem.values(), f"S5: dynamic shared memory recorded {dyn_smem}")
    # onehot's at its default warps (its warp sweep launched other counts last)
    dyn_smem["onehot"] = s5.onehot_plan(s5.RECEIVER_CHANNELS * 2 * s5.N_TILES,
                                        s5.TRACK_TILE).smem_bytes
    for m, r in zip(probes, res):
        m.report(r)
    print(f"  launches {launches}")
    r1, r2, r3, r4, r5 = res
    c = s1.N_CHANNELS[0]
    for label in s5.ACC_LABELS:
        print(f"  S5 {label} per-rep handoff: {r5[label]['step_us']:.4f} us "
              f"({s5.ACC_HANDOFF[label]})")
    s5_targets(r5)

    # the bounds, at the inputs each probe timed (C = 8, r = 64)
    cfg = default_config(number_of_channels=c)
    a1 = s1.ms_args(cfg, dev)
    b_s1 = ms_bound(a1[2], a1[7], a1[9])
    a2 = s2.block_args(cfg, s2.R, dev)
    samples = int((s2.track_block_stage("full", *a2)[0].ptr - a2[2].ptr).sum())
    b_s2 = block_bound(samples, s2.R * c * cfg.track_window + c * 1025 * 4 + s2.R * c * 88)
    a3 = s3.frame_args(c, s3.R, dev)
    b_s3 = frames_bound(*a3)
    lib_s3 = frames_library_ms(*a3)
    cap, starts, r, win, spc = s4.probe_args(c, s4.R, dev)
    span = (r - 1) * spc + win
    b_s4 = bound_ms(union_len((4 * starts).tolist(), span, cap.shape[0]) + r * c * 8, r * c * win)
    torch.cuda.synchronize(dev)
    ms_s4 = {label: float(np.mean(t["warm"])) for label, t in r4["turns"].items()}
    print(f"  S4 direct at kN={s4.CTAS_PER_CHANNEL}: {ms_s4['direct']:.5f} ms per call (first "
          f"design {ms_s4['cta']:.5f}, in turns), bound {b_s4[0]:.5f} ms ({b_s4[1]}): "
          f"{b_s4[0] / ms_s4['direct']:.3f} of it; target 0.02 ms "
          f"{'met' if ms_s4['direct'] <= 0.02 else 'missed'}")

    us = lambda ms, r=1: ms * 1e3 / r   # noqa: E731
    extra = [
        {"us_per_launch": {n: {v: {s: {k: us(t) for k, t in r1[n][v][s].items()}
                                   for s in s1.STAGES} for v in s1.VARIANTS} for n in r1}},
        {"us_per_ms": {f"C={n}/kN={k[0]}x{k[1]}": {s: us(r2[n][k][s], s2.R) for s in s2.STAGES}
                       for n in r2 for k in r2[n] if k != "plain"}},
        {"us_per_ms": {n: {v: {k: us(t, s3.R) for k, t in r3[n][v].items()} for v in s3.VARIANTS}
                       for n in r3}},
        {"us_per_ms": {f"{p}/{d}/kN={kn}": {k: us(t, s4.R) for k, t in r4[(p, d, kn)].items()}
                       for p, d in s4.PATTERNS for kn in s4.KN_SWEEP},
         "ctas_per_channel": s4.CTAS_PER_CHANNEL, "threads_per_cta": s4.THREADS,
         "ms_by_threads": r4["direct_by_threads"], "ms_r1": r4["direct_r1"],
         "ms_turns": r4["turns"]["direct"]["warm"],
         "ms_cold": float(np.mean(r4["turns"]["direct"]["cold"]))},
    ]
    recs = [
        ("S1", "correlate_ms_stage", "correlate_ms.cu", "scripts/pallas_ablate.py:49",
         r1[c]["b4"]["full"]["device"], r1[c]["plain"], b_s1, None),
        ("S2", "track_block_stage", "track_block.cu", "scripts/mega_vmem_bisect.py:45",
         r2[c][s2.launch_sizes(dev, c)[1]]["full"], r2[c]["plain"], b_s2, None),
        ("S3", "build_frames_vec4", "build_frames.cu", "scripts/builder_time.py:60",
         r3[c]["vec4"]["warm"], r3[c]["plain"], b_s3, lib_s3),
        ("S4", "dma_probe", "dma_probe.cu", "scripts/dma_probe.py:34",
         ms_s4["direct"], r4["plain"], b_s4, None),
    ]
    out = [{**record(kid, name, src, rep, err, ms, plain_ms, bound, lib),
            "launches": launches[name], **x}
           for (kid, name, src, rep, ms, plain_ms, bound, lib), err, x in zip(recs, errs, extra)]
    # B4's first design, kept for S1's same-run comparison (its stages are
    # in S1's us_per_launch)
    out.insert(1, {**record("S1", "correlate_ms_two_pass", "correlate_ms.cu",
                            "scripts/pallas_ablate.py:49", errs[0],
                            r1[c]["two_pass"]["full"]["device"], r1[c]["plain"], b_s1, None),
                   "launches": launches["correlate_ms_two_pass"]})
    # S4's first design, timed in turns with direct at kN = 16
    out.append({**record("S4", "dma_probe_cta", "dma_probe.cu", "scripts/dma_probe.py:34",
                         errs[3], ms_s4["cta"], r4["plain"], b_s4, None),
                "launches": launches["dma_probe_cta"], "ms_turns": r4["turns"]["cta"]["warm"],
                "ms_cold": float(np.mean(r4["turns"]["cta"]["cold"]))})
    for label in s5.VARIANTS:
        name = s5.probe_of(label)
        t = r5[label]
        rec = record("S5", f"probe_{label}", "pallas_probe.cu", s5.REPLACES[name], errs[4][label],
                     t["ms"], t["plain_ms"], (t["bound_ms"], t["bound_by"]), t["library_ms"])
        rec.update(launches=launches[f"probe_{label}"], ms_turns=t["ms_turns"],
                   kernel=s5.kernel_of(label), registers=s5_res[label]["registers"],
                   smem=s5_res[label]["smem"])
        if "library_default_ms" in t:     # library_ms: TF32 allowed, as the kernel computes
            rec["library_default_ms"] = t["library_default_ms"]
        if label in dyn_smem:
            rec["dynamic_smem"] = dyn_smem[label]
        if label == "dot":
            rec["ms_steps0"] = t["ms_steps0"]
        if label == "bdot":
            rec["ms_by_warps"] = t["ms_by_warps"]
        if name == "acc":
            rec.update(ms_reps=t["ms_reps"], us_per_rep_step=t["step_us"])
        if name in s5.RECEIVER_PROBES:    # flushed, in a graph, and where it does real work
            rec.update({k: t[k] for k in ("ms_cold", "graph_ms", "library_ms_cold",
                                          "library_graph_ms")},
                       **{case: t[case] for case in s5.RECEIVER_CASES if case in t})
        if label == "acc":                # every design's time and step beside the kept one
            rec["designs"] = {x: {"ms": r5[x]["ms"], "ms_reps": r5[x]["ms_reps"],
                                  "us_per_rep_step": r5[x]["step_us"]} for x in s5.ACC_LABELS}
        out.append(rec)
    return out


def s5_targets(r5: dict) -> None:
    """Print whether S5 onehot and conv met their targets: at the script's
    shape onehot <= 2.6 us and conv within grid's launch floor (<= 2.24
    us); at the receiver's geometry, L2 flushed, onehot <= 3.3 us (half its
    1.65-us bound) and twice as fast as its first design, conv <= 23.5 us
    (half its 11.74-us bound) and no slower than its library call."""
    us = 1e3
    one, walk = r5["onehot"], r5["onehot_walk"]
    conv, loop = r5["conv"], r5["conv_loop"]
    rows = [
        ("onehot, script's shape", one["ms"] * us, 2.6, one["ms"] * us <= 2.6),
        ("conv, script's shape", conv["ms"] * us, 2.24, conv["ms"] * us <= 2.24),
        ("onehot, receiver's geometry, flushed", one["receiver"]["ms_cold"] * us, 3.3,
         one["receiver"]["ms_cold"] * us <= 3.3
         and walk["receiver"]["ms_cold"] >= 2 * one["receiver"]["ms_cold"]),
        ("conv, receiver's geometry, flushed", conv["receiver"]["ms_cold"] * us, 23.5,
         conv["receiver"]["ms_cold"] * us <= 23.5
         and conv["receiver"]["ms_cold"] <= conv["receiver"]["library_ms_cold"]),
    ]
    for what, got, limit, met in rows:
        print(f"  S5 target {what}: {got:.3f} us against {limit} us: {'met' if met else 'missed'}")
    marg = {x: r5[x]["receiver"]["ms_cold_marginal"] * us for x in ("onehot", "onehot_walk",
                                                                     "conv", "conv_loop")}
    print(f"  S5 at the receiver's geometry, flushed: onehot_walk "
          f"{walk['receiver']['ms_cold'] * us:.3f} us, conv_loop "
          f"{loop['receiver']['ms_cold'] * us:.3f} us, conv's library call "
          f"{conv['receiver']['library_ms_cold'] * us:.3f} us; flushed back to back {marg}; "
          f"grid at the script's shape {r5['grid']['ms'] * us:.3f} us")


def check_locked(label, tr, skip_ms: int) -> None:
    """Every channel tracking, its PLL locked (data on I_P) and finite."""
    check(all(s == "T" for s in tr.status) and np.isinf(tr.lock_loss_ms).all(),
          f"{label}: demoted channels: status {tr.status}")
    for ch in range(len(tr.prn)):
        ip = np.abs(tr.i_p[ch, skip_ms:]).mean()
        qp = np.abs(tr.q_p[ch, skip_ms:]).mean()
        check(ip / qp > 4.0, f"{label}: ch {ch} PRN {int(tr.prn[ch])} not phase locked "
                             f"(|I_P|/|Q_P| {ip / qp:.2f})")
    check(all(np.isfinite(getattr(tr, f)).all() for f in
              ("carr_freq", "code_freq", "i_p", "q_p", "sample_frac")),
          f"{label}: non-finite tracking")


def check_fix(label, res, sc) -> dict:
    """The closed-loop bounds of tests/test_end_to_end.py."""
    check(res.has_fix, f"{label}: no position fix")
    for i, prn in enumerate(sc.prns):
        eph = res.ephemerides[prn - 1]
        truth = sc.ephemerides[i]
        check(eph is not None and eph.complete, f"{label}: PRN {prn} ephemeris missing")
        check(abs(eph.sqrt_a - truth.sqrt_a) <= 2.0**-19 and eph.t_oe == truth.t_oe
              and eph.iode_sf2 == truth.iode_sf2, f"{label}: PRN {prn} ephemeris differs")
    sol = res.solutions
    check(sol.tow == sc.tow_count * 6, f"{label}: TOW {sol.tow} != {sc.tow_count * 6}")
    rx = sc.receiver_ecef
    ok = np.isfinite(sol.x)
    err = np.sqrt((sol.x[ok] - rx[0]) ** 2 + (sol.y[ok] - rx[1]) ** 2
                  + (sol.z[ok] - rx[2]) ** 2)
    v = np.sqrt(sol.vx**2 + sol.vy**2 + sol.vz**2)
    out = {"fixed": int(ok.sum()), "epochs": int(sol.n_epochs),
           "err_median_m": float(np.median(err)), "err_mean_m": float(np.mean(err)),
           "v_median_ms": float(np.nanmedian(v))}
    check(ok.sum() >= 0.9 * sol.n_epochs, f"{label}: {out}")
    check(out["err_median_m"] < 30.0 and out["err_mean_m"] < 40.0, f"{label}: {out}")
    check(out["v_median_ms"] < 0.3, f"{label}: {out}")
    print(f"  {label} fix: {out['fixed']}/{out['epochs']} epochs, 3D error median "
          f"{out['err_median_m']:.3f} m, mean {out['err_mean_m']:.3f} m, |v| median "
          f"{out['v_median_ms']:.4f} m/s, TOW {sol.tow:.0f}")
    return out


def report_times(label, res, card: str) -> None:
    spc = res.config.samples_per_code
    n_ms = res.tracking.n_ms
    t_trk = res.timings_s["track"]
    msps = n_ms * spc / t_trk / 1e6
    times = ", ".join(f"{k} {v:.3f} s" for k, v in res.timings_s.items())
    print(f"  [{card}] {label}: {times} ({n_ms} ms: {msps:.1f} capture Msamples/s, "
          f"{msps * len(res.tracking.prn):.1f} channel-Msamples/s)")


def phase_main(cfg, sig, sc, card: str):
    from softgnss_tpu_torch.pipeline import run_receiver

    import torch

    B = cfg.track_block_ms
    n_segments = MAIN_MS // B + (MAIN_MS % B > 0)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = run_receiver(cfg, signal=sig, n_ms=MAIN_MS, navigate=True, device=sig.device)
    launches = read_launches()
    launches["ctas_per_channel"] = cluster_size("main path", "track_block")
    res.peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(res.summary())

    acq = res.acquisition
    injected = set(sc.prns)
    got = set((np.flatnonzero(acq.acquired) + 1).tolist())
    check(injected <= got, f"acquired {sorted(got)}, injected {sorted(injected)}")
    tr = res.tracking
    check(set(tr.prn.tolist()) == injected and len(tr.prn) == N_SATS,
          f"channels hold {sorted(tr.prn.tolist())}")
    # the truth delay is fractional and the acquisition grid has whole
    # samples (37.3 per chip here): hold it to a tenth of a chip
    tol = 0.1 * cfg.sampling_freq / cfg.code_freq_basis
    for i, prn in enumerate(sc.prns):
        d = abs(acq.code_phase[prn - 1] - sc.expected_code_phase(i))
        check(d <= tol, f"PRN {prn}: code phase off by {d:.2f} samples")
        df = abs(acq.carr_freq[prn - 1] - sc.expected_carrier_freq(i))
        check(df < 20.0, f"PRN {prn}: fine freq off by {df:.2f} Hz")
    check(tr.n_ms == MAIN_MS, f"tracked {tr.n_ms} ms")
    check_locked("main path", tr, 2000)
    fix = check_fix("main path", res, sc)
    want = {"build_frames": n_segments, "track_block": n_segments,
            "track_block_fused": 0, "correlate_ms": 0,
            "ctas_per_channel": launches["ctas_per_channel"]}
    check(launches == want, f"kernel launches {launches}, expected {want}")
    print(f"  launches {launches} ({n_segments} segments)")
    report_times("main path (block tracker)", res, card)
    return res, launches, fix


def device_spans(prof) -> list[tuple[float, float, str]]:
    """(start us, end us, name) of every device event of a profile."""
    return [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if str(e.device_type).endswith("CUDA")]


def merged(spans) -> list[tuple[float, float]]:
    """The union of (start, end) spans as sorted disjoint spans."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_us(spans) -> float:
    """Device-busy microseconds: the union of the spans."""
    return sum(b - a for a, b in merged((a, b) for a, b, _ in spans))


def phase_profile(cfg, sig, main, card: str) -> dict:
    """One torch.profiler window over the main path's track stage
    (scan.track over MAIN_MS ms of its channels, as pipeline.run_receiver
    calls it): the card's idle share and each kernel's share of device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from softgnss_tpu_torch.track.scan import track

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        track(cfg, sig, main.channels, n_ms=MAIN_MS)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = device_spans(prof)
    if not spans:
        print(f"  [{card}] the profiler recorded no device time: idle share not measured")
        return {}
    busy = busy_us(spans)
    share = lambda key: sum(b - a for a, b, n in spans if key in n) / busy   # noqa: E731
    out = {"wall_s": wall_us / 1e6, "busy_s": busy / 1e6, "idle_share": 1.0 - busy / wall_us,
           "b1_share": share("track_block_kernel"), "b2_share": share("build_frames_kernel"),
           "device_events": len(spans)}
    out["idle_share_unprofiled"] = 1.0 - out["busy_s"] / main.timings_s["track"]
    # inside the block loop: from the first B1 launch's start to the last one's end
    b1 = [(a, b) for a, b, n in spans if "track_block_kernel" in n]
    lo, hi = min(a for a, _ in b1), max(b for _, b in b1)
    loop = [(max(a, lo), min(b, hi), n) for a, b, n in spans if b > lo and a < hi]
    out["loop_s"] = (hi - lo) / 1e6
    out["loop_idle_share"] = 1.0 - busy_us(loop) / (hi - lo)
    print(f"  [{card}] track stage under the profiler: {out['wall_s']:.3f} s, device busy "
          f"{out['busy_s']:.3f} s, idle share {out['idle_share']:.4f} (against the main path's "
          f"unprofiled {main.timings_s['track']:.3f} s: {out['idle_share_unprofiled']:.4f}); of "
          f"device time B1 {out['b1_share']:.4f}, B2 {out['b2_share']:.4f} ({len(spans)} device "
          f"events); from the first B1 launch to the last: {out['loop_s']:.3f} s, idle share "
          f"{out['loop_idle_share']:.4f}")
    return out


def phase_fused(cfg, sig, main, card: str) -> dict:
    """B3 in place of B2 + B1: every tracking output bit-equal."""
    import torch

    from softgnss_tpu_torch.pipeline import run_receiver

    B = cfg.track_block_ms
    n_segments = MAIN_MS // B + (MAIN_MS % B > 0)
    reset_launches()
    res = run_receiver(cfg.with_options(mega_fused_frames=True), signal=sig, n_ms=MAIN_MS,
                       navigate=False, channels=main.channels, device=sig.device)
    launches = read_launches()
    launches["ctas_per_channel"] = cluster_size("fused", "track_block_fused")
    want = {"build_frames": 0, "track_block": 0, "track_block_fused": n_segments,
            "correlate_ms": 0, "ctas_per_channel": launches["ctas_per_channel"]}
    check(launches == want, f"fused: kernel launches {launches}, expected {want}")
    a, b = res.tracking, main.tracking
    for f in ("absolute_sample", "sample_frac", "code_freq", "carr_freq", "i_p", "i_e", "i_l",
              "q_e", "q_p", "q_l", "dll_discr", "dll_discr_filt", "pll_discr",
              "pll_discr_filt", "lock_loss_ms"):
        check(np.array_equal(getattr(a, f), getattr(b, f)), f"fused: {f} not bit-equal")
    for f, x, y in zip(a.final_state._fields, a.final_state, b.final_state):
        check(torch.equal(x, y), f"fused: final state {f} not bit-equal")
    check(a.status == b.status, "fused: status differs")
    print(f"  launches {launches}; every output bit-equal to the main path")
    report_times("fused (B3)", res, card)
    return launches, res


def phase_per_ms(cfg, sig, sc, main, card: str):
    """The per-ms tracker (B4 + torch filters) with navigation."""
    from softgnss_tpu_torch.pipeline import run_receiver

    reset_launches()
    res = run_receiver(cfg.with_options(correlator_impl="pallas"), signal=sig, n_ms=MAIN_MS,
                       navigate=True, channels=main.channels, device=sig.device)
    launches = read_launches()
    want = {"build_frames": 0, "track_block": 0, "track_block_fused": 0,
            "correlate_ms": MAIN_MS}
    check(launches == want, f"per-ms: kernel launches {launches}, expected {want}")
    a, b = res.tracking, main.tracking
    check_locked("per-ms", a, 2000)
    d_abs = np.abs(a.absolute_sample - b.absolute_sample)
    rms = {f: float(np.sqrt(np.mean((getattr(a, f).astype(np.float64)
                                     - getattr(b, f)) ** 2))
                    / np.sqrt(np.mean(getattr(b, f).astype(np.float64) ** 2)))
           for f in ("i_p", "i_e", "i_l", "q_e", "q_p", "q_l")}
    d_carr = float(np.abs(a.carr_freq - b.carr_freq).max())
    n_ms_diff = int(np.any(np.stack([np.any(getattr(a, f) != getattr(b, f), axis=0)
                                     for f in ("absolute_sample", "i_p", "q_p", "carr_freq",
                                               "code_freq")]), axis=0).sum())
    print(f"  against the block tracker: |absolute_sample| diff max {int(d_abs.max())}, "
          f"correlator rel RMS max {max(rms.values()):.3e}, carr_freq diff max "
          f"{d_carr:.3e} Hz; {n_ms_diff} of {MAIN_MS} ms differ at all")
    check(d_abs.max() <= ROUTE_TOL["absolute_sample"], "per-ms: absolute_sample off")
    check(max(rms.values()) < ROUTE_TOL["corr_rel_rms"], f"per-ms: correlators {rms}")
    check(d_carr < ROUTE_TOL["carr_freq_hz"], f"per-ms: carr_freq off by {d_carr}")
    check_fix("per-ms", res, sc)
    report_times("per-ms (B4)", res, card)
    return launches, res


def phase_stream(cfg, host, main, dev, card: str) -> dict:
    """track_streamed from pinned host memory in STREAM_CHUNK_MS chunks,
    against the main path: every output and the final state bit-equal."""
    import torch

    from softgnss_tpu_torch.parallel import track_streamed

    B = cfg.track_block_ms
    n_segments = MAIN_MS // B + (MAIN_MS % B > 0)
    upload_s = host_ms(lambda: host.to(dev, non_blocking=True), 3) / 1e3
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = track_streamed(cfg, host, main.channels, n_ms=MAIN_MS, chunk_ms=STREAM_CHUNK_MS,
                        device=dev)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launches = read_launches()
    launches["ctas_per_channel"] = cluster_size("stream", "track_block")
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    want = {"build_frames": n_segments, "track_block": n_segments, "track_block_fused": 0,
            "correlate_ms": 0, "ctas_per_channel": launches["ctas_per_channel"]}
    check(launches == want, f"stream: kernel launches {launches}, expected {want}")
    ref = main.tracking
    for f in ("absolute_sample", "sample_frac", "code_freq", "carr_freq", "i_p", "i_e", "i_l",
              "q_e", "q_p", "q_l", "dll_discr", "dll_discr_filt", "pll_discr", "pll_discr_filt"):
        check(np.array_equal(getattr(tr, f), getattr(ref, f)), f"stream: {f} not bit-equal")
    for f, x, y in zip(tr.final_state._fields, tr.final_state, ref.final_state):
        check(torch.equal(x, y), f"stream: final state {f} not bit-equal")
    main_s = main.timings_s["track"]
    print(f"  [{card}] streamed: {MAIN_MS} ms in {STREAM_CHUNK_MS}-ms chunks from pinned host "
          f"memory: track {stream_s:.3f} s, peak device memory {peak_gb:.3f} GB above the "
          f"{base / 1e9:.3f} GB held before it; main path: track {main_s:.3f} s + whole-capture upload {upload_s:.3f} s "
          f"({host.numel() / 1e9:.3f} GB) = {main_s + upload_s:.3f} s, peak device memory "
          f"{main.peak_gb:.3f} GB (capture resident); launches {launches}; every output and "
          "the final state bit-equal to the main path")
    return {"stream_track_s": stream_s, "main_track_s": main_s, "upload_s": upload_s,
            "stream_peak_gb": peak_gb, "main_peak_gb": main.peak_gb}


#: the mesh phase's runs: (shard, {time: n_t, channel: n_c}, navigate)
MESH_RUNS = (("channel", (1, 2), True), ("time-exact", (1, 2), False), ("time", (2, 1), True))
MESH_RANKS = 2
MESH_TIMEOUT_S = 600.0
#: fields of a TrackResults compared across ranks and against the main path
TRACK_FIELDS = ("absolute_sample", "sample_frac", "code_freq", "carr_freq", "i_p", "i_e", "i_l",
                "q_e", "q_p", "q_l", "dll_discr", "dll_discr_filt", "pll_discr",
                "pll_discr_filt")


def loop_spans(prof) -> list[tuple[float, float]]:
    """This process's device-busy spans in absolute ns (the host's realtime
    clock, which every process on the host shares), from its first B2 or B1
    launch's start to its last one's end; empty without such events."""
    spans = [(e.start_ns(), e.end_ns(), e.name()) for e in prof.profiler.kineto_results.events()
             if str(e.device_type()).endswith("CUDA")]
    loop = [(a, b) for a, b, n in spans
            if "track_block_kernel" in n or "build_frames_kernel" in n]
    if not loop:
        return []
    lo, hi = min(a for a, _ in loop), max(b for _, b in loop)
    return merged((max(a, lo), min(b, hi)) for a, b, _ in spans if b > lo and a < hi)


def _mesh_rank(cap_path: str, out_dir: str) -> None:
    """One rank of the mesh phase (parallel.mesh.spawn_world, every rank on
    cuda:0): run_receiver over the capture file for each of MESH_RUNS under
    torch.profiler window each (CUDA activity only: the host's navigation
    ops would swamp it); every rank writes its launches, times, device-busy
    spans and a digest of its tracking, rank 0 its whole results."""
    import hashlib
    import pickle

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from softgnss_tpu_torch import default_config
    from softgnss_tpu_torch.parallel import make_mesh
    from softgnss_tpu_torch.pipeline import run_receiver

    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = default_config()
    report = {}
    for shard, (n_t, n_c), navigate in MESH_RUNS:
        mesh = make_mesh({cfg.time_axis: n_t, cfg.channel_axis: n_c})
        reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res = run_receiver(cfg, file_name=cap_path, n_ms=MAIN_MS, navigate=navigate,
                               mesh=mesh, shard=shard, device=dev)
        launches = read_launches()
        tr = res.tracking
        tr.final_state = type(tr.final_state)(*[v.cpu() for v in tr.final_state])
        digest = hashlib.sha256()
        for f in TRACK_FIELDS:
            digest.update(np.ascontiguousarray(getattr(tr, f)).tobytes())
        for v in tr.final_state:
            digest.update(v.numpy().tobytes())
        report[shard] = {"launches": launches, "timings_s": res.timings_s,
                         "busy_ns": loop_spans(prof), "digest": digest.hexdigest(),
                         "device": str(dev)}
        if rank == 0:
            with open(f"{out_dir}/{shard}.pkl", "wb") as f:
                pickle.dump(res, f)
        dist.barrier()
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(report, f)


def phase_mesh(host, main, sc, card: str) -> dict:
    """The distribution layer with 2 ranks sharing one card: the capture
    written to a file once, then run_receiver under channel, time-exact and
    time sharding in one gloo world, and the CLI under torch.distributed.run."""
    import os
    import pickle
    import subprocess
    import tempfile

    import torch

    from softgnss_tpu_torch.parallel.mesh import spawn_world

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cap = os.path.join(tmp, "capture.bin")
        t0 = time.perf_counter()
        host.numpy().tofile(cap)
        print(f"  capture written to a file: {host.numel() / 1e9:.3f} GB in "
              f"{time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        spawn_world(_mesh_rank, MESH_RANKS, (cap, tmp), device="cuda", timeout=MESH_TIMEOUT_S)
        world_s = time.perf_counter() - t0
        reports = []
        for r in range(MESH_RANKS):
            with open(f"{tmp}/rank{r}.json") as f:
                reports.append(json.load(f))
        runs = {}
        for shard, _, _ in MESH_RUNS:
            with open(f"{tmp}/{shard}.pkl", "rb") as f:     # written by this script's rank 0
                runs[shard] = pickle.load(f)

        ref = main.tracking
        ref_state = [v.cpu() for v in ref.final_state]
        for shard, (n_t, n_c), _ in MESH_RUNS:
            label = f"mesh {n_t}x{n_c} {shard}"
            res, tr = runs[shard], runs[shard].tracking
            for r, rep in enumerate(reports):
                check(rep[shard]["digest"] == reports[0][shard]["digest"],
                      f"{label}: rank {r}'s tracking differs from rank 0's")
                ln = rep[shard]["launches"]
                check(ln["build_frames"] > 0 and ln["track_block"] > 0,
                      f"{label}: rank {r} launches {ln}")
            acq = res.acquisition
            check(np.array_equal(acq.code_phase, main.acquisition.code_phase)
                  and np.all(np.abs(acq.carr_freq - main.acquisition.carr_freq)
                             < main.config.acq_doppler_step_hz / 2),
                  f"{label}: acquisition differs")
            acq_equal = all(np.array_equal(getattr(acq, f), getattr(main.acquisition, f))
                            for f in ("carr_freq", "code_phase", "peak_metric"))
            if shard == "channel":
                for f in TRACK_FIELDS + ("lock_loss_ms",):
                    check(np.array_equal(getattr(tr, f), getattr(ref, f)),
                          f"{label}: {f} not bit-equal to the main path")
                for f, x, y in zip(tr.final_state._fields, tr.final_state, ref_state):
                    check(torch.equal(x, y), f"{label}: final state {f} not bit-equal")
                check(tr.status == ref.status, f"{label}: status differs")
                verdict = "every output and the final state bit-equal to the main path"
            elif shard == "time-exact":
                for f in ("absolute_sample", "sample_frac"):
                    check(np.array_equal(getattr(tr, f), getattr(ref, f)),
                          f"{label}: {f} not bit-equal")
                check(np.array_equal(np.sign(tr.i_p), np.sign(ref.i_p)), f"{label}: i_p signs")
                for i, f in ((0, "ptr"), (2, "code_rem_q")):
                    check(torch.equal(tr.final_state[i], ref_state[i]),
                          f"{label}: final state {f} not bit-equal")
                diff = max(float(np.max(np.abs(getattr(tr, f) - getattr(ref, f))))
                           for f in ("code_freq", "carr_freq", "dll_discr_filt",
                                     "pll_discr_filt"))
                verdict = (f"integer observables, i_p signs, ptr and code_rem_q bit-equal; "
                           f"largest float64 stream difference {diff:.3e}")
            else:
                d_abs = int(np.abs(tr.absolute_sample - ref.absolute_sample).max())
                check(d_abs <= 1, f"{label}: absolute_sample off by {d_abs}")
                agree = float(np.min(np.mean(np.sign(tr.i_p[:, 50:]) == np.sign(ref.i_p[:, 50:]),
                                             axis=1)))
                check(agree > 0.99, f"{label}: nav-bit sign agreement {agree}")
                out["time_fix"] = check_fix(label, res, sc)
                verdict = (f"absolute_sample within {d_abs}, nav-bit sign agreement >= "
                           f"{agree:.5f} past 50 ms")
            # the union of the ranks' kernel spans: an upper bound of the card's
            # busy time, since under time slicing a kernel's span also covers
            # the slices the card gave the other rank's context (the ranks'
            # sums overlap: 1.69-1.89 of the window on an H100)
            spans = [tuple(v) for rep in reports for v in rep[shard]["busy_ns"]]
            track_s = [rep[shard]["timings_s"]["track"] for rep in reports]
            share = "not measured (no device events)"
            if all(rep[shard]["busy_ns"] for rep in reports):
                window = max(b for _, b in spans) - min(a for a, _ in spans)
                share = f"{sum(b - a for a, b in merged(spans)) / window:.4f}"
            print(f"  [{card}] {label}, 2 ranks sharing one card: track stage "
                  f"{', '.join(f'{t:.3f}' for t in track_s)} s per rank, card busy share "
                  f"(union of the ranks' kernel spans, an upper bound) from the ranks' first "
                  f"B2 launch to their last B1 end {share}; launches per rank "
                  f"{[rep[shard]['launches'] for rep in reports]}; acquisition "
                  f"{'bit-equal' if acq_equal else 'same code phase and Doppler bin'} to "
                  f"the main path's; {verdict}")
            out[shard] = {"track_s": track_s, "busy_share": share, "acq_bit_equal": acq_equal}
        print(f"  world of {MESH_RANKS} ranks: {world_s:.3f} s (spawn, three runs)")

        # the CLI under torch.distributed.run, rank 0's fix against the channel run's
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(MESH_RANKS), "-m", "softgnss_tpu_torch.cli",
               "--file", cap, "--mesh", f"1x{MESH_RANKS}"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=MESH_TIMEOUT_S)
        cli_s = time.perf_counter() - t0
        print("\n".join("  | " + ln for ln in proc.stdout.splitlines() if ln.strip()))
        check(proc.returncode == 0,
              f"torchrun cli: exit {proc.returncode}\n{proc.stderr[-4000:]}")
        m = re.search(r"Mean ECEF position: (\S+) (\S+) (\S+) m", proc.stdout)
        check(m is not None, "torchrun cli: no fix")
        sol = runs["channel"].solutions
        want = np.array([np.nanmean(sol.x), np.nanmean(sol.y), np.nanmean(sol.z)])
        d = float(np.max(np.abs(np.array([float(v) for v in m.groups()]) - want)))
        check(d <= 1e-3, f"torchrun cli: fix {m.groups()} against {want}")
        print(f"  [{card}] {' '.join(cmd[1:])}: exit 0 in {cli_s:.3f} s, 2 ranks sharing one "
              f"card; rank 0's mean fix within {d:.1e} m of the channel-sharded run's")
        out["cli_s"] = cli_s
    return out


#: the oracle phase: ms of the main path's tracking held to the float64
#: oracle, and the capture it reads (the acquisition window and slack)
ORACLE_MS = 1000
ORACLE_CAPTURE_MS = 1020
#: parity_check's channel counts
PARITY_CHECK_CHANNELS = (3, 12)


def phase_oracle(cfg, host, routes, sc, dev, card: str) -> dict:
    """The float64 NumPy oracle (softgnss_tpu_torch.oracle) against the
    main path's acquisition (code phase and Doppler bin equal), its three
    tracking routes over the first ORACLE_MS ms of the closed-loop capture
    (absolute_sample within +-1 and the oracle's nav-bit signs; each
    figure of the North-star bounds printed) and its navigation
    (tests/test_oracle_parity.py's bounds on integer observables); then
    scripts.oracle_check's three satellites on the North-star bounds and
    scripts.parity_check at PARITY_CHECK_CHANNELS, which launch B1-B4 (the
    launches returned)."""
    from softgnss_tpu_torch.oracle import oracle_acquire_grid
    from softgnss_tpu_torch.scripts import oracle_check, parity_check
    from softgnss_tpu_torch.scripts.scenarios import PARITY_KNOBS, nav_parity

    main = routes["block (B2 + B1)"]
    spc = cfg.samples_per_code
    sig = host[:ORACLE_CAPTURE_MS * spc].numpy()
    acq = main.acquisition
    window = sig[cfg.skip_samples: cfg.skip_samples + cfg.acquisition_ms * spc]
    t0 = time.perf_counter()
    for prn in sc.prns:
        _, phase, doppler_bin, metric = oracle_acquire_grid(cfg, window, prn)
        check(acq.code_phase[prn - 1] == phase and acq.doppler_bin[prn - 1] == doppler_bin,
              f"oracle: PRN {prn}: acquisition at code phase {acq.code_phase[prn - 1]}, bin "
              f"{acq.doppler_bin[prn - 1]}; the oracle's {phase}, {doppler_bin}")
        print(f"  PRN {prn:2d}: code phase {phase} and Doppler bin {doppler_bin} "
              f"({cfg.doppler_bin_freqs[doppler_bin]:.0f} Hz) equal to the oracle's; peak "
              f"metric {acq.peak_metric[prn - 1]:.3f}, the oracle's {metric:.3f}")
    acq_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    logs = oracle_check.oracle_logs(cfg, sig, main.channels, ORACLE_MS)
    track_s = time.perf_counter() - t0
    ora_signs = np.sign(np.stack([log["i_p"] for log in logs]))[:, 50:]
    for label, res in routes.items():
        # on this 53-dB-Hz capture two closed loops of the same math part by
        # more than the North-star bounds (the JAX package's tracker parts from
        # the oracle as far: ROADMAP C.8), so it is held to the +-1-sample
        # envelope and the oracle's nav-bit signs; the bounds themselves are
        # held on oracle_check's capture below
        figures = oracle_check.deviation(res.tracking, logs, ORACLE_MS)
        agree = float(np.min(np.mean(
            np.sign(res.tracking.i_p[:, 50:ORACLE_MS]) == ora_signs, axis=1)))
        check(figures["absolute_sample"] <= oracle_check.BOUNDS["absolute_sample"],
              f"oracle: {label}: absolute_sample off by {figures['absolute_sample']}")
        check(agree > 0.99, f"oracle: {label}: nav-bit sign agreement {agree}")
        print(f"  [{card}] {label}, {len(logs)} channels x {ORACLE_MS} ms against the oracle: "
              f"{oracle_check.describe(figures)}; worst channel "
              f"{max(figures['per_channel_rms']):.2e}; I_P signs agree past 50 ms: >= "
              f"{agree:.5f}")
    print(f"  oracle host time: acquisition {acq_s:.3f} s ({len(sc.prns)} PRNs), tracking "
          f"{track_s:.3f} s ({len(logs)} channels x {ORACLE_MS} ms)")
    t0 = time.perf_counter()
    nav = nav_parity(cfg.with_options(**PARITY_KNOBS), main.tracking)
    print(f"  [{card}] post_navigate against oracle_navigate on the main path's {MAIN_MS}-ms "
          f"integer observables ({time.perf_counter() - t0:.3f} s): {nav}")

    reset_launches()
    t0 = time.perf_counter()
    for route, figures in oracle_check.run(dev).items():
        print(f"  [{card}] oracle_check {route:10s}: {oracle_check.describe(figures)}")
    for c in PARITY_CHECK_CHANNELS:
        for label, figures in parity_check.run(c, dev).items():
            print(f"  [{card}] parity_check {parity_check.describe(c, label, figures)}")
    launches = read_launches()
    blocks = -(-oracle_check.N_MS // cfg.track_block_ms) + 2 * -(-parity_check.N_MS
                                                              // cfg.track_block_ms)
    want = {"build_frames": blocks, "track_block": blocks, "track_block_fused": blocks,
            "correlate_ms": oracle_check.N_MS + 2 * parity_check.N_MS}
    check(launches == want, f"oracle: kernel launches {launches}, expected {want}")
    print(f"  oracle_check and parity_check: {time.perf_counter() - t0:.3f} s, launches "
          f"{launches}")
    return launches


def phase_scenarios(dev, card: str) -> dict:
    """Every closed-loop scenario of softgnss_tpu_torch.scripts.scenarios
    on the card (fast_config, 37 000 ms, the block tracker): the JAX
    suite's bounds; each one's seconds, figures and B2 / B1 launches.
    Returns the launches summed over the scenarios."""
    from softgnss_tpu_torch.scripts import scenarios

    cfg = scenarios.scenario_config()
    n_segments = -(-scenarios.N_MS // cfg.track_block_ms)
    total = dict.fromkeys(read_launches(), 0)
    for name, fn in scenarios.SCENARIOS.items():
        reset_launches()
        t0 = time.perf_counter()
        figures = fn(device=dev)
        seconds = time.perf_counter() - t0
        launches = read_launches()
        want = {"build_frames": n_segments, "track_block": n_segments, "track_block_fused": 0,
                "correlate_ms": 0}
        check(launches == want, f"scenario {name}: kernel launches {launches}, expected {want}")
        total = {k: total[k] + v for k, v in launches.items()}
        shown = ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                          for k, v in figures.items())
        print(f"  [{card}] {name}: {seconds:.3f} s; B2 {launches['build_frames']}, B1 "
              f"{launches['track_block']} launches; {shown}")
    return total


def phase_ekf(cfg, main, sc, card: str, save_dir: str | None = None) -> dict:
    """The EKF fix on the main path's tracking; with ``save_dir``, that
    tracking (a checkpoint either package loads) and the truth position are
    written there, for tests/nav_checkpoint_parity.py."""
    from softgnss_tpu_torch.nav.solve import post_navigate
    from softgnss_tpu_torch.pipeline import save_tracking

    if save_dir is not None:
        save_tracking(f"{save_dir}/main_track.npz", main.tracking)
        np.save(f"{save_dir}/main_truth_ecef.npy", np.asarray(sc.receiver_ecef))
    t0 = time.perf_counter()
    sol, _ = post_navigate(cfg.with_options(nav_filter="ekf"), main.tracking)
    nav_s = time.perf_counter() - t0
    check(sol is not None and sol.nav_filter == "ekf", "ekf: no solution")
    rx = sc.receiver_ecef
    err = lambda x, y, z: np.sqrt((x - rx[0]) ** 2 + (y - rx[1]) ** 2 + (z - rx[2]) ** 2)  # noqa: E731
    e_kf = err(sol.x, sol.y, sol.z)
    e_ls = err(sol.lsq_x, sol.lsq_y, sol.lsq_z)
    fixed = int(np.isfinite(sol.x).sum())
    tail = slice(2 * sol.n_epochs // 3, None)
    out = {"fixed": fixed, "epochs": int(sol.n_epochs), "ekf_median_m": float(np.nanmedian(e_kf)),
           "lsq_median_m": float(np.nanmedian(e_ls)), "navigate_s": nav_s,
           "ekf_tail_median_m": float(np.nanmedian(e_kf[tail])),
           "lsq_tail_median_m": float(np.nanmedian(e_ls[tail]))}
    check(fixed >= 0.9 * sol.n_epochs and out["ekf_median_m"] < 30.0, f"ekf: {out}")
    print(f"  [{card}] EKF: {fixed}/{sol.n_epochs} epochs fixed, 3D error median "
          f"{out['ekf_median_m']:.3f} m (its least-squares columns {out['lsq_median_m']:.3f} m); "
          f"last third {out['ekf_tail_median_m']:.3f} m (least squares "
          f"{out['lsq_tail_median_m']:.3f} m); navigate {nav_s:.3f} s (main path, least "
          f"squares: {main.timings_s['navigate']:.3f} s)")
    return out


def phase_cli(card: str) -> dict:
    """The CLI in process at default_config(), on the card, streamed, EKF."""
    from softgnss_tpu_torch import cli

    argv = ["--synthetic", "--stream", "--set", "nav_filter=ekf"]
    buf = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    launches["ctas_per_channel"] = cluster_size("cli", "track_block")
    out = buf.getvalue()
    print("\n".join("  | " + ln for ln in out.splitlines() if ln.strip()))
    m = re.search(r"3D error vs injected truth: mean ([0-9.]+) m", out)
    check(rc == 0 and m is not None, f"cli: exit {rc}, no 3D error line")
    mean_m = float(m.group(1))
    check(mean_m < 30.0, f"cli: 3D error mean {mean_m} m")
    check("PVT (EKF)" in out, "cli: the solution is not the EKF's")
    check(launches["build_frames"] > 0 and launches["track_block"] > 0
          and launches["build_frames"] == launches["track_block"], f"cli: launches {launches}")
    print(f"  [{card}] python -m softgnss_tpu_torch.cli {' '.join(argv)}: exit {rc}, 3D error "
          f"mean {mean_m} m, {wall_s:.3f} s in process; launches {launches}")
    return {"wall_s": wall_s, "err_mean_m": mean_m, "launches": launches}


def phase_front_end(dev, card: str) -> dict:
    """'auto' at a front end with samples_per_code % 4 != 0."""
    from softgnss_tpu_torch import default_config
    from softgnss_tpu_torch.pipeline import run_receiver
    from softgnss_tpu_torch.signals.synth import synthesize_signal

    cfg = default_config(sampling_freq=ODD_FS)
    check(cfg.samples_per_code % 4 != 0 and cfg.tracker == "per_ms",
          f"front end: spc {cfg.samples_per_code}, tracker {cfg.tracker}")
    sats = make_scenario(cfg)
    sig = synthesize_signal(cfg, sats, ODD_MS + cfg.acquisition_ms + 2, noise_std=NOISE_STD,
                            seed=SEED, device=dev)
    reset_launches()
    res = run_receiver(cfg, signal=sig, n_ms=ODD_MS, navigate=False, device=dev)
    launches = read_launches()
    want = {"build_frames": 0, "track_block": 0, "track_block_fused": 0,
            "correlate_ms": ODD_MS}
    check(launches == want, f"front end: kernel launches {launches}, expected {want}")
    tr = res.tracking
    check(set(tr.prn.tolist()) == {s.prn for s in sats}, f"front end: channels {tr.prn}")
    check_locked("front end", tr, 300)
    by_prn = {s.prn: s for s in sats}
    for ch, prn in enumerate(tr.prn):
        ferr = abs(float(np.median(tr.carr_freq[ch, 300:])) - cfg.intermediate_freq
                   - by_prn[prn].doppler_hz)
        check(ferr < 2.0, f"front end: ch {ch} PRN {prn}: carr_freq error {ferr:.3f} Hz")
    print(f"  fs {ODD_FS / 1e6:.3f} MHz, samples_per_code {cfg.samples_per_code}: "
          f"{len(tr.prn)} channels locked; launches {launches}")
    report_times("front end (per-ms)", res, card)
    return launches


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="On-card smoke test of softgnss_tpu_torch")
    parser.add_argument("--save-tracking", metavar="DIR",
                        help="also write the main path's tracking checkpoint and the truth "
                             "position to DIR (tests/nav_checkpoint_parity.py reads them)")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    from softgnss_tpu_torch import default_config
    from softgnss_tpu_torch.scenario import build_scenario, synthesize_scenario
    from softgnss_tpu_torch.signals.synth import amplitude_for_cn0
    from softgnss_tpu_torch.track import megakernel as mk

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with phase("card"):
        name = torch.cuda.get_device_name(0)
        card = smi_line()
        print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}")
        print(card)
    with phase("build"):
        from softgnss_tpu_torch import native

        lib = mk.load_library()
        print(f"  nvcc build {lib.build_s:.2f} s -> {lib.path}")
        for line in lib.log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("  " + line.strip())
        print(f"  native IO library (packed formats, probe statistics): "
              f"{'used' if native.used() else 'not built: io takes its NumPy versions'}")
    with phase("nco"):
        phase_nco(dev)
    cfg = default_config()
    with phase("B2 vs plain"):
        rec_b2 = phase_b2(cfg, dev)
    with phase("synthesize"):
        sc = build_scenario(cfg, n_sats=N_SATS, noise_std=NOISE_STD,
                            amplitude=amplitude_for_cn0(cfg, SCENARIO_CN0_DBHZ, NOISE_STD))
        sig = synthesize_scenario(sc, CAPTURE_MS, seed=SEED, device=dev)
        torch.cuda.synchronize()
        print(f"  {CAPTURE_MS} ms, {sig.numel() / 1e9:.3f} GB int8 on {name}; PRNs "
              f"{sc.prns}, C/N0 {SCENARIO_CN0_DBHZ} dB-Hz")
    with phase("B1 and B3 vs plain"):
        rec_b1, rec_b3 = phase_block_kernels(cfg, sig, sc, dev, lib.log)
    with phase("B4 vs plain"):
        rec_b4 = phase_b4(cfg, sig, sc, dev, lib.log)
    with phase("probes"):
        rec_probes = phase_probes(dev, lib.log)
    with phase("main path"):
        main_res, launches, _ = phase_main(cfg, sig, sc, card)
    with phase("profile"):
        phase_profile(cfg, sig, main_res, card)
    with phase("fused"):
        fused_launches, fused_res = phase_fused(cfg, sig, main_res, card)
    with phase("per-ms"):
        per_ms_launches, per_ms_res = phase_per_ms(cfg, sig, sc, main_res, card)
    host = torch.empty(sig.shape, dtype=sig.dtype, pin_memory=True)
    host.copy_(sig)
    del sig
    with phase("stream"):
        phase_stream(cfg, host, main_res, dev, card)
    with phase("mesh"):
        phase_mesh(host, main_res, sc, card)
    with phase("oracle"):
        oracle_launches = phase_oracle(
            cfg, host, {"block (B2 + B1)": main_res, "fused (B3)": fused_res,
                        "per-ms (B4)": per_ms_res}, sc, dev, card)
    del host, fused_res, per_ms_res
    with phase("front end"):
        phase_front_end(dev, card)
    with phase("ekf"):
        phase_ekf(cfg, main_res, sc, card, args.save_tracking)
    with phase("cli"):
        phase_cli(card)
    with phase("scenarios"):
        scenario_launches = phase_scenarios(dev, card)
    # each kernel's launches on its paths: the main path (B2, B1), the fused
    # (B3) and per-ms (B4) routes, the oracle phase and the scenarios
    rec_b2["launches"] = (launches["build_frames"] + oracle_launches["build_frames"]
                          + scenario_launches["build_frames"])
    rec_b1["launches"] = (launches["track_block"] + oracle_launches["track_block"]
                          + scenario_launches["track_block"])
    rec_b3["launches"] = fused_launches["track_block_fused"] + oracle_launches["track_block_fused"]
    rec_b4["launches"] = per_ms_launches["correlate_ms"] + oracle_launches["correlate_ms"]
    print(json.dumps({"kernels": [rec_b2, rec_b1, rec_b3, rec_b4, *rec_probes]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
