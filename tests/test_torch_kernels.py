"""The port's tracking kernels, build_frames (B2), track_block (B1),
track_block_fused (B3) and correlate_ms (B4), without the JAX package:
this file imports only torch, numpy and softgnss_tpu_torch (and, for the
benchmark cells' captures, gnss_bench's generator), so it also runs on the
card's machine, which has no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

On the CPU the wrappers run their plain versions; the ``gpu`` tests
compare the CUDA kernels with those plain versions, B1 and B3 at every
cluster size (``ctas_per_channel``) and at 3 and 12 channels, and at the
benchmark cells' front ends with 8 channels (also on ragged ms spans and
a zero code row, on both paths of the sample loop), and skip without a
card.  The CPU tests pin the premises of B1's sample loop: its sine, its
chip indices and its walk over the window's words.
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import softgnss_tpu_torch as sgt
from softgnss_tpu_torch.acquire.search import Channels
from softgnss_tpu_torch.signals.synth import SatelliteSignal, synthesize_signal
from softgnss_tpu_torch.track import megakernel as mk
from softgnss_tpu_torch.track import pallas_kernel as pk
from softgnss_tpu_torch.track import scan

torch.set_num_threads(1)


def test_build_frames_zero_fill():
    """Words before the capture start or past its end come back as 0."""
    cap = torch.arange(1, 101, dtype=torch.int32)
    frames = mk.build_frames(cap, torch.tensor([-3, 90]), 2, 8, 5)
    want = np.zeros((2, 2, 8), np.int32)
    for j in range(2):
        for c, s in enumerate((-3, 90)):
            for i in range(8):
                k = s + 5 * j + i
                want[j, c, i] = k + 1 if 0 <= k < 100 else 0
    np.testing.assert_array_equal(frames.numpy(), want)


REPO = Path(__file__).resolve().parent.parent
#: ``default_config`` options of the benchmark cells' front ends
#: (gnss_bench/configs): SoftGNSS's 38.192-MHz data set and its second,
#: 16.3676-MHz one
FRONT_ENDS = {"ref38": {},
              "giove16": {"sampling_freq": 16_367_600.0, "intermediate_freq": 4_130_400.0}}


def _scenario(device, n_ch: int = 3, ms: int = 100, seed: int = 4, front: str = "fast"):
    """Three satellites on ``n_ch`` channels (each satellite on every third
    channel), the second channel idle; an ``ms``-long capture, at the fast
    front end with 16-ms blocks.  At a benchmark cell's front end
    (``front``, a key of ``FRONT_ENDS``: 64-ms blocks), :func:`_cell_scenario`."""
    if front != "fast":
        return _cell_scenario(device, n_ch, ms, seed, front)
    cfg = sgt.fast_config(number_of_channels=n_ch, track_block_ms=16)
    sats = [SatelliteSignal(prn=p, doppler_hz=d, delay_samples=float(s), phase0=ph,
                            amplitude=2.0, nav_bits=(1, -1, -1, 1))
            for p, d, s, ph in ((5, 1200.0, 333, 0.4), (11, -2500.0, 1777, 2.1),
                                (20, 400.0, 40, 5.0))]
    sig = synthesize_signal(cfg, sats, ms, noise_std=4.0, seed=seed, device=device)
    on = [sats[i % 3] for i in range(n_ch)]
    ch = Channels(prn=np.asarray([s.prn for s in on]),
                  acquired_freq=np.asarray([cfg.intermediate_freq + s.doppler_hz for s in on]),
                  code_phase=np.asarray([int(s.delay_samples) for s in on], np.int64),
                  status=["T", "-"] + ["T"] * (n_ch - 2))
    return cfg, sig, ch


def _cell_scenario(device, n_ch: int, ms: int, seed: int, front: str):
    """A capture of the cells' ``obs`` traffic at ``front``'s front end,
    ``n_ch`` satellites, each on its channel at the truth, the second
    channel idle.  gnss_bench's generator makes it: the port's synthesizer
    takes whole-kHz sampling rates only, and giove16's is not one."""
    from gnss_bench import generator

    cfg = sgt.default_config(number_of_channels=n_ch, **FRONT_ENDS[front])
    traffic = json.loads((REPO / "gnss_bench" / "traffic" / "obs.json").read_text())
    front_end = {"sampling_freq": cfg.sampling_freq, "intermediate_freq": cfg.intermediate_freq,
                 "ms_to_process": ms}
    scene = generator.draw_scene(front_end, {**traffic, "n_sats": n_ch}, seed)
    sig = generator.synthesize(scene, device)
    ch = Channels(prn=scene.prn, acquired_freq=scene.carrier_hz(),
                  code_phase=np.floor(scene.delay_samples).astype(np.int64),
                  status=["T", "-"] + ["T"] * (n_ch - 2))
    return cfg, sig, ch


def _counts():
    return (mk.build_frames.launches, mk.track_block.launches,
            mk.track_block_fused.launches, pk.correlate_ms.launches)


def test_plain_path_counts_no_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    cfg, sig, ch = _scenario("cpu")
    before = _counts()
    res = scan.track(cfg, sig, ch, n_ms=40)
    assert _counts() == before
    assert np.all(res.i_p[1] == 0) and np.any(res.i_p[0] != 0)


@pytest.mark.parametrize("route", [{"mega_fused_frames": True},
                                   {"correlator_impl": "pallas"}], ids=["fused", "per_ms"])
def test_plain_routes_count_no_launches(route):
    """The fused and per-ms trackers on CPU tensors: plain versions only."""
    cfg, sig, ch = _scenario("cpu")
    before = _counts()
    res = scan.track(cfg.with_options(**route), sig, ch, n_ms=40)
    assert _counts() == before
    assert np.all(res.i_p[1] == 0) and np.any(res.i_p[0] != 0)


def test_correlate_ms_plain_reads_the_capture():
    """B4's plain version sums [ptr, ptr + blk) of the capture, zero past
    its ends and for idle channels."""
    cfg, sig, ch = _scenario("cpu")
    st = scan.initial_state(cfg, ch)
    pads = scan.build_tables(ch.prn)
    w = torch.zeros(3, dtype=torch.int32)                     # carrier at 0 turns: sin 0, cos 1
    step = torch.full((3,), 1 << 40, dtype=torch.int64)       # one chip per sample
    blk = torch.tensor([1023, 1023, 10])
    ptr = torch.tensor([0, 5, sig.shape[0] - 4])               # the last one runs past the end
    act = torch.tensor([True, False, True])
    out = pk.correlate_ms_plain(cfg, sig, ptr, st.carr_phase, w, st.code_rem_q, step, blk,
                                pads, act)
    from softgnss_tpu_torch.signals.nco import sin_turns

    q = (sin_turns(torch.tensor(0.25)) * sig.to(torch.float32)).to(torch.float64)
    prompt = pads[0, :1023].to(torch.float64)                       # ceil(k) -> chip k
    assert out.dtype == torch.float32 and out.shape == (3, 6)
    assert float(out[0, 4]) == float((prompt * q[:1023]).sum().to(torch.float32))
    assert not out[1].any() and not out[:, :3].any()               # idle; sin(0) = 0
    assert float(out[2, 4]) == float((pads[2, :4].to(torch.float64) * q[-4:]).sum()
                                     .to(torch.float32))


_FRONT_ENDS = {"default": sgt.default_config(),
               "odd_38194": sgt.default_config(sampling_freq=38_194_000.0),
               "fast": sgt.fast_config()}


@pytest.mark.parametrize("name", list(_FRONT_ENDS))
def test_correlate_plan_covers_the_window(name):
    """B4's launch plan covers samples_per_code + track_window_extra at any
    alignment of ptr in one pass, one 4-sample word per thread, within the
    kernel's limits (64 CTAs per channel, 1024 threads in warps, 512 staged
    vectors), with at most one CTA per SM of an H100 where it can."""
    cfg = _FRONT_ENDS[name]
    window = cfg.samples_per_code + cfg.track_window_extra
    for n_ch in (1, 3, 8, 12, 40):
        plan = pk.correlate_plan(cfg, n_ch)
        assert plan.ctas_per_channel * plan.samples_per_cta >= window + pk.VECTOR - 1
        assert (plan.ctas_per_channel - 1) * plan.vectors_per_cta < -(-(window + 15) // 16)
        if plan.threads < pk.MAX_THREADS:       # else a thread takes two words
            assert plan.samples_per_cta <= plan.threads * pk.SAMPLES_PER_THREAD < (
                plan.samples_per_cta + 32 * pk.SAMPLES_PER_THREAD)
        assert plan.threads % 32 == 0 and plan.threads <= pk.MAX_THREADS
        assert 1 <= plan.ctas_per_channel <= 64 and plan.vectors_per_cta <= 512
        assert plan.samples_per_cta >= 32 * pk.SAMPLES_PER_THREAD     # a warp's worth
        fewest = -(-(window + 15) // 16 // 512)
        assert n_ch * plan.ctas_per_channel <= max(pk.SMS, n_ch * (fewest + 1))
    if name != "fast":
        assert pk.correlate_plan(cfg, 8) == (16, 608, 150)
        assert pk.correlate_plan(cfg, 12).ctas_per_channel == 11
        assert pk.correlate_plan(cfg, 40) == (5, 1024, 478)
        assert pk.correlate_plan(cfg, 8, 12) == (12, 800, 200)


@pytest.mark.parametrize("case", ["no channels", "fs 200 MHz", "0 CTAs", "65 CTAs"])
def test_correlate_plan_refuses_shapes_past_its_limits(case):
    cfg, n_ch, kn = sgt.default_config(), 8, None
    if case == "no channels":
        n_ch = 0
    elif case == "fs 200 MHz":      # 200 000 samples per ms: more than 8 x 512 vectors
        cfg, kn = sgt.default_config(sampling_freq=200e6), 8
    else:
        kn = int(case.split()[0])
    with pytest.raises(ValueError, match="correlate_ms"):
        pk.correlate_plan(cfg, n_ch, kn)


def test_correlate_scratch_is_allocated_once():
    """B4's float64 rows and tickets come from one allocation per device and
    shape, never one per call: 16-byte aligned rows (the last CTA copies
    them by 16-byte cp.async) and tickets that start at zero."""
    rows, tickets = pk.scratch(torch.device("cpu"), 8, 16)
    again = pk.scratch(torch.device("cpu"), 8, 16)
    assert again[0] is rows and again[1] is tickets
    assert rows.shape == (8, 16, 6) and rows.dtype == torch.float64
    assert rows.data_ptr() % 16 == 0 and (6 * 8) % 16 == 0
    assert tickets.shape == (8,) and not tickets.any()


def _vector_cut(address: int, p0: int, n: int, n_cap: int, plan) -> list:
    """The window samples k that correlate_ms_kernel's threads correlate,
    in the kernel's own index arithmetic (csrc/correlate_ms.cu): 16-byte
    vectors on the capture's address grid, rank r's [r vpc, (r+1) vpc) then
    every kn vpc on, staged; thread t's 4-sample words t, t + threads, ...,
    lanes [lo, hi) in the window and the capture."""
    kn, vpc, threads = plan.ctas_per_channel, plan.vectors_per_cta, plan.threads
    head = (address + p0) % 16
    n_vec = (head + n + 15) // 16 if n > 0 else 0
    got = []
    for rank in range(kn):
        v0 = rank * vpc
        while v0 < n_vec:
            nv = min(vpc, n_vec - v0)
            s_base = p0 - head + 16 * v0
            assert (address + s_base) % 16 == 0          # every copy 16-byte aligned
            for tid in range(threads):
                for i in range(4 * tid, 16 * nv, 4 * threads):
                    s0 = s_base + i
                    k0 = s0 - p0
                    lo, hi = max(-k0, -s0, 0), min(n - k0, n_cap - s0, 4)
                    got.extend(k0 + j for j in range(lo, hi))
            v0 += kn * vpc
    return got


@pytest.mark.parametrize("address, p0, n, n_cap", [
    (0x7F0000000000, 0, 38_200, 10**6),          # aligned
    (0x7F0000000000, 13, 38_201, 10**6),         # odd ptr
    (0x7F0000000007, 1000, 38_194, 10**6),       # unaligned capture
    (0x7F0000000000, -21, 38_192, 10**6),        # before the capture
    (0x7F0000000000, 10**6 - 500, 38_192, 10**6),  # past its end
    (0x7F0000000000, 3, 3 * 38_200, 10**6),      # longer than one pass
])
def test_correlate_vector_cut_takes_each_sample_once(address, p0, n, n_cap):
    """Every sample of [ptr, ptr + blk) inside the capture is correlated by
    exactly one lane, and nothing else, at any alignment and length."""
    plan = pk.correlate_plan(sgt.default_config(), 8)
    got = _vector_cut(address, p0, n, n_cap, plan)
    want = [k for k in range(n) if 0 <= p0 + k < n_cap]
    assert len(got) == len(want) and sorted(got) == want


def test_code_tables_hold_only_signs_or_zeros():
    """B1 reads each chip as an exact sign: every row ``build_tables``
    makes holds only -1.0 and +1.0 (PRNs 1-32: the padded code) or only
    0.0 (PRN 0: an idle channel), so a chip times a float32 sample is the
    sample, its negation or a zero, and csrc/track_block.cu converts each
    sample to float64 once and not once per correlator."""
    from softgnss_tpu_torch.signals import ca
    from softgnss_tpu_torch.track.tables import build_tables

    pads = build_tables(np.arange(33))
    assert pads.dtype == torch.float32 and pads.shape == (33, 1025)
    assert not pads[0].any()
    assert bool(((pads[1:] == 1.0) | (pads[1:] == -1.0)).all())
    for prn in range(1, 33):
        np.testing.assert_array_equal(pads[prn].numpy(), ca.padded_code(prn))


def _sin_turns_unit(x: torch.Tensor) -> torch.Tensor:
    """csrc/track_block.cu's ``sin_turns_unit``, one float32 operation at a
    time: the floor of x + 0.5 by a comparison, each fold by a min or max."""
    x = x - torch.where(x + 0.5 >= 1.0, 1.0, 0.0).to(torch.float32)
    x = torch.minimum(x, 0.5 - x)
    x = torch.maximum(x, -0.5 - x)
    t2 = x * x
    return x * (6.2831853071795860
                + t2 * (-41.341702240399755
                        + t2 * (81.60524927607504
                                + t2 * (-76.70585975306136 + t2 * 42.05869394489765))))


@pytest.mark.parametrize("offset", [0.0, 0.25], ids=["sin", "cos"])
def test_sin_turns_unit_is_sin_turns_at_every_carrier_phase(offset):
    """B1's sine is valid for x in [0, 1.25] only: at each of the 2^23
    phases the carrier NCO's mantissa trick makes (turns in [0, 1)), and at
    turns + 0.25 (the cosine), it gives sin_turns's float32 bits."""
    from softgnss_tpu_torch.signals.nco import sin_turns

    turns = (torch.arange(1 << 23, dtype=torch.int32) | 0x3F800000).view(torch.float32) - 1.0
    x = turns + offset
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.25
    assert torch.equal(_sin_turns_unit(x).view(torch.int32), sin_turns(x).view(torch.int32))


@pytest.mark.parametrize("spacing", [0.5, 0.25, 0.3, 1.5])
def test_chip_index_from_the_phase_less_one(spacing):
    """B1's general path takes each of E, P and L as floor((q - 1) / 2^40)
    + 1 of q = tq - h, tq and tq + h (an arithmetic shift of the phase less
    one; the one is the table's offset), clamped to [0, 1024]: the chip
    ceil_chip_index(q) gives, at any spacing h (at 0.3 chips h has its low
    32 bits set), at random phases and on and beside every chip edge.  Its
    short path (h = 2^39, half a chip) takes E and P from the high word of
    the phase less one and L as the chip after E."""
    from softgnss_tpu_torch.signals.nco import ceil_chip_index, chips_to_q

    h = chips_to_q(spacing)
    rng = np.random.default_rng(22)
    edges = torch.arange(-3, 1027, dtype=torch.int64) << 40
    tq = torch.cat([torch.tensor(rng.integers(-(3 << 40), 1026 << 40, 200_000)),
                    *(edges + d for d in (-h - 1, -h, -h + 1, -1, 0, 1, h - 1, h, h + 1))])
    for d in (-h, 0, h):
        want = ceil_chip_index(tq + d).clamp(0, 1024).to(torch.int64)
        got = ((tq - 1 + d) >> 40).clamp(-1, 1023) + 1
        assert torch.equal(got, want), d
    if h == mk.HALF_CHIP_Q:
        # the short path, where E's chip lies in [0, 1023]: E and P from
        # the high word of the phase less one, L the chip after E
        gh = (tq - 1) >> 32
        e = ((gh - 128) >> 8) + 1
        inside = (e >= 0) & (e <= 1023)
        assert int(inside.sum()) > 100_000
        for got, d in ((e, -h), ((gh >> 8) + 1, 0), (e + 1, h)):
            assert torch.equal(got[inside], ceil_chip_index(tq + d)[inside].to(torch.int64)), d


def _word_walk(lo_r: int, hi_r: int, lo_c: int, hi_c: int, o: int, blk: int, threads: int,
               cp: int, w: int, rem: int, step: int):
    """What B1's sample loop sums in one ms of one rank, in the kernel's
    own arithmetic (csrc/track_block.cu): window indices [lo, hi), one
    4-byte word a thread a step, the edge words' other bytes masked, the
    NCO counts and the Q40 phase less one advanced by addition.  Returns
    (lo, hi, [(index, counts, phase less one)] of every unmasked byte)."""
    lo, hi = max(lo_r, o, lo_c), min(hi_r, o + blk, hi_c)
    v_end = (hi + 3) >> 2 if hi > lo else 0
    got = []
    for tid in range(threads):
        v = (lo >> 2) + tid
        k0 = 4 * v - o
        counts, g = (cp + w * k0) % 2**32, rem + step * k0 - 1
        while v < v_end:
            i0, mask = 4 * v, 0xFFFFFFFF
            if i0 < lo or i0 + 4 > hi:
                a, b = max(lo - i0, 0), min(hi - i0, 4)
                mask = (0xFFFFFFFF >> (8 * (4 - b + a))) << (8 * a) & 0xFFFFFFFF
            got.extend((i0 + s, (counts + s * w) % 2**32, g + s * step)
                       for s in range(4) if (mask >> (8 * s)) & 0xFF)
            v += threads
            counts, g = (counts + w * 4 * threads) % 2**32, g + step * 4 * threads
    return lo, hi, got


def _slice_case(front: str, kn: int, rank: int, threads: int, o: int, extra: int = 0):
    cfg = sgt.default_config(**FRONT_ENDS.get(front, {})) if front != "fast" else \
        sgt.fast_config()
    lo_r, hi_r = mk.rank_slices(cfg.track_window, kn)[rank]
    return lo_r, hi_r, 0, cfg.track_window, o, cfg.samples_per_code + extra, threads


#: (lo_r, hi_r, lo_c, hi_c, o, blk, threads) of one rank's ms
WALKS = {
    "ref38-kN16-first": _slice_case("ref38", 16, 0, 256, 37),
    "ref38-kN16-last-mid-word": _slice_case("ref38", 16, 15, 256, 34, 1),
    "giove16-kN16-shorter-than-a-step": _slice_case("giove16", 16, 7, 512, 31),
    "giove16-kN16-last": _slice_case("giove16", 16, 15, 256, 30, 1),
    "fast-kN16": _slice_case("fast", 16, 3, 256, 29),
    "ref38-one-CTA": _slice_case("ref38", 1, 0, 512, 35),
    "B3-capture-edges": (0, 2400, 8, 1202, 3, 38_192, 256),
    "empty": (2400, 4800, 0, 38_320, 37, 2000, 256),
}


@pytest.mark.parametrize("case", list(WALKS))
def test_sample_loop_takes_each_sample_once(case):
    """B1's word loop sums every sample of the rank's share of the ms span
    inside the source exactly once and no other, with the very NCO counts
    (cp + w k mod 2^32) and code phase (rem + step k) that the products
    give, k = index - o: spans starting and ending mid-word, a share
    shorter than one step of the CTA, a ragged last step, B3's capture
    edges and an empty share."""
    lo_r, hi_r, lo_c, hi_c, o, blk, threads = WALKS[case]
    cp, w = 0x9E3779B9, 0xC2B2AE35          # carrier counts wrap within a ms
    rem, step = 123_456_789_012, 29_450_922_427
    lo, hi, got = _word_walk(lo_r, hi_r, lo_c, hi_c, o, blk, threads, cp, w, rem, step)
    assert sorted(i for i, _, _ in got) == list(range(lo, hi))
    assert (hi > lo) == (case != "empty")
    for i, counts, g in got:
        assert counts == (cp + w * (i - o)) % 2**32 and g == rem + step * (i - o) - 1


def test_overflow_is_flagged():
    """A frame that cannot hold its ms span is reported, never silent."""
    cfg, sig, ch = _scenario("cpu")
    words = scan.capture_words(sig)
    st = scan.initial_state(cfg, ch)
    start_w = torch.div(st.ptr, 4, rounding_mode="floor") + 40     # frames start late
    frames = mk.build_frames(words, start_w, 4, cfg.track_window // 4,
                             cfg.samples_per_code // 4)
    _, _, ovf = mk.track_block(frames, 4 * start_w, st, scan.build_tables(ch.prn),
                               torch.as_tensor(ch.acquired_freq),
                               torch.ones(3, dtype=torch.bool), cfg, 4)
    assert int(ovf.min()) > 0
    with pytest.raises(RuntimeError, match="overflowed"):
        scan._check_overflow(ovf)
    scan._check_overflow(torch.zeros(3, dtype=torch.int64))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are also checked by chip_smoke.py)")
    return torch.device("cuda")


#: B1's options besides the default: pdi_ms accumulate-and-hold, the FLL,
#: the carrier-aided DLL and a narrower correlator spacing
VARIANT = {"pdi_ms": 4, "fll_bandwidth_hz": 10.0, "carrier_aided_dll": True,
           "dll_correlator_spacing": 0.25}
#: (front end, channels, CTAs per channel) of the card tests: at the fast
#: front end every cluster size at 3 channels, and 12 channels at the sizes
#: that hold 12 clusters (16 may not: then its clusters run in waves); at
#: each benchmark cell's front end its 8 channels at B1's launch plan
SIZES = ([("fast", 3, kn) for kn in mk.CLUSTER_SIZES] + [("fast", 12, 8), ("fast", 12, 16)]
         + [(front, 8, mk.CTAS_PER_CHANNEL) for front in FRONT_ENDS])
SIZE_IDS = [f"C{c}-kN{k}" if f == "fast" else f"{f}-C{c}-kN{k}" for f, c, k in SIZES]
#: (ms, capture ms) of the two calls, the second resuming the first: at
#: the fast front end (16-ms blocks) each has a lead, full blocks and a
#: tail; at a cell's (64-ms blocks) the first is a tail, the second a lead,
#: one full block and a tail
LENGTHS = {"fast": ((37, 43), 100), "cell": ((37, 93), 140)}


def _lengths(front: str):
    return LENGTHS["fast" if front == "fast" else "cell"]


@pytest.mark.gpu
@pytest.mark.parametrize("front, n_ch, kn", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("opts", [{}, VARIANT], ids=["default", "variant"])
def test_kernels_match_plain_on_card(cuda_device, opts, front, n_ch, kn):
    """B2 + B1 at ``kn`` CTAs per channel of B1's threads against their
    plain versions on the card, through the segment loop (lead segment
    included), inactive channel included."""
    (n1, n2), ms = _lengths(front)
    cfg, sig, ch = _scenario(cuda_device, n_ch, ms=ms, front=front)
    cfg = cfg.with_options(**opts)
    words = scan.capture_words(sig)
    pads = scan.build_tables(ch.prn, cuda_device)
    active = torch.tensor([s == "T" for s in ch.status], device=cuda_device)
    cb = torch.as_tensor(ch.acquired_freq).to(cuda_device)
    outs = []
    for build, block in ((mk.build_frames, functools.partial(mk.track_block,
                                                             ctas_per_channel=kn)),
                         (mk.build_frames_plain, mk.track_block_plain)):
        st = scan.initial_state(cfg, ch, cuda_device)
        st, ys1, ov1 = scan.track_segments(cfg, words, st, pads, cb, active, n1, 0,
                                           build, block)
        st, ys2, ov2 = scan.track_segments(cfg, words, st, pads, cb, active, n2, n1,
                                           build, block)
        assert int(torch.maximum(ov1, ov2).max()) == 0
        outs.append([torch.cat(p).cpu().numpy() for p in zip(ys1, ys2)] +
                    [v.cpu().numpy() for v in st])
    for f, a, b in zip(scan.MsOutputs._fields + scan.TrackState._fields, *outs):
        np.testing.assert_array_equal(a, b, err_msg=f)
    torch.cuda.synchronize()


def _segments_then_resume(cfg, sig, ch, dev, build, block, lengths=(37, 43)):
    words = scan.capture_words(sig)
    pads = scan.build_tables(ch.prn, dev)
    active = torch.tensor([s == "T" for s in ch.status], device=dev)
    cb = torch.as_tensor(ch.acquired_freq).to(dev)
    st = scan.initial_state(cfg, ch, dev)
    n1, n2 = lengths
    if build == "per_ms":
        st, ys1 = scan.track_ms(cfg, sig, st, pads, cb, active, n1, 0, block)
        st, ys2 = scan.track_ms(cfg, sig, st, pads, cb, active, n2, n1, block)
    else:
        st, ys1, ov1 = scan.track_segments(cfg, words, st, pads, cb, active, n1, 0,
                                           build, block)
        st, ys2, ov2 = scan.track_segments(cfg, words, st, pads, cb, active, n2, n1,
                                           build, block)
        assert int(torch.maximum(ov1, ov2).max()) == 0
    return ([torch.cat(p).cpu().numpy() for p in zip(ys1, ys2)]
            + [v.cpu().numpy() for v in st])


#: B3 at every size of SIZES, at the default options and, at the cells'
#: front ends, the variant; B4 at the fast front end
CASES = ([("B3", f, c, k, {}) for f, c, k in SIZES]
         + [("B3", f, c, k, VARIANT) for f, c, k in SIZES if f != "fast"]
         + [("B4", "fast", 3, None, {})])
CASE_IDS = ([f"B3-{i}" for i in SIZE_IDS]
            + [f"B3-{i}-variant" for (f, _, _), i in zip(SIZES, SIZE_IDS) if f != "fast"]
            + ["B4"])


@pytest.mark.gpu
@pytest.mark.parametrize("kernel, front, n_ch, kn, opts", CASES, ids=CASE_IDS)
def test_fused_and_per_ms_kernels_match_plain_on_card(cuda_device, kernel, front, n_ch, kn,
                                                      opts):
    """B3 at ``kn`` CTAs per channel (bit-equal, as the B2 + B1 pair it
    fuses) and B4 (the per-ms tracker through it: absolute_sample equal,
    correlators within 1e-4 of the plain version's RMS) on the card, with
    a resume and an idle channel."""
    lengths, ms = _lengths(front)
    cfg, sig, ch = _scenario(cuda_device, n_ch, ms=ms, front=front)
    cfg = cfg.with_options(**opts)
    fused = functools.partial(mk.track_block_fused, ctas_per_channel=kn)
    assert pk.correlate_plan(cfg, n_ch).ctas_per_channel > 1
    pair, plain = (((None, fused), (None, mk.track_block_fused_plain))
                   if kernel == "B3" else
                   (("per_ms", pk.correlate_ms), ("per_ms", pk.correlate_ms_plain)))
    got = _segments_then_resume(cfg, sig, ch, cuda_device, *pair, lengths=lengths)
    want = _segments_then_resume(cfg, sig, ch, cuda_device, *plain, lengths=lengths)
    fields = scan.MsOutputs._fields + scan.TrackState._fields
    for f, a, b in zip(fields, got, want):
        if kernel == "B3" or f == "absolute_sample":
            np.testing.assert_array_equal(a, b, err_msg=f)
        elif f in ("i_p", "i_e", "i_l", "q_e", "q_p", "q_l"):
            assert np.abs(a - b).max() <= 1e-4 * np.sqrt(np.mean(b.astype(np.float64) ** 2)), f
    torch.cuda.synchronize()


#: (CTAs per channel, threads per CTA) of the ragged-span card test: B1's
#: launch, 512 threads at 16 CTAs (giove16's 1 040-byte share is 260
#: words, fewer than a CTA's threads), 8 CTAs and one CTA
RAGGED_SIZES = [(16, 256), (16, 512), (8, 256), (1, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("front", list(FRONT_ENDS))
@pytest.mark.parametrize("kn, threads", RAGGED_SIZES,
                         ids=[f"kN{k}x{t}" for k, t in RAGGED_SIZES])
@pytest.mark.parametrize("spacing", [0.5, 0.3], ids=["spacing0.5", "spacing0.3"])
def test_block_kernels_on_ragged_spans_and_a_zero_code_row_on_card(cuda_device, front, kn,
                                                                   threads, spacing):
    """B1 and B3 bit-equal to their plain versions over a 64-ms block where
    each channel's pointer sits 0-3 samples past a word (its ms spans start
    and end at every offset within a word), a rank's share can be shorter
    than a CTA's step, an active channel's code row is all zeros (each
    chip times a sample is then a zero) and a channel is idle; at the
    spacing of both cells, counted on the loop's short path, and at 0.3
    chips, counted on its general path."""
    cfg, sig, ch = _scenario(cuda_device, 6, ms=140, front=front)
    cfg = cfg.with_options(dll_correlator_spacing=spacing)
    r = cfg.track_block_ms
    words = scan.capture_words(sig)
    pads, cb, active = scan.channel_tables(ch, cuda_device)
    pads[5] = 0.0                                   # active, its code row all zeros
    st = scan.initial_state(cfg, ch, cuda_device)
    st = st._replace(ptr=st.ptr + torch.tensor([0, 1, 2, 3, 1, 2], device=cuda_device))
    start_w = torch.div(st.ptr - cfg.track_frame_pre, 4, rounding_mode="floor")
    frames = mk.build_frames_plain(words, start_w, r, cfg.track_window // 4,
                                   cfg.samples_per_code // 4)
    size = {"ctas_per_channel": kn, "threads_per_cta": threads}
    tail = (st, pads, cb, active, cfg, r)
    want = mk.track_block_plain(frames, 4 * start_w, *tail)
    assert int(want[2].max()) == 0 and bool(active[5]) and not bool(active[1])
    assert bool(want[1].i_p[:, 5].eq(0).all()) and bool(want[1].i_p[:, 0].ne(0).any())
    wrappers = (mk.track_block, mk.track_block_fused)
    before = [(w.short_launches, w.general_launches) for w in wrappers]
    for got in (mk.track_block(frames, 4 * start_w, *tail, **size),
                mk.track_block_fused(words, start_w, *tail, **size)):
        for name, a, b in zip(scan.TrackState._fields + scan.MsOutputs._fields + ("overflow",),
                              [*got[0], *got[1], got[2]], [*want[0], *want[1], want[2]]):
            assert torch.equal(a, b), name
    torch.cuda.synchronize()
    one = (1, 0) if spacing == 0.5 else (0, 1)
    assert [(w.short_launches - s, w.general_launches - g)
            for w, (s, g) in zip(wrappers, before)] == [one, one]


def _b4_args(dev, n_ch: int, cfg=None, n_idle: int = 1):
    """One ms of every channel of a seeded capture (the probes' inputs)."""
    from softgnss_tpu_torch.scripts.pallas_ablate import ms_args

    return ms_args(cfg or sgt.default_config(number_of_channels=n_ch), dev, n_idle=n_idle)


def _assert_b4_bit_equal(args):
    got = pk.correlate_ms(*args)
    want = pk.correlate_ms_plain(*args)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want), float((got - want).abs().max())
    assert torch.equal(pk.correlate_ms(*args), got)         # a second launch: the same bits
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("n_ch", [3, 8, 12])
def test_correlate_ms_bit_equal_on_card(cuda_device, n_ch):
    """B4, one launch per call, bit-equal to its plain version at the
    reference front end with one idle channel, over two launches."""
    before = pk.correlate_ms.launches
    _assert_b4_bit_equal(_b4_args(cuda_device, n_ch))
    assert pk.correlate_ms.launches == before + 2
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["edges", "one idle", "all idle", "odd front end"])
def test_correlate_ms_edge_cases_on_card(cuda_device, case):
    """ptr before the capture and past its end (partly and wholly), idle
    channels (their rows zero), and the 38.194-MHz front end, whose windows
    start at any alignment."""
    if case == "odd front end":
        args = _b4_args(cuda_device, 8, sgt.default_config(sampling_freq=38_194_000.0,
                                                           number_of_channels=8))
    else:
        args = list(_b4_args(cuda_device, 8, n_idle=0))
        n_cap = args[1].shape[0]
        if case == "edges":
            args[2] = args[2].clone()
            args[2][:4] = torch.tensor([-777, -38_000, n_cap - 5000, n_cap + 3], device=cuda_device)
        else:
            args[9] = torch.zeros_like(args[9])
            if case == "one idle":
                args[9][1:] = True
    got = _assert_b4_bit_equal(tuple(args))
    assert not got[~args[9]].any()
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_correlate_ms_in_a_cuda_graph_on_card(cuda_device):
    """B4 captured in a CUDA graph (nothing in the wrapper synchronizes or
    allocates scratch): two replays give the plain version's bits."""
    args = _b4_args(cuda_device, 8)
    want = pk.correlate_ms_plain(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pk.correlate_ms(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pk.correlate_ms(*args)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


#: the block routes whose full blocks replay a CUDA graph on the card
GRAPH_ROUTES = {"B2+B1": (mk.build_frames, mk.track_block), "B3": (None, mk.track_block_fused)}


def _calls(cfg, sig, ch, build, block, calls):
    """``scan.track_segments`` over ``calls`` ms, each call resuming the
    last: [(final state, outputs, overflow)] of each call, on the card."""
    words = scan.capture_words(sig)
    tables = scan.channel_tables(ch, sig.device)
    st, start, out = scan.initial_state(cfg, ch, sig.device), 0, []
    for n in calls:
        st, ys, ovf = scan.track_segments(cfg, words, st, *tables, n, start, build, block)
        out.append((st, ys, ovf))
        start += n
    return out


def _leaves(calls) -> list:
    return [v for st, ys, ovf in calls for v in (*st, *ys, ovf)]


def _assert_bit_equal(got, want):
    names = [f"call {i}: {f}" for i in range(len(got))
             for f in scan.TrackState._fields + scan.MsOutputs._fields + ("overflow",)]
    for name, a, b in zip(names, _leaves(got), _leaves(want), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(GRAPH_ROUTES))
def test_graph_route_is_bit_equal_to_the_eager_route_on_card(cuda_device, route):
    """Full blocks replayed from a CUDA graph against the same kernels
    issued block by block (the wrapper wrapped, so that no graph engages):
    every output leaf, the final state and the overflow of a first call (2
    full blocks and a 5-ms tail) and a resumed one (an 11-ms lead, 7 full
    blocks, a 7-ms tail), an idle channel among four; each kernel launch
    counted once per segment either way, on the sample loop's short path."""
    cfg, sig, ch = _scenario(cuda_device, 4, ms=200)
    build, block = GRAPH_ROUTES[route]

    def eager(*args, **kwargs):
        return block(*args, **kwargs)

    runs = {}
    for label, fn in (("graph", block), ("eager", eager)):
        before = (scan.track_segments.graph_blocks, block.launches, block.short_launches)
        runs[label] = _calls(cfg, sig, ch, build, fn, (37, 130))
        torch.cuda.synchronize()
        runs[label + " counts"] = (scan.track_segments.graph_blocks - before[0],
                                   block.launches - before[1],
                                   block.short_launches - before[2])
    assert block.ctas_per_channel > 1
    assert runs["graph counts"] == (1 + 6, 3 + 9, 3 + 9)     # the short path, replays counted
    assert runs["eager counts"] == (0, 3 + 9, 3 + 9)
    assert all(int(ovf.max()) == 0 for _, _, ovf in runs["graph"])
    _assert_bit_equal(runs["graph"], runs["eager"])


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(GRAPH_ROUTES))
def test_graph_results_survive_the_next_call_on_card(cuda_device, route):
    """Two calls on different captures back to back: the first call's
    outputs and state, kept on the card, are unchanged by the second (no
    alias of a graph's memory, no stale pointer), and each call is
    bit-equal to the eager route's; the second capture takes no new memory
    from the card."""
    build, block = GRAPH_ROUTES[route]

    def eager(*args, **kwargs):
        return block(*args, **kwargs)

    scenes = [_scenario(cuda_device, 4, ms=200, seed=seed) for seed in (4, 9)]
    first = _calls(*scenes[0], build, block, (130,))
    kept = [v.clone() for v in _leaves(first)]
    reserved = torch.cuda.memory_reserved()
    second = _calls(*scenes[1], build, block, (130,))
    torch.cuda.synchronize()
    assert torch.cuda.memory_reserved() == reserved     # the capture reused the pool's memory
    for a, b in zip(_leaves(first), kept, strict=True):
        assert torch.equal(a, b)
    _assert_bit_equal(first, _calls(*scenes[0], build, eager, (130,)))
    _assert_bit_equal(second, _calls(*scenes[1], build, eager, (130,)))
    assert not torch.equal(first[0][1].i_p, second[0][1].i_p)
