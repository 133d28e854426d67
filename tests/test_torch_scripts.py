"""The port's measurement probes (softgnss_tpu_torch.scripts, S1-S5).

On the CPU each stage's and variant's plain version is held against the
JAX package's own building blocks on the same samples (the NCOs of
softgnss_tpu.signals.nco, megakernel.build_frames in interpret mode) or
against numpy, at ``fast_config()``; the ``full`` stages are the receiver's
plain versions themselves.  S5's plain versions are held against the TPU
script's own kernel bodies (scripts/pallas_probe.py) run by
``pl.pallas_call(..., interpret=True)`` with the script's BlockSpecs.  The
``gpu`` tests hold every stage, variant, load pattern and construct
kernel against its plain version on a card; they import no JAX, so they
also run on the card's machine:

    python -m pytest --noconftest -m gpu tests/test_torch_scripts.py
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import softgnss_tpu_torch as sgt
from softgnss_tpu_torch.scripts import builder_time as s3
from softgnss_tpu_torch.scripts import dma_probe as s4
from softgnss_tpu_torch.scripts import mega_vmem_bisect as s2
from softgnss_tpu_torch.scripts import pallas_ablate as s1
from softgnss_tpu_torch.scripts import pallas_probe as s5
from softgnss_tpu_torch.scripts import timing
from softgnss_tpu_torch.track import megakernel as mk
from softgnss_tpu_torch.track import pallas_kernel as pk
from softgnss_tpu_torch.track.scan import MsOutputs, TrackState

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
R = 12          # ms per block in the B1 tests


def _cfg(**kw):
    return sgt.fast_config(number_of_channels=4, track_block_ms=16, **kw)


def _jax_nco():
    """softgnss_tpu.signals.nco (imported here: the gpu tests need no JAX)."""
    from softgnss_tpu.signals import nco

    return nco


def _leaves(out) -> list:
    st, ys, ovf = out
    return [*st, *ys, ovf]


def _f32_sum(x) -> np.float32:
    """float32 of the float64 sum of float32 values (the port's sums)."""
    return np.float32(np.asarray(x, np.float32).astype(np.float64).sum())


# --- S2: B1 by stage ---------------------------------------------------------


@pytest.mark.parametrize("stage", ["filters", "load", "carrier"])
def test_b1_stage_plain_against_jax_nco(stage):
    """Each ablated B1 stage's sums, ms by ms, against the same samples
    through the JAX NCOs: the loads exact, the carrier sums at 1e-6;
    open loop: the state keeps its carr_freq and code_freq, no overflow."""
    nco = _jax_nco()
    cfg = _cfg()
    frames, fb0, st0, pads, cb, active, _, r = args = s2.block_args(cfg, R, "cpu", n_idle=1)
    st, ys, ovf = s2.track_block_stage_plain(stage, *args)
    assert int(ovf.max()) == 0
    assert torch.equal(st.carr_freq, st0.carr_freq) and torch.equal(st.code_freq, st0.code_freq)
    assert torch.equal(st.ms, st0.ms + torch.where(active, r, 0))
    for f in ("i_e", "i_l", "q_e", "q_l"):
        assert not getattr(ys, f).any(), f
    samples = frames.view(torch.int8).numpy()
    fs, spc = cfg.sampling_freq, cfg.samples_per_code
    w = np.asarray(nco.carrier_step_u32(st0.carr_freq.numpy(), fs))
    for c in np.flatnonzero(active.numpy()):
        ptr, cp = int(st0.ptr[c]), int(st0.carr_phase[c])
        for j in range(r):
            blk = int(ys.absolute_sample[j, c]) - ptr
            o = ptr - (int(fb0[c]) + j * spc)
            x = samples[j, c, o:o + blk].astype(np.float32)
            i_p, q_p = float(ys.i_p[j, c]), float(ys.q_p[j, c])
            if stage == "filters":
                assert i_p == 0.0 and q_p == 0.0
            elif stage == "load":
                assert i_p == _f32_sum(x) and q_p == 0.0
            else:
                turns = nco.carrier_turns(np.int32(cp), w[c], np.arange(blk, dtype=np.int32))
                np.testing.assert_allclose(i_p, _f32_sum(np.asarray(nco.sin_turns(turns)) * x),
                                           rtol=1e-6, atol=1e-6)
                np.testing.assert_allclose(
                    q_p, _f32_sum(np.asarray(nco.sin_turns(turns + np.float32(0.25))) * x),
                    rtol=1e-6, atol=1e-6)
            ptr += blk
            cp = int(np.int64(cp + int(w[c]) * blk).astype(np.uint32).astype(np.int32))
    idle = ~active
    for f in MsOutputs._fields:
        assert not getattr(ys, f)[:, idle].any(), f


def test_b1_full_stage_plain_is_track_block_plain():
    args = s2.block_args(_cfg(pdi_ms=4, fll_bandwidth_hz=10.0), R, "cpu", n_idle=1)
    for a, b in zip(_leaves(s2.track_block_stage("full", *args)),
                    _leaves(mk.track_block_plain(*args))):
        assert torch.equal(a, b)


def test_b1_stage_rejects_unknown_stage():
    args = s2.block_args(_cfg(), 2, "cpu")
    with pytest.raises(ValueError, match="stage"):
        s2.track_block_stage_plain("bb", *args)


# --- S1: B4 by stage ---------------------------------------------------------


@pytest.mark.parametrize("stage", ["noop", "carrier", "phase"])
def test_b4_stage_plain_against_jax_nco(stage):
    """Each ablated B4 stage against the JAX NCOs on the same capture
    samples: carrier sums at 1e-6, the Q40 chip-index sums exact."""
    nco = _jax_nco()
    cfg, cap, ptr, cp, w, rem, step, blk, pads, active = args = s1.ms_args(_cfg(), "cpu", n_idle=1)
    out = s1.correlate_ms_stage(stage, *args).numpy()
    assert out.dtype == np.float32 and out.shape == (4, 6)
    assert not out[~active.numpy()].any() and not out[:, 5].any()
    if stage == "noop":
        assert not out.any()
        return
    half = nco.chips_to_q(cfg.dll_correlator_spacing)
    capn = cap.numpy()
    for c in np.flatnonzero(active.numpy()):
        k = np.arange(int(blk[c]), dtype=np.int64)
        x = capn[int(ptr[c]) + k].astype(np.float32)
        turns = nco.carrier_turns(np.int32(cp[c]), np.int32(w[c]), k.astype(np.int32))
        np.testing.assert_allclose(out[c, 1], _f32_sum(np.asarray(nco.sin_turns(turns)) * x),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            out[c, 4], _f32_sum(np.asarray(nco.sin_turns(turns + np.float32(0.25))) * x),
            rtol=1e-6, atol=1e-6)
        tq = int(rem[c]) + int(step[c]) * k
        for slot, d in ((0, -half), (3, 0), (2, half)):
            want = 0
            if stage == "phase":
                want = int(np.clip(np.asarray(nco.ceil_chip_index(tq + d)), 0, 1024).sum())
            assert out[c, slot] == np.float32(want), (c, slot)


def test_b4_full_stage_plain_is_correlate_ms_plain():
    args = s1.ms_args(_cfg(dll_correlator_spacing=0.25), "cpu", n_idle=1)
    assert torch.equal(s1.correlate_ms_stage("full", *args), pk.correlate_ms_plain(*args))


@pytest.mark.parametrize("label", ["b4"])
def test_b4_variant_takes_plain_on_cpu(label):
    """B4's stage wrapper in S1 (the route's kernel, label b4) runs the
    plain version of every stage on CPU tensors, counting no launch; an
    unknown stage raises."""
    fn = s1.correlate_ms_stage
    args = s1.ms_args(_cfg(), "cpu", n_idle=1)
    before = fn.launches
    for stage in s1.STAGES:
        assert torch.equal(fn(stage, *args), s1.correlate_ms_stage_plain(stage, *args)), stage
    assert fn.launches == before
    with pytest.raises(ValueError, match="stage"):
        s1.correlate_ms_stage_plain("bb", *args)


# --- S3: B2 and its 16-byte variant -----------------------------------------


def test_b2_variant_plain_against_jax_build_frames():
    """The vec4 variant's plain version, frame for frame, equals the JAX
    frames builder (interpret mode) with its split rows put back together,
    as scripts/builder_time.py does."""
    import jax.numpy as jnp

    import softgnss_tpu as sg
    from softgnss_tpu.track.megakernel import build_frames
    from softgnss_tpu.track.tables import MEGA_ALIGN_W, MEGA_PACK, mega_split, mega_window

    cfg = sg.fast_config(number_of_channels=4, track_block_ms=8)
    r, c_dim = 8, 4
    s_split = mega_split(cfg)
    win_w = mega_window(cfg) // MEGA_PACK
    spc_w = cfg.samples_per_code // MEGA_PACK
    rng = np.random.default_rng(3)
    cap = rng.integers(-2**31, 2**31, r * spc_w + win_w + 4 * MEGA_ALIGN_W).astype(np.int32)
    starts = rng.integers(0, 2 * MEGA_ALIGN_W, c_dim)
    split = np.asarray(build_frames(cfg, r, c_dim, jnp.asarray(cap[None]),
                                    jnp.asarray(starts.astype(np.int32))))
    want = np.concatenate([split[:, q * c_dim:(q + 1) * c_dim] for q in range(s_split)], axis=2)
    got = s3.build_frames_vec4(torch.from_numpy(cap), torch.from_numpy(starts), r, win_w, spc_w)
    np.testing.assert_array_equal(got.numpy(), want)


def test_b2_variant_plain_zero_fill_at_both_edges():
    cap, starts, r, win_w, spc_w = s3.frame_args(3, 4, "cpu", edges=True)
    got = s3.build_frames_vec4(cap, starts, r, win_w, spc_w).numpy()
    capn = cap.numpy()
    for j in range(r):
        for c in range(3):
            idx = int(starts[c]) + j * spc_w + np.arange(win_w)
            inside = (idx >= 0) & (idx < capn.shape[0])
            want = np.where(inside, capn[idx.clip(0, capn.shape[0] - 1)], 0)
            np.testing.assert_array_equal(got[j, c], want)
    assert not got[0, 0, :7].any() and not got[-1, 1, -(win_w // 2):].any()


# --- S4: load-pattern probe --------------------------------------------------


@pytest.mark.parametrize("c, r", [(3, 4), (8, 2)])
def test_dma_probe_plain_against_numpy(c, r):
    cap, starts, r, win, spc = args = s4.probe_args(c, r, "cpu")
    got = s4.dma_probe("direct", 1, *args).numpy()
    capn = cap.numpy().astype(np.int64)
    want = np.array([[capn[4 * int(starts[ch]) + j * spc:][:win].sum() for ch in range(c)]
                     for j in range(r)])
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def _byte_mask(lo: int, hi: int) -> int:
    """csrc/dma_probe.cu ``byte_mask``: bytes [lo, hi) of a 32-bit word."""
    lo, hi = min(max(lo, 0), 4), min(max(hi, 0), 4)
    return 0 if hi <= lo else ((1 << (8 * hi)) - 1) ^ ((1 << (8 * lo)) - 1)


def _s4_walk(cap, starts, r: int, win: int, spc: int, kn: int):
    """The bytes dma_probe_kernel sums, in its own index arithmetic
    (csrc/dma_probe.cu ``slice_of`` / ``vec_sum``): rank q's slice [lo, hi)
    of window (j, c) is the capture bytes [a, b) = off + [lo, hi), off =
    4 starts[c] + j spc, clipped to the capture, read as the vectors
    [a >> 4, (b + 15) >> 4) of the
    16-byte grid, an interior vector whole, an edge vector's four words
    each masked by ``byte_mask(l - 4w, h - 4w)``, l, h = a, b - the
    vector's first byte, clamped to [0, 16].  Returns (sums (r, C), the
    times each window byte was summed (r, C, win), the window leads, the
    most vectors one rank read)."""
    capn = cap.numpy().astype(np.int64)
    c = starts.shape[0]
    chunk = mk.rank_chunk(win, kn)
    sums = np.zeros((r, c), np.int64)
    seen = np.zeros((r, c, win), np.int64)
    leads, most = set(), 0
    for j in range(r):
        for ch in range(c):
            off = 4 * int(starts[ch]) + j * spc
            leads.add(off % 16)
            for q in range(kn):
                lo = min(q * chunk, win)
                hi = min(lo + chunk, win)
                a, b = max(off + lo, 0), min(off + hi, capn.shape[0])   # zero outside the capture
                v0 = a >> 4
                nvec = ((b + 15) >> 4) - v0 if b > a else 0
                most = max(most, nvec)
                if nvec == 0:
                    continue
                assert 0 <= 16 * v0 and 16 * (v0 + nvec - 1) < capn.shape[0]  # in the capture
                # interior vectors (16 v >= a, 16 v + 16 <= b): all 16 bytes, in one slice
                i0, i1 = max(v0, (a + 15) >> 4), min(v0 + nvec, b >> 4)
                if i1 > i0:
                    sums[j, ch] += capn[16 * i0:16 * i1].sum()
                    seen[j, ch, 16 * i0 - off:16 * i1 - off] += 1
                for v in sorted({v0, v0 + nvec - 1}):         # the edge vectors, masked
                    base = 16 * v
                    if base >= a and base + 16 <= b:
                        continue
                    l, h = min(max(a - base, 0), 16), min(max(b - base, 0), 16)
                    for w in range(4):
                        mask = _byte_mask(l - 4 * w, h - 4 * w)
                        for k in range(4):
                            if (mask >> (8 * k)) & 0xFF:
                                i = base + 4 * w + k
                                sums[j, ch] += capn[i]
                                seen[j, ch, i - off] += 1
    return sums, seen, leads, most


@pytest.mark.parametrize("c, r", [(3, 1), (3, 2), (3, 5), (8, 1), (8, 2), (8, 5)])
@pytest.mark.parametrize("kn", s4.KN_SWEEP)
def test_dma_probe_index_walk_takes_each_byte_once(kn, c, r):
    """dma_probe_kernel's rank split (megakernel.rank_slices, B1's), 16-byte
    grid and edge masks sum every window byte exactly once and nothing
    else, at window leads 0, 4, 8 and 12 (consecutive word starts) and, with
    a code period of an odd byte count, at any lead; each rank reads at
    most a staging slot; the sums are dma_probe_plain's.  With windows past
    both ends of the capture, exactly the bytes inside it once."""
    cap, starts, r, win, spc = s4.probe_args(c, r, "cpu")
    starts = starts[0] + torch.arange(c)               # leads 0, 4, 8, 12 in turn
    assert [lo for lo, _ in mk.rank_slices(win, kn)] == [
        min(q * mk.rank_chunk(win, kn), win) for q in range(kn)]
    slot = s4.dma_plan("bulk", 2, win, r, kn).slot
    for period in (spc, spc - 1):
        sums, seen, leads, most = _s4_walk(cap, starts, r, win, period, kn)
        assert (seen == 1).all()
        assert 16 * most <= slot
        np.testing.assert_array_equal(sums, s4.dma_probe_plain(cap, starts, r, win, period).numpy())
        if period == spc and c >= 4:
            assert leads == {0, 4, 8, 12}
    if (c, r) == (8, 5):
        assert len(leads) == 16                         # the odd period reaches every lead
    cap, starts, r, win, spc = args = s4.probe_args(c, r, "cpu", edges="outside")
    sums, seen, _, _ = _s4_walk(cap, starts, r, win, spc, kn)
    pos = (4 * starts[None, :, None] + spc * torch.arange(r)[:, None, None]
           + torch.arange(win)[None, None, :]).numpy()
    np.testing.assert_array_equal(seen, (pos >= 0) & (pos < cap.shape[0]))
    assert not seen[0, 0, :1000].any() and not seen[-1].all()
    np.testing.assert_array_equal(sums, s4.dma_probe_plain(*args).numpy())


def test_dma_plan_at_b1_geometry():
    """At the reference front end the plan splits windows as B1 does: 16
    CTAs per channel by default (of 512 threads), rank slices of
    megakernel.rank_chunk bytes, staging slots of chunk + 16 bytes, the r
    int64 partials after them."""
    win = sgt.default_config().track_window
    plan = s4.dma_plan("direct", 1, win, 64)
    assert plan == (mk.CTAS_PER_CHANNEL, 512, 2400, 2416, 8 * 64)
    for kn in s4.KN_SWEEP:
        for p, d in s4.PATTERNS:
            got = s4.dma_plan(p, d, win, 64, kn)
            chunk = mk.rank_chunk(win, kn)
            assert got.chunk == chunk and got.chunk * kn >= win and got.slot == chunk + 16
            assert got.smem_bytes == (0 if p == "direct" else d * (chunk + 16)) + 8 * 64
            assert got.smem_bytes <= s4.MAX_SMEM_BYTES


@pytest.mark.parametrize("kw", [{"ctas_per_channel": 3}, {"ctas_per_channel": 32},
                                {"threads": 48}, {"threads": 2048}, {"r": 40_000},
                                {"pattern": "bulk", "depth": 8}])
def test_dma_plan_refuses_what_the_kernel_does_not_take(kw):
    """A cluster size the kernel is not built for, a thread count outside
    its launch bounds, a pattern it does not have, or more shared memory
    than a CTA holds (the partials of 40 000 ms)."""
    args = {"pattern": "direct", "depth": 1, "win": sgt.default_config().track_window, "r": 64,
            **kw}
    with pytest.raises(ValueError, match="dma_probe"):
        s4.dma_plan(**args)
    if "threads" not in kw:                             # the wrapper checks the plan on the CPU too
        cap, starts, _, win, spc = s4.probe_args(2, 1, "cpu")
        with pytest.raises(ValueError, match="dma_probe"):
            s4.dma_probe(args["pattern"], args["depth"], cap, starts, args["r"], win, spc,
                         ctas_per_channel=args.get("ctas_per_channel", 16))


def test_dma_probe_resources_found_per_instantiation():
    """Every (pattern, depth, kN) instantiation of dma_probe_kernel is found
    in the ptxas log by its mangled template arguments; a missing one
    raises."""
    names = [f"_ZN12_GLOBAL__N_116dma_probe_kernelILi{s4._PATTERN_IDS[p]}ELi{d}ELi{kn}EEEvPKa"
             for p, d in s4.PATTERNS for kn in s4.KN_SWEEP]
    log = "".join(f"ptxas info    : Compiling entry function '{k}' for 'sm_90a'\n"
                  f"ptxas info    : Used {20 + i} registers, 380 bytes cmem[0]\n"
                  for i, k in enumerate(names))
    res = s4.probe_resources(log)
    assert len(res) == len(s4.PATTERNS) * len(s4.KN_SWEEP)
    assert res[("direct", 1, 1)]["registers"] == 20
    assert res[("bulk", 4, 16)]["registers"] == 20 + len(names) - 1
    with pytest.raises(KeyError, match=r"\('bulk', 4, 16\)"):
        s4.probe_resources(log.replace("ILi2ELi4ELi16E", "ILi2ELi4ELi32E"))


# --- S5: the construct probes ------------------------------------------------


def _tpu_probe_module():
    """scripts/pallas_probe.py (the TPU script) as a module: its kernel
    bodies, without running its probes."""
    spec = importlib.util.spec_from_file_location("tpu_pallas_probe",
                                                  REPO / "scripts" / "pallas_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_probe(name, args):
    """The TPU script's kernel ``name`` on ``args`` (torch CPU tensors),
    through pl.pallas_call in interpret mode with the script's grid,
    BlockSpecs and output shapes."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    m = _tpu_probe_module()
    a = [jnp.asarray(t.numpy()) for t in args]
    f32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)    # noqa: E731
    block = pl.BlockSpec((8, 128), lambda i: (i, 0))
    calls = {
        "grid": lambda: pl.pallas_call(m._k_grid, grid=(8,), in_specs=[block], out_specs=block,
                                       out_shape=f32(64, 128), interpret=True),
        "acc": lambda: pl.pallas_call(m._k_acc, grid=(8,), in_specs=[block],
                                      out_specs=pl.BlockSpec((8, 1), lambda i: (0, 0)),
                                      out_shape=f32(8, 1), interpret=True),
        "conv": lambda: pl.pallas_call(m._k_conv, out_shape=f32(8, 128), interpret=True),
        "onehot": lambda: pl.pallas_call(m._k_3d, out_shape=f32(8, 32), interpret=True),
        "bdot": lambda: pl.pallas_call(m._k_bdot, out_shape=f32(4, 8, 8), interpret=True),
        "dot": lambda: pl.pallas_call(m._k_dot, out_shape=f32(32, 128), interpret=True),
    }
    return np.asarray(calls[name]()(*a))


def _sum_abs_terms(name, args) -> np.ndarray:
    """sum |terms| of each output: the scale of the float32 sum-order
    tolerance against JAX."""
    a = [t.numpy().astype(np.float64) for t in args]
    if name == "acc":
        return np.abs(a[0]).reshape(8, 8, 128).sum((0, 2))[:, None]
    if name == "onehot":
        h, b = a
        return np.stack([np.where(h == k, np.abs(b), 0.0).sum(1) for k in range(32)], 1)
    if name == "bdot":
        return np.abs(a[0]) @ np.abs(a[1])
    if name == "dot":
        return s5.DOT_STEPS * (np.abs(a[0]) @ np.abs(a[1]))
    return np.zeros(1)


@pytest.mark.parametrize("inputs", ["script", "seeded"])
@pytest.mark.parametrize("name", s5.PROBES)
def test_s5_plain_against_jax_interpret(name, inputs):
    """Each S5 plain version against the TPU kernel it replaces: bit-equal
    on the script's own inputs (and for grid and conv, full-range int32
    included, on every input); on seeded inputs within 1e-5 * sum |terms|,
    JAX's float32 sum order against the port's float64 sums."""
    args = (s5.script_inputs("cpu") if inputs == "script" else s5.seeded_inputs("cpu"))[name]
    got = s5.PLAINS[name](*args).numpy()
    want = _jax_probe(name, args)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    if inputs == "script" or name in ("grid", "conv"):
        np.testing.assert_array_equal(got, want)
    else:
        err = np.abs(got.astype(np.float64) - want)
        assert (err <= 1e-5 * _sum_abs_terms(name, args)).all(), err.max()
        # the kernel's own tolerance (TF32) bounds the plain version's too
        tol = s5.tf32_tolerance(name, args)
        if tol is not None:
            assert (err <= tol.numpy()).all()


def test_s5_acc_plain_is_the_row_sums():
    """The kernel-order sum (lanes, shuffle tree, ranks) of the acc probe
    is within one rounding of the float64 row sums, and exact on integers."""
    x = s5.seeded_inputs("cpu")["acc"][0]
    want = x.double().view(8, 8, 128).sum((0, 2))
    got = s5.probe_acc_plain(x)[:, 0].double()
    assert torch.allclose(got, want, rtol=2**-23, atol=0)
    ints = torch.from_numpy(np.random.default_rng(1).integers(-1000, 1000, (64, 128))
                            .astype(np.float32))
    assert torch.equal(s5.probe_acc_plain(ints)[:, 0],
                       ints.double().view(8, 8, 128).sum((0, 2)).float())


def _onehot_lane_order(h, b) -> np.ndarray:
    """probe_onehot_kernel's order walked in Python: lane l adds its run of
    width / 32 columns into its own float64 bins in column order, then
    bin k's 32 lane sums are added in lane order; rounded once."""
    h, b = h.numpy(), b.numpy().astype(np.float64)
    rows, width = h.shape
    cols = width // 32
    out = np.zeros((rows, 32), np.float32)
    for r in range(rows):
        part = np.zeros((32, 32))
        for lane in range(32):
            for w in range(lane * cols, (lane + 1) * cols):
                if 0 <= h[r, w] < 32:
                    part[lane, h[r, w]] += b[r, w]
        for k in range(32):
            s = part[0, k]
            for lane in range(1, 32):
                s += part[lane, k]
            out[r, k] = np.float32(s)
    return out


def _onehot_column_order(h, b) -> np.ndarray:
    """Another order walked in Python: each bin over the columns in order,
    in float64; rounded once."""
    h, b = h.numpy(), b.numpy().astype(np.float64)
    out = np.zeros((h.shape[0], 32), np.float32)
    for r in range(h.shape[0]):
        s = np.zeros(32)
        for w in range(h.shape[1]):
            if 0 <= h[r, w] < 32:
                s[h[r, w]] += b[r, w]
        out[r] = s.astype(np.float32)
    return out


def _order_sensitive_row():
    """One (1, 256) row on which the two orders round apart: bin 5 holds
    2^60 (lane 0), 100 and 100 (lane 1's columns 8, 9) and -2^60 (lane
    31).  Column by column each 100 is lost in 2^60's ulp of 256 (sum 0);
    lane 1's own 200 rounds 2^60 up by one ulp (sum 256)."""
    h = torch.full((1, 256), -1, dtype=torch.int32)
    b = torch.zeros((1, 256), dtype=torch.float32)
    for w, v in ((0, 2.0**60), (8, 100.0), (9, 100.0), (255, -2.0**60)):
        h[0, w], b[0, w] = 5, v
    return h, b


def test_s5_onehot_plains_follow_their_kernels_orders():
    """probe_onehot_plain repeats the kernel's order (lane runs, then lanes
    in order), equal to a Python walk of that order on the script's,
    seeded and receiver inputs; on a row where another order (columns in
    order) rounds apart, it follows its own walk."""
    cases = [s5.script_inputs("cpu")["onehot"], s5.seeded_inputs("cpu")["onehot"],
             *(tuple(t[:24] for t in s5.receiver_inputs("cpu", case=c)["onehot"])
               for c in s5.RECEIVER_CASES), _order_sensitive_row()]
    for h, b in cases:
        np.testing.assert_array_equal(s5.probe_onehot_plain(h, b).numpy(),
                                      _onehot_lane_order(h, b))
    h, b = _order_sensitive_row()
    assert float(s5.probe_onehot_plain(h, b)[0, 5]) == 256.0
    assert float(_onehot_column_order(h, b)[0, 5]) == 0.0


@pytest.mark.parametrize("label", ["onehot"])
def test_s5_onehot_plain_exact_on_integer_weights(label):
    """On integer weights (and the script's ones) every order sums exactly:
    the plain version equals the float64 bin sums, sentinels and indices
    outside [0, 32) adding nothing."""
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.integers(-4, 36, (16, 256)).astype(np.int32))
    b = torch.from_numpy(rng.integers(-1000, 1000, (16, 256)).astype(np.float32))
    for hh, bb in ((h, b), s5.script_inputs("cpu")["onehot"]):
        want = np.stack([np.where(hh.numpy() == k, bb.numpy().astype(np.float64), 0.0).sum(1)
                         for k in range(32)], 1).astype(np.float32)
        np.testing.assert_array_equal(s5.PLAINS[label](hh, bb).numpy(), want)


@pytest.mark.parametrize("which", ["seeded", "receiver", "receiver-uniform"])
def test_s5_onehot_plain_within_one_rounding(which):
    """The kernel-order sum of the onehot probe is within one float32
    rounding of the float64 bin sums, at the script's shape and at the
    receiver's geometry."""
    h, b = s5.input_sets("cpu")[which]["onehot"]
    want = torch.from_numpy(np.stack(
        [np.where(h.numpy() == k, b.numpy().astype(np.float64), 0.0).sum(1) for k in range(32)], 1))
    got = s5.probe_onehot_plain(h, b).double()
    assert torch.allclose(got, want, rtol=2**-23, atol=0)


@pytest.mark.parametrize("case", ["receiver", "uniform"])
def test_s5_onehot_plain_against_jax_receiver_contraction(case):
    """The port's onehot at the receiver's geometry computes the JAX
    receiver's own contraction, ``einsum("tkw,ctk->twc", onehot(h_local),
    bb)`` (softgnss_tpu/track/scan.py:262-272, h_local clipped to [-1, w]
    as int8), on channel 0's first tiles, I and Q planes: within 1e-5 *
    sum |terms|, JAX's float32 sums against the port's float64 ones."""
    import jax.numpy as jnp

    tiles = 6
    h, b = s5.receiver_inputs("cpu", case=case)["onehot"]
    rows = torch.cat([torch.arange(tiles), s5.N_TILES + torch.arange(tiles)])
    h, b = h[rows], b[rows]
    assert torch.equal(h[:tiles], h[tiles:])            # the planes share the tile's h
    w = s5._BINS
    h_local = jnp.clip(jnp.asarray(h[:tiles].numpy()), -1, w).astype(jnp.int8)
    oh = (h_local[:, :, None] == jnp.arange(w, dtype=jnp.int8)[None, None, :]).astype(jnp.float32)
    bb = jnp.asarray(b.numpy()).reshape(2, tiles, s5.TRACK_TILE)
    u = np.asarray(jnp.einsum("tkw,ctk->twc", oh, bb, preferred_element_type=jnp.float32))
    want = np.concatenate([u[:, :, 0], u[:, :, 1]])
    got = s5.probe_onehot_plain(h, b).numpy()
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= 1e-5 * s5.onehot_scale(h, b).numpy()).all(), err.max()
    assert np.abs(want).max() > 0


def test_s5_receiver_geometry_is_the_jax_receivers():
    """The port's own receiver constants against the JAX package's
    definitions at default_config() (and the port's config where it has
    the field)."""
    from softgnss_tpu import default_config
    from softgnss_tpu.track import tables

    cfg = default_config()
    assert tables.onehot_width(cfg) == s5._BINS == 32
    assert tables.n_tiles(cfg) == s5.N_TILES == 300
    assert cfg.track_tile == s5.TRACK_TILE == 128
    assert cfg.track_pack == s5.TRACK_PACK == 2
    assert cfg.track_window // 4 == 9600    # whole tiles; the port's frames are whole words
    assert cfg.track_block_ms == s5.FRAME_MS
    assert cfg.number_of_channels == s5.RECEIVER_CHANNELS
    assert tables.subdivision(cfg) == s5.SUBDIVISION
    assert tables._H_OFFSET == s5.H_OFFSET
    assert tables._frame_shift_subchips(cfg) == s5.FRAME_SHIFT
    assert cfg.code_freq_basis / cfg.sampling_freq == s5.CHIPS_PER_SAMPLE
    port = sgt.default_config()
    assert (port.track_window // 4, port.track_block_ms, port.number_of_channels) == (
        s5.FRAME_WORDS, s5.FRAME_MS, s5.RECEIVER_CHANNELS) == (9580, 64, 8)
    assert cfg.track_window - port.track_window == 80


def test_s5_receiver_inputs_at_the_receivers_geometry():
    """4 800 one-hot rows of 128 lanes, I and Q rows sharing each tile's
    indices, ~14 bins a row, every index in [-1, 32]; the uniform case at
    the same shape in [-4, 36) with the same weights; conv as (64, 8, 9580)
    full-range int32; both repeat from the seed."""
    ins = s5.receiver_inputs("cpu")
    h, b = ins["onehot"]
    assert h.shape == b.shape == (4800, 128) and h.dtype == torch.int32
    assert b.dtype == torch.float32
    planes = h.view(s5.RECEIVER_CHANNELS, 2, s5.N_TILES, s5.TRACK_TILE)
    assert torch.equal(planes[:, 0], planes[:, 1])
    assert -1 <= int(h.min()) and int(h.max()) <= 32
    bins = np.mean([len(set(row.tolist())) for row in h[::50]])
    assert 13 <= bins <= 16, bins
    # lane to lane the index steps by pack * S * chips per sample, ceil'd
    assert set(torch.diff(h, dim=1).unique().tolist()) <= {0, 1}
    hu, bu = s5.receiver_inputs("cpu", case="uniform")["onehot"]
    assert (int(hu.min()), int(hu.max())) == (-4, 35) and torch.equal(bu, b)
    planes = hu.view(s5.RECEIVER_CHANNELS, 2, s5.N_TILES, s5.TRACK_TILE)
    assert torch.equal(planes[:, 0], planes[:, 1])
    assert "conv" not in s5.receiver_inputs("cpu", case="uniform")
    x = ins["conv"][0]
    assert x.shape == (64, 8, 9580) and x.dtype == torch.int32
    assert int(x.min()) < -2**30 and int(x.max()) > 2**30
    again = s5.receiver_inputs("cpu")
    assert torch.equal(again["onehot"][0], h) and torch.equal(again["conv"][0], x)
    with pytest.raises(ValueError, match="case"):
        s5.receiver_inputs("cpu", case="ramp")


@pytest.mark.parametrize("rows, width, warps", [(8, 256, 8), (4800, 128, 8), (4800, 128, 2),
                                                (13, 512, 4), (3, 1024, 16), (37, 128, 16)])
def test_s5_onehot_plan_covers_each_row_and_column_once(rows, width, warps):
    """probe_onehot_kernel's launch plan: the CTAs' warps take every row
    once; the lanes take every column once, each a contiguous run in
    order, whole 16-byte vectors; shared memory is the warps' tables; at
    the script's shape one CTA of 8 warps."""
    plan = s5.onehot_plan(rows, width, warps)
    got = [plan.row_of(c, w) for c in range(plan.ctas) for w in range(plan.warps)]
    assert [r for r in got if r is not None] == list(range(rows))
    assert got.count(None) == plan.ctas * plan.warps - rows < plan.warps
    cols = [c for lane in range(32) for c in plan.columns_of(lane)]
    assert cols == list(range(width))
    assert all(len(plan.columns_of(lane)) == 4 * plan.vecs_per_lane for lane in range(32))
    assert plan.warps == min(warps, rows)
    assert plan.smem_bytes == plan.warps * 32 * 33 * 8 <= 227 * 1024
    if (rows, width) == (8, 256):
        assert (plan.ctas, plan.warps, plan.vecs_per_lane) == (1, 8, 2)
        assert s5.onehot_plan(rows, width) == (8, 256, s5.ONEHOT_WARPS, s5.ONEHOT_WARPS * 8448)
    if (rows, width, warps) == (4800, 128, 8):
        assert (plan.ctas, plan.vecs_per_lane, plan.smem_bytes) == (600, 1, 67584)


@pytest.mark.parametrize("rows, width, warps", [(8, 64, 8), (8, 192, 8), (8, 200, 8),
                                                (8, 0, 8), (8, 1152, 8), (0, 128, 8),
                                                (8, 128, 0), (8, 128, 17)])
def test_s5_onehot_plan_refuses_what_the_kernel_does_not_take(rows, width, warps):
    """A width that is not a positive multiple of 128 up to 1 024 (whole
    16-byte vectors per lane), no row, or a warp count outside [1, 16]."""
    with pytest.raises(ValueError, match="probe_onehot"):
        s5.onehot_plan(rows, width, warps)


@pytest.mark.parametrize("n, sms", [(1024, 132), (64 * 8 * 9580, 132), (1027, 132), (3, 8),
                                    (1 << 20, 2), (0, 132)])
def test_s5_conv_plan_covers_each_vector_once(n, sms):
    """probe_conv_kernel's launch plan: the grid's threads take every
    16-byte vector once, none more than CONV_VECS per pass; the n % 4
    tail falls to CTA 0; one CTA of one vector per thread at the script's
    shape, CONV_CTAS_PER_SM per SM at B2's frame geometry."""
    plan = s5.conv_plan(n, sms)
    assert plan.vectors == n // 4 and plan.tail == n % 4 < s5.CONV_THREADS
    seen = np.zeros(plan.vectors, np.int64)
    for t in range(plan.threads):
        for v in plan.vectors_of(t):
            seen[v] += 1
    assert (seen == 1).all()
    assert 1 <= plan.blocks <= max(1, sms * s5.CONV_CTAS_PER_SM)
    if plan.blocks < sms * s5.CONV_CTAS_PER_SM:     # a grid that is not capped: one pass
        assert -(-plan.vectors // plan.threads) <= s5.CONV_VECS
    if n == 1024:
        assert plan.blocks == 1 and all(len(plan.vectors_of(t)) == 1 for t in range(256))
    if n == 64 * 8 * 9580:
        assert plan.blocks == sms * s5.CONV_CTAS_PER_SM
    with pytest.raises(ValueError, match="probe_conv"):
        s5.conv_plan(-1, sms)


@pytest.mark.parametrize("case", ["receiver", "uniform"])
def test_s5_library_onehot_takes_every_index_at_receiver_shape(case):
    """LIBRARY["onehot"] on library_inputs' index (h clamped to [-1, 32],
    plus one, into 34 columns) computes the plain version's function at
    the receiver's geometry, within 1e-5 * sum |terms| of its float32
    scatter, with no index outside its buffer; the sentinels -1 and 32 and
    indices past them add nothing."""
    h, b = s5.receiver_inputs("cpu", case=case)["onehot"]
    idx, bb = s5.library_inputs("onehot", (h, b))
    assert idx.dtype == torch.int64 and 0 <= int(idx.min()) and int(idx.max()) <= 33
    assert bb is b
    got = s5.LIBRARY["onehot"](idx, bb)
    want = s5.probe_onehot_plain(h, b)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.double() - want.double()).abs()
    assert (err <= 1e-5 * s5.onehot_scale(h, b)).all(), float(err.max())
    outside = torch.tensor([[-40, -4, -1, 32, 33, 36, 2**30, 0] + [-1] * 24] * 2,
                           dtype=torch.int32)
    ones = torch.ones(outside.shape, dtype=torch.float32)
    got = s5.LIBRARY["onehot"](*s5.library_inputs("onehot", (outside, ones)))
    assert torch.equal(got, s5.probe_onehot_plain(outside, ones))
    assert float(got.sum()) == 2.0 and float(got[0, 0]) == 1.0


def test_s5_compare_and_bounds():
    """The TF32 check accepts a product rounded to TF32 and refuses a
    wrong one; each probe's bound is set by its bytes (launch-scale work)."""
    a, b = s5.seeded_inputs("cpu")["dot"]
    tf32 = lambda t: (t.view(torch.int32) & ~0x1FFF).view(torch.float32)   # noqa: E731
    rounded = s5.probe_dot_plain(tf32(a), tf32(b))
    assert s5.compare("dot", rounded, s5.probe_dot_plain(a, b), (a, b), exact=False) > 0
    with pytest.raises(AssertionError, match="TF32 bound"):
        s5.compare("dot", rounded + 1.0, s5.probe_dot_plain(a, b), (a, b), exact=False)
    with pytest.raises(AssertionError, match="differs"):
        s5.compare("dot", rounded, s5.probe_dot_plain(a, b), (a, b), exact=True)
    inputs = s5.script_inputs("cpu")
    for name in s5.PROBES:
        ms, by = s5.bound(name, inputs[name])
        assert by == "bytes" and 0 < ms < 1e-3, (name, ms, by)
    # dot: 64 KB + 256 KB read, 16 KB written at 3.35 TB/s
    assert s5.bound("dot", inputs["dot"])[0] == pytest.approx(
        (32 * 512 + 512 * 128 + 32 * 128) * 4 / 3.35e12 * 1e3)


@pytest.mark.parametrize("name", s5.PROBES)
def test_s5_library_computes_the_same_function(name):
    """Each LIBRARY call, the yardstick timed beside its kernel, computes
    the kernel's function: on the script's inputs (those it is timed on)
    bit-equal to the plain version, shape and dtype included; on seeded
    inputs bit-equal for grid and conv, within the TF32 bound for bdot and
    dot, and within 1e-5 * sum |terms| for the float32 sums of acc and
    onehot (whose seeded indices in [-4, 36) reach ``scatter_add_``
    through library_inputs' index, outside the bins included)."""
    for which in ("script", "seeded"):
        args = (s5.script_inputs("cpu") if which == "script" else s5.seeded_inputs("cpu"))[name]
        got = s5.LIBRARY[name](*s5.library_inputs(name, args))
        want = s5.PLAINS[name](*args)
        if which == "script" or name in ("grid", "conv"):
            s5.compare(name, got, want, args, exact=True)
        elif name in s5.TF32_PROBES:
            s5.compare(name, got, want, args, exact=False)
        else:
            assert got.dtype == want.dtype and got.shape == want.shape
            err = (got.double() - want.double()).abs().numpy()
            assert (err <= 1e-5 * _sum_abs_terms(name, args)).all(), err.max()


@pytest.mark.parametrize("m, k, n", [(32, 512, 128), (48, 104, 136), (16, 8, 8), (48, 1024, 136),
                                     (8, 520, 8)])
def test_s5_dot_plan_covers_each_tile_and_slice_once(m, k, n):
    """probe_dot_kernel's launch plan: the CTAs' tiles are every 8 x 8
    output tile once, the warps' K slices every 8-wide slice once, in
    order, none holding more than DOT_SLICES; at the script's shape 64
    CTAs of 8 warps, 8 slices each (two chains of 4 mma per step)."""
    plan = s5.dot_plan(m, k, n)
    tiles = [plan.tile(c) for c in range(plan.ctas)]
    assert sorted(tiles) == [(m0, n0) for m0 in range(0, m, 8) for n0 in range(0, n, 8)]
    slices = [j for w in range(plan.warps) for j in plan.slices_of(w)]
    assert slices == list(range(k // 8))
    assert max(len(plan.slices_of(w)) for w in range(plan.warps)) <= s5.DOT_SLICES
    assert s5.DOT_WARPS <= plan.warps <= s5.DOT_MAX_WARPS
    # a's rows at a stride whose float4 count is odd: 16-byte copies, and a
    # fragment read over rows g = 0..7, columns t = 0..3 on 32 distinct banks
    assert plan.lda >= k and plan.lda % 4 == 0 and (plan.lda // 4) % 2 == 1
    assert len({(g * plan.lda + t) % 32 for g in range(8) for t in range(4)}) == 32
    assert plan.smem_bytes == 4 * (8 * plan.lda + 8 * k + 64 * plan.warps) <= 227 * 1024
    if (m, k, n) == (32, 512, 128):
        assert (plan.ctas, plan.warps, plan.slices_per_warp, plan.smem_bytes) == (64, 8, 8, 34944)
    if (m, k, n) == (48, 104, 136):      # 13 slices: the last warps are short
        assert [len(plan.slices_of(w)) for w in range(plan.warps)] == [2] * 6 + [1, 0]
    if k > 512:                          # more than 8 warps of 8 slices
        assert plan.warps > s5.DOT_WARPS


@pytest.mark.parametrize("m, k, n", [(12, 512, 128), (32, 500, 128), (32, 512, 132),
                                     (0, 512, 128), (32, 1032, 128)])
def test_s5_dot_plan_refuses_shapes_the_kernel_does_not_take(m, k, n):
    """Ragged tiles or slices, an empty dimension, and a K beyond the
    fragments 16 warps hold in registers (the largest K taken is 1024)."""
    with pytest.raises(ValueError, match="probe_dot"):
        s5.dot_plan(m, k, n)
    assert s5.dot_plan(8, 1024, 8).warps == s5.DOT_MAX_WARPS


@pytest.mark.parametrize("k", [8, 128, 512, 1024])
def test_s5_dot_plan_gives_bdot_a_plan(k):
    """bdot's shapes, (B, 8, K) @ (B, K, 8), are one 8 x 8 tile of dot's
    kernel: one CTA, BDOT_WARPS warps (more only where K needs them), every
    K slice once; any warp count outside [1, 16] raises."""
    plan = s5.dot_plan(8, k, 8, s5.BDOT_WARPS)
    assert (plan.ctas, plan.tile(0)) == (1, (0, 0))
    assert [j for w in range(plan.warps) for j in plan.slices_of(w)] == list(range(k // 8))
    assert plan.warps == max(s5.BDOT_WARPS, -(-(k // 8) // s5.DOT_SLICES))
    assert plan.slices_per_warp <= s5.DOT_SLICES
    assert plan.smem_bytes == 4 * (8 * plan.lda + 8 * k + 64 * plan.warps)
    if k == 128:
        assert (plan.warps, plan.slices_per_warp) == (s5.BDOT_WARPS, 16 // s5.BDOT_WARPS)
    for w in s5.BDOT_WARP_SWEEP:
        assert s5.dot_plan(8, k, 8, w).warps >= w
    for w in (0, s5.DOT_MAX_WARPS + 1):
        with pytest.raises(ValueError, match="warps"):
            s5.dot_plan(8, k, 8, w)


def test_s5_vec4_check_refuses_sliced_views():
    """grid's and dot's 16-byte loads take a 16-byte aligned tensor and
    nothing else: a view one float past an aligned start raises, a row
    slice stays aligned (contiguity is ``megakernel._require``'s check,
    which a column slice fails on the card:
    test_s5_vec4_kernels_refuse_sliced_views_on_card)."""
    s5.require_vec4(torch.ones(64, 128), "x")
    s5.require_vec4(torch.ones(72, 128)[8:], "x")
    with pytest.raises(ValueError, match="16-byte aligned"):
        s5.require_vec4(torch.ones(64 * 128 + 2)[2:].view(64, 128), "x")
    with pytest.raises(ValueError, match="16-byte aligned"):
        s5.require_vec4(torch.ones(64 * 128 + 1)[1:].view(64, 128), "x")


@pytest.mark.parametrize("label", list(s5.VARIANTS))
def test_s5_variant_takes_plain_on_cpu(label):
    """Each S5 kernel's own wrapper (both designs of conv alike, each
    reached only through its own wrapper) runs its probe's plain version on
    CPU tensors, on the script's and on seeded inputs, counting no
    launch."""
    fn = s5.VARIANTS[label]
    name = s5.probe_of(label)
    assert name in s5.PROBES and fn.__name__ == f"probe_{label}"
    before = fn.launches
    for inputs in (s5.script_inputs("cpu"), s5.seeded_inputs("cpu")):
        assert torch.equal(fn(*inputs[name]), s5.PLAINS[label](*inputs[name]))
    assert fn.launches == before


def test_probe_resources_find_each_kernel_by_exact_name():
    """probe_conv_kernel and probe_conv_loop_kernel are told apart by the
    length-prefixed name in the mangled symbol; bdot's resources are dot's
    kernel's; a kernel missing from the log raises."""
    names = list(dict.fromkeys(s5.kernel_of(label) for label in s5.VARIANTS))
    assert len(names) == len(s5.VARIANTS) - 1          # bdot runs dot's body
    log = "".join(f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{len(k)}{k}EPKfPf' "
                  f"for 'sm_90a'\nptxas info    : Used {10 + i} registers, 380 bytes cmem[0]\n"
                  for i, k in enumerate(names))
    res = s5.probe_resources(log)
    assert list(res) == list(s5.VARIANTS)
    regs = {k: 10 + i for i, k in enumerate(names)}
    assert [r["registers"] for r in res.values()] == [regs[s5.kernel_of(x)] for x in s5.VARIANTS]
    assert res["bdot"] == res["dot"]
    with pytest.raises(KeyError, match="probe_dot_kernel"):
        s5.probe_resources(log.replace("16probe_dot_kernel", "16probe_xxx_kernel"))


def test_ptxas_resources_parsed():
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116probe_acc_kernelEPKfPfi'"
           " for 'sm_90a'\nptxas info    : Function properties for _ZN12_GLOBAL__N_116probe_acc"
           "_kernelEPKfPfi\n    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
           "ptxas info    : Used 30 registers, used 1 barriers, 64 bytes smem, 380 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_Z17probe_grid_kernelPKfPf' for 'sm_90a'\n"
           "ptxas info    : Used 10 registers, 380 bytes cmem[0]\n")
    res = s5.resources(log)
    assert res["_ZN12_GLOBAL__N_116probe_acc_kernelEPKfPfi"] == {
        "registers": 30, "smem": 64, "stack": 8, "spill_stores": 4, "spill_loads": 4}
    assert res["_Z17probe_grid_kernelPKfPf"]["registers"] == 10
    assert res["_Z17probe_grid_kernelPKfPf"]["smem"] == 0


# --- entry points and counters ----------------------------------------------


@pytest.mark.parametrize("name", ["pallas_ablate", "mega_vmem_bisect", "builder_time",
                                  "dma_probe", "pallas_probe"])
def test_probe_exits_nonzero_without_cuda(name):
    """No fallback: without a CUDA card each probe raises before it
    measures anything."""
    proc = subprocess.run([sys.executable, "-m", f"softgnss_tpu_torch.scripts.{name}"],
                          cwd=REPO, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                               "PYTHONPATH": str(REPO)})
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
    assert "us/ms" not in proc.stdout and "us/launch" not in proc.stdout
    assert "[ok]" not in proc.stdout and " us" not in proc.stdout


def test_timers_require_cuda():
    with pytest.raises(RuntimeError, match="CUDA card"):
        timing.require_cuda()


def test_plain_probes_count_no_launches():
    wrappers = (s1.correlate_ms_stage, s2.track_block_stage, s3.build_frames_vec4,
                s4.dma_probe, *s5.VARIANTS.values())
    before = [f.launches for f in wrappers]
    cfg = _cfg()
    s1.correlate_ms_stage("carrier", *s1.ms_args(cfg, "cpu"))
    s2.track_block_stage("load", *s2.block_args(cfg, 2, "cpu"))
    s3.build_frames_vec4(*s3.frame_args(2, 2, "cpu"))
    args = s4.probe_args(2, 2, "cpu")
    want = s4.dma_probe_plain(*args)
    for kn in s4.KN_SWEEP:
        assert torch.equal(s4.dma_probe("bulk", 4, *args, ctas_per_channel=kn), want)
    inputs = s5.seeded_inputs("cpu")
    for label, fn in s5.VARIANTS.items():
        name = s5.probe_of(label)
        assert torch.equal(fn(*inputs[name]), s5.PLAINS[label](*inputs[name]))
    assert [f.launches for f in wrappers] == before


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the probes are also checked by chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("stage", s2.STAGES)
def test_b1_stage_kernel_matches_plain_on_card(cuda_device, stage):
    args = s2.block_args(_cfg(pdi_ms=4, fll_bandwidth_hz=10.0), R, cuda_device, n_idle=1)
    got = _leaves(s2.track_block_stage(stage, *args))
    want = _leaves(s2.track_block_stage_plain(stage, *args))
    for f, a, b in zip(TrackState._fields + MsOutputs._fields + ("overflow",), got, want):
        assert torch.equal(a, b), f
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["b4"])
@pytest.mark.parametrize("stage", s1.STAGES)
def test_b4_stage_kernel_matches_plain_on_card(cuda_device, stage, label):
    """Every stage of B4, at the fast and the reference front end,
    bit-equal to its plain version."""
    for cfg in (_cfg(), sgt.default_config(number_of_channels=8)):
        args = s1.ms_args(cfg, cuda_device, n_idle=1)
        assert torch.equal(s1.correlate_ms_stage(stage, *args),
                           s1.correlate_ms_stage_plain(stage, *args))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("edges", [False, True], ids=["interior", "edges"])
@pytest.mark.parametrize("name", s3.VARIANTS)
def test_b2_variant_kernel_matches_plain_on_card(cuda_device, name, edges):
    args = s3.frame_args(5, 4, cuda_device, edges)
    assert torch.equal(s3.variant(name)(*args), mk.build_frames_plain(*args))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("kn", s4.KN_SWEEP)
@pytest.mark.parametrize("pattern, depth", s4.PATTERNS)
def test_dma_probe_kernel_matches_plain_on_card(cuda_device, pattern, depth, kn):
    """Every pattern at every cluster size, at 3, 8 and 12 channels and 1, 2
    and 64 ms, the last window ending at the capture's last byte, and
    windows past both ends of it: bit-equal to the plain version, and two
    launches bit-equal."""
    for edges in ("end", "outside"):
        for c in (3, 8, 12):
            for r in (1, 2, 64):
                args = s4.probe_args(c, r, cuda_device, edges)
                got = s4.dma_probe(pattern, depth, *args, ctas_per_channel=kn)
                assert torch.equal(got, s4.dma_probe_plain(*args)), (edges, c, r)
                assert torch.equal(s4.dma_probe(pattern, depth, *args, ctas_per_channel=kn), got)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("inputs", ["script", "seeded"])
@pytest.mark.parametrize("label", list(s5.VARIANTS))
def test_s5_kernel_matches_plain_on_card(cuda_device, label, inputs):
    """Every S5 kernel, both designs of conv among them, against its own
    plain version."""
    name = s5.probe_of(label)
    args = (s5.script_inputs(cuda_device) if inputs == "script"
            else s5.seeded_inputs(cuda_device))[name]
    s5.compare(name, s5.VARIANTS[label](*args), s5.PLAINS[label](*args), args,
               exact=inputs == "script")
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["dot"])
@pytest.mark.parametrize("m, k, n", [(16, 8, 8), (48, 1024, 136), (48, 104, 136)])
def test_s5_dot_shapes_on_card(cuda_device, m, k, n, label):
    """dot at further shapes the wrapper takes: one tile and one slice, a
    K twice the script's, and 13 slices over 8 warps."""
    rng = np.random.default_rng(m * k * n)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda_device)
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(cuda_device)
    s5.compare("dot", s5.VARIANTS[label](a, b), s5.probe_dot_plain(a, b), (a, b), exact=False)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["bdot"])
@pytest.mark.parametrize("k", [8, 128, 512])
@pytest.mark.parametrize("batch", [1, 4, 7])
def test_s5_bdot_shapes_on_card(cuda_device, batch, k, label):
    """bdot at batch 1, 4 and 7 and K = 8, 128, 512: within the TF32 bound
    on seeded inputs, bit-equal on ones; dot's body as bdot at every warp
    count of the sweep."""
    rng = np.random.default_rng(batch * k)
    a = torch.from_numpy(rng.standard_normal((batch, 8, k)).astype(np.float32)).to(cuda_device)
    b = torch.from_numpy(rng.standard_normal((batch, k, 8)).astype(np.float32)).to(cuda_device)
    s5.compare("bdot", s5.VARIANTS[label](a, b), s5.probe_bdot_plain(a, b), (a, b), exact=False)
    ones = (torch.ones_like(a), torch.ones_like(b))
    s5.compare("bdot", s5.VARIANTS[label](*ones), s5.probe_bdot_plain(*ones), ones, exact=True)
    for w in s5.BDOT_WARP_SWEEP:
        s5.compare("bdot", s5.probe_bdot(a, b, warps=w), s5.probe_bdot_plain(a, b), (a, b),
                   exact=False)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dot", "bdot"])
def test_s5_dot_launches_bit_equal_on_card(cuda_device, name):
    """The warps' partial tiles are summed in a fixed order, no atomics:
    as dot and as bdot."""
    args = s5.seeded_inputs(cuda_device)[name]
    assert torch.equal(s5.VARIANTS[name](*args), s5.VARIANTS[name](*args))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_s5_vec4_kernels_refuse_sliced_views_on_card(cuda_device):
    """No scalar path: grid and dot raise on a view they cannot load by 16
    bytes."""
    ones = lambda *s: torch.ones(s, device=cuda_device)   # noqa: E731
    with pytest.raises(ValueError, match="contiguous"):
        s5.probe_grid(ones(64, 256)[:, :128])
    shifted = ones(64 * 128 + 1)[1:].view(64, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        s5.probe_grid(shifted)
    a, b = s5.script_inputs(cuda_device)["dot"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        s5.probe_dot(ones(32 * 512 + 1)[1:].view(32, 512), b)
    a, b = s5.script_inputs(cuda_device)["bdot"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        s5.probe_bdot(ones(4 * 8 * 128 + 1)[1:].view(4, 8, 128), b)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_s5_library_matches_plain_on_card(cuda_device):
    errs = s5.check_library(cuda_device)
    for name in s5.TF32_PROBES:      # TF32 allowed rounds the inputs: a larger difference
        assert errs[name]["tf32"] > errs[name]["default"]


@pytest.mark.gpu
@pytest.mark.parametrize("reps", [1, 2, 3, 64])
@pytest.mark.parametrize("label", ["acc"])
def test_s5_acc_reps_rewrite_the_same_sum_on_card(cuda_device, label, reps):
    """acc (the push) bit-equal to the plain version at 1, 2, 3 and 64 reps
    (the push's slot ring wraps from 3 on), and two launches bit-equal."""
    x = s5.seeded_inputs(cuda_device)["acc"][0]
    got = s5.VARIANTS[label](x, reps)
    assert torch.equal(got, s5.probe_acc_plain(x))
    assert torch.equal(s5.VARIANTS[label](x, reps), got)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("label, case", [(label, case) for label in ("conv", "conv_loop", "onehot")
                                         for case in s5.RECEIVER_CASES
                                         if case == "receiver" or label == "onehot"])
def test_s5_kernel_matches_plain_at_receiver_geometry_on_card(cuda_device, label, case):
    """Each design of conv and onehot bit-equal to its own plain version at
    the receiver's geometry, and two launches bit-equal; onehot at every
    warp count of its sweep."""
    name = s5.probe_of(label)
    args = s5.receiver_inputs(cuda_device, case=case)[name]
    got = s5.VARIANTS[label](*args)
    s5.compare(label, got, s5.PLAINS[label](*args), args, exact=True)
    assert torch.equal(s5.VARIANTS[label](*args), got)
    if label == "onehot":
        for warps in s5.ONEHOT_WARP_SWEEP:
            assert torch.equal(s5.probe_onehot(*args, warps=warps), got)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_s5_conv_and_onehot_shapes_on_card(cuda_device):
    """No quiet fallback: onehot refuses a width that is not a multiple of
    128 and an unaligned view; conv refuses an unaligned view, which
    conv_loop takes, and converts a ragged tail (n % 4 = 1, 2, 3)
    bit-equal."""
    h, b = s5.seeded_inputs(cuda_device)["onehot"]
    h192, b192 = h[:, :192].contiguous(), b[:, :192].contiguous()
    with pytest.raises(ValueError, match="multiple of 128"):
        s5.probe_onehot(h192, b192)
    shifted = torch.zeros(8 * 256 + 1, dtype=torch.int32, device=cuda_device)[1:].view(8, 256)
    shifted.copy_(h)
    with pytest.raises(ValueError, match="16-byte aligned"):
        s5.probe_onehot(shifted, b)
    x = torch.from_numpy(np.random.default_rng(9).integers(-2**31, 2**31, 4099)
                         .astype(np.int32)).to(cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        s5.probe_conv(x[1:])
    assert torch.equal(s5.probe_conv_loop(x[1:]), x[1:].float())
    for n in (1, 2, 3, 1025, 1026, 1027, 4099):
        assert torch.equal(s5.probe_conv(x[:n]), x[:n].float()), n
    torch.cuda.synchronize()
