"""The port's measurement probes (softgnss_tpu_torch.scripts, S1-S4).

On the CPU each stage's and variant's plain version is held against the
JAX package's own building blocks on the same samples (the NCOs of
softgnss_tpu.signals.nco, megakernel.build_frames in interpret mode) or
against numpy, at ``fast_config()``; the ``full`` stages are the receiver's
plain versions themselves.  The ``gpu`` tests hold every stage, variant
and load pattern kernel bit-equal to its plain version on a card; they
import no JAX, so they also run on the card's machine:

    python -m pytest --noconftest -m gpu tests/test_torch_scripts.py
"""

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


# --- entry points and counters ----------------------------------------------


@pytest.mark.parametrize("name", ["pallas_ablate", "mega_vmem_bisect", "builder_time",
                                  "dma_probe"])
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


def test_timers_require_cuda():
    with pytest.raises(RuntimeError, match="CUDA card"):
        timing.require_cuda()


def test_plain_probes_count_no_launches():
    wrappers = (s1.correlate_ms_stage, s2.track_block_stage, s3.build_frames_vec4,
                s4.dma_probe)
    before = [f.launches for f in wrappers]
    cfg = _cfg()
    s1.correlate_ms_stage("carrier", *s1.ms_args(cfg, "cpu"))
    s2.track_block_stage("load", *s2.block_args(cfg, 2, "cpu"))
    s3.build_frames_vec4(*s3.frame_args(2, 2, "cpu"))
    s4.dma_probe("bulk", 4, *s4.probe_args(2, 2, "cpu"))
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
@pytest.mark.parametrize("stage", s1.STAGES)
def test_b4_stage_kernel_matches_plain_on_card(cuda_device, stage):
    args = s1.ms_args(_cfg(), cuda_device, n_idle=1)
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
@pytest.mark.parametrize("pattern, depth", s4.PATTERNS)
def test_dma_probe_kernel_matches_plain_on_card(cuda_device, pattern, depth):
    args = s4.probe_args(3, 6, cuda_device)
    assert torch.equal(s4.dma_probe(pattern, depth, *args), s4.dma_probe_plain(*args))
    torch.cuda.synchronize()
