"""The port's tracking kernels, build_frames (B2), track_block (B1),
track_block_fused (B3) and correlate_ms (B4), without the JAX package:
this file imports only torch, numpy and softgnss_tpu_torch, so it also
runs on the card's machine, which has no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

On the CPU the wrappers run their plain versions; the ``gpu`` tests
compare the CUDA kernels with those plain versions, B1 and B3 at every
cluster size (``ctas_per_channel``) and at 3 and 12 channels, and skip
without a card.
"""

import functools

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


def _scenario(device, n_ch: int = 3):
    """Three satellites on ``n_ch`` channels (each satellite on every third
    channel), the second channel idle."""
    cfg = sgt.fast_config(number_of_channels=n_ch, track_block_ms=16)
    sats = [SatelliteSignal(prn=p, doppler_hz=d, delay_samples=float(s), phase0=ph,
                            amplitude=2.0, nav_bits=(1, -1, -1, 1))
            for p, d, s, ph in ((5, 1200.0, 333, 0.4), (11, -2500.0, 1777, 2.1),
                                (20, 400.0, 40, 5.0))]
    sig = synthesize_signal(cfg, sats, 100, noise_std=4.0, seed=4, device=device)
    on = [sats[i % 3] for i in range(n_ch)]
    ch = Channels(prn=np.asarray([s.prn for s in on]),
                  acquired_freq=np.asarray([cfg.intermediate_freq + s.doppler_hz for s in on]),
                  code_phase=np.asarray([int(s.delay_samples) for s in on], np.int64),
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


#: (channels, CTAs per channel) of the card tests: every cluster size at 3
#: channels, and 12 channels at the sizes that hold 12 clusters (16 may
#: not: then its clusters run in waves)
SIZES = [(3, kn) for kn in mk.CLUSTER_SIZES] + [(12, 8), (12, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("n_ch, kn", SIZES, ids=[f"C{c}-kN{k}" for c, k in SIZES])
@pytest.mark.parametrize("opts", [{}, {"pdi_ms": 4, "fll_bandwidth_hz": 10.0,
                                       "carrier_aided_dll": True,
                                       "dll_correlator_spacing": 0.25}],
                         ids=["default", "variant"])
def test_kernels_match_plain_on_card(cuda_device, opts, n_ch, kn):
    """B2 + B1 at ``kn`` CTAs per channel against their plain versions on
    the card, through the segment loop (lead segment included), inactive
    channel included."""
    cfg, sig, ch = _scenario(cuda_device, n_ch)
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
        st, ys1, ov1 = scan.track_segments(cfg, words, st, pads, cb, active, 37, 0,
                                           build, block)
        st, ys2, ov2 = scan.track_segments(cfg, words, st, pads, cb, active, 43, 37,
                                           build, block)
        assert int(torch.maximum(ov1, ov2).max()) == 0
        outs.append([torch.cat(p).cpu().numpy() for p in zip(ys1, ys2)] +
                    [v.cpu().numpy() for v in st])
    for f, a, b in zip(scan.MsOutputs._fields + scan.TrackState._fields, *outs):
        np.testing.assert_array_equal(a, b, err_msg=f)
    torch.cuda.synchronize()


def _segments_then_resume(cfg, sig, ch, dev, build, block):
    words = scan.capture_words(sig)
    pads = scan.build_tables(ch.prn, dev)
    active = torch.tensor([s == "T" for s in ch.status], device=dev)
    cb = torch.as_tensor(ch.acquired_freq).to(dev)
    st = scan.initial_state(cfg, ch, dev)
    if build == "per_ms":
        st, ys1 = scan.track_ms(cfg, sig, st, pads, cb, active, 37, 0, block)
        st, ys2 = scan.track_ms(cfg, sig, st, pads, cb, active, 43, 37, block)
    else:
        st, ys1, ov1 = scan.track_segments(cfg, words, st, pads, cb, active, 37, 0,
                                           build, block)
        st, ys2, ov2 = scan.track_segments(cfg, words, st, pads, cb, active, 43, 37,
                                           build, block)
        assert int(torch.maximum(ov1, ov2).max()) == 0
    return ([torch.cat(p).cpu().numpy() for p in zip(ys1, ys2)]
            + [v.cpu().numpy() for v in st])


CASES = [("B3", c, k) for c, k in SIZES] + [("B4", 3, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel, n_ch, kn", CASES,
                         ids=[f"{k}-C{c}-kN{n}" if n else k for k, c, n in CASES])
def test_fused_and_per_ms_kernels_match_plain_on_card(cuda_device, kernel, n_ch, kn):
    """B3 at ``kn`` CTAs per channel (bit-equal, as the B2 + B1 pair it
    fuses) and B4 (the per-ms tracker through it: absolute_sample equal,
    correlators within 1e-4 of the plain version's RMS) on the card, with
    a resume and an idle channel."""
    cfg, sig, ch = _scenario(cuda_device, n_ch)
    fused = functools.partial(mk.track_block_fused, ctas_per_channel=kn)
    pair, plain = (((None, fused), (None, mk.track_block_fused_plain))
                   if kernel == "B3" else
                   (("per_ms", pk.correlate_ms), ("per_ms", pk.correlate_ms_plain)))
    got = _segments_then_resume(cfg, sig, ch, cuda_device, *pair)
    want = _segments_then_resume(cfg, sig, ch, cuda_device, *plain)
    fields = scan.MsOutputs._fields + scan.TrackState._fields
    for f, a, b in zip(fields, got, want):
        if kernel == "B3" or f == "absolute_sample":
            np.testing.assert_array_equal(a, b, err_msg=f)
        elif f in ("i_p", "i_e", "i_l", "q_e", "q_p", "q_l"):
            assert np.abs(a - b).max() <= 1e-4 * np.sqrt(np.mean(b.astype(np.float64) ** 2)), f
    torch.cuda.synchronize()
