"""Port parity: tracking of softgnss_tpu_torch against softgnss_tpu.

The port's tracker runs the block framing of the JAX megakernel branch
through the plain PyTorch versions of its two kernels (build_frames,
track_block) on the CPU, and is held against the JAX 'gather' tracker
(same float64 filter lineage) and the JAX megakernel in Pallas interpret
mode.  The CUDA kernels themselves are checked on the card
(``python3 chip_smoke.py`` and tests/test_torch_kernels.py).
"""

import numpy as np
import pytest
import torch

import softgnss_tpu as sg
import softgnss_tpu_torch as sgt
from softgnss_tpu.acquire.search import Channels as JChannels
from softgnss_tpu.signals.synth import SatelliteSignal, synthesize_signal
from softgnss_tpu.track import track as jtrack
from softgnss_tpu.track.scan import TrackState as JTrackState
from softgnss_tpu_torch.acquire.search import Channels
from softgnss_tpu_torch.convert import track_state_from_numpy, track_state_to_numpy
from softgnss_tpu_torch.track import megakernel as mk
from softgnss_tpu_torch.track import scan as tscan
from softgnss_tpu_torch.track import track

torch.set_num_threads(1)

_CORR = ("i_p", "i_e", "i_l", "q_e", "q_p", "q_l")


def _channels(cls, ch):
    return cls(prn=ch["prn"].copy(), acquired_freq=ch["acquired_freq"].copy(),
               code_phase=ch["code_phase"].copy(), status=list(ch["status"]))


@pytest.fixture(scope="module")
def two_sats():
    """The capture and hand-set channels of tests/test_tracking.py."""
    cfg = sg.fast_config(number_of_channels=2)
    nav_bits = tuple((-1) ** i for i in range(40))
    sats = [SatelliteSignal(prn=9, doppler_hz=1200.0, delay_samples=500.0, amplitude=1.0,
                            phase0=1.0, nav_bits=nav_bits),
            SatelliteSignal(prn=23, doppler_hz=-800.0, delay_samples=2000.0, amplitude=1.1,
                            phase0=2.5, nav_bits=nav_bits)]
    signal = synthesize_signal(cfg, sats, 403, noise_std=1.0, seed=11)
    ch = dict(prn=np.array([9, 23], np.int64),
              acquired_freq=np.array([cfg.intermediate_freq + 1200.0,
                                      cfg.intermediate_freq - 800.0]),
              code_phase=np.array([500, 2000], np.int64), status=["T", "T"])
    return signal, ch


@pytest.fixture(scope="module")
def three_sats():
    """The capture and channels of tests/test_megakernel.py."""
    cfg = sg.fast_config(number_of_channels=3, track_block_ms=16)
    rng = np.random.default_rng(7)
    params = [(5, 1200.0, 333, 0.4), (11, -2500.0, 1777, 2.1), (20, 400.0, 40, 5.0)]
    sats = [SatelliteSignal(prn=p, doppler_hz=d, delay_samples=float(s), phase0=ph,
                            nav_bits=tuple(rng.choice([-1, 1], size=8)))
            for p, d, s, ph in params]
    signal = synthesize_signal(cfg, sats, 100, noise_std=0.8, seed=4)
    ch = dict(prn=np.asarray([p for p, *_ in params]),
              acquired_freq=np.asarray([cfg.intermediate_freq + d for _, d, _, _ in params]),
              code_phase=np.asarray([s for _, _, s, _ in params], np.int64),
              status=["T"] * 3)
    return signal, ch


def _assert_gather_parity(port, ref, ref_ms=slice(None)):
    """The tolerances of tests/test_tracking.py::test_onehot_matches_gather_impl;
    ``ref_ms`` selects the reference milliseconds that ``port`` covers."""
    r = lambda f: getattr(ref, f)[:, ref_ms]                  # noqa: E731
    np.testing.assert_array_equal(port.absolute_sample, r("absolute_sample"))
    for key in _CORR:
        a, b = getattr(port, key), r(key)
        assert np.max(np.abs(a - b)) / np.sqrt(np.mean(b**2)) < 1e-4, key
    np.testing.assert_allclose(port.carr_freq, r("carr_freq"), atol=1e-6)
    # float32 sum order is the only difference: far inside the NCO step
    assert np.max(np.abs(port.carr_freq - r("carr_freq"))) < 1e-3
    assert np.max(np.abs(port.code_freq - r("code_freq"))) < 1e-3
    assert np.max(np.abs(port.sample_frac - r("sample_frac"))) < 1e-6


@pytest.mark.parametrize("opts", [
    {}, {"pdi_ms": 2}, {"fll_bandwidth_hz": 10.0}, {"carrier_aided_dll": True},
    {"dll_correlator_spacing": 0.25}],
    ids=["default", "pdi2", "fll", "aided", "spacing025"])
def test_track_matches_jax_gather(two_sats, opts):
    signal, ch = two_sats
    ref = jtrack(sg.fast_config(number_of_channels=2, correlator_impl="gather", **opts),
                 signal, _channels(JChannels, ch), n_ms=150)
    port = track(sgt.fast_config(number_of_channels=2, **opts),
                 torch.from_numpy(signal.copy()), _channels(Channels, ch), n_ms=150)
    assert port.i_p.shape == (2, 150) and port.i_p.dtype == np.float32
    assert port.absolute_sample.dtype == np.int64 and port.carr_freq.dtype == np.float64
    _assert_gather_parity(port, ref)


def test_track_matches_jax_megakernel_interpret(three_sats):
    """The TPU main-path kernel (Pallas interpret mode) against the port,
    at the tolerances of tests/test_megakernel.py (its f32 filters are
    their own lineage)."""
    signal, ch = three_sats
    ref = jtrack(sg.fast_config(number_of_channels=3, track_block_ms=16,
                                correlator_impl="megakernel"),
                 signal, _channels(JChannels, ch), n_ms=64)
    port = track(sgt.fast_config(number_of_channels=3, track_block_ms=16),
                 torch.from_numpy(signal.copy()), _channels(Channels, ch), n_ms=64)
    np.testing.assert_array_equal(port.absolute_sample, ref.absolute_sample)
    for f in _CORR:
        a = np.asarray(getattr(ref, f), np.float64)
        b = np.asarray(getattr(port, f), np.float64)
        assert np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(a**2)) < 1e-3, f
    assert np.max(np.abs(port.carr_freq - ref.carr_freq)) < 0.1
    assert np.max(np.abs(port.code_freq - ref.code_freq)) < 0.05
    assert np.max(np.abs(port.sample_frac - ref.sample_frac)) < 1e-3


@pytest.mark.parametrize("pdi", [1, 5])
def test_resume_bit_exact(three_sats, pdi):
    """Split runs (at a block boundary and mid-block: the lead segment)
    equal the uninterrupted run bit for bit."""
    signal, ch = three_sats
    cfg = sgt.fast_config(number_of_channels=3, track_block_ms=16, pdi_ms=pdi)
    sig = torch.from_numpy(signal.copy())
    full = track(cfg, sig, _channels(Channels, ch), n_ms=80)
    for split in (32, 37):
        a = track(cfg, sig, _channels(Channels, ch), n_ms=split)
        b = track(cfg, sig, _channels(Channels, ch), n_ms=80 - split, state=a.final_state)
        for f in tscan.MsOutputs._fields:
            np.testing.assert_array_equal(
                np.concatenate([getattr(a, f), getattr(b, f)], axis=1),
                getattr(full, f), err_msg=f"{f} split {split}")
        for f, x, y in zip(tscan.TrackState._fields, b.final_state, full.final_state):
            assert torch.equal(x, y), f


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_resume_across_packages(two_sats, direction):
    """A final_state carried across by convert.py resumes in the other
    package, to the gather tolerances against the uninterrupted JAX run."""
    signal, ch = two_sats
    jcfg = sg.fast_config(number_of_channels=2, correlator_impl="gather")
    tcfg = sgt.fast_config(number_of_channels=2)
    sig = torch.from_numpy(signal.copy())
    full = jtrack(jcfg, signal, _channels(JChannels, ch), n_ms=120)
    if direction == "jax_to_port":
        first = jtrack(jcfg, signal, _channels(JChannels, ch), n_ms=70)
        state = track_state_from_numpy(first.final_state._asdict())
        second = track(tcfg, sig, _channels(Channels, ch), n_ms=50, state=state)
    else:
        first = track(tcfg, sig, _channels(Channels, ch), n_ms=70)
        state = JTrackState(**track_state_to_numpy(first.final_state))
        second = jtrack(jcfg, signal, _channels(JChannels, ch), n_ms=50, state=state)
    for f in ("ptr", "code_rem_q", "ms", "block_base"):
        assert (np.asarray(getattr(state, f)) == np.asarray(getattr(first.final_state, f))).all()
    _assert_gather_parity(second, full, slice(70, None))


def test_inactive_channel_frozen_and_zero(three_sats):
    signal, ch = three_sats
    ch = dict(ch, status=["T", "-", "T"])
    cfg = sgt.fast_config(number_of_channels=3, track_block_ms=16)
    chans = _channels(Channels, ch)
    res = track(cfg, torch.from_numpy(signal.copy()), chans, n_ms=48)
    for f in tscan.MsOutputs._fields:
        assert not np.any(getattr(res, f)[1]), f
    assert np.any(res.i_p[0] != 0)
    st0 = tscan.initial_state(cfg, chans)
    for f, x, y in zip(tscan.TrackState._fields, st0, res.final_state):
        assert x[1] == y[1], f


def test_front_end_without_word_frames_rejected(three_sats):
    """A front end whose code period is not whole int32 words: the block
    tracker ('megakernel') rejects it, 'auto' tracks it on the per-ms
    tracker; a short capture is rejected either way."""
    signal, ch = three_sats
    cfg = sgt.fast_config(number_of_channels=3, sampling_freq=4_094_000.0)
    assert cfg.samples_per_code % 4 and cfg.tracker == "per_ms"
    sig = torch.from_numpy(signal.copy())
    with pytest.raises(ValueError, match="samples_per_code % 4"):
        track(cfg.with_options(correlator_impl="megakernel"), sig,
              _channels(Channels, ch), n_ms=10)
    res = track(cfg, sig, _channels(Channels, ch), n_ms=10)
    assert res.i_p.shape == (3, 10) and np.isfinite(res.carr_freq).all()
    with pytest.raises(ValueError, match="too short"):
        track(sgt.fast_config(), torch.from_numpy(signal[:50_000].copy()),
              _channels(Channels, ch), n_ms=20)


@pytest.mark.parametrize("tile", [64, 128])
def test_build_frames_plain_matches_jax_builder(tile):
    """B2's plain version against the JAX Pallas builder (interpret mode)
    at a one-row-piece geometry, as tests/test_megakernel.py checks it."""
    import jax.numpy as jnp

    from softgnss_tpu.track.megakernel import build_frames as jax_build_frames
    from softgnss_tpu.track.tables import MEGA_ALIGN_W, MEGA_PACK, mega_split, mega_window

    cfg = sg.fast_config(track_tile=tile, track_block_ms=8)
    assert mega_split(cfg) == 1
    r, c_dim = 4, 3
    win_w = mega_window(cfg) // MEGA_PACK
    spc_w = cfg.samples_per_code // MEGA_PACK
    rng = np.random.default_rng(tile)
    cap = rng.integers(-2**30, 2**30, (1, r * spc_w + win_w + 4 * MEGA_ALIGN_W),
                       np.int64).astype(np.int32)
    starts = rng.integers(0, 2 * MEGA_ALIGN_W, c_dim).astype(np.int32)
    want = np.asarray(jax_build_frames(cfg, r, c_dim, jnp.asarray(cap), jnp.asarray(starts)))
    got = mk.build_frames(torch.from_numpy(cap[0]), torch.from_numpy(starts.astype(np.int64)),
                          r, win_w, spc_w)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spacing", [0.5, 0.25, 0.1, 5 / 32, 0.123456789])
def test_subdivision_matches(spacing):
    from softgnss_tpu.track.tables import subdivision as jsub
    from softgnss_tpu_torch.track.tables import subdivision as tsub

    jc, tc = (m.fast_config(dll_correlator_spacing=spacing) for m in (sg, sgt))
    try:
        want = jsub(jc)
    except ValueError:
        with pytest.raises(ValueError, match="gather"):
            tsub(tc)
        return
    assert tsub(tc) == want
