"""Port parity: the per-ms tracker (kernel B4's route) and the fused block
tracker (kernel B3's route) of softgnss_tpu_torch.

On the CPU every route runs its kernels' plain versions.  The per-ms
tracker is held against the JAX 'pallas' tracker (its Mosaic kernel in
Pallas interpret mode, the tolerance of tests/test_tracking.py::
test_pallas_matches_onehot_impl) and against the port's block tracker
(same float64 filter lineage: bit equality expected); a front end whose
code period is not whole int32 words tracks through 'auto' and matches
the JAX 'gather' tracker; the fused block tracker equals the unfused one
bit for bit; resumes are bit-exact, also across the two trackers.
"""

import numpy as np
import pytest
import torch

import softgnss_tpu as sg
import softgnss_tpu_torch as sgt
from softgnss_tpu.acquire.search import Channels as JChannels
from softgnss_tpu.signals.synth import SatelliteSignal, synthesize_signal
from softgnss_tpu.track import track as jtrack
from softgnss_tpu_torch.acquire.search import Channels
from softgnss_tpu_torch.track import megakernel as mk
from softgnss_tpu_torch.track import pallas_kernel as pk
from softgnss_tpu_torch.track import scan as tscan
from softgnss_tpu_torch.track import track

torch.set_num_threads(1)

_CORR = ("i_p", "i_e", "i_l", "q_e", "q_p", "q_l")


def _capture(fs: float, n_ms: int):
    """The two satellites of tests/test_tracking.py at sampling rate ``fs``."""
    cfg = sg.fast_config(number_of_channels=2, sampling_freq=fs)
    nav_bits = tuple((-1) ** i for i in range(40))
    sats = [SatelliteSignal(prn=9, doppler_hz=1200.0, delay_samples=500.0, amplitude=1.0,
                            phase0=1.0, nav_bits=nav_bits),
            SatelliteSignal(prn=23, doppler_hz=-800.0, delay_samples=2000.0, amplitude=1.1,
                            phase0=2.5, nav_bits=nav_bits)]
    signal = synthesize_signal(cfg, sats, n_ms + 3, noise_std=1.0, seed=11)
    ch = dict(prn=np.array([9, 23], np.int64),
              acquired_freq=np.array([cfg.intermediate_freq + 1200.0,
                                      cfg.intermediate_freq - 800.0]),
              code_phase=np.array([500, 2000], np.int64), status=["T", "T"])
    return signal, ch


def _ch(cls, ch, status=None):
    return cls(prn=ch["prn"].copy(), acquired_freq=ch["acquired_freq"].copy(),
               code_phase=ch["code_phase"].copy(), status=list(status or ch["status"]))


@pytest.fixture(scope="module")
def fast_capture():
    return _capture(4_096_000.0, 120)


def _rel(a, b):
    return np.max(np.abs(a - b)) / np.sqrt(np.mean(np.asarray(b, np.float64) ** 2))


def test_per_ms_matches_jax_pallas(fast_capture):
    signal, ch = fast_capture
    ref = jtrack(sg.fast_config(number_of_channels=2, correlator_impl="pallas"),
                 signal, _ch(JChannels, ch), n_ms=60)
    cfg = sgt.fast_config(number_of_channels=2, correlator_impl="pallas")
    assert cfg.tracker == "per_ms"
    port = track(cfg, torch.from_numpy(signal.copy()), _ch(Channels, ch), n_ms=60)
    np.testing.assert_array_equal(port.absolute_sample, ref.absolute_sample)
    for f in _CORR:
        assert _rel(getattr(port, f), getattr(ref, f)) < 5e-3, f


@pytest.mark.parametrize("opts", [{}, {"pdi_ms": 2, "fll_bandwidth_hz": 10.0,
                                       "carrier_aided_dll": True,
                                       "dll_correlator_spacing": 0.25}],
                         ids=["default", "variant"])
def test_per_ms_matches_block_route(fast_capture, opts):
    """Both trackers through their plain versions, an idle channel
    included: the same exact NCOs and float64 filters."""
    signal, ch = fast_capture
    sig = torch.from_numpy(signal.copy())
    chans = _ch(Channels, ch, ["T", "-"])
    block = track(sgt.fast_config(number_of_channels=2, track_block_ms=16, **opts), sig,
                  chans, n_ms=40)
    per_ms = track(sgt.fast_config(number_of_channels=2, track_block_ms=16,
                                   correlator_impl="onehot", **opts), sig, chans, n_ms=40)
    np.testing.assert_array_equal(per_ms.absolute_sample, block.absolute_sample)
    for f in _CORR:
        assert _rel(getattr(per_ms, f)[0], getattr(block, f)[0]) < 1e-6, f
        assert not np.any(getattr(per_ms, f)[1])
    for f in ("carr_freq", "code_freq", "sample_frac"):
        np.testing.assert_allclose(getattr(per_ms, f), getattr(block, f), rtol=0, atol=1e-9)
    for f, a, b in zip(tscan.TrackState._fields, per_ms.final_state, block.final_state):
        if a.dtype in (torch.int64, torch.int32):
            assert torch.equal(a, b), f


def test_odd_front_end_matches_jax_gather():
    """fs = 4.094 MHz: samples_per_code = 4094 is not whole int32 words;
    'auto' takes the per-ms tracker (the JAX package's 'auto' on a TPU
    takes its per-ms kernel there)."""
    signal, ch = _capture(4_094_000.0, 100)
    cfg = sgt.fast_config(number_of_channels=2, sampling_freq=4_094_000.0)
    assert cfg.samples_per_code % 4 and cfg.tracker == "per_ms"
    ref = jtrack(sg.fast_config(number_of_channels=2, sampling_freq=4_094_000.0,
                                correlator_impl="gather"), signal, _ch(JChannels, ch), n_ms=100)
    port = track(cfg, torch.from_numpy(signal.copy()), _ch(Channels, ch), n_ms=100)
    np.testing.assert_array_equal(port.absolute_sample, ref.absolute_sample)
    for f in _CORR:
        assert _rel(getattr(port, f), getattr(ref, f)) < 1e-4, f
    # float32 sums in another order, fed back through the loops over 100 ms
    for f in ("carr_freq", "code_freq"):
        np.testing.assert_allclose(getattr(port, f), getattr(ref, f), rtol=0, atol=1e-4)
    # locked: data on I
    assert np.mean(np.abs(port.i_p[:, 50:])) > 4 * np.mean(np.abs(port.q_p[:, 50:]))


def test_fused_route_bit_equal(fast_capture):
    signal, ch = fast_capture
    sig = torch.from_numpy(signal.copy())
    cfg = sgt.fast_config(number_of_channels=2, track_block_ms=16)
    chans = _ch(Channels, ch, ["-", "T"])
    unfused = track(cfg, sig, chans, n_ms=45)
    fused = track(cfg.with_options(mega_fused_frames=True), sig, chans, n_ms=45)
    for f in tscan.MsOutputs._fields:
        np.testing.assert_array_equal(getattr(fused, f), getattr(unfused, f), err_msg=f)
    for f, a, b in zip(tscan.TrackState._fields, fused.final_state, unfused.final_state):
        assert torch.equal(a, b), f
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (mk.track_block_fused.launches, pk.correlate_ms.launches) == (0, 0)


@pytest.mark.parametrize("split", [20, 37])
def test_per_ms_resume_bit_exact(fast_capture, split):
    """Split per-ms runs (pdi 5, the split off the PDI grid) equal the
    uninterrupted run; the per-ms final state also resumes on the block
    tracker exactly as the block tracker's own state does."""
    signal, ch = fast_capture
    sig = torch.from_numpy(signal.copy())
    cfg = sgt.fast_config(number_of_channels=2, track_block_ms=16, pdi_ms=5,
                          correlator_impl="pallas")
    full = track(cfg, sig, _ch(Channels, ch), n_ms=64)
    a = track(cfg, sig, _ch(Channels, ch), n_ms=split)
    b = track(cfg, sig, _ch(Channels, ch), n_ms=64 - split, state=a.final_state)
    for f in tscan.MsOutputs._fields:
        np.testing.assert_array_equal(np.concatenate([getattr(a, f), getattr(b, f)], axis=1),
                                      getattr(full, f), err_msg=f)
    for f, x, y in zip(tscan.TrackState._fields, b.final_state, full.final_state):
        assert torch.equal(x, y), f
    blk = cfg.with_options(correlator_impl="auto")
    from_per_ms = track(blk, sig, _ch(Channels, ch), n_ms=64 - split, state=a.final_state)
    block_first = track(blk, sig, _ch(Channels, ch), n_ms=split)
    assert torch.equal(a.final_state.block_base, block_first.final_state.block_base)
    from_block = track(blk, sig, _ch(Channels, ch), n_ms=64 - split,
                       state=block_first.final_state)
    np.testing.assert_array_equal(from_per_ms.absolute_sample, from_block.absolute_sample)
