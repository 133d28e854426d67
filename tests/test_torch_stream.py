"""The streamed tracker (softgnss_tpu_torch.parallel.stream) against the
port's monolithic tracker, and one case against the JAX package's.

The cases of tests/test_stream.py without the mesh ones: the port runs the
same kernels on the same frames in every chunk, so every output and the
final state are bit-equal to ``track`` (the JAX package allows an ulp of
its per-chunk compiles, the port has none).  Against JAX's
``track_streamed`` the tolerances are those of the port's tracker against
JAX 'gather' (ROADMAP's north star).  On the CPU: plain versions.  The
``gpu`` tests import no JAX, so they also run on the card's machine:

    python -m pytest --noconftest -m gpu tests/test_torch_stream.py
"""

import numpy as np
import pytest
import torch

import softgnss_tpu_torch as sgt
from softgnss_tpu_torch.acquire.search import Channels
from softgnss_tpu_torch.parallel import track_streamed
from softgnss_tpu_torch.pipeline import run_receiver
from softgnss_tpu_torch.signals.synth import SatelliteSignal, synthesize_signal
from softgnss_tpu_torch.track.scan import MsOutputs, TrackState, track

torch.set_num_threads(1)

N_MS = 400


@pytest.fixture(scope="module")
def cfg():
    return sgt.fast_config(number_of_channels=3)


def _channels(cls, cfg):
    return cls(prn=np.array([4, 17, 0], np.int64),
               acquired_freq=np.array([cfg.intermediate_freq + 900.0,
                                       cfg.intermediate_freq - 2100.0, 0.0]),
               code_phase=np.array([700, 2500, 0], np.int64), status=["T", "T", "-"])


@pytest.fixture(scope="module")
def capture(cfg):
    """The satellites and channels of tests/test_stream.py (the port's
    synthesizer on the host), and the port's monolithic tracking."""
    nav_bits = tuple((-1) ** (i // 3) for i in range(40))
    sats = [SatelliteSignal(prn=4, doppler_hz=900.0, delay_samples=700.0, phase0=0.3,
                            nav_bits=nav_bits),
            SatelliteSignal(prn=17, doppler_hz=-2100.0, delay_samples=2500.0, phase0=4.0,
                            nav_bits=nav_bits)]
    signal = synthesize_signal(cfg, sats, N_MS + 3, noise_std=1.0, seed=5, device="cpu").numpy()
    ref = track(cfg, torch.from_numpy(signal.copy()), _channels(Channels, cfg), n_ms=N_MS)
    return signal, ref


def _assert_equal(st, ref, n_ms=N_MS):
    for f in MsOutputs._fields:
        np.testing.assert_array_equal(getattr(st, f), getattr(ref, f)[:, :n_ms], err_msg=f)
    assert st.status == ref.status
    np.testing.assert_array_equal(st.prn, ref.prn)


def _assert_state_equal(a: TrackState, b: TrackState):
    for f, x, y in zip(TrackState._fields, a, b):
        assert torch.equal(x, y), f


def test_matches_monolithic(cfg, capture):
    signal, ref = capture
    st = track_streamed(cfg, signal, _channels(Channels, cfg), n_ms=N_MS, chunk_ms=128,
                        device="cpu")
    _assert_equal(st, ref)
    _assert_state_equal(st.final_state, ref.final_state)


def test_partial_tail_chunk_and_memmap(cfg, capture, tmp_path):
    """n_ms not a chunk multiple; the capture read through np.memmap."""
    signal, ref = capture
    path = tmp_path / "cap.bin"
    signal.tofile(path)
    mm = np.memmap(path, np.int8, "r")
    st = track_streamed(cfg, mm, _channels(Channels, cfg), n_ms=300, chunk_ms=128,
                        device="cpu")
    _assert_equal(st, ref, 300)


def test_cpu_tensor_and_resume(cfg, capture):
    """A CPU tensor streams on the host by default; a streamed run resumed
    on the block grid from a streamed state equals the whole run; off the
    grid it raises."""
    signal, ref = capture
    sig = torch.from_numpy(signal.copy())
    first = track_streamed(cfg, sig, _channels(Channels, cfg), n_ms=192, chunk_ms=64)
    second = track_streamed(cfg, sig, _channels(Channels, cfg), n_ms=N_MS - 192, chunk_ms=64,
                            state=first.final_state)
    for f in MsOutputs._fields:
        np.testing.assert_array_equal(
            np.concatenate([getattr(first, f), getattr(second, f)], axis=1),
            getattr(ref, f), err_msg=f)
    _assert_state_equal(second.final_state, ref.final_state)
    off_grid = track(cfg, sig, _channels(Channels, cfg), n_ms=100)
    with pytest.raises(ValueError, match="block grid"):
        track_streamed(cfg, sig, _channels(Channels, cfg), n_ms=200, chunk_ms=64,
                       state=off_grid.final_state)


def test_single_chunk_covers_all(cfg, capture):
    signal, ref = capture
    st = track_streamed(cfg, signal, _channels(Channels, cfg), n_ms=150, chunk_ms=4096,
                        device="cpu")
    _assert_equal(st, ref, 150)


def test_too_short_capture_raises(cfg, capture):
    signal, _ = capture
    with pytest.raises(ValueError, match="capture too short"):
        track_streamed(cfg, signal[: 50 * cfg.samples_per_code], _channels(Channels, cfg),
                       n_ms=N_MS, chunk_ms=128, device="cpu")


def test_run_receiver_stream(cfg, capture):
    """run_receiver(stream=True) acquires on the acquisition window alone
    and streams the tracking: every output equal to the monolithic run."""
    signal, _ = capture
    kw = dict(n_ms=N_MS, navigate=False, device="cpu")
    ref = run_receiver(cfg.with_options(track_stream_chunk_ms=128), signal=signal, **kw)
    st = run_receiver(cfg.with_options(track_stream_chunk_ms=128), signal=signal, stream=True,
                      **kw)
    np.testing.assert_array_equal(st.acquisition.code_phase, ref.acquisition.code_phase)
    for f in MsOutputs._fields:
        np.testing.assert_array_equal(getattr(st.tracking, f), getattr(ref.tracking, f),
                                      err_msg=f)


def test_matches_jax_track_streamed(capture):
    """Against the JAX package's streamed tracker ('gather', 128-ms chunks):
    the port's tracker tolerances against JAX 'gather'."""
    import softgnss_tpu as sg
    from softgnss_tpu.acquire.search import Channels as JChannels
    from softgnss_tpu.parallel import track_streamed as jax_track_streamed
    from tests.test_torch_track import _assert_gather_parity

    signal, _ = capture
    jcfg = sg.fast_config(number_of_channels=3, correlator_impl="gather")
    ref = jax_track_streamed(jcfg, signal, _channels(JChannels, jcfg), n_ms=300, chunk_ms=128)
    tcfg = sgt.fast_config(number_of_channels=3)
    st = track_streamed(tcfg, signal, _channels(Channels, tcfg), n_ms=300, chunk_ms=128,
                        device="cpu")
    _assert_gather_parity(st, ref)


def test_streamed_needs_a_card_unless_told(cfg, capture):
    """A host capture streams to the card by default: without one it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    signal, _ = capture
    with pytest.raises(RuntimeError, match="no CUDA device"):
        track_streamed(cfg, signal, _channels(Channels, cfg), n_ms=N_MS, chunk_ms=128)


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the stream route is also checked by chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("pinned", [False, True], ids=["pageable", "pinned"])
def test_streamed_upload_matches_monolithic_on_card(cfg, capture, cuda_device, pinned):
    signal, _ = capture
    host = torch.from_numpy(signal.copy())
    if pinned:
        host = host.pin_memory()
    ref = track(cfg, host.to(cuda_device), _channels(Channels, cfg), n_ms=N_MS)
    st = track_streamed(cfg, host, _channels(Channels, cfg), n_ms=N_MS, chunk_ms=128,
                        device=cuda_device)
    _assert_equal(st, ref)
    _assert_state_equal(st.final_state, ref.final_state)
