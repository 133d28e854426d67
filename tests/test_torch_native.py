"""The port's native IO library, I/Q synthesis and front end, and where
its entry points run.

* softgnss_tpu_torch.native against the JAX package's softgnss_tpu.native
  byte for byte (the cases of tests/test_native.py), and io giving the
  same samples with and without it;
* synthesize_iq bit-equal to the JAX package's (noise-free), the iq8 / iq16
  chain of tests/test_iq_frontend.py through the port on the CPU;
* the synthesizers, ``acquire`` and ``track`` run on the card unless the
  caller names the CPU: without a card, each raises when no device is
  named.
"""

import numpy as np
import pytest
import torch

import softgnss_tpu as sg
import softgnss_tpu_torch as sgt
from softgnss_tpu import native as jnative
from softgnss_tpu.signals import synth as jsynth
from softgnss_tpu_torch import io as tio
from softgnss_tpu_torch import native
from softgnss_tpu_torch.acquire.search import Channels, acquire
from softgnss_tpu_torch.pipeline import run_receiver
from softgnss_tpu_torch.scenario import build_scenario, synthesize_scenario
from softgnss_tpu_torch.signals import synth as tsynth
from softgnss_tpu_torch.track.scan import track
from tests.test_native import numpy_unpack

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def libs():
    if native.load() is None or jnative.load() is None:
        pytest.skip("no C++ toolchain available")
    return native.load(), jnative.load()


def test_available_matches_jax(libs):
    """``available()``, the JAX package's name, beside the port's ``used()``."""
    assert native.available() is native.used() is jnative.available() is True


@pytest.mark.parametrize("fmt", ["int4", "int2", "int1", "uint8"])
def test_unpack_equals_jax_native(libs, fmt):
    raw = np.random.default_rng(1).integers(0, 256, size=4096).astype(np.uint8)
    got = native.unpack(raw, fmt)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, jnative.unpack(raw, fmt))
    # and the NumPy formulations io falls back to without the library
    want = ((raw.astype(np.int16) - 128).astype(np.int8) if fmt == "uint8"
            else numpy_unpack(raw, fmt))
    np.testing.assert_array_equal(got, want)


def test_narrow_and_probe_stats_equal_jax_native(libs):
    rng = np.random.default_rng(2)
    raw16 = rng.integers(-32768, 32768, size=1000).astype(np.int16)
    np.testing.assert_array_equal(native.narrow_int16(raw16), jnative.narrow_int16(raw16))
    np.testing.assert_array_equal(native.narrow_int16(raw16), (raw16 >> 8).astype(np.int8))
    x = rng.integers(-30, 31, size=100000).astype(np.int8)
    got, want = native.probe_stats(x), jnative.probe_stats(x)
    np.testing.assert_array_equal(got["hist"], want["hist"])
    assert got["mean"] == want["mean"] and got["std"] == want["std"]
    assert native.used()


@pytest.mark.parametrize("fmt", ["int4", "int2", "int1", "uint8", "int16"])
def test_io_same_bytes_with_and_without_native(libs, fmt, tmp_path, monkeypatch):
    """read_if_samples and probe_data give the same samples and statistics
    through the native library and through the NumPy versions, and the
    JAX package's read gives them too."""
    raw = np.random.default_rng(3).integers(0, 256, size=6000).astype(np.uint8)
    path = str(tmp_path / "p.bin")
    raw.tofile(path)
    cfg = sgt.fast_config(data_format=fmt)
    fast = tio.read_if_samples(path, cfg, count=7000, offset_samples=5)
    from softgnss_tpu import io as jio

    np.testing.assert_array_equal(
        fast, jio.read_if_samples(path, sg.fast_config(data_format=fmt), count=7000,
                                  offset_samples=5))
    sig = np.resize(fast, 2 * cfg.samples_per_code)
    stats = tio.probe_data(cfg, sig)
    for name in ("unpack", "narrow_int16", "probe_stats"):
        monkeypatch.setattr(native, name, lambda *a, **k: None)
    np.testing.assert_array_equal(tio.read_if_samples(path, cfg, count=7000, offset_samples=5),
                                  fast)
    plain = tio.probe_data(cfg, sig)
    for k in ("hist_values", "hist_counts", "psd"):
        np.testing.assert_array_equal(plain[k], stats[k], err_msg=k)
    assert plain["hist_values"].dtype == stats["hist_values"].dtype


# --- I/Q -----------------------------------------------------------------------

_SATS = [dict(prn=9, doppler_hz=2300.0, delay_samples=777.0, phase0=0.7),
         dict(prn=27, doppler_hz=-3400.0, delay_samples=2501.0, phase0=3.9)]


def test_synthesize_iq_bit_equal_to_jax():
    jc, tc = sg.fast_config(intermediate_freq=0.0), sgt.fast_config(intermediate_freq=0.0)
    want = jsynth.synthesize_iq(jc, [jsynth.SatelliteSignal(**s) for s in _SATS], 20)
    got = tsynth.synthesize_iq(tc, [tsynth.SatelliteSignal(**s) for s in _SATS], 20,
                               device="cpu")
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # upconverted, it is the real capture synthesized at fs/4 (up to the
    # independent rounding of the two lineages), as in the JAX package
    real, cfg2 = tio.upconvert_iq(tc, got[:, 0].numpy(), got[:, 1].numpy())
    direct = tsynth.synthesize_signal(cfg2, [tsynth.SatelliteSignal(**_SATS[0]),
                                             tsynth.SatelliteSignal(**_SATS[1])], 20,
                                      device="cpu").numpy()
    assert cfg2.intermediate_freq == tc.sampling_freq / 4.0
    assert np.mean(real == direct[:len(real)]) > 0.9


def test_default_scenario_matches_jax():
    cfg_j, cfg_t = sg.fast_config(ms_to_process=40), sgt.fast_config(ms_to_process=40)
    jsats, jsig = jsynth.default_scenario(cfg_j, noise_std=0.0)
    tsats, tsig = tsynth.default_scenario(cfg_t, noise_std=0.0, device="cpu")
    assert [s.prn for s in tsats] == [s.prn for s in jsats]
    np.testing.assert_array_equal(tsig.numpy(), jsig)


@pytest.fixture(scope="module")
def iq_file(tmp_path_factory):
    cfg = sgt.fast_config(intermediate_freq=0.0, number_of_channels=3)
    iq = tsynth.synthesize_iq(cfg, [tsynth.SatelliteSignal(**s) for s in _SATS], 400,
                              noise_std=1.5, seed=6, device="cpu")
    path = tmp_path_factory.mktemp("iq") / "capture_iq8.bin"
    iq.numpy().tofile(path)
    return cfg, str(path)


def test_iq8_receiver_chain(iq_file):
    cfg, path = iq_file
    c = cfg.with_options(data_format="iq8")
    res = run_receiver(c, file_name=path, n_ms=300, navigate=False, device="cpu")
    eff = res.config
    assert eff.intermediate_freq == cfg.sampling_freq / 4.0 and eff.data_format == "int8"
    acq, spc = res.acquisition, c.samples_per_code
    for s in _SATS:
        i = s["prn"] - 1
        assert acq.peak_metric[i] > c.acq_threshold
        d = abs(acq.code_phase[i] - s["delay_samples"] % spc)
        assert d <= 1 or abs(d - spc) <= 1
        assert abs(acq.carr_freq[i] - (eff.intermediate_freq + s["doppler_hz"])) < 10.0
    tr = res.tracking
    lock = (np.abs(tr.i_p[:2, 150:]).mean(axis=1) / np.abs(tr.q_p[:2, 150:]).mean(axis=1))
    assert (lock > 5.0).all()


def test_iq16_loads_like_iq8(iq_file):
    cfg, path = iq_file
    iq8 = np.fromfile(path, np.int8)
    (np.asarray(iq8, np.int16) << 8).tofile(path + "16")
    sig8, c8 = tio.load_capture(path, cfg.with_options(data_format="iq8"))
    sig16, c16 = tio.load_capture(path + "16", cfg.with_options(data_format="iq16"))
    np.testing.assert_array_equal(sig8, sig16)
    assert c8.intermediate_freq == c16.intermediate_freq and c16.data_format == "int8"
    part, _ = tio.load_capture(path, cfg.with_options(data_format="iq8"), count=1000)
    np.testing.assert_array_equal(part, sig8[:1000])


# --- where the entry points run -------------------------------------------------


def test_entry_points_need_a_card_unless_told():
    """No device named: the synthesizers, and acquire / track given a NumPy
    capture, run on the card and raise without one; device='cpu' (or a CPU
    tensor) runs on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults are valid here")
    cfg = sgt.fast_config(number_of_channels=2)
    sats = [tsynth.SatelliteSignal(**_SATS[0])]
    sc = build_scenario(sgt.fast_config(number_of_channels=4), n_sats=4)
    delays = np.full((1, 21), 0.07)
    bits = np.ones((1, 4))
    sig = tsynth.synthesize_signal(cfg, sats, 20, device="cpu").numpy()
    ch = Channels(prn=np.array([9, 0]), acquired_freq=np.array([cfg.intermediate_freq + 2300.0, 0]),
                  code_phase=np.array([777, 0]), status=["T", "-"])
    calls = {
        "synthesize_signal": lambda: tsynth.synthesize_signal(cfg, sats, 20),
        "synthesize_iq": lambda: tsynth.synthesize_iq(cfg, sats, 20),
        "synthesize_dynamic": lambda: tsynth.synthesize_dynamic(cfg, [9], delays, bits, 0.0, 20),
        "synthesize_scenario": lambda: synthesize_scenario(sc, 20),
        "default_scenario": lambda: tsynth.default_scenario(cfg.with_options(ms_to_process=5)),
        "acquire": lambda: acquire(cfg, sig),
        "track": lambda: track(cfg, sig, ch, n_ms=10),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the host when asked, or for a CPU tensor
    assert acquire(cfg, sig, device="cpu").acquired[8]
    assert track(cfg, torch.from_numpy(sig), ch, n_ms=10).i_p.shape == (2, 10)
    assert track(cfg, sig, ch, n_ms=10, device="cpu").i_p.shape == (2, 10)
