"""Port parity: config, C/A codes, integer NCOs and the synthesizer of
softgnss_tpu_torch against softgnss_tpu on the same inputs (NumPy in,
NumPy out; JAX on the CPU)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import softgnss_tpu as sg
import softgnss_tpu_torch as sgt
from softgnss_tpu.signals import ca as jca
from softgnss_tpu.signals import nco as jnco
from softgnss_tpu.signals import synth as jsynth
from softgnss_tpu_torch.convert import config_from_dict
from softgnss_tpu_torch.signals import ca as tca
from softgnss_tpu_torch.signals import nco as tnco
from softgnss_tpu_torch.signals import synth as tsynth

torch.set_num_threads(1)

_FS = 38_192_000.0


def _nco_inputs():
    rng = np.random.default_rng(11)
    edge32 = np.asarray([0, 1, -1, 2**31 - 1, -2**31, 2**30, -2**30], np.int32)
    p0 = np.concatenate([rng.integers(-2**31, 2**31, 4000).astype(np.int32), edge32])
    w = np.concatenate([rng.integers(-2**31, 2**31, 4000).astype(np.int32), edge32[::-1]])
    k = np.concatenate([rng.integers(0, 400_000, 4000).astype(np.int32),
                        np.asarray([0, 1, 38_191, 381_919, 65_535, 2, 3], np.int32)])
    # frequencies: random (both signs), IF +- Doppler, and values whose
    # counts land on the u32 wrap (f = fs/2 -> 2^31, f = -fs/2 -> -2^31)
    freqs = np.concatenate([rng.uniform(-2e7, 2e7, 2000),
                            9_548_000.0 + rng.uniform(-7000, 7000, 500),
                            [0.0, -1.0, _FS / 2, -_FS / 2, _FS, -_FS, 0.5 * _FS / 2**32]])
    x = np.concatenate([rng.uniform(-3, 3, 20_000).astype(np.float32),
                        np.float32([0.25, -0.25, 0.5, -0.5, 0.75, 0.0, 1e-8, 0.2499999,
                                    0.25000003, -0.7500001])])
    q = np.concatenate([rng.integers(-2**50, 2**52, 2000),
                        np.asarray([0, 1, -1, 2**40, -2**40, 2**40 - 1, -(2**40) + 1])])
    return p0, w, k, freqs, x, q


_NCO_CASES = {
    "carrier_turns": (lambda m, a: m.carrier_turns(*a[:3]), "ints"),
    "carrier_sin_cos": (lambda m, a: m.carrier_sin_cos(*a[:3]), "ints"),
    "sin_turns": (lambda m, a: m.sin_turns(a[4]), "x"),
    "carrier_step_u32": (lambda m, a: m.carrier_step_u32(a[3], _FS), "freqs"),
    "code_step_q": (lambda m, a: m.code_step_q(1.023e6 + a[3] / 1540.0, _FS), "freqs"),
    "ceil_chip_index": (lambda m, a: m.ceil_chip_index(a[5]), "q"),
}


@pytest.mark.parametrize("name", sorted(_NCO_CASES))
def test_nco_bit_exact(name):
    fn, _ = _NCO_CASES[name]
    args = _nco_inputs()
    want = fn(jnco, [jnp.asarray(a) for a in args])
    got = fn(tnco, [torch.from_numpy(np.ascontiguousarray(a)) for a in args])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for a, b in zip(want, got):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(b.numpy(), a)


def test_chips_to_q_matches():
    for chips in (0.5, 0.25, 0.1, 1023.0, 0.123456789):
        assert tnco.chips_to_q(chips) == jnco.chips_to_q(chips)


@pytest.mark.parametrize("which", ["fast", "default"])
def test_ca_codes_and_tables_equal(which):
    jc = getattr(sg, f"{which}_config")()
    tc = getattr(sgt, f"{which}_config")()
    np.testing.assert_array_equal(tca.gold_codes(), jca.gold_codes())
    for prn in (1, 17, 32, 37, 51):
        np.testing.assert_array_equal(tca.padded_code(prn), jca.padded_code(prn))
    np.testing.assert_array_equal(tca.resample_indices(tc), jca.resample_indices(jc))
    np.testing.assert_array_equal(tca.ca_table(tc), jca.ca_table(jc))


def test_config_derived_fields_match():
    for jc in (sg.default_config(), sg.fast_config(pdi_ms=4, track_block_ms=16),
               sg.fast_config(track_frame_margin=40, acq_noncoherent_ms=10)):
        tc = config_from_dict(dataclasses.asdict(jc))
        for prop in ("samples_per_code", "samples_per_chip", "num_doppler_bins",
                     "doppler_bin_freqs", "pdi_s", "track_frame_pre", "acquisition_ms",
                     "pll_taus", "dll_taus"):
            assert getattr(tc, prop) == getattr(jc, prop), prop
        assert tc.total_samples_needed() == jc.total_samples_needed()
        assert tc.loop_coefficients(3.0, 0.7, 2.0) == jc.loop_coefficients(3.0, 0.7, 2.0)
    # the port's frame is one code period + slack, in whole 4-sample words
    tc = sgt.default_config()
    assert tc.track_window == 38_320 and tc.track_window % 4 == 0


@pytest.mark.parametrize("impl", ["onehot", "pallas"])
def test_unported_correlators_rejected(impl):
    """'onehot' and 'pallas' select the per-ms tracker (kernel B4) at any
    front end; 'auto' and 'gather' the block tracker where the code period
    is whole int32 words; unknown names are rejected."""
    assert sgt.fast_config(correlator_impl=impl).tracker == "per_ms"
    assert sgt.default_config(correlator_impl=impl, sampling_freq=38_194_000.0).tracker \
        == "per_ms"
    for ok, tracker in (("auto", "block"), ("gather", "block"), ("megakernel", "block")):
        assert sgt.fast_config(correlator_impl=ok).tracker == tracker
    assert sgt.fast_config(sampling_freq=4_094_000.0).tracker == "per_ms"
    with pytest.raises(ValueError, match="expected one of"):
        sgt.fast_config(correlator_impl=impl + "x")
    # a JAX config naming the per-ms correlators carries across
    tc = config_from_dict(dataclasses.asdict(sg.fast_config(correlator_impl=impl)))
    assert tc.correlator_impl == impl and tc.tracker == "per_ms"


def _sats(module, rng, n_sats=4):
    return [module.SatelliteSignal(
        prn=int(p), doppler_hz=float(rng.uniform(-5000, 5000)),
        delay_samples=float(rng.uniform(0, 4096)), amplitude=float(rng.uniform(2, 20)),
        phase0=float(rng.uniform(0, 6)),
        nav_bits=tuple(int(b) for b in rng.choice([-1, 1], 8)))
        for p in rng.choice(np.arange(1, 33), n_sats, replace=False)]


@pytest.mark.parametrize("which,n_ms", [("fast", 60), ("default", 4)])
def test_synth_noise_free_matches(which, n_ms):
    """Equal sample for sample except <= 1e-4 of samples by +-1 LSB (the
    float32 sum order over satellites)."""
    jc = getattr(sg, f"{which}_config")()
    tc = getattr(sgt, f"{which}_config")()
    want = jsynth.synthesize_signal(jc, _sats(jsynth, np.random.default_rng(3)), n_ms)
    got = tsynth.synthesize_signal(tc, _sats(tsynth, np.random.default_rng(3)), n_ms,
                                  device="cpu")
    assert got.dtype == torch.int8 and got.shape == want.shape
    d = got.numpy().astype(np.int16) - want
    assert np.abs(d).max() <= 1
    assert np.mean(d != 0) <= 1e-4


def test_synth_noise_std_and_amplitude():
    jc, tc = sg.fast_config(), sgt.fast_config()
    assert tsynth.amplitude_for_cn0(tc, 45.0, 8.0) == jsynth.amplitude_for_cn0(jc, 45.0, 8.0)
    sats = _sats(tsynth, np.random.default_rng(5))
    clean = tsynth.synthesize_signal(tc, sats, 40, device="cpu").numpy().astype(np.float64)
    noisy = tsynth.synthesize_signal(tc, sats, 40, noise_std=8.0, seed=1,
                                     device="cpu").numpy()
    jn = jsynth.synthesize_signal(jc, _sats(jsynth, np.random.default_rng(5)), 40,
                                  noise_std=8.0, seed=1).astype(np.float64)
    std_t = np.std(noisy - clean)
    std_j = np.std(jn - clean)
    assert abs(std_t / std_j - 1) < 0.02
    # a seed fixes the draw; another seed gives another draw
    again = tsynth.synthesize_signal(tc, sats, 40, noise_std=8.0, seed=1,
                                     device="cpu").numpy()
    other = tsynth.synthesize_signal(tc, sats, 40, noise_std=8.0, seed=2,
                                     device="cpu").numpy()
    np.testing.assert_array_equal(noisy, again)
    assert np.mean(noisy != other) > 0.5
