"""Port parity: the golden-scenario builder and the dynamic synthesizer of
softgnss_tpu_torch against softgnss_tpu.

``build_scenario`` must draw the same truth (geometry, ephemerides,
timing); ``synthesize_scenario``, noise-free, must give the same capture
up to +-1 LSB on at most 1e-4 of the samples (the float32 sum order over
satellites), as tests/test_torch_signals.py holds synthesize_signal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import softgnss_tpu as sg
import softgnss_tpu_torch as sgt
from softgnss_tpu import scenario as jsc
from softgnss_tpu_torch import convert
from softgnss_tpu_torch import scenario as tsc

torch.set_num_threads(1)

IONO = np.array([40 * 2.0**-30, 16 * 2.0**-27, -5 * 2.0**-24, -3 * 2.0**-24,
                 38 * 2.0**11, 3 * 2.0**14, -1 * 2.0**16, -5 * 2.0**16])


@pytest.mark.parametrize("kwargs", [
    {}, {"full_model": True, "velocity_enu": (3.0, -1.0, 0.5)},
    {"accel_enu": (2.0, 0.0, 0.0), "clock_ppm": 0.8, "n_sats": 6, "seed": 5}],
    ids=["default", "full_model_kinematic", "dynamics_clock"])
def test_build_scenario_fields_equal(kwargs):
    kw = dict({"n_sats": 5}, **kwargs)
    j = jsc.build_scenario(sg.fast_config(), **kw)
    t = tsc.build_scenario(sgt.fast_config(), **kw)
    np.testing.assert_array_equal(t.receiver_ecef, j.receiver_ecef)
    assert t.prns == j.prns and t.tow_count == j.tow_count and t.t_rx0 == j.t_rx0
    assert [convert.ephemeris_to_dict(e) for e in t.ephemerides] == \
        [convert.ephemeris_to_dict(e) for e in j.ephemerides]
    for f in ("receiver_vel", "receiver_accel"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert (t.clock_ppm, t.noise_std, t.amplitude, t.t_bits0) == \
        (j.clock_ppm, j.noise_std, j.amplitude, j.t_bits0)
    times = t.t_rx0 + np.array([0.0, 1.5, 30.0])
    np.testing.assert_array_equal(t.receiver_ecef_at(times), j.receiver_ecef_at(times))
    np.testing.assert_array_equal(t.receiver_vel_at(times), j.receiver_vel_at(times))


@pytest.mark.parametrize("which", ["kinematic_iono", "full_model_clock"])
def test_synthesize_scenario_noise_free_matches(which):
    opts = (dict(velocity_enu=(10.0, 0.0, 0.0)) if which == "kinematic_iono"
            else dict(full_model=True, clock_ppm=-1.2))
    j = jsc.build_scenario(sg.fast_config(), n_sats=4, noise_std=0.0, **opts)
    t = tsc.build_scenario(sgt.fast_config(), n_sats=4, noise_std=0.0, **opts)
    if which == "kinematic_iono":
        j.iono = t.iono = IONO
    want = jsc.synthesize_scenario(j, 60)
    got = tsc.synthesize_scenario(t, 60, device="cpu")
    assert got.dtype == torch.int8 and got.shape == want.shape
    np.testing.assert_array_equal(t.delays, j.delays)
    np.testing.assert_array_equal(t.dopplers, j.dopplers)
    for i in range(4):
        assert t.expected_code_phase(i) == j.expected_code_phase(i)
        assert t.expected_carrier_freq(i) == j.expected_carrier_freq(i)
    d = got.numpy().astype(np.int16) - want
    assert np.abs(d).max() <= 1
    assert np.mean(d != 0) <= 1e-4


def test_synthesize_dynamic_envelope_and_noise():
    """Per-ms amplitude envelopes and edge-held bit streams (no wrap) as
    the JAX synthesizer; the noise has the JAX synthesizer's spread."""
    from softgnss_tpu.signals import synth as jsynth
    from softgnss_tpu_torch.signals import synth as tsynth

    cfg_j, cfg_t = sg.fast_config(), sgt.fast_config()
    rng = np.random.default_rng(9)
    n = 40
    delays = 0.07 + 1e-7 * np.arange(n + 1)[None, :] + rng.uniform(0, 1e-3, (2, 1))
    bits = rng.choice([-1.0, 1.0], (2, 3))                 # shorter than the capture
    env = np.ones((2, n), np.float32)
    env[1, 25:] = 0.0
    args = ([3, 17], delays, bits, 0.013, n)
    want = jsynth.synthesize_dynamic(cfg_j, *args, amplitudes=env, phase0=[0.3, 1.1])
    got = tsynth.synthesize_dynamic(cfg_t, *args, amplitudes=env, phase0=[0.3, 1.1],
                                   device="cpu")
    d = got.numpy().astype(np.int16) - want
    assert np.abs(d).max() <= 1 and np.mean(d != 0) <= 1e-4
    with pytest.raises(ValueError, match="delays_s"):
        tsynth.synthesize_dynamic(cfg_t, [3], delays, bits, 0.0, n, device="cpu")
    noisy = tsynth.synthesize_dynamic(cfg_t, *args, noise_std=4.0, seed=2,
                                     device="cpu").numpy()
    jn = jsynth.synthesize_dynamic(cfg_j, *args, noise_std=4.0, seed=2)
    clean = tsynth.synthesize_dynamic(cfg_t, *args, device="cpu").numpy().astype(np.float64)
    assert abs(np.std(noisy - clean) / np.std(jn - clean) - 1) < 0.03
    assert dataclasses.is_dataclass(tsc.Scenario)
