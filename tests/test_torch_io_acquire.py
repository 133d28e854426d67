"""Port parity: capture IO and acquisition of softgnss_tpu_torch against
softgnss_tpu on the same captures (JAX on the CPU, the port on CPU
tensors)."""

import numpy as np
import pytest
import torch

import softgnss_tpu as sg
import softgnss_tpu_torch as sgt
from softgnss_tpu import io as jio
from softgnss_tpu.acquire import search as jsearch
from softgnss_tpu.signals.synth import SatelliteSignal, synthesize_signal
from softgnss_tpu_torch import io as tio
from softgnss_tpu_torch.acquire import search as tsearch

torch.set_num_threads(1)


@pytest.mark.parametrize("fmt", ["int8", "uint8", "int16", "int4", "int2", "int1",
                                 "iq8", "iq16"])
def test_load_capture_and_probe_equal(fmt, tmp_path):
    rng = np.random.default_rng(len(fmt) * 7 + ord(fmt[-1]))
    path = tmp_path / f"cap.{fmt}"
    nbytes = 2 * 4096 * 12 if fmt in ("int16", "iq8") else 4096 * 12
    if fmt == "iq16":
        nbytes *= 4
    path.write_bytes(rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes())
    jc = sg.fast_config(data_format=fmt)
    tc = sgt.fast_config(data_format=fmt)
    for count, offset in ((None, 0), (4096 * 3, 8)):
        want, jc2 = jio.load_capture(str(path), jc, count=count, offset_samples=offset)
        got, tc2 = tio.load_capture(str(path), tc, count=count, offset_samples=offset)
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want)
        assert (tc2.intermediate_freq, tc2.data_format) == (jc2.intermediate_freq,
                                                           jc2.data_format)
    pj, pt = jio.probe_data(jc2, want), tio.probe_data(tc2, got)
    assert pj.keys() == pt.keys()
    for k in pj:
        np.testing.assert_array_equal(pt[k], pj[k], err_msg=k)


def test_write_read_round_trip(tmp_path):
    x = np.random.default_rng(0).integers(-128, 128, 5000).astype(np.int8)
    tio.write_if_samples(str(tmp_path / "a.bin"), x)
    np.testing.assert_array_equal(
        tio.read_if_samples(str(tmp_path / "a.bin"), sgt.fast_config()), x)


@pytest.fixture(scope="module")
def capture():
    cfg = sg.fast_config()
    rng = np.random.default_rng(21)
    sats = [SatelliteSignal(prn=p, doppler_hz=float(rng.uniform(-5000, 5000)),
                            delay_samples=float(rng.integers(0, 4096)), amplitude=a,
                            phase0=float(rng.uniform(0, 6)))
            for p, a in ((3, 3.5), (7, 3.0), (19, 2.5), (30, 2.0), (25, 0.9))]
    return synthesize_signal(cfg, sats, 24, noise_std=8.0, seed=5), sats


@pytest.mark.parametrize("k_ms", [2, 10])
@pytest.mark.parametrize("hinted", [False, True])
def test_acquisition_matches(capture, k_ms, hinted):
    capture, sats = capture
    """Same code phase and Doppler bin, carr_freq within 1e-3 Hz, peak
    metric within 1e-4 relative (FFT backends differ in the last bits)."""
    jc = sg.fast_config(acq_noncoherent_ms=k_ms)
    tc = sgt.fast_config(acq_noncoherent_ms=k_ms)
    hints = None
    if hinted:
        # true Doppler for PRNs 3 and 19, a band-missing hint for PRN 7
        hints = np.full(32, np.nan)
        for s in sats[0], sats[2]:
            hints[s.prn - 1] = jc.intermediate_freq + s.doppler_hz + 120.0
        hints[sats[1].prn - 1] = jc.intermediate_freq + 20_000.0
    want = jsearch.acquire(jc, capture, doppler_hints=hints)
    got = tsearch.acquire(tc, torch.from_numpy(capture.copy()), doppler_hints=hints)
    assert want.acquired.sum() >= 3
    np.testing.assert_array_equal(got.acquired, want.acquired)
    np.testing.assert_array_equal(got.code_phase, want.code_phase)
    assert np.max(np.abs(got.carr_freq - want.carr_freq)) < 1e-3
    np.testing.assert_allclose(got.peak_metric, want.peak_metric, rtol=1e-4)
    mask_j = jsearch.hint_bin_mask(jc, hints, 500.0)
    mask_t = tsearch.hint_bin_mask(tc, hints, 500.0)
    assert (mask_j is None) == (mask_t is None)
    if mask_j is not None:
        np.testing.assert_array_equal(mask_t, mask_j)

    # channel assignment and the status table from the same results
    ch_j = jsearch.assign_channels(jc, want)
    ch_t = tsearch.assign_channels(tc, got)
    np.testing.assert_array_equal(ch_t.prn, ch_j.prn)
    assert ch_t.status == ch_j.status
    assert (tsearch.format_channel_status(tc, ch_t)
            == jsearch.format_channel_status(jc, ch_j))


def test_acquisition_short_capture_rejected(capture):
    with pytest.raises(ValueError, match="acquisition needs"):
        tsearch.acquire(sgt.fast_config(), torch.from_numpy(capture[0][:4096].copy()))
    assert tsearch.fine_freq_resolution(sgt.default_config()) == \
        jsearch.fine_freq_resolution(sg.default_config())
