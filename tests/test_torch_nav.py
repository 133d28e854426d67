"""Port parity: navigation of softgnss_tpu_torch against softgnss_tpu.

Nav bits and messages are held bit for bit; orbits, geodesy, atmosphere,
ionosphere and the least-squares PVT to 1e-6 (m, or relative); the whole
post_navigate stage, on the fabricated observables of
tests/test_postnav.py, to 1e-3 m with equal TOW, decoded ephemerides and
RAIM flags, with the least squares and with the EKF (nav_filter='ekf':
its lsq_* columns and accepted updates too, also with an inactive channel
and through an outage); ekf_epoch alone to 1e-9 relative.  Both packages
get the same NumPy inputs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import softgnss_tpu as sg
import softgnss_tpu_torch as sgt
from softgnss_tpu.nav import assist as jassist
from softgnss_tpu.nav import atmosphere as jatm
from softgnss_tpu.nav import ekf as jekf
from softgnss_tpu.nav import geodesy as jgeo
from softgnss_tpu.nav import iono as jiono
from softgnss_tpu.nav import message as jmsg
from softgnss_tpu.nav import orbit as jorbit
from softgnss_tpu.nav import parity as jpar
from softgnss_tpu.nav import preamble as jpre
from softgnss_tpu.nav import pvt as jpvt
from softgnss_tpu.nav import solve as jsolve
from softgnss_tpu_torch import convert
from softgnss_tpu_torch.nav import assist as tassist
from softgnss_tpu_torch.nav import atmosphere as tatm
from softgnss_tpu_torch.nav import ekf as tekf
from softgnss_tpu_torch.nav import geodesy as tgeo
from softgnss_tpu_torch.nav import iono as tiono
from softgnss_tpu_torch.nav import message as tmsg
from softgnss_tpu_torch.nav import orbit as torbit
from softgnss_tpu_torch.nav import parity as tpar
from softgnss_tpu_torch.nav import preamble as tpre
from softgnss_tpu_torch.nav import pvt as tpvt
from softgnss_tpu_torch.nav import solve as tsolve
from tests.test_postnav import N_MS, TOW_COUNT, FakeTrack, build_track, visible_constellation

torch.set_num_threads(1)

IONO = np.array([40 * 2.0**-30, 16 * 2.0**-27, -5 * 2.0**-24, -3 * 2.0**-24,
                 38 * 2.0**11, 3 * 2.0**14, -1 * 2.0**16, -5 * 2.0**16])
UTC = dict(a0=-2.793967724e-9, a1=-7.105427358e-15, t_ot=147456.0, wn_t=200,
           delta_t_ls=18, wn_lsf=201, dn=3, delta_t_lsf=19)


def _np(x):
    return np.asarray(x, np.float64)


def _eph(module, rng):
    """Random broadcast ephemeris of ``module`` (field values inside the
    message's field widths)."""
    u = lambda lo, hi: float(rng.uniform(lo, hi))                     # noqa: E731
    return module.Ephemeris(
        week_number=2100, accuracy=2, health=0, t_gd=u(-1e-8, 1e-8),
        iodc=17, t_oc=417792.0, a_f2=0.0, a_f1=u(-1e-11, 1e-11),
        a_f0=u(-2e-4, 2e-4), iode_sf2=17, c_rs=u(-80, 80),
        delta_n=u(-5e-9, 5e-9), m_0=u(-3, 3), c_uc=u(-5e-6, 5e-6), e=u(0.001, 0.02),
        c_us=u(2e-6, 1e-5), sqrt_a=u(5150, 5160), t_oe=417792.0, c_ic=u(-2e-7, 2e-7),
        omega_0=u(-3, 3), c_is=u(-2e-7, 2e-7), i_0=u(0.9, 1.0), c_rc=u(150, 350),
        omega=u(-3, 3), omega_dot=u(-9e-9, -7e-9), iode_sf3=17, i_dot=u(-3e-10, 3e-10))


# --- bits and messages: bit-exact ---------------------------------------------


def test_parity_bit_exact():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2, size=(40, 24)).astype(np.int8)
    np.testing.assert_array_equal(tpar.encode_stream(words, 1, 0),
                                  jpar.encode_stream(words, 1, 0))
    ndat = rng.choice([-1, 1], size=(500, 32))
    tx = 2 * jpar.encode_stream(words).astype(np.int64) - 1
    ndat[:39] = np.stack([tx[w * 30 - 2: w * 30 + 30] for w in range(1, 40)])
    got, want = tpar.nav_parity_check(ndat), jpar.nav_parity_check(ndat)
    np.testing.assert_array_equal(got, want)
    assert np.all(got[:39] != 0) and np.any(got[39:] == 0)


def test_message_encode_decode_bit_exact():
    rng = np.random.default_rng(2)
    teph, jeph = _eph(tmsg, np.random.default_rng(3)), _eph(jmsg, np.random.default_rng(3))
    talm = {p: tmsg.ephemeris_to_almanac(teph, p) for p in (1, 2, 3)}
    jalm = {p: jmsg.ephemeris_to_almanac(jeph, p) for p in (1, 2, 3)}
    assert {p: dataclasses.asdict(a) for p, a in talm.items()} == \
        {p: dataclasses.asdict(a) for p, a in jalm.items()}
    t_stream = tmsg.build_nav_stream(teph, 69584, 26, iono=IONO, utc=tmsg.UtcParams(**UTC),
                                     almanac=talm)
    j_stream = jmsg.build_nav_stream(jeph, 69584, 26, iono=IONO, utc=jmsg.UtcParams(**UTC),
                                     almanac=jalm)
    np.testing.assert_array_equal(t_stream, j_stream)
    # flip polarity at random: decoders see the PLL's 180-degree ambiguity
    bits = t_stream * rng.choice([-1, 1])
    for start in (300, 600, 900):
        window, prev = bits[start:start + 1500], bits[start - 1]
        te, ttow = tmsg.decode_ephemeris(window, prev)
        je, jtow = jmsg.decode_ephemeris(window, prev)
        assert convert.ephemeris_to_dict(te) == convert.ephemeris_to_dict(je) and ttow == jtow
        np.testing.assert_array_equal(tmsg.decode_iono(window, prev), jmsg.decode_iono(window, prev))
        assert dataclasses.asdict(tmsg.decode_utc(window, prev)) == \
            dataclasses.asdict(jmsg.decode_utc(window, prev))
        assert tmsg.decode_tow(window, prev) == jmsg.decode_tow(window, prev)
    tp = tmsg.decode_almanac_pages(bits[2:], bits[1], d29star=bits[0])
    jp = jmsg.decode_almanac_pages(bits[2:], bits[1], d29star=bits[0])
    assert {p: dataclasses.asdict(a) for p, a in tp.items()} == \
        {p: dataclasses.asdict(a) for p, a in jp.items()}


@pytest.fixture(scope="module")
def nav_case():
    """The observables of tests/test_postnav.py (5 circular-orbit
    satellites, 37 000 ms, exact boundary times) and the JAX config."""
    config = sg.fast_config(number_of_channels=5, ms_to_process=N_MS, use_trop_corr=False)
    rx = np.asarray(jgeo.geo2cart(np.array([47.0, 0, 0]), np.array([8.5, 0, 0]), 500.0, 4))
    t_rx0 = TOW_COUNT * 6.0 - 0.35
    ephs = visible_constellation(rx, 5, TOW_COUNT * 6.0)
    return config, rx, ephs, build_track(config, rx, ephs, t_rx0)


def test_preambles_bit_exact(nav_case):
    _, _, _, track = nav_case
    rng = np.random.default_rng(4)
    i_p = track.i_p + rng.normal(0, 2000.0, track.i_p.shape)
    for status in (["T"] * 5, ["T", "-", "T", "T", "-"]):
        got, want = tpre.find_preambles(i_p, status), jpre.find_preambles(i_p, status)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    noise = rng.normal(size=(2, 8000))
    for a, b in zip(tpre.find_preambles(noise, ["T", "T"]), jpre.find_preambles(noise, ["T", "T"])):
        np.testing.assert_array_equal(a, b)


# --- float64 math: within 1e-6 ------------------------------------------------


def test_orbit_matches():
    rng = np.random.default_rng(5)
    teph = [_eph(tmsg, np.random.default_rng(s)) for s in range(6)]
    jeph = [_eph(jmsg, np.random.default_rng(s)) for s in range(6)]
    np.testing.assert_array_equal(torbit.pack_ephemerides(teph), jorbit.pack_ephemerides(jeph))
    for t in (417792.0 + rng.uniform(-7200, 7200, 4)).tolist() + [10.0, 604000.0]:
        tp, tc = torbit.satellite_positions(t, teph)
        jp, jc = jorbit.satellite_positions(t, jeph)
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-15)
    t = rng.uniform(-8e5, 8e5, 100)
    np.testing.assert_array_equal(torbit.check_t(t).numpy(), np.asarray(jorbit.check_t(t)))


def test_geodesy_matches():
    rng = np.random.default_rng(6)
    lat, lon = rng.uniform(-80, 84, 50), rng.uniform(-180, 180, 50)
    h = rng.uniform(-100, 9000, 50)
    xyz_t = tgeo.geo2cart(np.stack([lat, 0 * lat, 0 * lat]), np.stack([lon, 0 * lon, 0 * lon]), h)
    xyz_j = jgeo.geo2cart(np.stack([lat, 0 * lat, 0 * lat]), np.stack([lon, 0 * lon, 0 * lon]), h)
    for a, b in zip(xyz_t, xyz_j):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)
    x, y, z = (_np(v) for v in xyz_j)
    for ell in (0, 4):
        for a, b in zip(tgeo.cart2geo(x, y, z, ell), jgeo.cart2geo(x, y, z, ell)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)
    for a, b in zip(tgeo.togeod(6378137.0, 298.257223563, x, y, z),
                    jgeo.togeod(6378137.0, 298.257223563, x, y, z)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)
    origin = np.stack([x, y, z], 1)[0]
    dx = rng.normal(0, 2e7, (30, 3))
    for a, b in zip(tgeo.topocent(origin, dx), jgeo.topocent(origin, dx)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)
    sat = rng.normal(0, 2e7, (10, 3))
    np.testing.assert_allclose(_np(tgeo.e_r_corr(0.07, sat)), _np(jgeo.e_r_corr(0.07, sat)),
                               rtol=0, atol=1e-6)
    keep = (np.abs(lat) < 80) & (np.abs(lon - 8.5) < 3)
    zone = 32
    for a, b in zip(tgeo.cart2utm(x[keep], y[keep], z[keep], zone),
                    jgeo.cart2utm(x[keep], y[keep], z[keep], zone)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)
    for la, lo in zip(lat[:20], lon[:20]):
        assert tgeo.find_utm_zone(la, lo) == jgeo.find_utm_zone(la, lo)
        assert tgeo.deg2dms(la) == jgeo.deg2dms(la)
        assert tgeo.dms2mat(tgeo.deg2dms(lo)) == jgeo.dms2mat(jgeo.deg2dms(lo))
    assert tgeo.find_utm_zone(75.0, 10.0) == jgeo.find_utm_zone(75.0, 10.0)


def test_atmosphere_and_iono_match():
    rng = np.random.default_rng(7)
    el = rng.uniform(-5, 90, 200)
    np.testing.assert_allclose(_np(tatm.tropo(np.sin(np.deg2rad(el)))),
                               _np(jatm.tropo(np.sin(np.deg2rad(el)))), rtol=1e-12, atol=1e-9)
    az = rng.uniform(0, 360, 200)
    for tow in (10000.0, 50400.0, 300000.0):
        for lat, lon in ((47.0, 8.5), (-33.0, 151.2), (70.0, -150.0)):
            got = _np(tiono.klobuchar(IONO, lat, lon, az, el, tow))
            want = _np(jiono.klobuchar(IONO, lat, lon, az, el, tow))
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)


def test_least_squares_pos_matches():
    from tests.test_geodesy_pvt import make_constellation

    rx = np.asarray(jgeo.geo2cart(np.array([47.0, 0, 0]), np.array([8.5, 0, 0]), 500.0, 4))
    sat_pos = make_constellation(rx, n_sats=7)
    obs = (np.linalg.norm(sat_pos - rx, axis=1) + 93_000.0
           + np.random.default_rng(8).normal(0, 3.0, 7))
    mask = np.ones(len(obs), bool)
    mask[2] = False
    for use_trop in (True, False):
        for m in (None, mask):
            got = tpvt.least_squares_pos(sat_pos, obs, m, use_trop=use_trop)
            want = jpvt.least_squares_pos(sat_pos, obs, m, use_trop=use_trop)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-6)


def test_predict_doppler_matches():
    teph = [_eph(tmsg, np.random.default_rng(s)) for s in range(4)] + [None] * 28
    jeph = [_eph(jmsg, np.random.default_rng(s)) for s in range(4)] + [None] * 28
    rx = np.asarray(jgeo.geo2cart(np.array([47.0, 0, 0]), np.array([8.5, 0, 0]), 500.0, 4))
    got = tassist.predict_doppler(sgt.fast_config(), teph, rx, 417800.0)
    want = jassist.predict_doppler(sg.fast_config(), jeph, rx, 417800.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.isnan(got[4:]).all() and np.isfinite(got[:4]).all()


# --- the whole navigation stage ------------------------------------------------


def _compare(tsol, jsol):
    t, j = convert.nav_solutions_to_numpy(tsol), convert.nav_solutions_to_numpy(jsol)
    assert t["tow"] == j["tow"] and t["first_epoch_ms"] == j["first_epoch_ms"]
    np.testing.assert_array_equal(t["first_subframe"], j["first_subframe"])
    np.testing.assert_array_equal(t["prn"], j["prn"])
    np.testing.assert_array_equal(t["raim_flag"], j["raim_flag"])
    np.testing.assert_array_equal(t["raim_excluded_prn"], j["raim_excluded_prn"])
    np.testing.assert_array_equal(t["n_used"], j["n_used"])
    assert t["utm_zone"] == j["utm_zone"] and t["week_number"] == j["week_number"]
    assert t["utc_params"] == j["utc_params"] and t["almanac"] == j["almanac"]
    for f in ("x", "y", "z", "dt", "e", "n", "u", "raw_p", "corrected_p"):
        np.testing.assert_allclose(t[f], j[f], rtol=0, atol=1e-3, err_msg=f)
    for f in ("latitude", "longitude", "el", "az", "dop", "vx", "vy", "vz", "clock_drift"):
        np.testing.assert_allclose(t[f], j[f], rtol=0, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(t["height"], j["height"], rtol=0, atol=1e-3)
    assert t["nav_filter"] == j["nav_filter"]
    for f in ("lsq_x", "lsq_y", "lsq_z", "lsq_dt", "ekf_used"):
        assert (t[f] is None) == (j[f] is None), f
        if t[f] is not None:
            np.testing.assert_allclose(t[f], j[f], rtol=0, atol=1e-3, err_msg=f)


@pytest.mark.parametrize("case", ["cold", "raim_fault"])
def test_post_navigate_matches(nav_case, case):
    """Cold decode, and a 22-km fault on one channel from 20 s on (RAIM
    invalidates the late epochs: 5 satellites cannot isolate it)."""
    jcfg, rx, ephs, track = nav_case
    if case == "raim_fault":
        bad = FakeTrack()
        bad.__dict__.update(track.__dict__)
        bad.absolute_sample = track.absolute_sample.copy()
        bad.absolute_sample[0, 20000:] += 300.0
        track = bad
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jsol, jephs = jsolve.post_navigate(jcfg, track)
    tsol, tephs = tsolve.post_navigate(tcfg, track)
    _compare(tsol, jsol)
    assert [None if e is None else convert.ephemeris_to_dict(e) for e in tephs] == \
        [None if e is None else convert.ephemeris_to_dict(e) for e in jephs]
    assert tsol.tow == TOW_COUNT * 6
    err = np.sqrt((tsol.x - rx[0]) ** 2 + (tsol.y - rx[1]) ** 2 + (tsol.z - rx[2]) ** 2)
    if case == "raim_fault":
        assert (tsol.raim_flag == 2).any() and np.isnan(tsol.x[tsol.raim_flag == 2]).all()
    else:
        assert np.nanmax(err) < 5.0 and (tsol.raim_flag == 0).all()


def test_warm_start_navigates(nav_case):
    """Supplied ephemerides, iono and UTC: 12 s of observables give fixes
    (the TOW from the TLM+HOW alone), as in the JAX package."""
    jcfg, rx, ephs, track = nav_case
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    teph = [None] * 32
    for i, e in enumerate(ephs):
        teph[i] = convert.ephemeris_from_dict(convert.ephemeris_to_dict(e))
    short = FakeTrack()
    short.__dict__.update(track.__dict__)
    for f in ("i_p", "absolute_sample", "carr_freq"):
        setattr(short, f, getattr(track, f)[:, :12000])
    sol, out = tsolve.post_navigate(tcfg, short, ephemerides=teph, iono=IONO,
                                    utc=tmsg.UtcParams(**UTC))
    assert sol is not None and sol.tow == TOW_COUNT * 6 and out[:5] == teph[:5]
    np.testing.assert_array_equal(sol.iono, IONO)
    assert sol.utc_offset_s() is not None
    err = np.sqrt((sol.x - rx[0]) ** 2 + (sol.y - rx[1]) ** 2 + (sol.z - rx[2]) ** 2)
    # the fabricated observables carry no ionosphere: the correction shows
    assert np.isfinite(err).all() and np.median(err) < 100.0


def test_nav_solutions_round_trip(nav_case):
    jcfg, _, _, track = nav_case
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    short = FakeTrack()
    short.__dict__.update(track.__dict__)
    sol, _ = tsolve.post_navigate(tcfg.with_options(raim=False), track)
    d = convert.nav_solutions_to_numpy(sol)
    back = convert.nav_solutions_from_numpy(d)
    for f, v in convert.nav_solutions_to_numpy(back).items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, d[f], err_msg=f)
        else:
            assert v == d[f], f
    assert back.ttff_ms == sol.ttff_ms and back.n_epochs == sol.n_epochs
    # too short a record gives no solution, as in the JAX package
    short.i_p = track.i_p[:, :10000]
    short.absolute_sample = track.absolute_sample[:, :10000]
    assert tsolve.post_navigate(tcfg, short)[0] is None
    # the EKF's columns round-trip too
    sol_k, _ = tsolve.post_navigate(tcfg.with_options(nav_filter="ekf"), track)
    d_k = convert.nav_solutions_to_numpy(sol_k)
    assert d_k["nav_filter"] == "ekf" and d_k["ekf_used"].dtype == np.int64
    back_k = convert.nav_solutions_to_numpy(convert.nav_solutions_from_numpy(d_k))
    for f in ("x", "lsq_x", "lsq_dt", "ekf_used"):
        np.testing.assert_array_equal(back_k[f], d_k[f], err_msg=f)


@pytest.mark.parametrize("case", ["all", "inactive_channel", "outage"])
def test_post_navigate_ekf_matches(nav_case, case):
    """nav_filter='ekf' against the JAX package: every channel; channel 4
    inactive (its infinite travel time must not poison the state, 4
    satellites left); channels 3 and 4 lose lock at 20 s (3 satellites:
    least squares stops, the EKF bridges), the cases of tests/test_ekf.py."""
    jcfg, rx, ephs, track = nav_case
    jcfg = jcfg.with_options(nav_filter="ekf")
    t2 = FakeTrack()
    t2.__dict__.update(track.__dict__)
    if case == "inactive_channel":
        t2.status = list(track.status)
        t2.status[4] = "-"
    elif case == "outage":
        loss = np.full(len(track.prn), np.inf)
        loss[3] = loss[4] = 20000.0
        t2.lock_loss_ms = loss
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jsol, _ = jsolve.post_navigate(jcfg, t2)
    tsol, _ = tsolve.post_navigate(tcfg, t2)
    _compare(tsol, jsol)
    assert tsol.nav_filter == "ekf" and tsol.lsq_x is not None
    err = np.sqrt((tsol.x - rx[0]) ** 2 + (tsol.y - rx[1]) ** 2 + (tsol.z - rx[2]) ** 2)
    assert np.isfinite(tsol.x).sum() >= 0.9 * tsol.n_epochs
    if case == "outage":
        epoch_ms = tsol.first_epoch_ms + tsol._period_ms * np.arange(tsol.n_epochs)
        out = epoch_ms > 20000.0 + tsol._period_ms
        assert out.sum() >= 10 and not np.isfinite(tsol.lsq_x[out]).any()
        assert np.isfinite(tsol.x[out]).all() and (tsol.ekf_used[out] <= 3).all()
        assert np.nanmax(err[out]) < 100.0
        # the summary's EKF tag counts the bridged epochs, as the JAX one does
        from softgnss_tpu import pipeline as jpipe
        from softgnss_tpu_torch import pipeline as tpipe

        line = tpipe.ReceiverResults(config=tcfg, solutions=tsol).summary().splitlines()[0]
        assert line.startswith("PVT (EKF), ") and "epochs bridged" in line
        assert line == jpipe.ReceiverResults(config=jcfg, solutions=jsol).summary().splitlines()[0]
    else:
        assert np.nanmedian(err) < 10.0


def _ekf_inputs(seed: int, n_sats: int = 6):
    """One epoch's satellites above a receiver at 47 N 8.5 E, pseudoranges
    and range rates with noise, one masked satellite and one infinite
    pseudorange (an inactive channel)."""
    from tests.test_geodesy_pvt import make_constellation

    rng = np.random.default_rng(seed)
    rx = np.asarray(jgeo.geo2cart(np.array([47.0, 0, 0]), np.array([8.5, 0, 0]), 500.0, 4))
    sat_pos = make_constellation(rx, n_sats=n_sats)
    sat_vel = rng.normal(0, 3000.0, (n_sats, 3))
    pr = np.linalg.norm(sat_pos - rx, axis=1) + 1500.0 + rng.normal(0, 3.0, n_sats)
    pr[-1] = np.inf
    rr = rng.normal(0, 500.0, n_sats)
    mask = np.ones(n_sats, bool)
    mask[1] = False
    ls = np.concatenate([rx + rng.normal(0, 20.0, 3), [1500.0]])
    vel = rng.normal(0, 0.5, 4)
    return sat_pos, sat_vel, pr, rr, mask, ls, vel


@pytest.mark.parametrize("use_trop", [True, False])
def test_ekf_epoch_matches(use_trop):
    """ekf_epoch alone, three epochs (init, then two predict + update) with
    an iono model on the last, against the JAX function: 1e-9 relative."""
    kw = dict(t_step=0.5, q_accel=2.0, q_clock=1.0, q_bias=0.1, r_pr=5.0, r_rr=0.15, gate=6.0)
    jst, tst = jekf.initial_ekf_state(), tekf.initial_ekf_state()
    for ep in range(3):
        sat_pos, sat_vel, pr, rr, mask, ls, vel = _ekf_inputs(10 + ep)
        iono = None if ep < 2 else (IONO, 417800.0)
        jst, jout = jekf.ekf_epoch(jst, sat_pos, sat_vel, pr, rr, mask, use_trop, iono,
                                   ls_pos=ls, ls_ok=True, ls_vel=vel, **kw)
        tst, tout = tekf.ekf_epoch(tst, sat_pos, sat_vel, pr, rr, mask, use_trop,
                                   None if iono is None else (torch.from_numpy(IONO), iono[1]),
                                   ls_pos=torch.from_numpy(ls), ls_ok=True,
                                   ls_vel=torch.from_numpy(vel), **kw)
        assert tst.init and bool(jst.init)
        np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(tst.p.numpy(), np.asarray(jst.p), rtol=1e-9, atol=1e-9)
        for a, b in zip(tout[:4], jout[:4]):
            np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b), rtol=1e-9)
        assert tout[4] == int(jout[4]) and tout[4] >= 1
    # before any valid least-squares fix the filter stays uninitialized
    st, out = tekf.ekf_epoch(tekf.initial_ekf_state(), sat_pos, sat_vel, pr, rr, mask, True,
                             ls_pos=torch.from_numpy(ls), ls_ok=False, **kw)
    assert not st.init and np.isnan(out[0].numpy()).all() and out[4] == 0
