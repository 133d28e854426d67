"""Float64 NumPy oracle of the receiver math, for parity tests and checks.

The port's own copy of the JAX package's oracle/numpy_rx.py: the same
functions, arguments and return values, on the port's ``config`` and
``signals.ca`` (the port imports nothing of the JAX package, and the
card's machine has no JAX).  It is a vectorized re-derivation of the
reference's *mathematics* (the equations in SURVEY.md §2/§3, cited per
function below) in NumPy float64, independent of the receiver's integer
NCOs, tables and kernels: tests, ``softgnss_tpu_torch.scripts`` and
``chip_smoke.py`` hold the port's correlator time series, acquisition
grids and fixes against it (<1e-3 RMS target, BASELINE.md).

It is *not* part of the receiver: nothing imports it outside tests,
scripts and ``chip_smoke.py``.  It runs on the host; no torch device.
"""

from __future__ import annotations

import numpy as np

from softgnss_tpu_torch.config import ReceiverConfig
from softgnss_tpu_torch.signals.ca import ca_table, padded_code


def oracle_acquire_grid(config: ReceiverConfig, long_signal: np.ndarray, prn: int):
    """Acquisition correlation grid + peak metric for one PRN, float64.

    Math per reference acquisition.py:55-164: two 1-ms coherent FFT
    correlations per Doppler bin, keep the stronger row, peak / second-peak
    with a +/-1 chip exclusion zone.
    Returns (grid (bins, spc), code_phase, bin_index, metric).
    """
    spc = config.samples_per_code
    fs = config.sampling_freq
    sig1 = long_signal[:spc].astype(np.float64)
    sig2 = long_signal[spc:2 * spc].astype(np.float64)
    t = np.arange(spc) / fs

    code_fd = np.conj(np.fft.fft(ca_table(config)[prn - 1].astype(np.float64)))
    freqs = np.asarray(config.doppler_bin_freqs)
    # sin(th) + 1j*cos(th) mixing, as in the reference (acquisition.py:103-117)
    theta = 2.0 * np.pi * freqs[:, None] * t[None, :]
    mixer = np.sin(theta) + 1j * np.cos(theta)
    r1 = np.abs(np.fft.ifft(np.fft.fft(mixer * sig1) * code_fd)) ** 2
    r2 = np.abs(np.fft.ifft(np.fft.fft(mixer * sig2) * code_fd)) ** 2
    take1 = r1.max(axis=1, keepdims=True) > r2.max(axis=1, keepdims=True)
    grid = np.where(take1, r1, r2)

    flat = int(np.argmax(grid))
    bin_index, code_phase = divmod(flat, spc)
    peak = grid[bin_index, code_phase]
    pos = np.arange(spc)
    dist = np.abs(pos - code_phase)
    circ = np.minimum(dist, spc - dist)
    second = grid[bin_index, circ >= config.samples_per_chip].max()
    return grid, code_phase, bin_index, peak / second


def oracle_track_channel(config: ReceiverConfig, signal: np.ndarray, prn: int,
                         acq_freq: float, code_phase: int, n_ms: int):
    """Track one channel for n_ms milliseconds in float64.

    Implements the loop equations of reference tracking.py:107-275 with the
    reference's float64 linspace/ceil code-phase formulation (not the integer
    NCO) so it is an independent formulation of the same math.
    Returns a dict of per-ms arrays.
    """
    fs = config.sampling_freq
    spacing = config.dll_correlator_spacing
    tau1c, tau2c = config.pll_taus
    tau1d, tau2d = config.dll_taus
    pdi = config.pdi_s

    code = padded_code(prn).astype(np.float64)
    ptr = config.skip_samples + int(code_phase)
    code_freq = config.code_freq_basis
    rem_code = 0.0
    carr_freq = float(acq_freq)
    rem_carr = 0.0
    nco_carr = err_carr = nco_code = err_code = 0.0
    K = config.pdi_ms
    acc = [0.0] * 6

    log = {k: np.zeros(n_ms) for k in (
        "absolute_sample", "code_freq", "carr_freq", "i_p", "i_e", "i_l",
        "q_e", "q_p", "q_l", "dll_discr", "dll_discr_filt", "pll_discr",
        "pll_discr_filt")}

    for ms in range(n_ms):
        step = code_freq / fs
        blk = int(np.ceil((config.code_length - rem_code) / step))
        raw = signal[ptr:ptr + blk].astype(np.float64)
        if raw.shape[0] != blk:
            raise ValueError("oracle ran out of samples")
        ptr += blk

        tcode = rem_code + step * np.arange(blk)
        early = code[np.ceil(tcode - spacing).astype(np.int64)]
        prompt = code[np.ceil(tcode).astype(np.int64)]
        late = code[np.ceil(tcode + spacing).astype(np.int64)]
        rem_code = tcode[blk - 1] + step - config.code_length

        trig = carr_freq * 2.0 * np.pi * np.arange(blk + 1) / fs + rem_carr
        rem_carr = trig[blk] % (2.0 * np.pi)
        i_bb = np.sin(trig[:blk]) * raw
        q_bb = np.cos(trig[:blk]) * raw

        i_e, q_e = early @ i_bb, early @ q_bb
        i_p, q_p = prompt @ i_bb, prompt @ q_bb
        i_l, q_l = late @ i_bb, late @ q_bb

        # coherent accumulation over config.pdi_ms code periods (K == 1 is
        # the reference cadence); filters update on the K-period totals
        acc = [a + v for a, v in zip(acc, (i_e, i_p, i_l, q_e, q_p, q_l))]
        if ms % K == K - 1:
            a_ie, a_ip, a_il, a_qe, a_qp, a_ql = acc
            c_err = np.arctan(a_qp / a_ip) / (2.0 * np.pi)
            nco_carr += tau2c / tau1c * (c_err - err_carr) + c_err * (pdi / tau1c)
            err_carr = c_err
            carr_freq = acq_freq + nco_carr

            e_mag, l_mag = np.hypot(a_ie, a_qe), np.hypot(a_il, a_ql)
            d_err = (e_mag - l_mag) / (e_mag + l_mag)
            nco_code += tau2d / tau1d * (d_err - err_code) + d_err * (pdi / tau1d)
            err_code = d_err
            code_freq = config.code_freq_basis - nco_code
            acc = [0.0] * 6
        d_err, c_err = err_code, err_carr

        log["absolute_sample"][ms] = ptr
        log["code_freq"][ms] = code_freq
        log["carr_freq"][ms] = carr_freq
        log["i_p"][ms], log["i_e"][ms], log["i_l"][ms] = i_p, i_e, i_l
        log["q_e"][ms], log["q_p"][ms], log["q_l"][ms] = q_e, q_p, q_l
        log["dll_discr"][ms], log["dll_discr_filt"][ms] = d_err, nco_code
        log["pll_discr"][ms], log["pll_discr_filt"][ms] = c_err, nco_carr
    return log


# --- navigation stage (reference postNavigation.py + geoFunctions) ----------
# Full-chain parity: these functions re-derive the reference's bit sync,
# pseudorange, orbit propagation, and least-squares math in plain NumPy
# float64 loops, independent of the receiver (nav/preamble, nav/solve,
# nav/orbit, nav/pvt implement the same equations in torch float64).

_PREAMBLE = np.array([1, -1, -1, -1, 1, -1, 1, 1], np.float64)
_GM = 3.986005e14
_OMEGA_E = 7.2921151467e-5
_F_REL = -4.442807633e-10
_HALF_WEEK = 302400.0

#: IS-GPS-200 parity participation sets over the 26-vector
#: [D29*, D30*, d1..d24] (GPS SPS spec Table 2-x / reference navPartyChk
#: postNavigation.py:485-508 — physical-layer constants, not code)
_PARITY_SETS = (
    (0, 2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24),
    (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22, 25),
    (0, 2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23),
    (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24),
    (1, 2, 4, 6, 7, 8, 10, 11, 15, 16, 17, 18, 19, 22, 23, 25),
    (0, 4, 6, 7, 9, 10, 11, 12, 14, 16, 20, 23, 24, 25),
)


def oracle_parity(ndat: np.ndarray) -> int:
    """navPartyChk (reference postNavigation.py:441-521): ``ndat`` is 32
    values +-1 = (D29*, D30*, D1..D30 as received); returns +-1 (valid,
    sign = data polarity) or 0 (parity failure).  Scalar loop
    implementation (the receiver's nav/parity.py is a batched masked
    product over the same spec table)."""
    d = np.asarray(ndat, np.float64).copy()
    if d[1] != 1:                       # D30* == -1: un-invert data bits
        d[2:26] = -d[2:26]
    vec = np.concatenate([d[0:2], d[2:26]])
    for k, idx in enumerate(_PARITY_SETS):
        p = 1.0
        for i in idx:
            p *= vec[i]
        if p != d[26 + k]:
            return 0
    return int(-d[1])


def oracle_fine_freq(config: ReceiverConfig, signal: np.ndarray,
                     code_phase: int, prn: int) -> float:
    """Fine carrier frequency (reference acquisition.py:166-193): wipe
    ``acq_fine_freq_ms`` of signal with the prompt code, zero-padded FFT,
    take the strongest positive-frequency line."""
    spc = config.samples_per_code
    fs = config.sampling_freq
    n_ms = config.acq_fine_freq_ms
    code = ca_table(config)[prn - 1].astype(np.float64)
    x = signal[code_phase:code_phase + n_ms * spc].astype(np.float64)
    wiped = x * np.tile(code, n_ms)
    n_fft = 8 * len(wiped)
    spec = np.abs(np.fft.rfft(wiped, n_fft))
    freqs = np.fft.rfftfreq(n_fft, 1.0 / fs)
    lo = np.searchsorted(freqs, config.intermediate_freq - 7000.0)
    hi = np.searchsorted(freqs, config.intermediate_freq + 7000.0)
    return float(freqs[lo + np.argmax(spec[lo:hi])])


def oracle_find_preamble(i_p: np.ndarray):
    """Bit/frame sync (reference postNavigation.py:524-631): cross-correlate
    sign(I_P) with the x20-upsampled preamble, confirm a candidate by a
    partner exactly 6000 ms away AND two parity-clean 30-bit words.
    Returns (first_subframe_ms, tow_seconds) or (None, None)."""
    bits = np.where(np.asarray(i_p, np.float64) > 0, 1.0, -1.0)
    up = np.repeat(_PREAMBLE, 20)
    corr = np.correlate(bits, up, mode="full")
    cand = np.flatnonzero(np.abs(corr) > 153.0)
    cand_start = cand - (len(up) - 1)
    starts = set(cand_start.tolist())
    for s in sorted(starts):
        if s - 40 < 0 or s + 1200 > len(bits):
            continue
        if (s + 6000 not in starts) and (s - 6000 not in starts):
            continue
        window = bits[s - 40:s + 1200]
        b62 = np.where(window.reshape(62, 20).sum(axis=1) > 0, 1.0, -1.0)
        p1 = oracle_parity(b62[0:32])
        p2 = oracle_parity(b62[30:62])
        if p1 == 0 or p2 == 0:
            continue
        # TOW: bits 1..17 of the HOW (word 2), polarity-corrected by the
        # parity outcome.  The field holds the NEXT subframe's Z-count, so
        # *6 - 6 stamps THIS subframe's start (the reference's -30,
        # ephemeris.py:190, reads the field from the LAST of its five
        # subframes and references subframe 1)
        how = b62[32:49] * p2
        tow_bits = (how > 0).astype(np.int64)
        tow = int("".join(map(str, tow_bits)), 2) * 6 - 6
        return int(s), float(tow)
    return None, None


def _check_t(t: float) -> float:
    if t > _HALF_WEEK:
        return t - 2 * _HALF_WEEK
    if t < -_HALF_WEEK:
        return t + 2 * _HALF_WEEK
    return t


def oracle_satpos(transmit_time: float, eph):
    """Satellite ECEF position + clock at ``transmit_time`` (reference
    geoFunctions/__init__.py:779-885).  Returns ((3,) m, clock s)."""
    dt = _check_t(transmit_time - eph.t_oc)
    satclk = (eph.a_f2 * dt + eph.a_f1) * dt + eph.a_f0 - eph.t_gd
    time = transmit_time - satclk

    a = eph.sqrt_a ** 2
    tk = _check_t(time - eph.t_oe)
    n = np.sqrt(_GM / a ** 3) + eph.delta_n
    m = np.remainder(eph.m_0 + n * tk + 2 * np.pi, 2 * np.pi)
    e_anom = m
    for _ in range(10):
        e_old = e_anom
        e_anom = m + eph.e * np.sin(e_anom)
        if abs(e_anom - e_old) < 1e-12:
            break
    e_anom = np.remainder(e_anom + 2 * np.pi, 2 * np.pi)
    dtr = _F_REL * eph.e * eph.sqrt_a * np.sin(e_anom)
    nu = np.arctan2(np.sqrt(1.0 - eph.e ** 2) * np.sin(e_anom),
                    np.cos(e_anom) - eph.e)
    phi = np.remainder(nu + eph.omega, 2 * np.pi)
    u = phi + eph.c_uc * np.cos(2 * phi) + eph.c_us * np.sin(2 * phi)
    r = (a * (1.0 - eph.e * np.cos(e_anom))
         + eph.c_rc * np.cos(2 * phi) + eph.c_rs * np.sin(2 * phi))
    inc = (eph.i_0 + eph.i_dot * tk
           + eph.c_ic * np.cos(2 * phi) + eph.c_is * np.sin(2 * phi))
    lon_asc = np.remainder(
        eph.omega_0 + (eph.omega_dot - _OMEGA_E) * tk - _OMEGA_E * eph.t_oe
        + 2 * np.pi, 2 * np.pi)
    xp = r * np.cos(u)
    yp = r * np.sin(u)
    pos = np.array([
        xp * np.cos(lon_asc) - yp * np.cos(inc) * np.sin(lon_asc),
        xp * np.sin(lon_asc) + yp * np.cos(inc) * np.cos(lon_asc),
        yp * np.sin(inc)])
    return pos, satclk + dtr


def oracle_least_squares(sat_pos: np.ndarray, obs: np.ndarray):
    """7-iteration Gauss-Newton PVT (reference geoFunctions:636-739),
    troposphere disabled.  ``sat_pos``: (S, 3); ``obs``: (S,) corrected
    pseudoranges.  Returns (pos (4,), dop (5,), el (S,))."""
    s = sat_pos.shape[0]
    c = 299792458.0
    pos = np.zeros(4)
    el = np.zeros(s)
    for it in range(7):
        if it == 0:
            rot_x = sat_pos.copy()
            trop = np.full(s, 2.0)
        else:
            rho = np.linalg.norm(sat_pos - pos[:3], axis=1)
            travel = rho / c
            omega_tau = _OMEGA_E * travel
            rot_x = np.stack([
                np.cos(omega_tau) * sat_pos[:, 0]
                + np.sin(omega_tau) * sat_pos[:, 1],
                -np.sin(omega_tau) * sat_pos[:, 0]
                + np.cos(omega_tau) * sat_pos[:, 1],
                sat_pos[:, 2]], axis=1)
            d = rot_x - pos[:3]
            rng = np.linalg.norm(d, axis=1)
            up = pos[:3] / max(np.linalg.norm(pos[:3]), 1.0)
            el = np.degrees(np.arcsin(np.clip(d @ up / rng, -1, 1)))
            trop = np.zeros(s)
        diff = rot_x - pos[:3]
        dist = np.linalg.norm(diff, axis=1)
        omc = obs - dist - pos[3] - trop
        a_mat = np.concatenate([-diff / obs[:, None], np.ones((s, 1))], axis=1)
        delta, *_ = np.linalg.lstsq(a_mat, omc, rcond=None)
        pos = pos + delta
    q = np.linalg.inv(a_mat.T @ a_mat)
    dop = np.array([np.sqrt(np.trace(q)),
                    np.sqrt(q[0, 0] + q[1, 1] + q[2, 2]),
                    np.sqrt(q[0, 0] + q[1, 1]),
                    np.sqrt(q[2, 2]),
                    np.sqrt(q[3, 3])])
    return pos, dop, el


def oracle_navigate(config: ReceiverConfig, absolute_sample: np.ndarray,
                    i_p: np.ndarray, prns: np.ndarray, ephemerides):
    """Navigation chain (reference postNavigation.py:75-305): preamble sync
    per channel, TOW vote, epochs every nav_sol_period_ms with
    reference-style integer pseudoranges, satpos, 7-iteration LS.
    Troposphere and elevation masking off (parity configs disable them).

    ``absolute_sample``/``i_p``: (C, n_ms); ``prns``: (C,);
    ``ephemerides``: 32-list by PRN.  Returns dict with ``first_subframe``
    (C,), ``tow``, ``raw_p`` (C, E), ``fix`` (E, 4), ``dop`` (E, 5).
    """
    c_ch, n_ms = absolute_sample.shape
    spc = config.samples_per_code
    c_light = config.speed_of_light
    period = config.nav_sol_period_ms

    first = np.full(c_ch, -1, np.int64)
    tows = np.full(c_ch, np.nan)
    for ch in range(c_ch):
        if prns[ch] <= 0 or ephemerides[prns[ch] - 1] is None:
            continue
        s, tow = oracle_find_preamble(i_p[ch])
        if s is not None:
            first[ch] = s
            tows[ch] = tow
    active = np.flatnonzero(first >= 0)
    if len(active) < 4:
        raise ValueError(f"oracle: only {len(active)} channels frame-synced")
    vals, counts = np.unique(tows[active], return_counts=True)
    tow_common = float(vals[np.argmax(counts)])
    active = active[tows[active] == tow_common]

    n_epochs = int((n_ms - first[active].max()) // period)
    raw_p = np.full((c_ch, n_epochs), np.nan)
    fix = np.full((n_epochs, 4), np.nan)
    dop = np.full((n_epochs, 5), np.nan)
    for k in range(n_epochs):
        travel = np.full(c_ch, np.inf)
        for ch in active:
            travel[ch] = absolute_sample[ch, first[ch] + k * period] / spc
        tmin = np.floor(travel[active].min())
        pr = (travel - tmin + config.start_offset_ms) * c_light / 1000.0
        raw_p[active, k] = pr[active]

        t_tx = tow_common + k * period / 1000.0
        sat_pos = np.zeros((len(active), 3))
        obs = np.zeros(len(active))
        for n, ch in enumerate(active):
            p, clk = oracle_satpos(t_tx, ephemerides[prns[ch] - 1])
            sat_pos[n] = p
            obs[n] = pr[ch] + clk * c_light
        pos, dop_k, _el = oracle_least_squares(sat_pos, obs)
        fix[k] = pos
        dop[k] = dop_k
    return {"first_subframe": first, "tow": tow_common,
            "raw_p": raw_p, "fix": fix, "dop": dop}
