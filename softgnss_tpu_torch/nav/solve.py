"""Navigation orchestration: tracking output -> ephemerides -> PVT fixes.

The port of softgnss_tpu.nav.solve (reference postNavigation.py:27-305,
calculatePseudoranges + postNavigate): find preambles, integrate nav
bits, decode ephemerides, then per measurement epoch compute pseudoranges
from the tracked ``absolute_sample`` counters, propagate the satellites
and solve least-squares PVT with elevation masking, RAIM, velocity from
carrier Doppler and geodetic/UTM conversion.

The JAX package's jitted ``lax.scan`` over epochs (``_epoch_scan``)
becomes :func:`_epoch_loop`, a plain loop over epochs on CPU float64
tensors, vectorized over channels.  Navigation is host float64 math on
tiny arrays, so it runs on the CPU by design, as it does in the JAX
package.  The documented divergences from the reference are the JAX
package's (data-sized epoch capacity, channels indexed by channel number,
TOW majority vote, UTM zone from the first fix).  With
``config.nav_filter='ekf'`` the filter of :mod:`softgnss_tpu_torch.nav.ekf`
runs in the same loop and gives the primary solution; the per-epoch least
squares stays in the ``lsq_*`` columns.
"""

from __future__ import annotations

import logging
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from softgnss_tpu_torch.config import ReceiverConfig
from softgnss_tpu_torch.nav.ekf import ekf_epoch, initial_ekf_state
from softgnss_tpu_torch.nav.geodesy import cart2geo, cart2utm, find_utm_zone
from softgnss_tpu_torch.nav.message import (Ephemeris, UtcParams, decode_almanac_pages,
                                            decode_ephemeris, decode_iono, decode_tow,
                                            decode_utc)
from softgnss_tpu_torch.nav.orbit import pack_ephemerides, satpos
from softgnss_tpu_torch.nav.preamble import find_preambles
from softgnss_tpu_torch.nav.pvt import inv4, solve_epoch

logger = logging.getLogger(__name__)

_MS_PER_BIT = 20

_FRAME_BITS = 1500

#: chi-square inverse CDF at confidence 0.999 for 1..16 degrees of freedom
#: — the RAIM fault-test thresholds on the normalized residual SSE
_CHI2_999 = (10.828, 13.816, 16.266, 18.467, 20.515, 22.458,
             24.322, 26.124, 27.877, 29.588, 31.264, 32.909,
             34.528, 36.123, 37.697, 39.252)
#: minimum capture for a solution: 5 subframes + sync margin
#: (reference guard: postNavigation.py:104)
MIN_NAV_MS = 36000
#: minimum capture on which a warm-start solution (supplied ephemerides)
#: is possible: two 6000-ms-spaced preambles plus the 60-bit TLM+HOW read
#: (softgnss_tpu.nav.solve.MIN_WARM_NAV_MS)
MIN_WARM_NAV_MS = 8000


@dataclass
class NavSolutions:
    """Per-epoch navigation solutions (E epochs, C channels); the fields of
    softgnss_tpu.nav.solve.NavSolutions, NumPy arrays."""

    x: np.ndarray            # (E,) ECEF, m
    y: np.ndarray
    z: np.ndarray
    dt: np.ndarray           # (E,) receiver clock bias, m
    latitude: np.ndarray     # (E,) deg
    longitude: np.ndarray    # (E,) deg
    height: np.ndarray       # (E,) m
    e: np.ndarray            # (E,) UTM easting
    n: np.ndarray            # (E,) UTM northing
    u: np.ndarray            # (E,) UTM up
    dop: np.ndarray          # (5, E) GDOP PDOP HDOP VDOP TDOP
    prn: np.ndarray          # (C, E) int, 0 where unused
    el: np.ndarray           # (C, E) deg
    az: np.ndarray           # (C, E) deg
    raw_p: np.ndarray        # (C, E) m
    corrected_p: np.ndarray  # (C, E) m
    utm_zone: int
    first_subframe: np.ndarray  # (C,) ms index of first preamble (0 = none)
    tow: float               # GPS time of week of the first epoch, s
    #: receiver ECEF velocity (E,) per axis + clock drift, from carrier Doppler
    vx: np.ndarray | None = None
    vy: np.ndarray | None = None
    vz: np.ndarray | None = None
    clock_drift: np.ndarray | None = None   # (E,) m/s
    #: capture ms of epoch 0; epoch k is at first_epoch_ms + k * nav_sol_period_ms
    first_epoch_ms: int = 0
    #: (8,) Klobuchar coefficients applied (decoded or supplied), or None
    iono: np.ndarray | None = None
    #: (E,) RAIM outcome per epoch: 0 = residuals consistent, 1 = fault
    #: isolated and excluded (raim_excluded_prn), 2 = fault detected but not
    #: isolable — epoch invalidated (NaN fix)
    raim_flag: np.ndarray | None = None
    #: (E,) PRN excluded by RAIM at each epoch (0 = none)
    raim_excluded_prn: np.ndarray | None = None
    #: GPS->UTC parameters decoded from subframe 4 page 18 (or supplied)
    utc_params: UtcParams | None = None
    #: full GPS week number of the decoded ephemerides
    week_number: int | None = None
    #: which filter produced the primary columns: 'lsq' (per-epoch least
    #: squares) or 'ekf' (nav.ekf)
    nav_filter: str = "lsq"
    #: with nav_filter='ekf': the per-epoch least-squares x, y, z, dt, and
    #: (E,) accepted pseudorange updates per epoch
    lsq_x: np.ndarray | None = None
    lsq_y: np.ndarray | None = None
    lsq_z: np.ndarray | None = None
    lsq_dt: np.ndarray | None = None
    ekf_used: np.ndarray | None = None
    #: (E,) usable satellites per epoch (post elevation-mask / lock / RAIM)
    n_used: np.ndarray | None = None
    #: {prn: nav.message.Almanac} pages collected from subframes 4/5
    almanac: dict | None = None

    def utc_offset_s(self, epoch: int = 0) -> float | None:
        """GPS-minus-UTC offset (s) at a measurement epoch, from the
        broadcast UTC parameters (IS-GPS-200 20.3.3.5.2.4).  None without
        utc_params/week."""
        if self.utc_params is None or self.week_number is None:
            return None
        tow = self.tow + (self.first_epoch_ms + epoch * self._period_ms) / 1000.0
        return self.utc_params.gps_to_utc_offset(tow, self.week_number)

    @property
    def n_epochs(self) -> int:
        return self.x.shape[0]

    @property
    def ttff_ms(self) -> float:
        """Time to first fix: capture ms of the first finite solution (inf if none)."""
        ok = np.flatnonzero(np.isfinite(self.x))
        if ok.size == 0:
            return float("inf")
        return float(self.first_epoch_ms + ok[0] * self._period_ms)

    #: filled at construction so ttff_ms needs no config
    _period_ms: int = 500


def calculate_pseudoranges(config: ReceiverConfig, absolute_sample: np.ndarray,
                           ms_of_signal: np.ndarray, channel_list: np.ndarray) -> np.ndarray:
    """Relative pseudoranges (m) at per-channel millisecond indices
    (reference postNavigation.py:27-72)."""
    c_ch = absolute_sample.shape[0]
    travel = np.full(c_ch, np.inf)
    for ch in channel_list:
        travel[ch] = absolute_sample[ch, int(ms_of_signal[ch])] / config.samples_per_code
    travel = travel - np.floor(travel.min()) + config.start_offset_ms
    return travel * config.speed_of_light / 1000.0


def _raim_exclude(sat_pos, obs, mask, use_trop, iono_tow, sigma2, dof):
    """Leave-one-out re-solves of one epoch (batched over the left-out
    channel): (isolated, channel, pos, el, az, dop, mask) of the best."""
    c_ch = mask.shape[0]
    excl_masks = mask[None, :] & ~torch.eye(c_ch, dtype=torch.bool)
    e_pos, e_el, e_az, e_dop, e_res = solve_epoch(sat_pos, obs, excl_masks, use_trop,
                                                  iono_tow)
    e_sse = torch.where(mask, torch.sum(e_res * e_res, dim=1) / sigma2, torch.inf)
    j = int(torch.argmin(e_sse))
    thr_ex = _CHI2_999[min(max(dof - 1, 1), 16) - 1]
    isolated = bool(e_sse[j] < thr_ex)
    return isolated, j, e_pos[j], e_el[j], e_az[j], e_dop[j], excl_masks[j]


def _epoch_loop(config: ReceiverConfig, use_trop: bool, packed, base_mask, travel_time,
                transmit_times, doppler_meas, lock_ok, iono8=None, raim_sigma=np.inf,
                ekf_sigma=5.0):
    """softgnss_tpu.nav.solve._epoch_scan as a loop over epochs.

    packed: (C, F); base_mask: (C,) bool; travel_time: (C, E) ms units;
    transmit_times: (E,) s; doppler_meas: (C, E) measured carrier Doppler,
    Hz; lock_ok: (C, E) bool; iono8: optional (8,) Klobuchar coefficients;
    raim_sigma: one-sigma pseudorange error (m) of the RAIM fault test (inf
    disables detection: the sigma-calibration pass); ekf_sigma: pseudorange
    one-sigma (m) of the EKF (``config.nav_filter='ekf'``).  All float64
    CPU tensors.  Returns the per-epoch outputs stacked along axis 0: (pos,
    dop, el, az, raw_p, corrected, lat, lon, hgt, vel4, raim_flag,
    excl_ch, sse_raw, n_used, ekf_out); ekf_out (9,) per epoch is the
    filter's [pos (3), vel (3), cdt, cddt, accepted updates], zeros
    without the EKF."""
    elev_mask = config.elevation_mask_deg
    c_light = config.speed_of_light
    lam = c_light / config.l1_freq
    nan = float("nan")
    n_ep = travel_time.shape[1]
    sat_elev = torch.full(base_mask.shape, torch.inf, dtype=torch.float64)
    ones = torch.ones(base_mask.shape + (1,), dtype=torch.float64)
    use_ekf = config.nav_filter == "ekf"
    # the EKF needs a continuous common travel anchor across epochs (the
    # least squares re-floors per epoch, stepping by whole ms): the first
    # epoch's floor plus the nominal per-epoch advance
    anchors = (torch.floor(torch.min(torch.where(base_mask, travel_time[:, 0], torch.inf)))
               + config.nav_sol_period_ms * torch.arange(n_ep, dtype=torch.float64))
    ekf_state = initial_ekf_state()
    rows = []
    for ep in range(n_ep):
        travel, t_tx = travel_time[:, ep], transmit_times[ep]
        doppler, locked = doppler_meas[:, ep], lock_ok[:, ep]
        mask = base_mask & locked & (sat_elev >= elev_mask)

        # pseudoranges: masked min (reference postNavigation.py:52-71)
        tmin = torch.floor(torch.min(torch.where(mask, travel, torch.inf)))
        raw_p = (travel - tmin + config.start_offset_ms) * c_light / 1000.0

        sat_pos, clk = satpos(t_tx, packed)
        obs = raw_p + clk * c_light

        iono_tow = None if iono8 is None else (iono8, t_tx)
        pos, el, az, dop, resid = solve_epoch(sat_pos, obs, mask, use_trop, iono_tow)
        n_used = int(mask.sum())
        ok = n_used > 3

        # --- RAIM fault detection & exclusion (softgnss_tpu.nav.solve) -----
        mask_eff = mask
        raim_flag = 0
        excl_ch = -1
        sse_raw = torch.sum(resid * resid)
        if config.raim:
            sigma2 = raim_sigma * raim_sigma
            dof = n_used - 4
            sse = float(sse_raw) / sigma2
            thr = _CHI2_999[min(max(dof, 1), 16) - 1]
            fault = dof >= 1 and sse > thr
            isolated = False
            if fault and n_used >= 6:
                isolated, j, x_pos, x_el, x_az, x_dop, x_mask = _raim_exclude(
                    sat_pos, obs, mask, use_trop, iono_tow, sigma2, dof)
                if isolated:
                    pos, el, az, dop, mask_eff = x_pos, x_el, x_az, x_dop, x_mask
                    excl_ch = j
            raim_flag = (1 if isolated else 2) if fault else 0
            # a detected but non-isolated fault invalidates the epoch
            ok = ok and not (fault and not isolated)
            if raim_flag == 2:
                mask_eff = mask_eff & False
        n_used = int(mask_eff.sum())

        # --- velocity from carrier Doppler ---------------------------------
        # rho_dot_i = e_i . (v_sat_i - v_rx) + clock_drift, rho_dot =
        # -lambda * doppler; satellite velocity and clock drift by central
        # finite difference of the broadcast orbit
        h = 0.05
        sat_a, clk_a = satpos(t_tx - h, packed)
        sat_b, clk_b = satpos(t_tx + h, packed)
        sat_vel = (sat_b - sat_a) / (2.0 * h)
        clk_drift = (clk_b - clk_a) / (2.0 * h)
        diff = sat_pos - pos[:3]
        rho = torch.linalg.norm(diff, dim=-1)
        e_los = diff / torch.clamp(rho, min=1.0)[:, None]
        rho_dot = -lam * doppler
        vobs = torch.where(mask_eff, rho_dot + c_light * clk_drift
                           - torch.sum(e_los * sat_vel, dim=-1), 0.0)
        a_v = torch.cat([-e_los, ones], dim=1) * mask_eff.to(torch.float64)[:, None]
        inv_v, det_v = inv4(a_v.T @ a_v)
        vel4 = inv_v @ (a_v.T @ vobs)
        if not (abs(float(det_v)) > 1e-12 and ok):
            vel4 = torch.full((4,), nan, dtype=torch.float64)

        if not ok:
            pos = torch.full((4,), nan, dtype=torch.float64)
            dop = torch.zeros(5, dtype=torch.float64)
        shown = mask_eff & ok
        el_out = torch.where(shown, el, nan)
        az_out = torch.where(shown, az, nan)
        corrected = torch.where(mask_eff, raw_p + clk * c_light + pos[3], nan)

        # --- EKF navigation filter (config.nav_filter='ekf'; nav.ekf) ------
        ekf_out = torch.zeros(9, dtype=torch.float64)
        if use_ekf:
            anchor = anchors[ep]
            pr_f = (travel - anchor + config.start_offset_ms) * c_light / 1000.0 + clk * c_light
            rr_f = -lam * doppler + c_light * clk_drift
            # the least-squares clock bias references this epoch's floor;
            # the filter's pseudoranges reference the fixed anchor
            ls_init = pos.clone()
            ls_init[3] = ls_init[3] + (tmin - anchor) * c_light / 1000.0
            ekf_state, (e_pos, e_vel, e_cdt, e_cddt, e_used) = ekf_epoch(
                ekf_state, sat_pos, sat_vel, pr_f, rr_f, mask_eff, use_trop, iono_tow,
                t_step=config.nav_sol_period_ms / 1000.0, q_accel=config.ekf_accel_psd,
                q_clock=config.ekf_clock_psd, q_bias=config.ekf_clock_bias_psd,
                r_pr=ekf_sigma, r_rr=config.ekf_doppler_sigma, gate=config.ekf_gate_sigma,
                ls_pos=ls_init, ls_ok=ok, ls_vel=vel4)
            ekf_out = torch.cat([e_pos, e_vel, torch.tensor([e_cdt, e_cddt, float(e_used)],
                                                            dtype=torch.float64)])
        lat, lon, hgt = cart2geo(pos[0], pos[1], pos[2], 4)

        # after a successful solve, masked-out satellites get NaN elevations
        # and stay excluded; a failed epoch keeps the previous elevations;
        # the pre-RAIM mask keeps a RAIM-excluded satellite re-tested
        if ok:
            sat_elev = torch.where(mask, el, nan)
        rows.append((pos, dop, el_out, az_out, torch.where(mask_eff, raw_p, nan),
                     corrected, lat, lon, hgt, vel4, raim_flag, excl_ch, sse_raw, n_used,
                     ekf_out))
    return tuple(
        torch.stack(col) if isinstance(col[0], torch.Tensor) else torch.tensor(col)
        for col in zip(*rows))


def post_navigate(config: ReceiverConfig, track, ephemerides=None, iono=None, utc=None,
                  ) -> tuple[NavSolutions | None, list[Ephemeris | None]]:
    """Full navigation stage on tracking output (softgnss_tpu.nav.solve.
    post_navigate).

    ``track``: a TrackResults (softgnss_tpu_torch.track.scan) or any object
    with ``i_p (C, n_ms)``, ``absolute_sample (C, n_ms)``, ``status``,
    ``prn``.  ``ephemerides``: optional per-PRN list of 32 (warm start:
    channels whose PRN has a complete entry read only the TLM+HOW for the
    TOW, so fixes need as little as ``MIN_WARM_NAV_MS`` of capture);
    ``iono``: (8,) Klobuchar coefficients and ``utc``: UtcParams to use in
    place of decoding subframe 4.

    Returns (solutions | None, per-PRN ephemeris list of length 32).
    """
    eph_by_prn: list[Ephemeris | None] = [None] * 32
    i_p = np.asarray(track.i_p)
    n_ms = i_p.shape[1]
    n_tracked = sum(1 for s in track.status if s != "-")
    min_ms = MIN_NAV_MS if ephemerides is None else MIN_WARM_NAV_MS
    if n_ms < min_ms or n_tracked < 4:
        logger.warning("Record too short or too few satellites tracked "
                       "(%d ms, %d channels).", n_ms, n_tracked)
        return None, eph_by_prn

    first_subframe, active = find_preambles(i_p, track.status)

    # --- ephemerides: in-signal decode (reference postNavigation.py:115-146)
    # --- or warm-start TOW-only read against the supplied set --------------
    ephs: dict[int, Ephemeris] = {}
    tows: dict[int, float] = {}
    iono8 = None if iono is None else np.asarray(iono, np.float64)
    utc_params: UtcParams | None = utc
    for ch in list(active):
        start = int(first_subframe[ch])
        prn = int(track.prn[ch])
        provided = (ephemerides[prn - 1]
                    if ephemerides is not None and prn >= 1 else None)
        if (provided is not None and provided.complete
                and provided.health not in (None, 0)):
            logger.warning("Channel %d (PRN %d): supplied ephemeris has "
                           "health %d; excluded.", ch, prn, int(provided.health))
            active = np.setdiff1d(active, ch)
            continue
        if provided is not None and provided.complete:
            if start - _MS_PER_BIT < 0 or start + 60 * _MS_PER_BIT > n_ms:
                active = np.setdiff1d(active, ch)
                continue
            window = i_p[ch, start - _MS_PER_BIT: start + 60 * _MS_PER_BIT]
            bits = np.where(window.reshape(-1, _MS_PER_BIT).sum(axis=1) > 0, 1, -1)
            ephs[ch] = provided
            tows[ch] = decode_tow(bits[1:], bits[0])
            eph_by_prn[prn - 1] = provided
            continue
        if start - _MS_PER_BIT < 0 or start + _FRAME_BITS * _MS_PER_BIT > n_ms:
            active = np.setdiff1d(active, ch)
            continue
        window = i_p[ch, start - _MS_PER_BIT: start + _FRAME_BITS * _MS_PER_BIT]
        bits = np.where(window.reshape(-1, _MS_PER_BIT).sum(axis=1) > 0, 1, -1)
        eph, tow = decode_ephemeris(bits[1:], bits[0])
        if not eph.complete:
            active = np.setdiff1d(active, ch)
            continue
        if eph.health not in (None, 0):
            # SV health word (subframe 1): nonzero = do not use
            logger.warning("Channel %d (PRN %d) broadcasts health %d; "
                           "excluded from navigation.", ch, prn, int(eph.health))
            eph_by_prn[prn - 1] = eph
            active = np.setdiff1d(active, ch)
            continue
        ephs[ch] = eph
        tows[ch] = tow
        eph_by_prn[prn - 1] = eph
        if iono8 is None and config.use_iono_corr:
            iono8 = decode_iono(bits[1:], bits[0])
            if iono8 is not None:
                logger.info("Ionospheric coefficients decoded from channel "
                            "%d (PRN %d); Klobuchar correction enabled.", ch, prn)
        if utc_params is None:
            utc_params = decode_utc(bits[1:], bits[0])
            if utc_params is not None:
                logger.info("UTC parameters decoded from channel %d (PRN %d).", ch, prn)

    if len(active) < 4:
        logger.warning("Too few satellites with ephemeris data (%d).", len(active))
        return None, eph_by_prn

    # --- TOW consistency: drop channels locked to a different subframe ----
    tow_common, _ = Counter(tows[ch] for ch in active).most_common(1)[0]
    for ch in list(active):
        if tows[ch] != tow_common:
            logger.warning("Channel %d TOW %.0f disagrees with majority %.0f; dropped.",
                           ch, tows[ch], tow_common)
            active = np.setdiff1d(active, ch)
    if len(active) < 4:
        logger.warning("Too few TOW-consistent satellites (%d).", len(active))
        return None, eph_by_prn

    # --- almanac collection: the constellation almanac, one page per 30-s
    # --- frame, from every parity-valid page the channels yield ----------
    almanac: dict[int, object] = {}
    lock_loss_alm = getattr(track, "lock_loss_ms", None)
    for ch in active:
        start = int(first_subframe[ch])
        end_ms = n_ms
        if lock_loss_alm is not None and np.isfinite(lock_loss_alm[ch]):
            # never decode pages from post-lock-loss noise bits
            end_ms = min(end_ms, int(lock_loss_alm[ch]))
        n_sub = (end_ms - start) // (_MS_PER_BIT * 300)
        if n_sub < 1 or start < 2 * _MS_PER_BIT:
            continue
        window = i_p[ch, start - 2 * _MS_PER_BIT: start + 300 * n_sub * _MS_PER_BIT]
        bits = np.where(window.reshape(-1, _MS_PER_BIT).sum(axis=1) > 0, 1, -1)
        pages = decode_almanac_pages(bits[2:], bits[1], d29star=bits[0])
        for prn, page in pages.items():
            almanac.setdefault(prn, page)
    if almanac:
        logger.info("Collected %d almanac page(s): PRNs %s.", len(almanac), sorted(almanac))

    # --- epoch setup -------------------------------------------------------
    c_ch = i_p.shape[0]
    period = config.nav_sol_period_ms
    max_start = int(first_subframe[active].max())
    n_epochs = int((n_ms - max_start) // period)
    if n_epochs < 1:
        logger.warning("No full measurement epoch after subframe sync.")
        return None, eph_by_prn

    base_mask = np.zeros(c_ch, bool)
    base_mask[active] = True

    # --- lock demotion: channels whose C/N0 or phase lock collapsed are
    # --- excluded from every epoch at/after the collapse ------------------
    lock_ok = np.ones((c_ch, n_epochs), bool)
    lock_loss = getattr(track, "lock_loss_ms", None)
    if (lock_loss is None and config.lock_demotion
            and hasattr(track, "q_p") and hasattr(track, "code_freq")):
        from softgnss_tpu_torch.profiling import channel_lock_loss

        lock_loss = channel_lock_loss(config, track)
    if config.lock_demotion and lock_loss is not None:
        lock_loss = np.asarray(lock_loss, np.float64)
        for ch in active:
            ms_idx = first_subframe[ch] + period * np.arange(n_epochs)
            lock_ok[ch] = ms_idx < lock_loss[ch]
            if not lock_ok[ch].all():
                logger.warning("Channel %d (PRN %d) lost lock at %.0f ms; "
                               "demoted for %d of %d epochs.", ch,
                               int(np.asarray(track.prn)[ch]), lock_loss[ch],
                               int((~lock_ok[ch]).sum()), n_epochs)

    # per-channel travel times (ms units) at every epoch's measurement
    # point, code-phase exact with the sub-sample boundary fraction
    absolute_sample = np.asarray(track.absolute_sample, np.float64)
    frac = getattr(track, "sample_frac", None)
    if frac is not None:
        absolute_sample = absolute_sample - np.asarray(frac)
    travel = np.full((c_ch, n_epochs), np.inf)
    for ch in active:
        ms_idx = first_subframe[ch] + period * np.arange(n_epochs)
        travel[ch] = absolute_sample[ch, ms_idx] / config.samples_per_code

    # --- carrier smoothing (Hatch filter) ---------------------------------
    n_smooth = config.carrier_smoothing_epochs
    carr_freq_raw = getattr(track, "carr_freq", None)
    carr_freq_arr = (None if carr_freq_raw is None
                     else np.asarray(carr_freq_raw, np.float64))
    if n_smooth > 1 and carr_freq_arr is not None and n_epochs > 1:
        lam_ms = (config.speed_of_light / config.l1_freq) / (
            config.speed_of_light / 1000.0)        # wavelength in travel-ms
        cyc = np.cumsum(carr_freq_arr - config.intermediate_freq, axis=1) * 1e-3
        for ch in active:
            ms_idx = first_subframe[ch] + period * np.arange(n_epochs)
            phi = cyc[ch, ms_idx]
            sm = travel[ch].copy()
            for n in range(1, n_epochs):
                alpha = 1.0 / min(n + 1, n_smooth)
                pred = sm[n - 1] + period - lam_ms * (phi[n] - phi[n - 1])
                sm[n] = alpha * travel[ch, n] + (1.0 - alpha) * pred
            travel[ch] = sm

    # packed ephemerides; inactive rows get a valid dummy (masked in solver)
    dummy = ephs[int(active[0])]
    packed = pack_ephemerides([ephs.get(ch, dummy) for ch in range(c_ch)])

    transmit_times = tow_common + period / 1000.0 * np.arange(n_epochs)

    # measured carrier Doppler at each epoch, averaged over +-50 ms (NaN
    # without carr_freq, so the velocity solution reports NaN)
    doppler = np.full((c_ch, n_epochs), np.nan)
    if carr_freq_arr is not None:
        half_w = 50
        for ch in active:
            ms_idx = first_subframe[ch] + period * np.arange(n_epochs)
            lo = np.maximum(ms_idx - half_w, 0)
            hi = np.minimum(ms_idx + half_w + 1, carr_freq_arr.shape[1])
            csum = np.concatenate([[0.0], np.cumsum(carr_freq_arr[ch])])
            doppler[ch] = (csum[hi] - csum[lo]) / (hi - lo) - config.intermediate_freq

    loop_args = (torch.from_numpy(packed), torch.from_numpy(base_mask),
                 torch.from_numpy(travel), torch.from_numpy(transmit_times),
                 torch.from_numpy(doppler), torch.from_numpy(lock_ok),
                 None if iono8 is None else torch.from_numpy(iono8))
    use_trop = bool(config.use_trop_corr)
    raim_sigma = np.inf
    if config.raim:
        if config.raim_sigma_m is not None:
            raim_sigma = float(config.raim_sigma_m)
        else:
            # sigma auto-calibration: the same loop with detection off, a
            # robust per-epoch scale from the raw residual SSE
            # (sse/median(chi2(dof)) estimates sigma^2; the median over
            # epochs rejects transiently faulty ones)
            pre = _epoch_loop(config, use_trop, *loop_args, np.inf)
            sse_pre = pre[12].numpy()
            dof_pre = pre[13].numpy() - 4
            sel = dof_pre >= 1
            if sel.any():
                # median of chi2(k) ~ k*(1 - 2/(9k))^3 (Wilson-Hilferty)
                med_k = dof_pre[sel] * (1.0 - 2.0 / (9.0 * dof_pre[sel])) ** 3
                sigma_est = np.sqrt(np.median(sse_pre[sel] / med_k))
            else:
                sigma_est = 0.0
            raim_sigma = max(float(sigma_est), config.raim_sigma_floor_m)
            logger.info("RAIM sigma auto-calibrated: %.2f m over %d epochs.",
                        raim_sigma, int(sel.sum()))
    ekf_sigma = (float(config.ekf_range_sigma_m) if config.ekf_range_sigma_m is not None
                 else (raim_sigma if np.isfinite(raim_sigma) else config.raim_sigma_floor_m))
    (pos, dop, el, az, raw_p, corrected, lat, lon, hgt, vel4,
     raim_flag, raim_excl_ch, _sse, n_used, ekf_out) = (
        t.numpy() for t in _epoch_loop(config, use_trop, *loop_args, raim_sigma, ekf_sigma))

    # --- the EKF as the primary solution (config.nav_filter='ekf'): the
    # --- per-epoch least squares stays in the lsq_* columns ---------------
    lsq_cols = ekf_used = None
    if config.nav_filter == "ekf":
        lsq_cols = tuple(pos[:, i].copy() for i in range(4))
        ekf_used = ekf_out[:, 8].astype(np.int64)
        pos = np.concatenate([ekf_out[:, 0:3], ekf_out[:, 6:7]], axis=1)
        vel4 = np.concatenate([ekf_out[:, 3:6], ekf_out[:, 7:8]], axis=1)
        fin = np.isfinite(pos[:, 0])
        lat, lon, hgt = (np.full(n_epochs, np.nan) for _ in range(3))
        if fin.any():
            geo = cart2geo(*(torch.from_numpy(pos[fin, i]) for i in range(3)), 4)
            lat[fin], lon[fin], hgt[fin] = (v.numpy() for v in geo)
        n_bridge = int(np.sum(fin & (n_used <= 3)))
        if n_bridge:
            logger.info("EKF bridged %d epoch(s) with fewer than 4 usable satellites.",
                        n_bridge)

    # --- UTM conversion (zone fixed from the first valid fix) ----------------
    valid = np.isfinite(lat)
    if valid.any():
        k = int(valid.nonzero()[0][0])
        utm_zone = find_utm_zone(float(lat[k]), float(lon[k]))
        e_utm, n_utm, u_utm = (v.numpy() for v in cart2utm(pos[:, 0], pos[:, 1],
                                                            pos[:, 2], utm_zone))
    else:
        utm_zone = 0
        e_utm = n_utm = u_utm = np.full(n_epochs, np.nan)

    prn = np.zeros((c_ch, n_epochs), np.int64)
    prn[active] = np.asarray(track.prn)[active, None]

    prn_arr = np.asarray(track.prn, np.int64)
    raim_prn = np.where(raim_excl_ch >= 0, prn_arr[np.clip(raim_excl_ch, 0, c_ch - 1)], 0)
    for flag, count in zip(*np.unique(raim_flag[raim_flag > 0], return_counts=True)):
        if flag == 1:
            logger.warning("RAIM excluded a faulty satellite at %d epoch(s) (PRNs %s).",
                           count, sorted(set(raim_prn[raim_flag == 1].tolist())))
        else:
            logger.warning("RAIM detected non-isolable faults at %d epoch(s); "
                           "fixes invalidated.", count)

    week = ephs[int(active[0])].week_number
    solutions = NavSolutions(
        x=pos[:, 0], y=pos[:, 1], z=pos[:, 2], dt=pos[:, 3],
        latitude=lat, longitude=lon, height=hgt,
        e=e_utm, n=n_utm, u=u_utm,
        dop=dop.T, prn=prn, el=el.T, az=az.T,
        raw_p=raw_p.T, corrected_p=corrected.T,
        utm_zone=utm_zone, first_subframe=first_subframe, tow=float(tow_common),
        vx=vel4[:, 0], vy=vel4[:, 1], vz=vel4[:, 2], clock_drift=vel4[:, 3],
        first_epoch_ms=int(max_start), _period_ms=int(period), iono=iono8,
        raim_flag=raim_flag.astype(np.int32), raim_excluded_prn=raim_prn,
        n_used=n_used.astype(np.int64), almanac=almanac or None,
        utc_params=utc_params,
        week_number=int(week) if week is not None else None,
        nav_filter=config.nav_filter,
        lsq_x=None if lsq_cols is None else lsq_cols[0],
        lsq_y=None if lsq_cols is None else lsq_cols[1],
        lsq_z=None if lsq_cols is None else lsq_cols[2],
        lsq_dt=None if lsq_cols is None else lsq_cols[3],
        ekf_used=ekf_used,
    )
    return solutions, eph_by_prn
