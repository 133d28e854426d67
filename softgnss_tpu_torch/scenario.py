"""Golden scenario builder: truth geometry -> ephemerides -> IF capture.

The port of softgnss_tpu.scenario: the same truth (NumPy float64 orbit
and light-time propagators, independent of the receiver's own orbit code),
with the capture synthesized on a torch device.

The reference ships no test recordings (its golden inputs are unpublished
textbook files, reference: initialize.py:99, main.py:60), so the framework
establishes correctness closed-loop (SURVEY.md §4): pick a receiver
position and a satellite constellation, derive per-ms light times from the
SAME broadcast-orbit model the receiver inverts, encode real nav subframes,
and synthesize a geometry-consistent int8 IF capture.  A correct receiver
must then acquire every satellite, track it, decode its ephemeris, and
produce PVT fixes at the injected position.

The default scenario uses circular (e=0), zero-clock orbits so the
closed-form truth propagator stays independent of the receiver's Kepler
code; ``build_scenario(full_model=True)`` switches to eccentric orbits
with harmonics and satellite clock terms (a_f0/a_f1/T_GD + relativistic),
exercising every branch of the broadcast model closed-loop.  The receiver
clock is drift-free; the receiver is static by default, or moves at a
constant velocity when ``build_scenario(velocity_enu=...)`` is given
(kinematic closed loop).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

import torch

from softgnss_tpu_torch.config import ReceiverConfig
from softgnss_tpu_torch.nav.geodesy import cart2geo, geo2cart, topocent
from softgnss_tpu_torch.nav.iono import klobuchar
from softgnss_tpu_torch.nav.message import Ephemeris, build_nav_stream, ephemeris_to_almanac
from softgnss_tpu_torch.nav.orbit import GM, OMEGA_E_DOT, satellite_positions
from softgnss_tpu_torch.nav.pvt import SPEED_OF_LIGHT
from softgnss_tpu_torch.signals.synth import synthesize_dynamic

_W_SAGNAC = 7.292115147e-5   # e_r_corr's rotation rate (geoFunctions:509)


def keplerian_ephemeris(sqrt_a: float = 5153.8, i_0: float = 0.96,
                        omega_0: float = 0.0, m_0: float = 0.0,
                        t_oe: float = 0.0, iod: int = 1,
                        e: float = 0.0, omega: float = 0.0,
                        delta_n: float = 0.0, i_dot: float = 0.0,
                        omega_dot: float = 0.0,
                        c_rs: float = 0.0, c_rc: float = 0.0,
                        c_us: float = 0.0, c_uc: float = 0.0,
                        c_is: float = 0.0, c_ic: float = 0.0,
                        a_f0: float = 0.0, a_f1: float = 0.0,
                        a_f2: float = 0.0, t_gd: float = 0.0) -> Ephemeris:
    """Broadcast ephemeris with the full orbital/clock parameter set
    (reference field inventory: ephemeris.py decode targets)."""
    return Ephemeris(
        week_number=2000, accuracy=0, health=0, t_gd=t_gd, iodc=iod,
        t_oc=t_oe, a_f0=a_f0, a_f1=a_f1, a_f2=a_f2,
        iode_sf2=iod, c_rs=c_rs, delta_n=delta_n, m_0=m_0, c_uc=c_uc, e=e,
        c_us=c_us, sqrt_a=sqrt_a, t_oe=t_oe, c_ic=c_ic, omega_0=omega_0,
        c_is=c_is, i_0=i_0, c_rc=c_rc, omega=omega, omega_dot=omega_dot,
        iode_sf3=iod, i_dot=i_dot,
    )


def circular_ephemeris(sqrt_a: float = 5153.8, i_0: float = 0.96,
                       omega_0: float = 0.0, m_0: float = 0.0,
                       t_oe: float = 0.0, iod: int = 1) -> Ephemeris:
    """Zero-eccentricity, zero-harmonics, zero-clock broadcast ephemeris."""
    return keplerian_ephemeris(sqrt_a=sqrt_a, i_0=i_0, omega_0=omega_0,
                               m_0=m_0, t_oe=t_oe, iod=iod)


def propagate_circular(eph: Ephemeris, t: np.ndarray) -> np.ndarray:
    """ECEF positions (3, T) of a circular-orbit ephemeris at GPS times t.

    Closed form (e=0 makes the Kepler solve the identity); independent of
    the receiver's propagator, so scenario truth and receiver code
    cannot share a bug.
    """
    t = np.asarray(t, np.float64)
    a = eph.sqrt_a**2
    tk = t - eph.t_oe
    n = np.sqrt(GM / a**3) + eph.delta_n
    u = eph.m_0 + n * tk + eph.omega
    inc = eph.i_0 + eph.i_dot * tk
    node = eph.omega_0 + (eph.omega_dot - OMEGA_E_DOT) * tk - OMEGA_E_DOT * eph.t_oe
    x_orb, y_orb = a * np.cos(u), a * np.sin(u)
    x = x_orb * np.cos(node) - y_orb * np.cos(inc) * np.sin(node)
    y = x_orb * np.sin(node) + y_orb * np.cos(inc) * np.cos(node)
    z = y_orb * np.sin(inc)
    return np.stack([x, y, z])


def _eccentric_anomaly(eph: Ephemeris, t: np.ndarray) -> np.ndarray:
    """Kepler solve M = E - e sin E (NumPy fixed point, 12 iterations —
    converges below 1e-12 rad for GPS eccentricities e < 0.03)."""
    a = eph.sqrt_a**2
    n = np.sqrt(GM / a**3) + eph.delta_n
    m = eph.m_0 + n * (np.asarray(t, np.float64) - eph.t_oe)
    e_anom = m
    for _ in range(12):
        e_anom = m + eph.e * np.sin(e_anom)
    return e_anom


def propagate_orbit(eph: Ephemeris, t: np.ndarray) -> np.ndarray:
    """ECEF positions (3, T) from the FULL broadcast model at GPS times t.

    Eccentricity, argument of perigee, all six harmonic corrections,
    delta_n, i_dot, omega_dot — the complete IS-GPS-200 user algorithm the
    receiver's satpos inverts (reference geoFunctions:819-885), in plain
    NumPy so scenario truth does not share code with the receiver
    propagator.  Reduces exactly to :func:`propagate_circular` when all the
    extra terms are zero.
    """
    t = np.asarray(t, np.float64)
    a = eph.sqrt_a**2
    tk = t - eph.t_oe
    e_anom = _eccentric_anomaly(eph, t)
    nu = np.arctan2(np.sqrt(1.0 - eph.e**2) * np.sin(e_anom),
                    np.cos(e_anom) - eph.e)
    phi = nu + eph.omega
    s2p, c2p = np.sin(2.0 * phi), np.cos(2.0 * phi)
    u = phi + eph.c_us * s2p + eph.c_uc * c2p
    r = a * (1.0 - eph.e * np.cos(e_anom)) + eph.c_rs * s2p + eph.c_rc * c2p
    inc = eph.i_0 + eph.i_dot * tk + eph.c_is * s2p + eph.c_ic * c2p
    node = eph.omega_0 + (eph.omega_dot - OMEGA_E_DOT) * tk - OMEGA_E_DOT * eph.t_oe
    x_orb, y_orb = r * np.cos(u), r * np.sin(u)
    x = x_orb * np.cos(node) - y_orb * np.cos(inc) * np.sin(node)
    y = x_orb * np.sin(node) + y_orb * np.cos(inc) * np.cos(node)
    z = y_orb * np.sin(inc)
    return np.stack([x, y, z])


#: relativistic clock constant -2 sqrt(GM)/c^2 (reference geoFunctions:810)
_F_REL = -4.442807633e-10


def satellite_clock_offset(eph: Ephemeris, t: np.ndarray) -> np.ndarray:
    """L1 satellite clock offset dt_sv (s) at satellite-clock times t.

    Polynomial + relativistic eccentricity term - T_GD: the exact quantity
    the receiver's satpos returns as ``clk`` and adds to pseudoranges
    (reference geoFunctions:825-833, 855).  A positive offset means the
    satellite clock runs ahead of GPS time, so its signal timeline arrives
    early and the effective capture delay is tau_geometric - dt_sv.
    """
    dt = np.asarray(t, np.float64) - eph.t_oc
    dtr = _F_REL * eph.e * eph.sqrt_a * np.sin(_eccentric_anomaly(eph, t))
    return (eph.a_f2 * dt + eph.a_f1) * dt + eph.a_f0 + dtr - eph.t_gd


def light_times(rx_ecef: np.ndarray, eph: Ephemeris, t_tx: np.ndarray) -> np.ndarray:
    """Signal flight times with Sagnac rotation — the model the PVT inverts.

    ``t_tx``: transmit times in GPS time (the receiver's satpos is also
    evaluated at transmit time).
    """
    pos = propagate_orbit(eph, t_tx)
    # rx_ecef: (3,) static receiver, or (3, T) per-transmit-time receiver
    # positions in the receive-time ECEF frame (moving receiver)
    rx = rx_ecef if rx_ecef.ndim == 2 else rx_ecef[:, None]
    tau = np.full(pos.shape[1], 0.07)
    for _ in range(4):
        ang = _W_SAGNAC * tau
        rot = np.stack([np.cos(ang) * pos[0] + np.sin(ang) * pos[1],
                        -np.sin(ang) * pos[0] + np.cos(ang) * pos[1],
                        pos[2]])
        tau = np.linalg.norm(rot - rx, axis=0) / SPEED_OF_LIGHT
    return tau


@dataclass
class Scenario:
    """Injected truth for a full-receiver closed-loop run."""

    config: ReceiverConfig
    receiver_ecef: np.ndarray            # (3,)
    prns: list[int]
    ephemerides: list[Ephemeris]
    tow_count: int                       # Z-count of the first in-capture subframe
    t_rx0: float                         # GPS time at capture sample 0
    noise_std: float = 1.5
    amplitude: float = 1.0
    #: optional (S, n_ms) per-ms amplitude envelope overriding ``amplitude``
    #: (e.g. zero a row's tail to kill a satellite mid-capture and exercise
    #: the receiver's lock-loss demotion)
    amplitude_ms: np.ndarray = field(default=None, repr=False)
    #: optional (8,) Klobuchar [alpha0..3, beta0..3]: slant ionospheric
    #: delays are injected into every satellite's signal AND the
    #: coefficients are broadcast in subframe 4 page 18 — the receiver
    #: must decode and correct them (config.use_iono_corr)
    iono: np.ndarray = field(default=None, repr=False)
    #: optional UTC parameters broadcast on subframe 4 page 18 alongside
    #: the Klobuchar coefficients — the receiver decodes them and reports
    #: GPS->UTC time (nav.message.UtcParams)
    utc: object = field(default=None, repr=False)
    #: optional (3,) constant receiver ECEF velocity, m/s (kinematic
    #: scenario — the reference and its recordings are static-only);
    #: truth position at GPS time t is ``receiver_ecef_at(t)``
    receiver_vel: np.ndarray = field(default=None, repr=False)
    #: optional (3,) constant receiver ECEF acceleration, m/s^2 — a
    #: high-dynamics scenario; the synthesized delays follow the
    #: quadratic trajectory (Doppler sweeps through the capture)
    receiver_accel: np.ndarray = field(default=None, repr=False)
    #: receiver-oscillator fractional frequency offset, parts per million
    #: (synth.synthesize_dynamic docstring): common apparent Doppler bias
    #: ~ -f_L1*rho, scaled code clock, and a rho*c m/s receiver clock
    #: drift the navigation solution must absorb.  The reference is blind
    #: to this (initialize.py:105-107 assumes exact fs/IF)
    clock_ppm: float = 0.0
    delays: np.ndarray = field(default=None, repr=False)     # (S, n_ms+1) s
    dopplers: np.ndarray = field(default=None, repr=False)   # (S,) Hz at t_rx0

    @property
    def t_bits0(self) -> float:
        """Transmit time of bit 0 (one subframe of history before tow_count)."""
        return (self.tow_count - 1) * 6.0

    def receiver_ecef_at(self, t) -> np.ndarray:
        """Truth receiver position(s) at GPS receive time(s) t: (3,) or (3, T)."""
        t = np.asarray(t, np.float64)
        rx = np.asarray(self.receiver_ecef, np.float64)
        if t.ndim:
            rx = np.broadcast_to(rx[:, None], (3,) + t.shape).copy()
        dt = t - self.t_rx0
        if self.receiver_vel is not None:
            rx = rx + np.multiply.outer(
                np.asarray(self.receiver_vel, np.float64), dt).reshape(rx.shape)
        if self.receiver_accel is not None:
            rx = rx + np.multiply.outer(
                np.asarray(self.receiver_accel, np.float64),
                0.5 * dt * dt).reshape(rx.shape)
        return rx

    def receiver_vel_at(self, t) -> np.ndarray:
        """Truth receiver velocity at GPS receive time(s) t: (3,) or (3, T)."""
        t = np.asarray(t, np.float64)
        v = np.zeros(3) if self.receiver_vel is None else np.asarray(
            self.receiver_vel, np.float64)
        if t.ndim:
            v = np.broadcast_to(v[:, None], (3,) + t.shape).copy()
        if self.receiver_accel is None:
            return v
        return v + np.multiply.outer(
            np.asarray(self.receiver_accel, np.float64),
            t - self.t_rx0).reshape(v.shape)

    def expected_code_phase(self, i: int) -> float:
        """Acquisition code phase (samples) of satellite i at capture start."""
        cfg = self.config
        fc = cfg.code_freq_basis
        chips = fc * (self.t_rx0 - self.delays[i, 0] - self.t_bits0)
        frac = np.ceil(chips / cfg.code_length) * cfg.code_length - chips
        return float(frac / fc * cfg.sampling_freq)

    def expected_carrier_freq(self, i: int) -> float:
        return float(self.config.intermediate_freq + self.dopplers[i])


def build_scenario(config: ReceiverConfig, n_sats: int = 5,
                   latitude: float = 47.0, longitude: float = 8.5,
                   height: float = 500.0, tow_count: int = 70000,
                   noise_std: float = 1.5, amplitude: float = 1.0,
                   min_elevation: float = 20.0, seed: int = 11,
                   sync_offset_s: float = 0.35,
                   full_model: bool = False,
                   velocity_enu: tuple[float, float, float] | None = None,
                   accel_enu: tuple[float, float, float] | None = None,
                   clock_ppm: float = 0.0,
                   ) -> Scenario:
    """Construct a consistent scenario with n_sats visible satellites.

    The capture starts ``sync_offset_s`` before the arrival of subframe
    ``tow_count``, so the first confirmed preamble lands early in tracking.

    ``full_model``: instead of circular/zero-clock orbits, draw eccentric
    orbits (e ~ 0.01) with nonzero argument of perigee, delta_n, i_dot,
    omega_dot, all six harmonic corrections, and satellite clock terms
    a_f0/a_f1/T_GD — every branch of the IS-GPS-200 user algorithm
    (reference geoFunctions:819-885) then flows encode -> decode -> satpos
    -> PVT closed-loop.  Magnitudes are typical broadcast values, all well
    inside the nav-message field widths.

    ``velocity_enu``: optional constant receiver velocity (east, north,
    up) in m/s — a kinematic scenario (beyond the reference, whose
    recordings are static).  ``accel_enu``: optional constant
    acceleration (m/s^2) on top — a high-dynamics scenario whose carrier
    Doppler sweeps through the capture (tests/test_high_dynamics.py
    drives 1.5 g).  Satellite delays then follow the moving
    receiver, so tracked Doppler, pseudoranges, and the PVT/velocity
    solutions must all reflect the trajectory
    ``receiver_ecef_at(t)``.
    """
    rx = torch.stack(geo2cart(np.array([latitude, 0, 0]),
                              np.array([longitude, 0, 0]), height, 4)).numpy()
    t0 = tow_count * 6.0
    # ephemeris epoch on the nav message's 16-s t_oe/t_oc quantization
    # grid: tow_count*6 is not generally divisible by 16, and an epoch off
    # the grid decodes 8 s away from the one synthesized — ~30 km of
    # in-track satellite position inconsistency
    t_epoch = round(t0 / 16.0) * 16.0
    rng = np.random.default_rng(seed)

    ephs, prns = [], []
    trial = 0
    while len(ephs) < n_sats and trial < 500:
        trial += 1
        if full_model:
            eph = keplerian_ephemeris(
                i_0=float(rng.uniform(0.8, 1.1)),
                omega_0=float(rng.uniform(0, 2 * np.pi)),
                m_0=float(rng.uniform(0, 2 * np.pi)),
                t_oe=t_epoch, iod=len(ephs) + 1,
                e=float(rng.uniform(0.005, 0.015)),
                omega=float(rng.uniform(0, 2 * np.pi)),
                delta_n=float(rng.uniform(-5e-9, 5e-9)),
                i_dot=float(rng.uniform(-3e-10, 3e-10)),
                omega_dot=float(rng.uniform(-9e-9, -7e-9)),
                c_rs=float(rng.uniform(-80.0, 80.0)),
                c_rc=float(rng.uniform(150.0, 350.0)),
                c_us=float(rng.uniform(2e-6, 1e-5)),
                c_uc=float(rng.uniform(-5e-6, 5e-6)),
                c_is=float(rng.uniform(-2e-7, 2e-7)),
                c_ic=float(rng.uniform(-2e-7, 2e-7)),
                a_f0=float(rng.uniform(-2e-4, 2e-4)),
                a_f1=float(rng.uniform(-1e-11, 1e-11)),
                t_gd=float(rng.uniform(-1e-8, 1e-8)),
            )
        else:
            eph = circular_ephemeris(
                i_0=float(rng.uniform(0.8, 1.1)),
                omega_0=float(rng.uniform(0, 2 * np.pi)),
                m_0=float(rng.uniform(0, 2 * np.pi)),
                t_oe=t_epoch, iod=len(ephs) + 1,
            )
        pos = propagate_orbit(eph, np.asarray([t0]))[:, 0]
        _, el, _ = topocent(rx, pos - rx)
        if float(el) > min_elevation:
            ephs.append(eph)
            prns.append(len(ephs))  # PRNs 1..n, distinct
    if len(ephs) < n_sats:
        raise RuntimeError("scenario generation failed to place satellites")

    vel = accel = None
    if velocity_enu is not None or accel_enu is not None:
        lam, phi = np.deg2rad(longitude), np.deg2rad(latitude)
        enu = np.array([
            [-np.sin(lam), -np.sin(phi) * np.cos(lam), np.cos(phi) * np.cos(lam)],
            [np.cos(lam), -np.sin(phi) * np.sin(lam), np.cos(phi) * np.sin(lam)],
            [0.0, np.cos(phi), np.sin(phi)],
        ])                                  # columns: e_hat, n_hat, u_hat
        if velocity_enu is not None:
            vel = enu @ np.asarray(velocity_enu, np.float64)
        if accel_enu is not None:
            accel = enu @ np.asarray(accel_enu, np.float64)

    t_rx0 = t0 - sync_offset_s
    return Scenario(config=config, receiver_ecef=rx, prns=prns,
                    ephemerides=ephs, tow_count=tow_count, t_rx0=t_rx0,
                    noise_std=noise_std, amplitude=amplitude,
                    receiver_vel=vel, receiver_accel=accel,
                    clock_ppm=clock_ppm)


def synthesize_scenario(scenario: Scenario, n_ms: int, seed: int = 0,
                        device="cuda") -> torch.Tensor:
    """int8 IF capture of ``n_ms`` milliseconds for the scenario, on
    ``device`` (the card unless the caller names the CPU).

    Also fills ``scenario.delays``/``scenario.dopplers`` with the truth
    tables used (for assertions against receiver output).
    """
    cfg = scenario.config
    s = len(scenario.prns)
    # receiver samples sit at true times k/(fs*(1+rho)): a fast oscillator
    # (rho > 0) collects each "millisecond" of samples in less true time
    rho = scenario.clock_ppm * 1e-6
    t_bounds = scenario.t_rx0 + 1e-3 * np.arange(n_ms + 1) / (1.0 + rho)

    delays = np.empty((s, n_ms + 1))
    # receiver truth positions at each ms boundary's receive time (static:
    # constant columns; kinematic: the linear trajectory)
    rx_t = scenario.receiver_ecef_at(t_bounds)
    for i, eph in enumerate(scenario.ephemerides):
        # solve tau_eff(t_rx): receive-time grid -> iterate the satellite's
        # signal-timeline time t_stream (= satellite clock time stamped on
        # the nav bits).  The signal stamped t_stream leaves at GPS time
        # t_stream - dt_sv and flies tau_geo, so the capture-relative delay
        # the receiver observes is tau_geo - dt_sv (the +dt_sv it adds back
        # as the satpos clock correction, reference postNavigation.py:231).
        tau = np.full(n_ms + 1, 0.07)
        for _ in range(3):
            t_stream = t_bounds - tau
            dt_sv = satellite_clock_offset(eph, t_stream)
            tau = light_times(rx_t, eph, t_stream - dt_sv) - dt_sv
        delays[i] = tau

    if scenario.iono is not None:
        # slant ionospheric group delay per satellite (Klobuchar at the
        # truth position/geometry, effectively constant over the capture);
        # the receiver recovers it from the broadcast page-18 coefficients
        rx = np.asarray(scenario.receiver_ecef, np.float64)
        lat, lon, _h = (float(v) for v in cart2geo(rx[0], rx[1], rx[2], 4))
        sat_pos, _ = satellite_positions(scenario.t_rx0, scenario.ephemerides)
        az, el, _ = topocent(rx, (sat_pos - rx[:, None]).T)
        tow = scenario.t_rx0 % 604800.0
        d_ion = klobuchar(scenario.iono, lat, lon, az, el, tow).numpy()
        delays += d_ion[:, None]

    scenario.delays = delays
    # APPARENT Doppler in receiver-clock units: geometry plus the
    # oscillator's common ~ -f_L1*rho offset (zero when clock_ppm == 0)
    f_if_x = (cfg.intermediate_freq
              - (cfg.l1_freq - cfg.intermediate_freq) * rho) / (1.0 + rho)
    scenario.dopplers = ((f_if_x - cfg.intermediate_freq)
                         - cfg.l1_freq * (delays[:, 1] - delays[:, 0]) * 1000.0)

    n_subframes = int(np.ceil((scenario.t_rx0 - scenario.t_bits0 + n_ms / 1000.0) / 6.0)) + 2
    # every satellite broadcasts the same almanac set on its subframe-5
    # pages (as the real constellation does); the receiver collects the
    # pages the capture happens to span (nav.message.decode_almanac_pages)
    alm = {prn: ephemeris_to_almanac(eph, prn)
           for prn, eph in zip(scenario.prns, scenario.ephemerides)}
    streams = np.stack([
        build_nav_stream(eph, scenario.tow_count - 1, n_subframes,
                         iono=scenario.iono, utc=scenario.utc, almanac=alm)
        for eph in scenario.ephemerides
    ]).astype(np.float32)

    if scenario.amplitude_ms is not None:
        amps = np.empty((s, n_ms), np.float32)
        env = np.asarray(scenario.amplitude_ms, np.float32)
        k = min(env.shape[1], n_ms)
        amps[:, :k] = env[:, :k]
        amps[:, k:] = env[:, -1:]                           # edge hold
    else:
        amps = np.full(s, scenario.amplitude, np.float32)
    return synthesize_dynamic(
        cfg, scenario.prns, delays, streams,
        scenario.t_rx0 - scenario.t_bits0, n_ms,
        amplitudes=amps,
        phase0=np.linspace(0.0, 5.0, s),
        noise_std=scenario.noise_std, seed=seed,
        clock_ppm=scenario.clock_ppm, device=device)
