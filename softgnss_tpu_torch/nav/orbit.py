"""Satellite position/clock from broadcast ephemeris (torch float64, CPU).

The port of softgnss_tpu.nav.orbit (reference geoFunctions/__init__.py:
745-885, satpos and check_t): every satellite at once as a batch, with
the fixed-count Kepler iteration (10 fixed-point steps, the reference's
cap) of the JAX package in place of a per-satellite loop with early exit.
"""

from __future__ import annotations

import numpy as np
import torch

from softgnss_tpu_torch.nav.geodesy import f64, remainder
from softgnss_tpu_torch.nav.message import GPS_PI, Ephemeris

#: WGS-84 earth rotation rate, rad/s (reference: geoFunctions:805)
OMEGA_E_DOT = 7.2921151467e-5
#: WGS-84 earth gravitational parameter, m^3/s^2 (reference: geoFunctions:807)
GM = 3.986005e14
#: relativistic clock constant -2*sqrt(GM)/c^2, s/sqrt(m) (reference: geoFunctions:810)
F_REL = -4.442807633e-10
#: seconds in half a GPS week (reference: geoFunctions:761)
HALF_WEEK = 302400.0

#: ephemeris fields consumed by the orbit propagator, in array-pack order
ORBIT_FIELDS = ("t_oc", "a_f0", "a_f1", "a_f2", "t_gd", "sqrt_a", "t_oe",
                "delta_n", "m_0", "e", "omega", "c_uc", "c_us", "c_rc",
                "c_rs", "c_ic", "c_is", "i_0", "i_dot", "omega_0", "omega_dot")


def check_t(time):
    """Half-week crossover correction (reference: geoFunctions:745-770)."""
    t = f64(time)
    t = torch.where(t > HALF_WEEK, t - 2 * HALF_WEEK, t)
    return torch.where(t < -HALF_WEEK, t + 2 * HALF_WEEK, t)


def pack_ephemerides(ephs: list[Ephemeris]) -> np.ndarray:
    """Pack per-satellite ephemerides into a (S, len(ORBIT_FIELDS)) f64 array."""
    out = np.zeros((len(ephs), len(ORBIT_FIELDS)))
    for i, eph in enumerate(ephs):
        for j, name in enumerate(ORBIT_FIELDS):
            v = getattr(eph, name)
            if v is None:
                raise ValueError(f"ephemeris field {name} unset for satellite {i}")
            out[i, j] = float(v)
    return out


def satpos(transmit_time, packed):
    """ECEF positions (S, 3) and clock corrections (S,) of every satellite
    of ``packed`` ((S, len(ORBIT_FIELDS)) float64 tensor) at
    ``transmit_time`` (reference geoFunctions:819-885)."""
    (t_oc, a_f0, a_f1, a_f2, t_gd, sqrt_a, t_oe, delta_n, m_0, ecc, omega,
     c_uc, c_us, c_rc, c_rs, c_ic, c_is, i_0, i_dot, omega_0,
     omega_dot) = f64(packed).unbind(-1)
    two_pi = 2.0 * GPS_PI
    transmit_time = f64(transmit_time)

    dt = check_t(transmit_time - t_oc)
    clk = (a_f2 * dt + a_f1) * dt + a_f0 - t_gd
    time = transmit_time - clk

    a = sqrt_a * sqrt_a
    tk = check_t(time - t_oe)
    n = torch.sqrt(GM / a**3) + delta_n
    m = remainder(m_0 + n * tk + two_pi, two_pi)

    e_anom = m
    for _ in range(10):
        e_anom = m + ecc * torch.sin(e_anom)
    e_anom = remainder(e_anom + two_pi, two_pi)

    dtr = F_REL * ecc * sqrt_a * torch.sin(e_anom)

    nu = torch.atan2(torch.sqrt(1.0 - ecc**2) * torch.sin(e_anom), torch.cos(e_anom) - ecc)
    phi = remainder(nu + omega, two_pi)

    cos2p, sin2p = torch.cos(2 * phi), torch.sin(2 * phi)
    u = phi + c_uc * cos2p + c_us * sin2p
    r = a * (1.0 - ecc * torch.cos(e_anom)) + c_rc * cos2p + c_rs * sin2p
    inc = i_0 + i_dot * tk + c_ic * cos2p + c_is * sin2p

    lon_node = remainder(
        omega_0 + (omega_dot - OMEGA_E_DOT) * tk - OMEGA_E_DOT * t_oe + two_pi, two_pi)

    cu, su = torch.cos(u), torch.sin(u)
    co, so = torch.cos(lon_node), torch.sin(lon_node)
    ci = torch.cos(inc)
    x = cu * r * co - su * r * ci * so
    y = cu * r * so + su * r * ci * co
    z = su * r * torch.sin(inc)

    clk_corr = (a_f2 * dt + a_f1) * dt + a_f0 - t_gd + dtr
    return torch.stack([x, y, z], dim=-1), clk_corr


def satellite_positions(transmit_time, ephs_or_packed) -> tuple[np.ndarray, np.ndarray]:
    """Positions (3, S) and clock corrections (S,) for all satellites, as
    NumPy (the reference satpos layout, geoFunctions:779-885).

    ``ephs_or_packed``: list of :class:`Ephemeris` or a pre-packed
    (S, len(ORBIT_FIELDS)) array."""
    packed = ephs_or_packed
    if not isinstance(packed, (np.ndarray, torch.Tensor)):
        packed = pack_ephemerides(packed)
    pos, clk = satpos(float(transmit_time), packed)
    return pos.T.numpy(), clk.numpy()
