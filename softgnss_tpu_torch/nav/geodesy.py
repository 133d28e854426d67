"""Geodetic / topocentric coordinate library (torch float64, CPU).

The port of softgnss_tpu.nav.geodesy: cart2geo, geo2cart, togeod,
topocent, cart2utm (with the clsin/clksin Clenshaw series), find_utm_zone,
e_r_corr, deg2dms and dms2mat (reference: geoFunctions/__init__.py).  The
iterative solvers keep the JAX package's fixed iteration counts, so both
packages run the same arithmetic; inputs may be Python floats, NumPy
arrays or tensors and come back as float64 tensors (the last three, host
scalars, as floats).

Array arguments broadcast as in NumPy, except that :func:`topocent` lines
a batch of origins up with the LEADING axes of ``dx`` (an (B, 3) batch of
receiver positions against (B, S, 3) satellite deltas), which is how the
PVT solver batches its RAIM re-solves.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: reference ellipsoids: semi-major axis a (m), flattening f
#: 0: International 1924, 1: International 1967, 2: WGS-72, 3: GRS-80,
#: 4: WGS-84 (softgnss_tpu.nav.geodesy)
ELLIPSOIDS_A = (6378388.0, 6378160.0, 6378135.0, 6378137.0, 6378137.0)
ELLIPSOIDS_F = (1 / 297.0, 1 / 298.247, 1 / 298.26, 1 / 298.257222101,
                1 / 298.257223563)

_OMEGA_E_DOT_ROT = 7.292115147e-5  # e_r_corr's constant (geoFunctions:509)


def f64(x) -> torch.Tensor:
    """``x`` as a float64 tensor (no copy when it already is one)."""
    return torch.as_tensor(x, dtype=torch.float64)


def remainder(a, b: float):
    """NumPy's (and XLA's) floating remainder: fmod, moved to the sign of
    ``b`` — exact, unlike ``a - floor(a/b)*b``."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def cart2geo(x, y, z, ellipsoid: int = 4):
    """ECEF -> geodetic (lat deg, lon deg, height m): 30 fixed iterations
    of the reference's height/latitude fixed point (geoFunctions:7-77)."""
    a = ELLIPSOIDS_A[ellipsoid]
    f = ELLIPSOIDS_F[ellipsoid]
    x, y, z = f64(x), f64(y), f64(z)
    lam = torch.atan2(y, x)
    ex2 = (2 - f) * f / (1 - f) ** 2
    c = a * math.sqrt(1 + ex2)
    p = torch.sqrt(x**2 + y**2)
    phi = torch.atan2(z, p * (1 - (2 - f) * f))
    h = torch.full_like(phi, 0.1)
    for _ in range(30):
        n = c / torch.sqrt(1 + ex2 * torch.cos(phi) ** 2)
        phi = torch.atan(z / (p * (1 - (2 - f) * f * n / (n + h))))
        h = p / torch.cos(phi) - n
    return torch.rad2deg(phi), torch.rad2deg(lam), h


def geo2cart(phi_dms, lam_dms, h, ellipsoid: int = 4):
    """Geodetic ([deg, min, sec] each) -> ECEF (geoFunctions:578-632)."""
    phi_dms, lam_dms = f64(phi_dms), f64(lam_dms)
    b = torch.deg2rad(phi_dms[0] + phi_dms[1] / 60.0 + phi_dms[2] / 3600.0)
    lon = torch.deg2rad(lam_dms[0] + lam_dms[1] / 60.0 + lam_dms[2] / 3600.0)
    a = ELLIPSOIDS_A[ellipsoid]
    f = ELLIPSOIDS_F[ellipsoid]
    ex2 = (2 - f) * f / (1 - f) ** 2
    c = a * math.sqrt(1 + ex2)
    n = c / torch.sqrt(1 + ex2 * torch.cos(b) ** 2)
    return ((n + h) * torch.cos(b) * torch.cos(lon),
            (n + h) * torch.cos(b) * torch.sin(lon),
            ((1 - f) ** 2 * n + h) * torch.sin(b))


def togeod(a: float, finv: float, x, y, z):
    """ECEF -> geodetic (lat deg, lon deg in [0, 360), height) on the
    ellipsoid (a, 1/f): Goad's iteration, 10 fixed steps (geoFunctions:892-997)."""
    x, y, z = f64(x), f64(y), f64(z)
    esq = 0.0 if finv < 1e-20 else (2 - 1 / finv) / finv
    oneesq = 1 - esq
    p = torch.sqrt(x**2 + y**2)
    lon = torch.where(p > 1e-20, torch.rad2deg(torch.atan2(y, x)), 0.0)
    lon = torch.where(lon < 0, lon + 360.0, lon)
    r = torch.sqrt(p**2 + z**2)
    sinphi = torch.where(r > 1e-20, z / torch.clamp(r, min=1e-300), 0.0)
    phi = torch.asin(sinphi)
    h = r - a * (1 - sinphi * sinphi / finv)
    for _ in range(10):
        s, cphi = torch.sin(phi), torch.cos(phi)
        n_phi = a / torch.sqrt(1 - esq * s * s)
        dp = p - (n_phi + h) * cphi
        dz = z - (n_phi * oneesq + h) * s
        phi, h = phi + (cphi * dz - s * dp) / (n_phi + h), h + s * dz + cphi * dp
    return torch.rad2deg(phi), lon, h


def topocent(origin_ecef, dx):
    """ECEF delta-vectors ``dx`` (..., 3) -> (azimuth deg, elevation deg,
    distance) at ``origin_ecef`` (3,) or a batch (B, 3) matching the
    leading axes of ``dx``; WGS-84 ENU rotation (geoFunctions:1003-1062)."""
    origin_ecef, dx = f64(origin_ecef), f64(dx)
    phi, lam, _ = togeod(6378137.0, 298.257223563,
                         origin_ecef[..., 0], origin_ecef[..., 1], origin_ecef[..., 2])
    extra = (1,) * (dx.dim() - origin_ecef.dim())
    phi, lam = phi.reshape(phi.shape + extra), lam.reshape(lam.shape + extra)
    cl, sl = torch.cos(torch.deg2rad(lam)), torch.sin(torch.deg2rad(lam))
    cb, sb = torch.cos(torch.deg2rad(phi)), torch.sin(torch.deg2rad(phi))
    e = -sl * dx[..., 0] + cl * dx[..., 1]
    n = -sb * cl * dx[..., 0] - sb * sl * dx[..., 1] + cb * dx[..., 2]
    u = cb * cl * dx[..., 0] + cb * sl * dx[..., 1] + sb * dx[..., 2]
    hor = torch.sqrt(e**2 + n**2)
    az = torch.where(hor < 1e-20, 0.0, torch.rad2deg(torch.atan2(e, n)))
    el = torch.where(hor < 1e-20, 90.0, torch.rad2deg(torch.atan2(u, hor)))
    az = torch.where(az < 0, az + 360.0, az)
    return az, el, torch.linalg.norm(dx, dim=-1)


def e_r_corr(travel_time, x_sat):
    """Earth-rotation (Sagnac) correction of satellite ECEF ``x_sat``
    (..., 3) during the signal flight (geoFunctions:491-521)."""
    x_sat = f64(x_sat)
    w = _OMEGA_E_DOT_ROT * f64(travel_time)
    cw, sw = torch.cos(w), torch.sin(w)
    return torch.stack([cw * x_sat[..., 0] + sw * x_sat[..., 1],
                        -sw * x_sat[..., 0] + cw * x_sat[..., 1],
                        x_sat[..., 2]], dim=-1)


# --- UTM (transverse Mercator on International 1924 / ED50) -----------------

def clsin(coeffs, argument):
    """Clenshaw summation sum_k coeffs[k-1] sin(k*argument) (geoFunctions:84-111)."""
    cos_arg = 2 * torch.cos(argument)
    hr1 = torch.zeros_like(cos_arg)
    hr = torch.zeros_like(cos_arg)
    for t in range(len(coeffs), 0, -1):
        hr2 = hr1
        hr1 = hr
        hr = coeffs[t - 1] + cos_arg * hr1 - hr2
    return hr * torch.sin(argument)


def clksin(coeffs, arg_real, arg_imag):
    """Clenshaw summation of sin with complex argument; returns (re, im)
    (geoFunctions:118-172)."""
    sr, cr = torch.sin(arg_real), torch.cos(arg_real)
    shi, chi = torch.sinh(arg_imag), torch.cosh(arg_imag)
    r = 2 * cr * chi
    i = -2 * sr * shi
    hr1 = hr = hi1 = hi = torch.zeros_like(r)
    for t in range(len(coeffs), 0, -1):
        hr2, hi2 = hr1, hi1
        hr1, hi1 = hr, hi
        hr = coeffs[t - 1] + r * hr1 - i * hi - hr2
        hi = i * hr1 + r * hi1 - hi2
    rr = sr * chi
    ii = cr * shi
    return rr * hr - ii * hi, rr * hi + ii * hr


#: trig-series coefficients for f = 1/297 (geoFunctions:319-325)
_UTM_GTU = (0.000841275991, 7.67306686e-07, 1.2129123e-09, 2.48508228e-12)
_UTM_BG = (-0.00337077907, 4.73444769e-06, -8.2991457e-09, 1.5878533e-11)


def cart2utm(x, y, z, zone: int):
    """ITRF ECEF -> (E, N, U) in UTM ``zone`` on ED50/International 1924,
    with the reference's datum shift (geoFunctions:176-372)."""
    a = 6378388.0
    f = 1.0 / 297.0
    ex2 = (2 - f) * f / (1 - f) ** 2
    c = a * math.sqrt(1 + ex2)

    x, y, z = f64(x), f64(y), f64(z)
    vx = x - 7.56e-7 * y
    vy = 7.56e-7 * x + y
    vz = z - 4.5
    scale = 0.9999988
    v0, v1, v2 = scale * vx + 89.5, scale * vy + 93.8, scale * vz + 127.6

    lon = torch.atan2(v1, v0)
    p = torch.sqrt(v0**2 + v1**2)
    n1 = 6395000.0
    lat = torch.atan2(v2 / ((1 - f) ** 2 * n1), p / n1)
    u = torch.full_like(lat, 0.1)
    for _ in range(30):
        n1 = c / torch.sqrt(1 + ex2 * torch.cos(lat) ** 2)
        lat = torch.atan2(v2 / ((1 - f) ** 2 * n1 + u), p / (n1 + u))
        u = p / torch.cos(lat) - n1

    # normalized meridian quadrant (KW p.50)
    m0 = 4e-4
    n = f / (2 - f)
    m = n**2 * (0.25 + n**2 / 64)
    q_n = a + (a * (-n - m0 + m * (1 - m0))) / (1 + n)

    e0 = 500000.0
    lon0 = math.radians((zone - 30) * 6 - 3.0)

    neg = lat < 0
    bg_r = torch.abs(lat) + clsin(_UTM_BG, 2 * torch.abs(lat))
    lg_r = lon - lon0
    cos_bn = torch.cos(bg_r)
    np_ = torch.atan2(torch.sin(bg_r), torch.cos(lg_r) * cos_bn)
    ep = torch.atanh(torch.sin(lg_r) * cos_bn)
    dn, de = clksin(_UTM_GTU, 2 * np_, 2 * ep)
    np_, ep = np_ + dn, ep + de
    northing = q_n * np_
    easting = q_n * ep + e0
    northing = torch.where(neg, -northing + 20000000.0, northing)
    return easting, northing, u


def find_utm_zone(latitude: float, longitude: float) -> int:
    """UTM zone for lat/lon in decimal degrees, with the Norway/Svalbard
    exceptions (geoFunctions:529-574)."""
    if longitude > 180 or longitude < -180:
        raise ValueError("Longitude value exceeds limits (-180:180).")
    if latitude > 84 or latitude < -80:
        raise ValueError("Latitude value exceeds limits (-80:84).")
    zone = int(np.fix((180 + longitude) / 6)) + 1
    if latitude > 72:
        if 0 <= longitude < 9:
            zone = 31
        elif 9 <= longitude < 21:
            zone = 33
        elif 21 <= longitude < 33:
            zone = 35
        elif 33 <= longitude < 42:
            zone = 37
    elif 56 <= latitude < 64 and 3 <= longitude < 12:
        zone = 32
    return zone


def deg2dms(deg: float) -> float:
    """Decimal degrees -> dd*100 + mm + ss/100 packed form (geoFunctions:379-426)."""
    sign = -1.0 if deg < 0 else 1.0
    deg = abs(deg)
    d = np.floor(deg)
    minutes_part = (deg - d) * 60
    m = np.floor(minutes_part)
    s = (minutes_part - m) * 60
    if s >= 60.0 - 1e-12:
        m += 1
        s = 0.0
    if m >= 60.0:
        d += 1
        m = 0.0
    return sign * (d * 100 + m + s / 100)


def dms2mat(dms: float, n: int = -3) -> tuple[float, float, float]:
    """Split dd*100 + mm + ss/100 into (dd, mm, ss rounded to 10^n): the
    documented contract of the reference's dead-code version
    (geoFunctions:433-482), as softgnss_tpu.nav.geodesy implements it."""
    sign = -1.0 if dms < 0 else 1.0
    dms = abs(dms)
    d = np.floor(dms / 100)
    m = np.floor(dms - 100 * d)
    s = round((dms - 100 * d - m) * 100, -n)
    if s >= 60.0:
        m += 1
        s = 0.0
    if m >= 60.0:
        d += 1
        m = 0.0
    return sign * d, m, s
