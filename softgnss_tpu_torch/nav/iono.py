"""Klobuchar ionospheric delay model (IS-GPS-200 20.3.3.5.2.5).

The port of softgnss_tpu.nav.iono: the broadcast alpha/beta coefficients
of subframe 4 page 18 drive the single-frequency correction that the PVT
solver applies next to the troposphere (torch float64).
"""

from __future__ import annotations

import math

import torch

from softgnss_tpu_torch.nav.geodesy import f64, remainder

#: seconds per GPS day
_DAY = 86400.0


def klobuchar(iono, lat_deg, lon_deg, az_deg, el_deg, gps_tow):
    """Slant ionospheric delay in SECONDS at L1.

    ``iono``: (8,) [alpha0..alpha3, beta0..beta3]; ``lat_deg``/``lon_deg``:
    receiver geodetic coordinates, broadcastable against
    ``az_deg``/``el_deg`` (satellite azimuth/elevation, degrees);
    ``gps_tow``: GPS time of week, s.  IS-GPS-200 figure 20-4.
    """
    iono = f64(iono)
    a, b = iono[:4], iono[4:]
    el = torch.clamp(f64(el_deg), min=0.0) / 180.0          # semicircles
    az = torch.deg2rad(f64(az_deg))
    lat_deg, lon_deg = f64(lat_deg), f64(lon_deg)

    psi = 0.0137 / (el + 0.11) - 0.022                       # earth-centred angle
    phi_i = torch.clamp(lat_deg / 180.0 + psi * torch.cos(az), -0.416, 0.416)
    lam_i = lon_deg / 180.0 + psi * torch.sin(az) / torch.cos(phi_i * math.pi)
    phi_m = phi_i + 0.064 * torch.cos((lam_i - 1.617) * math.pi)  # geomagnetic

    t = remainder(_DAY / 2.0 * lam_i + f64(gps_tow), _DAY)  # local time, s
    f = 1.0 + 16.0 * (0.53 - el) ** 3                        # slant factor

    powers = (torch.ones_like(phi_m), phi_m, phi_m**2, phi_m**3)
    per = torch.clamp(sum(b[k] * powers[k] for k in range(4)), min=72000.0)
    amp = torch.clamp(sum(a[k] * powers[k] for k in range(4)), min=0.0)

    x = 2.0 * math.pi * (t - 50400.0) / per
    day = 5e-9 + amp * (1.0 - x**2 / 2.0 + x**4 / 24.0)
    return f * torch.where(torch.abs(x) < 1.57, day, 5e-9)
