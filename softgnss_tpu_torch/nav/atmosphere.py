"""Tropospheric range correction — Goad & Goodman (1974) model.

The port of softgnss_tpu.nav.atmosphere (reference geoFunctions/__init__.py:
1071-1185): the reference's two-pass dry/wet ``while`` as an explicit dry
+ wet evaluation of the shared refraction integral, batched over
satellites (torch float64).
"""

from __future__ import annotations

import torch

from softgnss_tpu_torch.nav.geodesy import f64

_A_E = 6378.137        # earth radius, km
_B0 = 7.839257e-5
_TLAPSE = -6.5         # K/km


def _refraction_integral(sinel, hsta, htop, ref):
    """One pass of the layer refraction integral (reference: geoFunctions:1141-1172)."""
    rtop = (_A_E + htop) ** 2 - (_A_E + hsta) ** 2 * (1.0 - sinel**2)
    rtop = torch.sqrt(torch.clamp(rtop, min=0.0)) - (_A_E + hsta) * sinel
    a = -sinel / (htop - hsta)
    b = -_B0 * (1.0 - sinel**2) / (htop - hsta)
    rn = torch.stack([rtop ** (i + 2) for i in range(8)])
    alpha = torch.stack([
        2 * a,
        2 * a**2 + 4 * b / 3,
        a * (a**2 + 3 * b),
        a**4 / 5 + 2.4 * a**2 * b + 1.2 * b**2,
        2 * a * b * (a**2 + 3 * b) / 3,
        b**2 * (6 * a**2 + 4 * b) * 0.1428571,
        torch.where(b**2 > 1e-35, a * b**3 / 2, 0.0),
        torch.where(b**2 > 1e-35, b**4 / 9, 0.0),
    ])
    dr = rtop + torch.sum(alpha * rn, dim=0)
    return dr * ref * 1000.0


def tropo(sinel, hsta=0.0, p=1013.0, tkel=293.0, hum=50.0,
          hp=0.0, htkel=0.0, hhum=0.0):
    """Tropospheric delay in meters to subtract from pseudoranges.

    Arguments as in the reference (sin(elevation), station height km,
    pressure mb, temperature K, humidity %, measurement heights km); the
    defaults are the fixed values the reference's PVT passes
    (geoFunctions:697).  Accepts batched ``sinel``.
    """
    sinel = torch.clamp(f64(sinel), min=0.0)

    tkhum = tkel + _TLAPSE * (hhum - htkel)
    atkel = 7.5 * (tkhum - 273.15) / (237.3 + tkhum - 273.15)
    e0 = 0.0611 * hum * 10.0**atkel
    tksea = tkel - _TLAPSE * htkel
    em = -978.77 / (2870400.0 * _TLAPSE * 1e-5)
    tkelh = tksea + _TLAPSE * hhum
    e0sea = e0 * (tksea / tkelh) ** (4 * em)
    tkelp = tksea + _TLAPSE * hp
    psea = p * (tksea / tkelp) ** em

    # dry component
    refsea_d = 7.7624e-5 / tksea
    htop_d = 1.1385e-5 / refsea_d
    ref_d = refsea_d * psea * ((htop_d - hsta) / htop_d) ** 4
    dry = _refraction_integral(sinel, hsta, htop_d, ref_d)

    # wet component
    refsea_w = (0.3719 / tksea - 1.292e-5) / tksea
    htop_w = 1.1385e-5 * (1255.0 / tksea + 0.05) / refsea_w
    ref_w = refsea_w * e0sea * ((htop_w - hsta) / htop_w) ** 4
    wet = _refraction_integral(sinel, hsta, htop_w, ref_w)

    return dry + wet
