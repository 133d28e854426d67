"""Least-squares PVT solver — masked, fixed-iteration Gauss-Newton.

The port of softgnss_tpu.nav.pvt (reference geoFunctions/__init__.py:
636-739, leastSquarePos): 7 Gauss-Newton iterations; per satellite an
earth-rotation (Sagnac) correction by the current travel time, topocentric
az/el, optional Goad-Goodman troposphere (and Klobuchar ionosphere);
residual ``omc = obs - |RotX - pos| - clock_bias - trop``; geometry rows
``[-(LOS)/obs, 1]`` (normalized by the observation, as the reference
does, for DOP parity); DOP from inv(A^T A).  As in the JAX package all
satellites form one masked batch with a determinant guard in place of the
reference's rank check, and the iteration count is fixed.  torch float64
on the CPU; a leading batch axis of masks solves several satellite
subsets at once (the RAIM leave-one-out re-solves of nav.solve).
"""

from __future__ import annotations

import numpy as np
import torch

from softgnss_tpu_torch.nav.atmosphere import tropo
from softgnss_tpu_torch.nav.geodesy import cart2geo, e_r_corr, f64, topocent

SPEED_OF_LIGHT = 299792458.0
_ITERATIONS = 7
#: row (column) indices of the 3x3 minors: minor (i, j) drops row i, column j
_KEEP = torch.tensor([[k for k in range(4) if k != i] for i in range(4)])
_MINOR_ROWS = _KEEP[:, None, :, None]     # (4, 1, 3, 1)
_MINOR_COLS = _KEEP[None, :, None, :]     # (1, 4, 1, 3)
_COF_SIGN = torch.tensor([[(-1.0) ** (i + j) for j in range(4)] for i in range(4)],
                         dtype=torch.float64)


def _det3(m):
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def inv4(a):
    """Adjugate inverse and determinant of (..., 4, 4) matrices (the JAX
    package's closed-form cofactors).  Returns (inverse, det)."""
    cof = _COF_SIGN * _det3(a[..., _MINOR_ROWS, _MINOR_COLS])   # (..., 4, 4)
    det = torch.sum(a[..., 0, :] * cof[..., 0, :], dim=-1)
    return cof.transpose(-1, -2) / det[..., None, None], det


def _atmosphere(use_trop: bool, iono_tow, pos, az, el):
    """Troposphere (+ Klobuchar ionosphere) range delays, m, (..., S)."""
    trop = tropo(torch.sin(torch.deg2rad(el))) if use_trop else torch.zeros_like(el)
    if iono_tow is not None:
        from softgnss_tpu_torch.nav.iono import klobuchar

        iono8, tow = iono_tow
        lat, lon, _h = cart2geo(pos[..., 0], pos[..., 1], pos[..., 2], 4)
        trop = trop + SPEED_OF_LIGHT * klobuchar(iono8, lat[..., None], lon[..., None],
                                                 az, el, tow)
    return trop


def solve_epoch(sat_pos, obs, mask, use_trop: bool, iono_tow=None):
    """One masked PVT solve (softgnss_tpu.nav.pvt.solve_epoch).

    ``sat_pos``: (S, 3), ``obs``: (S,), ``mask``: (..., S) bool — a leading
    batch of masks solves each subset.  ``iono_tow``: optional ((8,)
    Klobuchar coefficients, GPS tow).  Returns (pos (..., 4), el, az
    (..., S) deg, dop (..., 5), resid (..., S)): ``resid`` is the post-fit
    residual at the converged position (0 where masked), RAIM's input."""
    sat_pos, obs = f64(sat_pos), f64(obs)
    batch = mask.shape[:-1]
    s = sat_pos.shape[0]
    wgt = mask.to(torch.float64)
    safe_obs = torch.where(mask, obs, 1.0)
    pos = torch.zeros(batch + (4,), dtype=torch.float64)
    el = az = torch.zeros(batch + (s,), dtype=torch.float64)
    ones = torch.ones(batch + (s, 1), dtype=torch.float64)

    def design(diff):
        return torch.cat([-diff / safe_obs[..., None], ones], dim=-1) * wgt[..., None]

    for i in range(_ITERATIONS):
        if i == 0:
            rot_x = sat_pos.expand(batch + (s, 3))
            trop = torch.full(batch + (s,), 2.0, dtype=torch.float64)
            el = az = torch.zeros(batch + (s,), dtype=torch.float64)
        else:
            rho = torch.linalg.norm(sat_pos - pos[..., None, :3], dim=-1)
            rot_x = e_r_corr(rho / SPEED_OF_LIGHT, sat_pos)
            az, el, _ = topocent(pos[..., :3], rot_x - pos[..., None, :3])
            trop = _atmosphere(use_trop, iono_tow, pos, az, el)
        diff = rot_x - pos[..., None, :3]
        dist = torch.linalg.norm(diff, dim=-1)
        omc = torch.where(mask, obs - dist - pos[..., 3:4] - trop, 0.0)
        a = design(diff)
        at = a.transpose(-1, -2)
        inv, det = inv4(at @ a)
        # rank guard: the reference bails with zeros when rank(A) < 4
        ok = torch.abs(det) > 1e-12
        delta = torch.where(ok[..., None], (inv @ (at @ omc[..., None]))[..., 0], 0.0)
        pos = pos + delta

    # final-geometry DOP (reference: geoFunctions:727-737)
    rho = torch.linalg.norm(sat_pos - pos[..., None, :3], dim=-1)
    rot_x = e_r_corr(rho / SPEED_OF_LIGHT, sat_pos)
    diff = rot_x - pos[..., None, :3]
    a = design(diff)
    q, _ = inv4(a.transpose(-1, -2) @ a)
    dop = torch.stack([
        torch.sqrt(q[..., 0, 0] + q[..., 1, 1] + q[..., 2, 2] + q[..., 3, 3]),
        torch.sqrt(q[..., 0, 0] + q[..., 1, 1] + q[..., 2, 2]),
        torch.sqrt(q[..., 0, 0] + q[..., 1, 1]),
        torch.sqrt(q[..., 2, 2]),
        torch.sqrt(q[..., 3, 3]),
    ], dim=-1)

    # post-fit residuals at the converged position (atmosphere at the
    # final elevations carried out of the loop): RAIM's chi-square input
    trop_f = _atmosphere(use_trop, iono_tow, pos, az, el)
    dist_f = torch.linalg.norm(diff, dim=-1)
    resid = torch.where(mask, obs - dist_f - pos[..., 3:4] - trop_f, 0.0)
    return pos, el, az, dop, resid


def least_squares_pos(sat_pos, obs, mask=None, use_trop: bool = True):
    """Receiver position/clock from satellite positions + pseudoranges.

    ``sat_pos``: (3, S) or (S, 3); ``obs``: (S,) meters; ``mask``: (S,)
    bool of usable satellites (default all).  Returns NumPy
    (pos[4] = x,y,z,dt, el (S,) deg, az (S,) deg, dop (5,)).
    """
    sat_pos = np.asarray(sat_pos, np.float64)
    if sat_pos.shape[0] == 3 and sat_pos.shape[-1] != 3:
        sat_pos = sat_pos.T
    obs = np.asarray(obs, np.float64)
    mask = np.ones(len(obs), bool) if mask is None else np.asarray(mask, bool)
    pos, el, az, dop, _resid = solve_epoch(torch.from_numpy(sat_pos), torch.from_numpy(obs),
                                           torch.from_numpy(mask), bool(use_trop))
    return pos.numpy(), el.numpy(), az.numpy(), dop.numpy()
