"""Extended Kalman filter navigation: PV + clock states across epochs.

The port of softgnss_tpu.nav.ekf, run by ``config.nav_filter='ekf'`` in
:func:`softgnss_tpu_torch.nav.solve._epoch_loop` in place of the
per-epoch least squares as the primary solution:

    x = [p (3, ECEF m), v (3, m/s), cdt (clock bias, m), cddt (drift, m/s)]

* **Dynamics**: constant velocity plus a clock-drift random walk, with
  discrete white-noise-acceleration process noise (``ekf_accel_psd`` per
  axis, ``ekf_clock_psd`` for the drift, ``ekf_clock_bias_psd``).
* **Measurements**: per satellite, the corrected pseudorange
  (Sagnac-rotated geometry, troposphere and optional Klobuchar, the model
  of nav.pvt) and the carrier-Doppler range rate, as sequential scalar
  updates in Joseph form: masking a satellite is a zero gain, so epochs
  with 1-3 usable satellites still update the filter.
* **Innovation gating**: a measurement whose innovation exceeds
  ``ekf_gate_sigma`` standard deviations of its predicted variance is
  skipped; an infinite innovation (an inactive channel's travel time) is
  zeroed, not only gain-masked, since 0 * inf = NaN would poison the state.

The first successful least-squares fix initializes the filter.  Its
pseudoranges are anchored at the FIRST epoch's common travel offset (see
nav.solve): cdt differs from the least-squares dt by that constant.
Host float64 tensors on the CPU, as all of navigation; one
:func:`ekf_epoch` call per epoch, the same arithmetic as the JAX
function, written for one epoch at a time instead of inside a
``lax.scan``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from softgnss_tpu_torch.nav.atmosphere import tropo
from softgnss_tpu_torch.nav.geodesy import cart2geo, e_r_corr, topocent

SPEED_OF_LIGHT = 299792458.0
N_STATES = 8
_F64 = torch.float64
#: the initial covariance: a cold single-epoch fix (tens of metres under
#: poor DOP), so the first epochs' measurements pull the state quickly
_P0 = (2500.0, 2500.0, 2500.0, 900.0, 900.0, 900.0, 1e6, 1e4)


class EkfState(NamedTuple):
    """Filter state carried across measurement epochs (float64)."""

    x: torch.Tensor      # (8,) [px py pz vx vy vz cdt cddt]
    p: torch.Tensor      # (8, 8) covariance
    init: bool           # has the filter been initialized?


def initial_ekf_state() -> EkfState:
    return EkfState(x=torch.zeros(N_STATES, dtype=_F64), p=torch.eye(N_STATES, dtype=_F64),
                    init=False)


def _transition(t: float) -> torch.Tensor:
    """F: constant-velocity dynamics over ``t`` seconds."""
    f = torch.eye(N_STATES, dtype=_F64)
    f[0, 3] = f[1, 4] = f[2, 5] = f[6, 7] = t
    return f


def _wna_q(t: float, q_accel: float, q_clock: float, q_bias: float) -> torch.Tensor:
    """Discrete white-noise-acceleration Q for the [pos, vel] pairs and the
    [bias, drift] pair."""
    t2, t3 = t * t, t * t * t
    q = torch.zeros((N_STATES, N_STATES), dtype=_F64)
    for i in range(3):
        q[i, i] = q_accel * t3 / 3.0
        q[i, i + 3] = q[i + 3, i] = q_accel * t2 / 2.0
        q[i + 3, i + 3] = q_accel * t
    q[6, 6] = q_clock * t3 / 3.0 + q_bias * t
    q[6, 7] = q[7, 6] = q_clock * t2 / 2.0
    q[7, 7] = q_clock * t
    return q


def _scalar_update(x, p, h, innov, r: float, use: bool):
    """One masked scalar Kalman update (Joseph form): ``h`` (8,) measurement
    row, ``innov`` z - h(x), ``r`` its variance; ``use`` False keeps (x, p)
    (the covariance still goes through the identity Joseph form, as in the
    JAX package)."""
    ph = p @ h
    s = h @ ph + r
    k = ph / s if use else torch.zeros_like(ph)
    x_new = x + k * innov
    ikh = torch.eye(N_STATES, dtype=_F64) - torch.outer(k, h)
    p_new = ikh @ p @ ikh.T + r * torch.outer(k, k)
    return x_new, p_new


def ekf_epoch(state: EkfState, sat_pos, sat_vel, pr_obs, rr_obs, mask, use_trop: bool,
              iono_tow=None, *, t_step: float, q_accel: float, q_clock: float, q_bias: float,
              r_pr: float, r_rr: float, gate: float, ls_pos=None, ls_ok=None, ls_vel=None):
    """Predict and update over one epoch's satellites
    (softgnss_tpu.nav.ekf.ekf_epoch).

    sat_pos / sat_vel: (S, 3) ECEF m, m/s at transmit time; pr_obs: (S,)
    corrected pseudoranges (satellite clock applied, fixed common travel
    offset); rr_obs: (S,) corrected range rates; mask: (S,) bool usable
    satellites; ``iono_tow``: (Klobuchar coefficients, GPS time of week) or
    None.  ``ls_pos`` / ``ls_ok`` / ``ls_vel``: this epoch's least-squares
    [x y z dt], whether it is valid, and [vx vy vz drift], used once to
    initialize the filter.

    Returns (new_state, (pos (3,), vel (3,), cdt, cddt, used)): ``used``
    counts accepted pseudorange updates; outputs are NaN until the filter
    initializes."""
    sat_pos, sat_vel, pr_obs, rr_obs = (torch.as_tensor(v, dtype=_F64)
                                        for v in (sat_pos, sat_vel, pr_obs, rr_obs))
    mask = torch.as_tensor(mask, dtype=torch.bool)

    # initialize from the first valid least-squares fix; the predict is
    # skipped at that epoch (the seed already reflects its measurements)
    just_init = ls_pos is not None and ls_ok is not None and not state.init and bool(ls_ok)
    if just_init:
        x0 = torch.zeros(N_STATES, dtype=_F64)
        x0[0:3] = ls_pos[:3]
        x0[6] = ls_pos[3]
        if ls_vel is not None and bool(torch.isfinite(ls_vel).all()):
            x0[3:6] = ls_vel[:3]
            x0[7] = ls_vel[3]
        state = EkfState(x=x0, p=torch.diag(torch.tensor(_P0, dtype=_F64)), init=True)
        x, p = state.x, state.p
    else:
        f = _transition(t_step)
        x = f @ state.x
        p = f @ state.p @ f.T + _wna_q(t_step, q_accel, q_clock, q_bias)

    # measurement geometry at the predicted position
    rho0 = torch.linalg.norm(sat_pos - x[:3], dim=-1)
    rot_x = e_r_corr(rho0 / SPEED_OF_LIGHT, sat_pos)               # Sagnac
    diff = rot_x - x[:3]
    rho = torch.linalg.norm(diff, dim=-1)
    e_los = diff / torch.clamp(rho, min=1.0)[:, None]
    az, el, _ = topocent(x[:3], diff)
    atm = tropo(torch.sin(torch.deg2rad(el))) if use_trop else torch.zeros_like(rho)
    if iono_tow is not None:
        from softgnss_tpu_torch.nav.iono import klobuchar

        iono8, tow = iono_tow
        lat, lon, _h = cart2geo(x[0], x[1], x[2], 4)
        atm = atm + SPEED_OF_LIGHT * klobuchar(iono8, lat, lon, az, el, tow)

    # sequential scalar updates
    zero3 = torch.zeros(3, dtype=_F64)
    one, zero = torch.ones(1, dtype=_F64), torch.zeros(1, dtype=_F64)
    used = 0
    for i in range(sat_pos.shape[0]):
        # pseudorange: z = rho + cdt + atm
        h_pr = torch.cat([-e_los[i], zero3, one, zero])
        innov = pr_obs[i] - (rho[i] + x[6] + atm[i])
        fin = bool(torch.isfinite(innov))
        innov = innov if fin else torch.zeros((), dtype=_F64)
        s_pr = h_pr @ (p @ h_pr) + r_pr * r_pr
        ok = state.init and bool(mask[i]) and fin and bool(innov * innov < gate * gate * s_pr)
        x, p = _scalar_update(x, p, h_pr, innov, r_pr * r_pr, ok)
        used += int(ok)
        # range rate: z = e . (v_sat - v) + cddt
        h_rr = torch.cat([zero3, -e_los[i], zero, one])
        z_pred = e_los[i] @ sat_vel[i] - e_los[i] @ x[3:6] + x[7]
        innov_r = rr_obs[i] - z_pred
        finite = bool(torch.isfinite(innov_r))
        innov_r = innov_r if finite else torch.zeros((), dtype=_F64)
        s_rr = h_rr @ (p @ h_rr) + r_rr * r_rr
        ok_r = (state.init and bool(mask[i]) and finite
                and bool(innov_r * innov_r < gate * gate * s_rr))
        x, p = _scalar_update(x, p, h_rr, innov_r, r_rr * r_rr, ok_r)

    if not state.init:
        nan = torch.full((3,), float("nan"), dtype=_F64)
        return state, (nan, nan.clone(), float("nan"), float("nan"), used)
    new_state = EkfState(x=x, p=p, init=True)
    return new_state, (x[0:3], x[3:6], float(x[6]), float(x[7]), used)
