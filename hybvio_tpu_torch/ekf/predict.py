"""EKF prediction step (port of the reference's ``ekf/predict.py``),
batch-first over lanes; every lane has its own ``dt``.

    p_new = p + v dt,  q_new = A q,  A = expm(-dt/2 S(xg - bga)),
    v_new = v + (R(q_new)^T (BAT*xa - baa) + g) dt,  baa *= exp(-dt theta_a)

and the block covariance update P_II = F P_II F^T + G Q G^T,
P_TI = P_TI F^T, P_IT = F P_IT.
"""
from __future__ import annotations

import torch

from ..geometry.quaternion import gyro_update_matrix, quat_to_rmat
from ..lanes import lane_where
from ..runtime import constant
from .state import (
    BAA, BAT, BGA, INER_DIM, ORI, POS, Q_ACC, Q_BAA_DRIFT, Q_BGA_DRIFT, Q_DIM,
    Q_GYRO, VEL, EKFState, process_noise_values,
)
from .update import pdot

_dquat_to_rmat = torch.func.vmap(torch.func.jacfwd(quat_to_rmat))


def _smat(i: int, h, like):
    """dS/dw_i * dt/2 for the gyro-noise columns, (B, 4, 4)."""
    M = torch.zeros(h.shape + (4, 4), dtype=like.dtype, device=like.device)
    pos = {0: ((0, 1), (2, 3)), 1: ((0, 2), (3, 1)), 2: ((0, 3), (1, 2))}[i]
    neg = {0: ((1, 0), (3, 2)), 1: ((1, 3), (2, 0)), 2: ((2, 1), (3, 0))}[i]
    for r, c in pos:
        M[..., r, c] = h
    for r, c in neg:
        M[..., r, c] = -h
    return M


def predict_mean_and_jacobians(po, m, dt, xg, xa):
    """(m_new (B, d), dydx (B, 20, 20), dydq (B, 20, 12))."""
    B = m.shape[0]
    dtype, dev = m.dtype, m.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    gravity = constant((0.0, 0.0, -po.gravity), dtype, dev)
    dtc = dt[:, None]

    A = gyro_update_matrix(xg - m[:, BGA:BGA + 3], dt)
    prev_q = m[:, ORI:ORI + 4]
    new_q = (A @ prev_q[..., None])[..., 0]
    R = quat_to_rmat(new_q)
    Rt = R.transpose(-1, -2)
    dR = _dquat_to_rmat(new_q).movedim(-1, 1)  # (B, 4, 3, 3)

    Txab = m[:, BAT:BAT + 3] * xa - m[:, BAA:BAA + 3]
    new_p = m[:, POS:POS + 3] + m[:, VEL:VEL + 3] * dtc
    new_v = m[:, VEL:VEL + 3] + ((Rt @ Txab[..., None])[..., 0] + gravity) * dtc
    parts = [new_p, new_v, new_q, m[:, BGA:BGA + 3], m[:, BAA:BAA + 3], m[:, BAT:]]
    if po.noiseProcessBAA > 0.0:
        parts[4] = parts[4] * torch.exp(-dt * po.noiseProcessBAARev)[:, None]
    if po.noiseProcessBGA > 0.0:
        parts[3] = parts[3] * torch.exp(-dt * po.noiseProcessBGARev)[:, None]
    m = torch.cat(parts, dim=-1)

    dydx = torch.eye(INER_DIM, dtype=dtype, device=dev).repeat(B, 1, 1)
    dydq = torch.zeros((B, INER_DIM, Q_DIM), dtype=dtype, device=dev)
    dydx[:, POS:POS + 3, VEL:VEL + 3] = dt[:, None, None] * eye3
    dv_dnewq = torch.stack(
        [(dR[:, k].transpose(-1, -2) @ Txab[..., None])[..., 0] for k in range(4)],
        dim=-1) * dt[:, None, None]  # (B, 3, 4)
    dydx[:, VEL:VEL + 3, ORI:ORI + 4] = dv_dnewq @ A
    dydx[:, ORI:ORI + 4, ORI:ORI + 4] = A
    dydq[:, VEL:VEL + 3, Q_ACC:Q_ACC + 3] = Rt * dt[:, None, None]
    h = dt / 2
    dq_dgyro = torch.stack(
        [(A @ (_smat(i, h, m) @ prev_q[..., None]))[..., 0] for i in range(3)],
        dim=-1)  # (B, 4, 3)
    dydq[:, ORI:ORI + 4, Q_GYRO:Q_GYRO + 3] = dq_dgyro
    dydq[:, BGA:BGA + 3, Q_BGA_DRIFT:Q_BGA_DRIFT + 3] = eye3
    dydq[:, BAA:BAA + 3, Q_BAA_DRIFT:Q_BAA_DRIFT + 3] = eye3
    dv_dgyro = dydx[:, VEL:VEL + 3, ORI:ORI + 4] @ dq_dgyro
    dydq[:, VEL:VEL + 3, Q_GYRO:Q_GYRO + 3] = dv_dgyro
    dydx[:, VEL:VEL + 3, BGA:BGA + 3] = -dv_dgyro
    dydx[:, ORI:ORI + 4, BGA:BGA + 3] = -dq_dgyro
    dydx[:, VEL:VEL + 3, BAA:BAA + 3] = -Rt * dt[:, None, None]
    dydx[:, VEL:VEL + 3, BAT:BAT + 3] = (Rt * xa[:, None, :]) * dt[:, None, None]
    if po.noiseProcessBAA > 0.0:
        decay = torch.exp(-dt * po.noiseProcessBAARev)
        dydx[:, BAA:BAA + 3, BAA:BAA + 3] = decay[:, None, None] * eye3
    if po.noiseProcessBGA > 0.0:
        decay = torch.exp(-dt * po.noiseProcessBGARev)
        dydx[:, BGA:BGA + 3, BGA:BGA + 3] = decay[:, None, None] * eye3
    return m, dydx, dydq


def process_noise_diag(po, dt, dtype, device):
    """(B, Q_DIM) process-noise diagonal with the dt-dependent OU terms."""
    noise_scale = po.noiseScale * po.noiseScale
    q = constant(process_noise_values(po), dtype, device).repeat(dt.shape[0], 1)
    if po.noiseProcessBAA > 0.0:
        qb = noise_scale * po.noiseProcessBAA**2 * torch.ones_like(dt)
        if po.noiseProcessBAARev > 0.0:
            qb = qb * (1 - torch.exp(-2 * dt * po.noiseProcessBAARev)) / (2 * po.noiseProcessBAARev)
        q[:, Q_BAA_DRIFT:Q_BAA_DRIFT + 3] = qb[:, None]
    if po.noiseProcessBGA > 0.0:
        qg = noise_scale * po.noiseProcessBGA**2 * torch.ones_like(dt)
        if po.noiseProcessBGARev > 0.0:
            qg = qg * (1 - torch.exp(-2 * dt * po.noiseProcessBGARev)) / (2 * po.noiseProcessBGARev)
        q[:, Q_BGA_DRIFT:Q_BGA_DRIFT + 3] = qg[:, None]
    return q


def make_predict(po):
    """predict(state, t (B,), xg (B, 3), xa (B, 3)) -> state. A lane whose
    dt is not positive (first, duplicate or out-of-order sample) keeps its
    mean and covariance."""

    def predict(s: EKFState, t, xg, xa) -> EKFState:
        first = ~s.got_first_sample
        zero = torch.zeros_like(t)
        dt = torch.where(first, zero, t - s.prev_sample_t)
        first_sample_t = torch.where(first, t, s.first_sample_t)
        time = torch.where(first, s.time, t - first_sample_t)
        s = s._replace(prev_sample_t=t, first_sample_t=first_sample_t,
                       got_first_sample=torch.ones_like(s.got_first_sample),
                       time=time)
        m, dydx, dydq = predict_mean_and_jacobians(po, s.m, dt, xg, xa)
        q_diag = process_noise_diag(po, dt, s.m.dtype, s.m.device)
        P = s.P
        dydxT = dydx.transpose(-1, -2)
        P_II = (pdot(pdot(dydx, P[:, :INER_DIM, :INER_DIM]), dydxT)
                + pdot(dydq * q_diag[:, None, :], dydq.transpose(-1, -2)))
        P_TI = pdot(P[:, INER_DIM:, :INER_DIM], dydxT)
        P_IT = pdot(dydx, P[:, :INER_DIM, INER_DIM:])
        P_new = torch.cat([torch.cat([P_II, P_IT], dim=2),
                           torch.cat([P_TI, P[:, INER_DIM:, INER_DIM:]], dim=2)], dim=1)
        go = dt > 0.0
        return s._replace(m=lane_where(go, m, s.m), P=lane_where(go, P_new, s.P))

    return predict
