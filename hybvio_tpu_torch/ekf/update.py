"""Kalman filter updates (port of the reference's ``ekf/update.py``),
batch-first.

Measurement matrices are full width ``(n, d)`` or ``(B, n, d)`` with masked
rows zeroed. An update whose result is not finite is dropped for that lane,
so one degenerate innovation covariance cannot destroy a filter. The visual
downdate is the symmetrized ``P - K'HP`` (not Joseph form), as in the
reference's default. With ``sqrt_mode`` the P field holds the factor W
(P = W W^T) and every update is one pre-array QR (``ekf/sqrt.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..lanes import lane_where, tuple_where
from ..runtime import constant
from .chi2 import CHI2INV95
from .sqrt import sr_innovation_chi2, sr_update
from .state import CAM, ORI, POSE_DIM, VEL, EKFState

_CHI2INV95 = tuple(CHI2INV95.tolist())


def pdot(a, b):
    """Full-precision product (the step runs under runtime.full_precision:
    "highest", TF32 off)."""
    return torch.matmul(a, b)


def _t(a):
    return a.transpose(-1, -2)


def normalize_current_quat(m):
    q = m[..., ORI:ORI + 4]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.cat([m[..., :ORI], q, m[..., ORI + 4:]], dim=-1)


def normalize_quaternions(m, cam_pose_count: int):
    """Normalize the current and all trail quaternions; zero ones stay zero."""
    m = normalize_current_quat(m)
    L = cam_pose_count
    trail = m[..., CAM:CAM + POSE_DIM * L].reshape(m.shape[:-1] + (L, POSE_DIM))
    q = trail[..., 3:]
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    q = torch.where(n > 0, q / torch.where(n > 0, n, torch.ones_like(n)), q)
    trail = torch.cat([trail[..., :3], q], dim=-1).reshape(m.shape[:-1] + (POSE_DIM * L,))
    return torch.cat([m[..., :CAM], trail, m[..., CAM + POSE_DIM * L:]], dim=-1)


def solve_innovation(S, B):
    """Solve S X = B by Cholesky; a lane whose S is not positive definite
    gets NaN, which the callers turn into a dropped update (the reference
    package's ``cho_factor`` NaNs the same way)."""
    L, info = torch.linalg.cholesky_ex(S)
    X = torch.cholesky_solve(B, L)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(X, float("nan")), X)


def innovation_chi2(HPHt, v, r_var):
    """v^T (HPH' + r_var I)^-1 v over the leading dims of ``HPHt`` (..., n,
    n) and ``v`` (..., n); ``r_var`` a float or a tensor of the leading
    dims. Not finite where the solve is not (+inf, or NaN where the
    residual's signs mix, as the reference's): a degenerate innovation
    covariance must reject."""
    eye = torch.eye(HPHt.shape[-1], dtype=HPHt.dtype, device=HPHt.device)
    r_eye = r_var[..., None, None] * eye if isinstance(r_var, torch.Tensor) else r_var * eye
    Sv = solve_innovation(HPHt + r_eye, v[..., None])[..., 0]
    Sv = torch.where(torch.isfinite(Sv), Sv, torch.full_like(Sv, float("inf")))
    return torch.sum(Sv * v, dim=-1)


def _finite_lanes(*ts):
    ok = None
    for t in ts:
        f = torch.isfinite(t).reshape(t.shape[0], -1).all(dim=1)
        ok = f if ok is None else ok & f
    return ok


def kf_update(m, P, y, H, r_diag, sqrt_mode: bool = False):
    """Generic KF update with diagonal noise; ``m`` (B, d), ``P`` (B, d, d),
    ``H`` (n, d) or (B, n, d), ``y`` and ``r_diag`` (n,) or (B, n)."""
    v = y - pdot(H, m[..., None])[..., 0]
    if sqrt_mode:
        m_new, P_new, _ = sr_update(m, P, v.expand(m.shape[0], v.shape[-1]), H,
                                    torch.sqrt(r_diag))
    else:
        HP = pdot(H, P)
        S = pdot(HP, _t(H)) + torch.diag_embed(r_diag.expand(v.shape))
        K = solve_innovation(S, HP)
        m_new = m + pdot(_t(K), v[..., None])[..., 0]
        P_new = P - pdot(_t(K), HP)
    ok = _finite_lanes(m_new, P_new)
    m = lane_where(ok, m_new, m)
    P = lane_where(ok, P_new, P)
    return normalize_current_quat(m), P


def _block_h(d, offset, n, like):
    H = torch.zeros((n, d), dtype=like.dtype, device=like.device)
    H[:, offset:offset + n] = torch.eye(n, dtype=like.dtype, device=like.device)
    return H


def update_zupt(s: EKFState, r, noise_scale, sqrt_mode: bool = False) -> EKFState:
    """Zero-velocity update, rate-limited to once per 0.25 s."""
    do = s.time - s.zupt_time >= 0.25
    H = _block_h(s.m.shape[-1], VEL, 3, s.m)
    zero = torch.zeros(3, dtype=s.m.dtype, device=s.m.device)
    m, P = kf_update(s.m, s.P, zero, H, torch.full_like(zero, r * noise_scale), sqrt_mode)
    new = s._replace(m=m, P=P, zupt_time=s.time,
                     was_stationary=torch.ones_like(s.was_stationary))
    return tuple_where(do, new, s)


def update_zupt_initialization(s: EKFState, init_zupt_r, noise_scale,
                               sqrt_mode: bool = False) -> EKFState:
    """Decaying initialization ZUPT."""
    do = (~s.was_stationary) & (s.time <= 60.0) & (s.time - s.init_zupt_time >= 0.1)
    H = _block_h(s.m.shape[-1], VEL, 3, s.m)
    r = init_zupt_r * noise_scale * torch.exp(0.5 * s.time)
    zero = torch.zeros(3, dtype=s.m.dtype, device=s.m.device)
    m, P = kf_update(s.m, s.P, zero, H, torch.ones_like(zero) * r[:, None], sqrt_mode)
    new = s._replace(m=m, P=P, init_zupt_time=s.time)
    return tuple_where(do, new, s)


def update_pseudo_velocity(s: EKFState, default_speed, r, noise_scale,
                           sqrt_mode: bool = False) -> EKFState:
    """Horizontal speed clamp, rank-1 update."""
    h = torch.linalg.norm(s.m[:, VEL:VEL + 2], dim=-1)
    do = h > 1e-7
    hh = torch.where(do, h, torch.ones_like(h))
    d = s.m.shape[-1]
    H = torch.zeros((s.m.shape[0], 1, d), dtype=s.m.dtype, device=s.m.device)
    H[:, 0, VEL:VEL + 2] = s.m[:, VEL:VEL + 2] / hh[:, None]
    if sqrt_mode:
        m, P, _ = sr_update(s.m, s.P, (default_speed - h)[:, None], H,
                            (r * noise_scale) ** 0.5)
        m = normalize_current_quat(m)
        return tuple_where(do, s._replace(m=m, P=P), s)
    HP = pdot(H, s.P)
    S = pdot(HP, _t(H))[:, 0, 0] + r * noise_scale
    K = HP / S[:, None, None]
    m = s.m + K[:, 0] * (default_speed - h)[:, None]
    P = s.P - pdot(_t(K), HP)
    m = normalize_current_quat(m)
    return tuple_where(do, s._replace(m=m, P=P), s)


class VisualUpdateResult(NamedTuple):
    m: torch.Tensor
    P: torch.Tensor
    is_inlier: torch.Tensor
    rmse_ok: torch.Tensor
    chi2_ok: torch.Tensor
    chi2_value: torch.Tensor


def _over(x, lead):
    """A (B,) threshold tensor shaped to broadcast over the leading dims
    ``lead`` (B, ...); a Python float as it is."""
    if isinstance(x, torch.Tensor):
        return x.reshape(x.shape + (1,) * (len(lead) - x.dim()))
    return x


def _gated(ok, threshold):
    """``ok`` where the gate is on (threshold >= 0), else True: decided once
    for a Python float, lane by lane (no host sync) for a tensor."""
    if isinstance(threshold, torch.Tensor):
        return ok | (threshold < 0)
    return ok if threshold >= 0 else torch.ones_like(ok)


def _gate(P, H, v, n_valid, noise_scale, chi_outlier_r, rmse_threshold,
          sqrt_mode: bool = False):
    """(HP, HPH', rmse_ok, chi2_ok, chi2) of masked tracks over leading dims;
    in sqrt mode (P the factor W) HP and HPH' are None."""
    lead = v.shape[:-1]
    chi_outlier_r, rmse_threshold = _over(chi_outlier_r, lead), _over(rmse_threshold, lead)
    rmse2 = torch.sum(v * v, dim=-1) / torch.clamp(n_valid, min=1)
    rmse_ok = _gated(rmse2 <= rmse_threshold * rmse_threshold, rmse_threshold)
    r_gate = abs((chi_outlier_r * chi_outlier_r) * noise_scale)
    if sqrt_mode:
        HP = HPHt = None
        chi2 = noise_scale * sr_innovation_chi2(P, H, v, r_gate)
    else:
        HP = pdot(H, P)
        HPHt = pdot(HP, _t(H))
        chi2 = noise_scale * innovation_chi2(HPHt, v, r_gate)
    table = constant(_CHI2INV95, P.dtype, P.device)
    thresh = table[torch.clamp(n_valid, max=len(CHI2INV95) - 1)]
    chi2_ok = _gated(chi2 <= thresh, chi_outlier_r)
    return HP, HPHt, rmse_ok, chi2_ok, chi2


def visual_track_update(m, P, H, f, y, mask, visual_r, noise_scale,
                        chi_outlier_r, rmse_threshold, apply_update, sqrt_mode: bool = False):
    """Masked visual update with chi2/RMSE gating, per lane: ``H`` (B, n, d),
    ``f``/``y``/``mask`` (B, n), ``apply_update`` (B,) bool. A gate
    threshold < 0 disables its gate: a Python float decides that for every
    lane at once, a (B,) tensor lane by lane. ``visual_r`` is a float or a
    0-d tensor (a per-frame lens). In sqrt mode ``P`` is the factor W and
    the returned P the updated factor."""
    maskf = mask.to(m.dtype)
    H = H * maskf[..., None]
    v = (y - f) * maskf
    n_valid = torch.sum(mask, dim=-1)
    HP, HPHt, rmse_ok, chi2_ok, chi2 = _gate(
        P, H, v, n_valid, noise_scale, chi_outlier_r, rmse_threshold, sqrt_mode)
    is_inlier = rmse_ok & chi2_ok & (n_valid > 0)
    r = (visual_r * visual_r) * noise_scale
    if sqrt_mode:
        m_new, P_new, _ = sr_update(m, P, v, H, r ** 0.5)
    else:
        eye = torch.eye(H.shape[-2], dtype=P.dtype, device=P.device)
        K = solve_innovation(HPHt + r * eye, HP)
        m_new = m + pdot(_t(K), v[..., None])[..., 0]
        P_new = P - pdot(_t(K), HP)
        P_new = 0.5 * (P_new + _t(P_new))
    m_new = normalize_current_quat(m_new)
    do = is_inlier & apply_update & _finite_lanes(m_new, P_new)
    return VisualUpdateResult(lane_where(do, m_new, m), lane_where(do, P_new, P),
                              is_inlier, rmse_ok, chi2_ok, chi2)


def visual_track_gate(P, H, f, y, mask, noise_scale, chi_outlier_r, rmse_threshold,
                      sqrt_mode: bool = False):
    """Chi2 + RMSE gates only, against one pre-update state: ``P``
    (B, 1, d, d) broadcast over candidate tracks ``H`` (B, NV, n, d); in
    sqrt mode the factor W. Returns (is_inlier, chi2)."""
    maskf = mask.to(P.dtype)
    H = H * maskf[..., None]
    v = (y - f) * maskf
    n_valid = torch.sum(mask, dim=-1)
    _, _, rmse_ok, chi2_ok, chi2 = _gate(
        P, H, v, n_valid, noise_scale, chi_outlier_r, rmse_threshold, sqrt_mode)
    return rmse_ok & chi2_ok & (n_valid > 0), chi2
