"""State transforms (port of the reference's ``ekf/transforms.py``),
batch-first: orientation initialization from the first accelerometer sample
(heading variance pinned to zero), the insertion of a hybrid map point, and
the host-triggered state surgery of the API (rigid re-anchoring on a reset
that keeps the pose, conditioning on the last pose, locking the biases;
reference: src/odometry/ekf.cpp:296-317, 686-758, 928-947). Each takes
``sqrt_mode``: the P field then holds the factor W (P = W W^T,
``ekf/sqrt.py``)."""
from __future__ import annotations

import torch

from ..geometry.quaternion import (
    quat_conj, quat_from_two_vectors, quat_mul, quat_right_mul_matrix, quat_to_rmat,
)
from ..runtime import constant
from .sqrt import sr_add_diag_noise
from .state import BGA, CAM, MAP_POINT_DIM, ORI, POS, POSE_DIM, VEL, EKFState

MAP_POINT_PRIOR_STD = 1e3
CONDITIONED_POSE_STD = 1e3


def insert_map_point(s: EKFState, offset, pf, sqrt_mode: bool = False) -> EKFState:
    """Write map point ``pf`` (B, 3) into the state block at ``offset``
    (B,) of every lane: the block's mean becomes ``pf``, its covariance rows
    and columns zero and its variance ``MAP_POINT_PRIOR_STD**2`` (in sqrt
    mode: the factor's rows zeroed, the prior folded in by one QR). Index
    masks, no host sync."""
    m = s.m
    idx = torch.arange(m.shape[-1], device=m.device)[None, :]
    rel = idx - offset.to(idx.dtype)[:, None]
    in_block = (rel >= 0) & (rel < MAP_POINT_DIM)
    keep = (~in_block).to(m.dtype)
    prior = torch.where(in_block, MAP_POINT_PRIOR_STD * MAP_POINT_PRIOR_STD, 0.0).to(m.dtype)
    if sqrt_mode:
        P = sr_add_diag_noise(s.P * keep[:, :, None], prior)
    else:
        P = s.P * (keep[:, :, None] * keep[:, None, :]) + torch.diag_embed(prior)
    pf_at = torch.gather(pf, 1, torch.clamp(rel, 0, MAP_POINT_DIM - 1))
    return s._replace(m=torch.where(in_block, pf_at, m), P=P)


def initialize_orientation(s: EKFState, xa, noise_initial_ori, noise_scale,
                           sqrt_mode: bool = False) -> EKFState:
    """The orientation from the first accelerometer sample, heading
    variance zero. In sqrt mode the factor's ORI rows become the block's
    standard deviations: that zeroes P's ORI rows and columns too, which
    equals the reference's diagonal-block overwrite where it is called (the
    ORI cross-covariances are still zero then)."""
    dtype, dev = s.m.dtype, s.m.device
    up = constant((0.0, 0.0, 1.0), dtype, dev).expand_as(xa)
    q = quat_from_two_vectors(up, xa)
    m = torch.cat([s.m[:, :ORI], q, s.m[:, ORI + 4:]], dim=1)
    block_var = constant((1.0, 1.0, 1.0, 0.0), dtype, dev) * (
        noise_initial_ori**2 * noise_scale)
    P = s.P.clone()
    if sqrt_mode:
        P[:, ORI:ORI + 4, :] = 0.0
        block_var = torch.sqrt(block_var)
    P[:, ORI:ORI + 4, ORI:ORI + 4] = torch.diag(block_var)
    return s._replace(m=m, P=P)


def translate_to(s: EKFState, pos, cam_pose_count: int) -> EKFState:
    """Translate the current and trail positions of every lane so the
    current position becomes ``pos`` (B, 3) (reference: ekf.cpp:686-702)."""
    delta = pos - s.m[:, POS:POS + 3]
    m = s.m.clone()
    m[:, POS:POS + 3] += delta
    for i in range(cam_pose_count):
        off = CAM + POSE_DIM * i
        m[:, off:off + 3] += delta
    return s._replace(m=m)


def transform_to(s: EKFState, pos, q, cam_pose_count: int, pose_index: int = -1,
                 sqrt_mode: bool = False) -> EKFState:
    """Rigidly rotate and translate the whole state of every lane, its
    covariance included, so pose ``pose_index`` (-1 = current) becomes
    (``pos`` (B, 3), ``q`` (B, 4)) (reference: ekf.cpp:704-758)."""
    m, P = s.m, s.P
    B, d = m.shape
    if pose_index < 0:
        q0, p0 = m[:, ORI:ORI + 4], m[:, POS:POS + 3]
    else:
        off = CAM + POSE_DIM * pose_index
        p0, q0 = m[:, off:off + 3], m[:, off + 3:off + 7]
    q_change = quat_mul(quat_conj(q0), q)
    q_change_mat = quat_right_mul_matrix(q_change)
    p_change_mat = quat_to_rmat(q_change).transpose(-1, -2)

    A = torch.eye(d, dtype=m.dtype, device=m.device).repeat(B, 1, 1)
    A[:, POS:POS + 3, POS:POS + 3] = p_change_mat
    A[:, VEL:VEL + 3, VEL:VEL + 3] = p_change_mat
    A[:, ORI:ORI + 4, ORI:ORI + 4] = q_change_mat
    for i in range(cam_pose_count):
        off = CAM + POSE_DIM * i
        A[:, off:off + 3, off:off + 3] = p_change_mat
        A[:, off + 3:off + 7, off + 3:off + 7] = q_change_mat
    m = (A @ m[:, :, None])[:, :, 0]
    P = A @ P if sqrt_mode else A @ P @ A.transpose(-1, -2)
    s = s._replace(m=m, P=P)
    ref_pos = (p_change_mat @ p0[:, :, None])[:, :, 0]
    return translate_to(s, s.m[:, POS:POS + 3] + (pos - ref_pos), cam_pose_count)


def condition_on_last_pose(s: EKFState, cam_pose_count: int, sqrt_mode: bool = False) -> EKFState:
    """Schur-condition every lane's state on its last POSE_DIM entries, then
    give them a covariance of ``CONDITIONED_POSE_STD**2`` (reference:
    ekf.cpp:928-942). In sqrt mode P = W W^T is conditioned and re-factored
    through its symmetric eigendecomposition, as the reference does: rare
    surgery the API runs between steps (``eigh`` checks its result on the
    host)."""
    P = s.P @ s.P.transpose(-1, -2) if sqrt_mode else s.P
    k = P.shape[-1] - POSE_DIM
    A, Bm, C = P[:, :k, :k], P[:, :k, k:], P[:, k:, k:]
    Pnew = A - Bm @ torch.linalg.solve_ex(C, Bm.transpose(-1, -2))[0]
    out = torch.zeros_like(P)
    out[:, :k, :k] = Pnew
    out[:, k:, k:] = torch.eye(POSE_DIM, dtype=P.dtype, device=P.device) * (
        CONDITIONED_POSE_STD * CONDITIONED_POSE_STD)
    if sqrt_mode:
        lam, V = torch.linalg.eigh(0.5 * (out + out.transpose(-1, -2)))
        out = V * torch.sqrt(torch.clamp(lam, min=0.0))[:, None, :]
    return s._replace(P=out)


def lock_biases(s: EKFState, sqrt_mode: bool = False) -> EKFState:
    """Zero all covariance involving BGA/BAA/BAT (reference: ekf.cpp:944-947;
    in sqrt mode the factor's rows, which zeroes P's rows and columns)."""
    P = s.P.clone()
    P[:, BGA:BGA + 9, :] = 0.0
    if not sqrt_mode:
        P[:, :, BGA:BGA + 9] = 0.0
    return s._replace(P=P)
