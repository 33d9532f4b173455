"""Pose-trail augmentation and its undo (port of the reference's
``ekf/augment.py``), batch-first with a per-lane dropped trail index.

The augmentation permutation is a gather index computed from the dropped
index, so one program serves every lane; A P A^T is a double gather + mask.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..runtime import constant
from .state import CAM, ORI, POS, POSE_DIM, EKFState
from .update import normalize_quaternions, pdot, solve_innovation


def _gather_sym(P, src):
    """P[b][src[b]][:, src[b]] for every lane b."""
    d = P.shape[-1]
    rows = torch.gather(P, 1, src[:, :, None].expand(-1, -1, d))
    return torch.gather(rows, 2, src[:, None, :].expand(-1, d, -1))


@functools.lru_cache(maxsize=None)
def _head_h(d: int) -> tuple:
    """The (POSE_DIM, d) measurement "trail head == current pose"."""
    H = np.zeros((POSE_DIM, d))
    for i in range(3):
        H[i, POS + i] = 1.0
        H[i, CAM + i] = -1.0
    for i in range(4):
        H[3 + i, ORI + i] = 1.0
        H[3 + i, CAM + 3 + i] = -1.0
    return tuple(map(tuple, H.tolist()))


def augment_pose(s: EKFState, dropped_pose_index, po) -> EKFState:
    """Clone the current pose into the trail head, dropping trail pose
    ``dropped_pose_index`` (B,) in [0, L-1], then enforce head == current
    with the reference's KF "update trick" (Joseph form)."""
    L = po.cameraTrailLength
    noise_scale = po.noiseScale * po.noiseScale
    dtype, dev = s.m.dtype, s.m.device
    B, d = s.m.shape
    K = dropped_pose_index.to(torch.int64)[:, None]

    idx = torch.arange(d, device=dev)[None, :]
    in_trail = (idx >= CAM) & (idx < CAM + POSE_DIM * L)
    slot = torch.where(in_trail, (idx - CAM) // POSE_DIM, torch.zeros_like(idx))
    src = torch.where(in_trail & (slot >= 1) & (slot <= K), idx - POSE_DIM, idx)
    keepf = (~(in_trail & (slot == 0))).to(dtype).expand(B, d)
    m = torch.gather(s.m, 1, src) * keepf
    P = _gather_sym(s.P, src) * (keepf[:, :, None] * keepf[:, None, :])

    H = constant(_head_h(d), dtype, dev)
    r = po.augmentR * noise_scale
    qdiag = np.zeros(d)
    qdiag[CAM:CAM + 3] = po.noiseInitialPosTrail**2 * noise_scale
    qdiag[CAM + 3:CAM + POSE_DIM] = po.noiseInitialOriTrail**2 * noise_scale
    P = P + torch.diag(constant(tuple(qdiag.tolist()), dtype, dev))

    R = r * torch.eye(POSE_DIM, dtype=dtype, device=dev)
    HP = pdot(H, P)
    S = pdot(HP, H.T) + R
    Kg = solve_innovation(S, HP).transpose(-1, -2)  # (B, d, 7)
    m_new = m + (Kg @ (-(H @ m[..., None])))[..., 0]
    IKH = torch.eye(d, dtype=dtype, device=dev) - pdot(Kg, H)
    P_new = pdot(pdot(IKH, P), IKH.transpose(-1, -2)) + pdot(pdot(Kg, R), Kg.transpose(-1, -2))
    ok = (torch.isfinite(m_new).all(dim=1)
          & torch.isfinite(P_new).reshape(B, -1).all(dim=1))
    m = torch.where(ok[:, None], m_new, m)
    P = torch.where(ok[:, None, None], P_new, P)
    P = 0.5 * (P + P.transpose(-1, -2))
    m = normalize_quaternions(m, L)

    t_now = s.first_sample_t + s.time
    slots = torch.arange(L, device=dev)[None, :]
    old = s.pose_times
    shifted = torch.gather(old, 1, torch.clamp(slots - 1, min=0).expand(B, L))
    new_times = torch.where(slots == 0, t_now[:, None],
                            torch.where(slots <= K, shifted, old))
    augment_count = torch.clamp(s.augment_count + 1, max=L)
    return s._replace(m=m, P=P, pose_times=new_times, augment_count=augment_count)


def undo_augmentation(s: EKFState, cam_pose_count: int) -> EKFState:
    """Drop the head trail pose, shifting the trail back one slot."""
    B, d = s.m.shape
    dev = s.m.device
    trail_dim = POSE_DIM * cam_pose_count
    idx = torch.arange(d, device=dev)
    src = torch.where((idx >= CAM) & (idx + POSE_DIM < CAM + trail_dim), idx + POSE_DIM, idx)
    last = (idx >= CAM + trail_dim - POSE_DIM) & (idx < CAM + trail_dim)
    keepf = (~last).to(s.m.dtype)
    m = s.m[:, src] * keepf
    P = s.P[:, src][:, :, src] * (keepf[:, None] * keepf[None, :])
    new_times = torch.cat([s.pose_times[:, 1:], torch.zeros_like(s.pose_times[:, :1])], dim=1)
    return s._replace(m=m, P=P, pose_times=new_times,
                      augment_count=torch.clamp(s.augment_count - 1, min=0))
