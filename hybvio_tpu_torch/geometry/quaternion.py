"""Quaternion / rotation utilities (wxyz, Hamilton), over leading dims.

Port of the reference's ``geometry/quaternion.py`` pieces the stereo step
uses.
"""
from __future__ import annotations

import torch

from ..runtime import constant


def quat_to_rmat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix of a (possibly unnormalized) quaternion; quadratic in
    q and not norm-invariant, like the reference."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack([
        w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z,
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_from_two_vectors(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Quaternion rotating u onto v (Eigen FromTwoVectors semantics)."""
    un = u / torch.linalg.norm(u, dim=-1, keepdim=True)
    vn = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    c = torch.sum(un * vn, dim=-1)
    axis = torch.linalg.cross(un, vn)
    w = torch.sqrt(torch.clamp((1.0 + c) / 2.0, min=0.0))
    xyz = axis / torch.sqrt(torch.clamp(2.0 * (1.0 + c), min=1e-30))[..., None]
    q = torch.cat([w[..., None], xyz], dim=-1)
    ex = constant((1.0, 0.0, 0.0), u.dtype, u.device).expand_as(un)
    ey = constant((0.0, 1.0, 0.0), u.dtype, u.device).expand_as(un)
    ortho = torch.where(torch.abs(un[..., 0:1]) < 0.9,
                        torch.linalg.cross(un, ex), torch.linalg.cross(un, ey))
    ortho = ortho / torch.linalg.norm(ortho, dim=-1, keepdim=True)
    q_pi = torch.cat([torch.zeros_like(c)[..., None], ortho], dim=-1)
    return torch.where((c < -1.0 + 1e-9)[..., None], q_pi, q)


def gyro_update_matrix(w: torch.Tensor, dt) -> torch.Tensor:
    """A = expm(-dt/2 S(w)) in closed form: cos(|w|h) I - sin(|w|h)/|w| S(w)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    S = torch.stack([
        z, -wx, -wy, -wz,
        wx, z, -wz, wy,
        wy, wz, z, -wx,
        wz, -wy, wx, z,
    ], dim=-1).reshape(w.shape[:-1] + (4, 4))
    half = 0.5 * dt
    nrm2 = torch.sum(w * w, dim=-1)
    small = nrm2 < 1e-24
    nrm = torch.sqrt(torch.where(small, torch.ones_like(nrm2), nrm2))
    nh = nrm * half
    h2n2 = nrm2 * half * half
    sinc = torch.where(small, half * (1.0 - h2n2 / 6.0), torch.sin(nh) / nrm)
    cos = torch.where(small, 1.0 - h2n2 / 2.0, torch.cos(nh))
    eye = torch.eye(4, dtype=w.dtype, device=w.device)
    return cos[..., None, None] * eye - sinc[..., None, None] * S
