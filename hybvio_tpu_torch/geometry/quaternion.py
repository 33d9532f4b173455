"""Quaternion / rotation utilities (wxyz, Hamilton), over leading dims.

Port of the reference's ``geometry/quaternion.py`` pieces the step, the
host API (``ekf/transforms.py``, ``api/vio.py``) and the SLAM solves
(``slam/ba.py``) use.
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


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * constant((1.0, -1.0, -1.0, -1.0), q.dtype, q.device)


def quat_right_mul_matrix(p: torch.Tensor) -> torch.Tensor:
    """Matrix M such that M @ q == quat_mul(q, p) (right multiplication by
    p), used to rotate the whole pose trail."""
    p1, p2, p3, p4 = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return torch.stack([
        p1, -p2, -p3, -p4,
        p2, p1, p4, -p3,
        p3, -p4, p1, p2,
        p4, p3, -p2, p1,
    ], dim=-1).reshape(p.shape[:-1] + (4, 4))


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize; an all-zero quaternion stays all-zero (the reference's
    ``quat_normalize`` with eps = 0)."""
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(n > 0, q / torch.where(n > 0, n, torch.ones_like(n)), q)


def rmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Quaternion [w,x,y,z] from a rotation matrix; w >= 0, branch-free
    Shepperd as the reference."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp(1 + tr, min=0.0)) / 2
    qx = torch.sqrt(torch.clamp(1 + m00 - m11 - m22, min=0.0)) / 2
    qy = torch.sqrt(torch.clamp(1 - m00 + m11 - m22, min=0.0)) / 2
    qz = torch.sqrt(torch.clamp(1 - m00 - m11 + m22, min=0.0)) / 2
    sign = lambda d: torch.where(d < 0, -1.0, 1.0).to(R.dtype)
    q = torch.stack([qw, qx * sign(m21 - m12), qy * sign(m02 - m20), qz * sign(m10 - m01)],
                    dim=-1)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def remove_z_tilt_rmat(R: torch.Tensor) -> torch.Tensor:
    """The XY (yaw-only) rotation part of R (..., 3, 3) (reference:
    src/odometry/util.cpp:76-101): the rotation about z that takes x where
    R's first column points in the xy plane."""
    angle = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([c, -s, z, s, c, z, z, z, o], dim=-1).reshape(R.shape[:-2] + (3, 3))
