"""Triangulation (port of the reference's ``odometry/triangulation.py``).

``triangulate_gn`` works on ONE track (N poses) so that the visual update
can take ``torch.func.vmap(torch.func.jacfwd(...))`` of it: no host syncs and
no Python branches on tensor values. The Gauss-Newton fixed point is solved
on detached values, then one differentiable step at the solution carries
all input sensitivities (implicit-function differentiation, as in the
reference). A camera pose is (p, R): camera position in world and
world-to-camera rotation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.quaternion import quat_to_rmat

TRI_OK = 0
TRI_NO_CONVERGENCE = 1
TRI_BAD_COND = 2
TRI_BEHIND = 3
TRI_UNKNOWN_PROBLEM = 4
TRI_BAD_DEPTH = 5
TRI_HYBRID = 6


class CameraPoses(NamedTuple):
    p: torch.Tensor  # (..., 3) camera position in world
    R: torch.Tensor  # (..., 3, 3) world-to-camera rotation


def camera_poses_from_states(pose_states, imu_to_camera) -> CameraPoses:
    """IMU pose states (..., 7) [pos, quat] -> camera poses."""
    R = imu_to_camera[:3, :3] @ quat_to_rmat(pose_states[..., 3:7])
    p = pose_states[..., :3] - (R.transpose(-1, -2) @ imu_to_camera[:3, 3])
    return CameraPoses(p=p, R=R)


def inverse_depth(pf):
    """[x, y, z] -> [x/z, y/z, 1/z] (its own inverse)."""
    return torch.stack([pf[..., 0], pf[..., 1], torch.ones_like(pf[..., 2])], dim=-1) / pf[..., 2:3]


def _solve3_spd_equil(A, b):
    """x = A^-1 b for PSD 3x3 A: Jacobi equilibration, then Cholesky."""
    tiny = torch.finfo(A.dtype).tiny
    s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(A), min=tiny))
    As = A * s[:, None] * s[None, :]
    bs = b * s
    l11 = torch.sqrt(torch.clamp(As[0, 0], min=tiny))
    l21 = As[0, 1] / l11
    l31 = As[0, 2] / l11
    l22 = torch.sqrt(torch.clamp(As[1, 1] - l21 * l21, min=tiny))
    l32 = (As[1, 2] - l21 * l31) / l22
    l33 = torch.sqrt(torch.clamp(As[2, 2] - l31 * l31 - l32 * l32, min=tiny))
    y1 = bs[0] / l11
    y2 = (bs[1] - l21 * y1) / l22
    y3 = (bs[2] - l31 * y1 - l32 * y2) / l33
    x3 = y3 / l33
    x2 = (y2 - l32 * x3) / l22
    x1 = (y1 - l21 * x2 - l31 * x3) / l11
    return torch.stack([x1, x2, x3]) * s


def _rcond_sym3(A):
    """|lambda_min| / |lambda_max| of a symmetric 3x3 matrix from the
    closed-form (trigonometric) eigenvalues: no iterative solver, so it never
    raises and needs no host sync; absolute accuracy ~eps * ||A||, the same
    order as an iterative eigensolver's."""
    a00, a11, a22 = A[0, 0], A[1, 1], A[2, 2]
    a01, a02, a12 = A[0, 1], A[0, 2], A[1, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p = torch.sqrt((b00 * b00 + b11 * b11 + b22 * b22 + 2 * p1) / 6)
    sp = torch.where(p > 0, p, torch.ones_like(p))
    c00, c11, c22, c01, c02, c12 = b00 / sp, b11 / sp, b22 / sp, a01 / sp, a02 / sp, a12 / sp
    det = (c00 * (c11 * c22 - c12 * c12) - c01 * (c01 * c22 - c12 * c02)
           + c02 * (c01 * c12 - c11 * c02))
    phi = torch.acos(torch.clamp(det / 2, -1.0, 1.0)) / 3
    lmax = q + 2 * p * torch.cos(phi)
    lmin = q + 2 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)
    lmin = torch.where(p > 0, lmin, q)
    lmax = torch.where(p > 0, lmax, q)
    return torch.abs(lmin) / torch.clamp(torch.abs(lmax), min=1e-300)


def triangulate_two_cameras(p0, R0, p1, R1, ip0, ip1):
    """Midpoint 2-view triangulation via the 3x2 normal equations, in camera
    0 coordinates; over leading dims."""
    C = R0 @ R1.transpose(-1, -2)
    b = (R0 @ (p1 - p0)[..., None])[..., 0]
    one = torch.ones_like(ip0[..., :1])
    v0 = torch.cat([ip0, one], dim=-1)
    v1 = torch.cat([ip1, one], dim=-1)
    vn0 = v0 / torch.linalg.norm(v0, dim=-1, keepdim=True)
    vn1 = v1 / torch.linalg.norm(v1, dim=-1, keepdim=True)
    A = torch.stack([vn0, -(C @ vn1[..., None])[..., 0]], dim=-1)  # (..., 3, 2)
    At = A.transpose(-1, -2)
    eye = torch.eye(2, dtype=A.dtype, device=A.device)
    # solve_ex: a singular system gives inf/nan like the reference's LU
    # solve, without raising or syncing with the host
    s = torch.linalg.solve_ex(At @ A + 1e-300 * eye, (At @ b[..., None])[..., 0])[0]
    return s[..., 0:1] * vn0


def _pick(a, i):
    """a[i] for a 0-d index tensor (vmap-safe)."""
    return torch.index_select(a, 0, i.reshape(1))[0]


def triangulate_gn(poses: CameraPoses, ips, mask, gn_iterations=10,
                   convergence_threshold=1e-2, convergence_r=11.0,
                   rcond_threshold=1e-8, stereo=False):
    """GN triangulation of ONE track in inverse-depth coordinates: poses
    (N,) (stereo: left poses then right poses), ips (N, 2), mask (N,).
    Returns (pf (3,) world point, status () int64). Differentiable in poses
    and ips through the final GN step."""
    dtype = ips.dtype
    N = ips.shape[0]
    maskf = mask.to(dtype)
    half = N // 2 if stereo else N
    idx_range = torch.arange(half, device=ips.device)
    ind1 = torch.clamp(torch.max(torch.where(mask[:half], idx_range, -1)), min=1)

    p0, R0 = poses.p[0], poses.R[0]
    pf0 = triangulate_two_cameras(
        p0.detach(), R0.detach(), _pick(poses.p, ind1).detach(),
        _pick(poses.R, ind1).detach(), ips[0].detach(), _pick(ips, ind1).detach())
    pfi = inverse_depth(pf0)
    R0T = R0.transpose(0, 1)
    C = poses.R @ R0T
    t = (poses.R @ (p0[None, :] - poses.p)[..., None])[..., 0]

    def gn_step(pfi, C, t, ips):
        pfiab = torch.stack([pfi[0], pfi[1], torch.ones_like(pfi[0])])
        h = (C @ pfiab) + pfi[2] * t
        h2 = h[:, 2]
        safe_h2 = torch.where(torch.abs(h2) > 1e-12, h2, torch.ones_like(h2))
        err = (ips - h[:, :2] / safe_h2[:, None]) * maskf[:, None]
        ih2sq = 1.0 / (safe_h2 * safe_h2)
        E01 = (-1.0 / safe_h2)[:, None, None] * C[:, :2, :2] + (
            h[:, :2, None] * ih2sq[:, None, None]) * C[:, None, 2, :2]
        E2 = -t[:, :2] / safe_h2[:, None] + h[:, :2] * (ih2sq * t[:, 2])[:, None]
        E = torch.cat([E01, E2[:, :, None]], dim=2) * maskf[:, None, None]
        ETE = torch.einsum("nij,nik->jk", E, E)
        Eerr = torch.einsum("nij,ni->j", E, err)
        J = 0.5 * torch.sum(err * err) / (convergence_r * convergence_r)
        return pfi - _solve3_spd_equil(ETE, Eerr), J, ETE

    C_ng, t_ng, ips_ng = C.detach(), t.detach(), ips.detach()
    pfi_k = pfi
    J_prev = torch.full((), 1e10, dtype=dtype, device=ips.device)
    converged = torch.zeros((), dtype=torch.bool, device=ips.device)
    for _ in range(gn_iterations - 1):
        pfi_k, J, _ = gn_step(pfi_k, C_ng, t_ng, ips_ng)
        Jd = torch.abs((J - J_prev) / torch.where(torch.abs(J) > 0, J, torch.ones_like(J)))
        converged = converged | (Jd < convergence_threshold) | (J < 1e-14)
        J_prev = J

    pfi, _, ETE = gn_step(pfi_k, C, t, ips)
    rcond = _rcond_sym3(ETE.detach())

    pf = R0T @ inverse_depth(pfi) + p0
    z_all = (poses.R @ (pf[None, :] - poses.p)[..., None])[..., 2, 0]
    behind = torch.any(mask & (z_all.detach() < 0))
    status = torch.where(
        ~converged, TRI_NO_CONVERGENCE,
        torch.where(rcond < rcond_threshold, TRI_BAD_COND,
                    torch.where(behind, TRI_BEHIND, TRI_OK)))
    return pf, status


def _solve3_lu(A, b):
    """x = A^-1 b for one 3x3 A by Gaussian elimination with partial
    pivoting (an LU solve, as the reference's) in elementwise tensor ops.
    ``torch.linalg.solve`` is avoided: its forward-mode derivative under
    ``torch.func.vmap`` is wrong for all but the first batch element
    (torch 2.13). A singular A gives inf/nan; nothing raises or syncs."""
    Ab = torch.cat([A, b[:, None]], dim=1)  # (3, 4)
    rows = torch.arange(3, device=A.device)
    for k in range(2):
        p = torch.argmax(torch.abs(Ab[k:, k])) + k
        swap = torch.where(rows == k, p, torch.where(rows == p, k, rows))
        Ab = torch.gather(Ab, 0, swap[:, None].expand(3, 4))
        below = Ab[k + 1:, k:k + 1] * (1.0 / Ab[k, k])
        Ab = torch.cat([Ab[:k + 1], Ab[k + 1:] - below * Ab[k:k + 1]], dim=0)
    x2 = Ab[2, 3] / Ab[2, 2]
    x1 = (Ab[1, 3] - Ab[1, 2] * x2) / Ab[1, 1]
    x0 = (Ab[0, 3] - Ab[0, 2] * x2 - Ab[0, 1] * x1) / Ab[0, 0]
    return torch.stack([x0, x1, x2])


def triangulate_linear(poses: CameraPoses, ips, mask):
    """Closed-form linear triangulation of ONE track: the point nearest to
    its rays in the least-squares sense, poses (N,), ips (N, 2), mask (N,).
    Returns (pf (3,), status () int64: TRI_BEHIND or TRI_OK).
    Differentiable in poses and ips; the 3x3 solve neither raises nor syncs
    (a singular system gives inf/nan, as the reference's LU solve)."""
    dtype = ips.dtype
    maskf = mask.to(dtype)
    v = torch.cat([ips, torch.ones_like(ips[..., :1])], dim=-1)
    vw = (poses.R.transpose(-1, -2) @ v[..., None])[..., 0]  # the ray in world
    vn = vw / torch.linalg.norm(vw, dim=-1, keepdim=True)
    eye = torch.eye(3, dtype=dtype, device=ips.device)
    A = (eye[None] - vn[:, :, None] * vn[:, None, :]) * maskf[:, None, None]
    S0 = torch.sum(A, dim=0)
    S1 = torch.einsum("nij,nj->i", A, poses.p)
    pf = _solve3_lu(S0 + 1e-300 * eye, S1)
    z_all = (poses.R @ (pf[None, :] - poses.p)[..., None])[..., 2, 0]
    behind = torch.any(mask & (z_all.detach() < 0))
    return pf, torch.where(behind, TRI_BEHIND, TRI_OK)


def _inverse_depth_jacobian(a):
    """d inverse_depth / d a of points (..., 3): closed form."""
    iz = 1.0 / a[..., 2]
    zero = torch.zeros_like(iz)
    return torch.stack([
        torch.stack([iz, zero, -a[..., 0] * iz * iz], dim=-1),
        torch.stack([zero, iz, -a[..., 1] * iz * iz], dim=-1),
        torch.stack([zero, zero, -iz * iz], dim=-1)], dim=-2)


def _inv3(A):
    """Inverse of 3x3 matrices (..., 3, 3) by the adjugate (elementwise, so
    forward-mode safe under vmap); a singular A gives inf/nan."""
    a = lambda i, j: A[..., i, j]
    c00 = a(1, 1) * a(2, 2) - a(1, 2) * a(2, 1)
    c01 = a(1, 2) * a(2, 0) - a(1, 0) * a(2, 2)
    c02 = a(1, 0) * a(2, 1) - a(1, 1) * a(2, 0)
    det = a(0, 0) * c00 + a(0, 1) * c01 + a(0, 2) * c02
    adj = torch.stack([
        c00, a(0, 2) * a(2, 1) - a(0, 1) * a(2, 2), a(0, 1) * a(1, 2) - a(0, 2) * a(1, 1),
        c01, a(0, 0) * a(2, 2) - a(0, 2) * a(2, 0), a(0, 2) * a(1, 0) - a(0, 0) * a(1, 2),
        c02, a(0, 1) * a(2, 0) - a(0, 0) * a(2, 1), a(0, 0) * a(1, 1) - a(0, 1) * a(1, 0),
    ], dim=-1).reshape(A.shape)
    return adj / det[..., None, None]


def triangulate_stereo_fused(poses: CameraPoses, stereo_idp, stereo_cov, stereo_valid):
    """Information-weighted fusion of ONE track's per-pose stereo
    triangulations (``useIndependentStereoTriangulation``): poses (N,) left
    cameras, stereo_idp (N, 3) each in inverse-depth coordinates of its own
    camera, stereo_cov (N, 3, 3) their sensitivity covariances, stereo_valid
    (N,). Each is mapped into the anchor (row 0) camera's inverse-depth
    coordinates and averaged with weights (J cov J^T)^-1; J is in closed
    form and the 3x3 inverse an adjugate, so ``torch.func.jacfwd`` of the
    whole under vmap is exact. Returns (pf (3,) world point, status () int64,
    rcond ())."""
    dtype = stereo_idp.dtype
    p0, R0 = poses.p[0], poses.R[0]
    eye = torch.eye(3, dtype=dtype, device=stereo_idp.device)
    RiT = poses.R.transpose(-1, -2)
    f3 = inverse_depth(stereo_idp)
    pos_w = (RiT @ f3[..., None])[..., 0] + poses.p
    pos0 = (R0 @ (pos_w - p0)[..., None])[..., 0]
    ipos = inverse_depth(pos0)
    J = _inverse_depth_jacobian(pos0) @ R0 @ RiT @ _inverse_depth_jacobian(stereo_idp)
    cov = J @ stereo_cov @ J.transpose(-1, -2)
    finite_cov = torch.all(torch.isfinite(cov.reshape(-1, 9)), dim=-1)
    usable = (stereo_valid & (torch.linalg.norm(cov.reshape(-1, 9), dim=-1) >= 1e-10)
              & finite_cov)
    tiny = torch.finfo(dtype).tiny
    ridge = 1e-9 * torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1) + tiny
    info = _inv3(cov + ridge[:, None, None] * eye)
    finite_info = torch.all(torch.isfinite(info.reshape(-1, 9)), dim=-1)
    info = torch.where(finite_info[:, None, None], info, torch.zeros_like(info))
    info = info * usable.to(dtype)[:, None, None]
    wsum = torch.sum((info @ ipos[..., None])[..., 0], dim=0)
    SW = torch.sum(info, dim=0)
    ok_cond = torch.linalg.norm(SW) >= 1e-10
    SW_safe = SW + torch.where(ok_cond, 0.0, 1.0).to(dtype) * eye
    pf = R0.transpose(0, 1) @ inverse_depth(_solve3_spd_equil(SW_safe, wsum)) + p0
    finite = torch.all(torch.isfinite(pf))
    status = torch.where(ok_cond & finite, TRI_OK, TRI_BAD_COND)
    diag = torch.diagonal(SW)
    rc = torch.min(diag) / torch.clamp(torch.max(diag), min=tiny)
    return torch.where(finite, pf, torch.zeros_like(pf)), status, rc


def _norm(x):
    """|x| over the last dim as sqrt(sum x^2) (keepdim), whose derivative at
    0 is nan, as the reference's ``jnp.linalg.norm``'s."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def triangulate_stereo_idp(ip_first, ip_second, second_to_first_camera, with_cov=True):
    """(w)Mid2 two-ray triangulation in inverse-depth coordinates of the
    first camera, over leading dims. Returns (idp, cov or None, ok); the
    3x3 sensitivity covariance J J^T of the idp in the four image
    coordinates, J by reverse mode (``torch.func.jacrev``: forward mode
    keeps a process-global dual level, which a SLAM worker thread's own
    Jacobians would race)."""
    R = second_to_first_camera[:3, :3]
    tt = second_to_first_camera[:3, 3]

    def pf_fn(f0, f1):
        f0hat = f0 / _norm(f0)
        f1hat = f1 / _norm(f1)
        Rf0 = (R @ f0hat[..., None])[..., 0]
        ttb = tt.expand_as(Rf0)
        p = torch.linalg.cross(Rf0, f1hat)
        q = torch.linalg.cross(Rf0, ttb)
        r = torch.linalg.cross(f1hat, ttb)
        pn = _norm(p)
        qn = _norm(q)
        rn = _norm(r)
        lam0 = rn / torch.clamp(pn, min=1e-300)
        w = qn / torch.clamp(qn + rn, min=1e-300)
        pf = w * (tt + lam0 * (Rf0 + f1hat))
        return pf, Rf0, f1hat, lam0, qn, pn

    one = torch.ones_like(ip_first[..., :1])
    f0 = torch.cat([ip_second, one], dim=-1)
    f1 = torch.cat([ip_first, one], dim=-1)
    pf, Rf0, f1hat, lam0, qn, pn = pf_fn(f0, f1)
    lam1 = qn / torch.clamp(pn, min=1e-300)
    l0Rf0 = lam0 * Rf0
    l1f1 = lam1 * f1hat
    c0 = torch.sum((tt + l0Rf0 - l1f1) ** 2, dim=-1)
    c1 = torch.sum((tt + l0Rf0 + l1f1) ** 2, dim=-1)
    c2 = torch.sum((tt - l0Rf0 - l1f1) ** 2, dim=-1)
    c3 = torch.sum((tt - l0Rf0 + l1f1) ** 2, dim=-1)
    ok = c0 <= torch.minimum(torch.minimum(c1, c2), c3)
    z = pf[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-12, z, torch.ones_like(z))
    idp = torch.stack([pf[..., 0], pf[..., 1], torch.ones_like(z)], dim=-1) / safe_z[..., None]
    if not with_cov:
        return idp, None, ok

    def idp_fn(ips):
        one1 = torch.ones_like(ips[:1])
        pfx = pf_fn(torch.cat([ips[2:], one1]), torch.cat([ips[:2], one1]))[0]
        return torch.stack([pfx[0], pfx[1], torch.ones_like(pfx[0])]) / pfx[2]

    lead = ip_first.shape[:-1]
    x = torch.cat([ip_first, ip_second], dim=-1).reshape(-1, 4)
    J = torch.func.vmap(torch.func.jacrev(idp_fn))(x).reshape(lead + (3, 4))
    return idp, J @ J.transpose(-1, -2), ok
