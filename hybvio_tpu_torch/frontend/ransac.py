"""RANSAC outlier rejection (port of the reference's ``frontend/ransac.py``:
``ransac2``, ``ransac5``, ``hybrid_ransac``, ``ransac3``, the gravity-aligned
``stereo_upright_2p`` and the Horn/QCP rotation solve), batch-first.

Every lane draws its hypotheses from its own threefry key, so the hypotheses
are the reference's, and all of them are solved and scored at once.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import random as jr
from ..geometry.cameras import pixel_to_ray, ray_to_pixel
from ..geometry.quaternion import quat_to_rmat
from ..runtime import constant
from .five_point import five_point_essential

ROT_RANSAC_MAX_ITERS = 100


def rotation_from_cross_cov(S, n_newton_iters: int = 20):
    """Rotation maximizing tr(R S) for cross-covariances S (..., 3, 3):
    Horn's quaternion method with the QCP eigensolve (Newton on the quartic
    characteristic polynomial from ||N||_F, then a column of the
    Cayley-Hamilton adjugate, with the multiplicity-2 fallback)."""
    dtype, dev = S.dtype, S.device
    s = lambda i, j: S[..., i, j]
    tr = s(0, 0) + s(1, 1) + s(2, 2)
    N = torch.stack([
        tr, s(1, 2) - s(2, 1), s(2, 0) - s(0, 2), s(0, 1) - s(1, 0),
        s(1, 2) - s(2, 1), 2 * s(0, 0) - tr, s(0, 1) + s(1, 0), s(2, 0) + s(0, 2),
        s(2, 0) - s(0, 2), s(0, 1) + s(1, 0), 2 * s(1, 1) - tr, s(1, 2) + s(2, 1),
        s(0, 1) - s(1, 0), s(2, 0) + s(0, 2), s(1, 2) + s(2, 1), 2 * s(2, 2) - tr,
    ], dim=-1).reshape(S.shape[:-2] + (4, 4))
    fnorm = torch.sqrt(torch.sum(N * N, dim=(-2, -1)))
    scale = torch.clamp(fnorm, min=1e-30)
    N = N / scale[..., None, None]

    N2 = N @ N
    p2 = torch.diagonal(N2, dim1=-2, dim2=-1).sum(-1)
    p3 = torch.sum(N2 * N, dim=(-2, -1))
    p4 = torch.sum(N2 * N2, dim=(-2, -1))
    e2 = -p2 / 2
    e3 = p3 / 3
    e4 = (p2 * p2 / 2 - p4) / 4
    x = torch.ones_like(p2)
    for _ in range(n_newton_iters):
        px = ((x * x + e2) * x - e3) * x + e4
        dpx = (4 * x * x + 2 * e2) * x - e3
        x = x - px / torch.where(torch.abs(dpx) < 1e-30, torch.full_like(dpx, 1e-30), dpx)
    eye = torch.eye(4, dtype=dtype, device=dev)
    A = N - x[..., None, None] * eye
    A2 = A @ A
    A3 = A2 @ A
    s1 = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
    s2 = torch.diagonal(A2, dim1=-2, dim2=-1).sum(-1)
    s3 = torch.sum(A2 * A, dim=(-2, -1))
    a3 = -s1
    a2 = (s1 * s1 - s2) / 2
    a1 = -(s1 * s1 * s1 - 3 * s1 * s2 + 2 * s3) / 6
    e = lambda v: v[..., None, None]
    B = A3 + e(a3) * A2 + e(a2) * A + e(a1) * eye
    C = A2 - e(s1) * A + e(a2) * eye

    def best_column(M):
        norms2 = torch.sum(M * M, dim=-2)
        j = torch.argmax(norms2, dim=-1, keepdim=True)
        col = torch.gather(M, -1, j[..., None, :].expand(M.shape[:-1] + (1,)))[..., 0]
        return col, torch.sqrt(torch.gather(norms2, -1, j))

    qB, nB = best_column(B)
    qC, nC = best_column(C)
    unit = constant((1.0, 0.0, 0.0, 0.0), dtype, dev)
    q = torch.where(nB > 1e-6, qB / torch.clamp(nB, min=1e-30),
                    torch.where(nC > 1e-6, qC / torch.clamp(nC, min=1e-30), unit))
    return quat_to_rmat(q)


def _cross_cov(w, a, b):
    """sum_n w_n a_n b_n^T over dim -2: (..., N), (..., N, 3) -> (..., 3, 3)."""
    return torch.einsum("...n,...ni,...nj->...ij", w, a, b)


def _valid_first(valid):
    """Slot order with valid slots first (stable)."""
    return torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)


def _lane_take(a, idx):
    """a[b, idx[b, ...]] for a (B, T, ...) and idx (B, ...)."""
    B = a.shape[0]
    flat = idx.reshape(B, -1)
    g = torch.gather(a, 1, flat.reshape(flat.shape + (1,) * (a.dim() - 2)).expand(
        flat.shape + a.shape[2:]))
    return g.reshape(idx.shape + a.shape[2:])


class Ransac2Result(NamedTuple):
    R: torch.Tensor  # (B, 3, 3)
    inliers: torch.Tensor  # (B, T)
    inlier_count: torch.Tensor  # (B,)
    score: torch.Tensor  # (B,)


def ransac2(cam1, cam2, pts1, pts2, valid, rng_key, threshold_px,
            max_iters: int = ROT_RANSAC_MAX_ITERS, int_bits: int = 32) -> Ransac2Result:
    """Rotation-only RANSAC over tracked pixel pairs (B, T, 2)."""
    dtype = pts1.dtype
    p1, _ = pixel_to_ray(cam1, pts1)
    p2, _ = pixel_to_ray(cam2, pts2)
    n_tracked = torch.sum(valid, dim=1)
    k1 = jr.split(rng_key)[:, 0]
    idx = jr.randint(k1, (max_iters, 2), 0, torch.clamp(n_tracked, min=1), int_bits)
    slots = _lane_take(_valid_first(valid), idx)  # (B, K, 2)
    distinct = slots[..., 0] != slots[..., 1]
    thr2 = threshold_px * threshold_px

    def count_inliers(R):  # R (B, ..., 3, 3) -> (B, ..., T)
        lead = R.shape[1:-2]
        pp = p1.reshape((p1.shape[0],) + (1,) * len(lead) + p1.shape[1:])
        proj, ok = ray_to_pixel(cam2, pp @ R.transpose(-1, -2))
        pts = pts2.reshape(pp.shape[:-1] + (2,))
        d2 = torch.sum((proj - pts) ** 2, dim=-1)
        vv = valid.reshape(pp.shape[:-1])
        return vv & ok & (d2 <= thr2)

    a = _lane_take(p1, slots)  # (B, K, 2, 3)
    b = _lane_take(p2, slots)
    Hm = a[..., 0, :, None] * b[..., 0, None, :] + a[..., 1, :, None] * b[..., 1, None, :]
    Rs = rotation_from_cross_cov(Hm)
    ok_pair = distinct & (n_tracked >= 2)[:, None]
    counts = torch.where(ok_pair, torch.sum(count_inliers(Rs), dim=-1), -1)
    best = torch.argmax(counts, dim=1)
    R_best = Rs[torch.arange(Rs.shape[0], device=Rs.device), best]

    inl0 = count_inliers(R_best)
    enough = torch.sum(inl0, dim=1) >= 2
    R_refit = rotation_from_cross_cov(_cross_cov(inl0.to(dtype), p1, p2))
    R_final = torch.where(enough[:, None, None], R_refit, R_best)
    inl = count_inliers(R_final)
    cnt = torch.sum(inl, dim=1)
    score = cnt / torch.clamp(n_tracked, min=1).to(dtype)
    return Ransac2Result(R=R_final, inliers=inl, inlier_count=cnt.to(torch.int32), score=score)


JACOBI_SWEEPS = 5  # one-sided Jacobi sweeps of a 3x3: float64 converges in 4


def essential_projection(E, sweeps: int = JACOBI_SWEEPS):
    """U diag(1, 1, 0) V^T of the SVD E = U diag(s) V^T, for (..., 3, 3):
    the nearest essential matrix. A fixed number of one-sided (Hestenes)
    Jacobi sweeps over the column pairs of A = E V makes them orthogonal
    (then a_i = s_i u_i); the projection is the sum of a_i v_i^T / s_i over
    the two largest s_i. Plain tensor ops with no checked factorization,
    so no host sync; the result does not depend on the signs of the paired
    singular vectors."""
    A = E
    V = torch.eye(3, dtype=E.dtype, device=E.device).expand(E.shape).clone()
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            ap, aq = A[..., :, p], A[..., :, q]
            alpha = torch.sum(ap * ap, dim=-1)
            beta = torch.sum(aq * aq, dim=-1)
            gamma = torch.sum(ap * aq, dim=-1)
            rotate = gamma != 0.0
            zeta = (beta - alpha) / (2.0 * torch.where(rotate, gamma, torch.ones_like(gamma)))
            t = torch.where(zeta >= 0.0, 1.0, -1.0) / (torch.abs(zeta) + torch.sqrt(1.0 + zeta * zeta))
            t = torch.where(rotate, t, torch.zeros_like(t))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            sn = c * t

            def turn(M):
                mp, mq = M[..., :, p], M[..., :, q]
                cols = [M[..., :, k] for k in range(3)]
                cols[p] = c[..., None] * mp - sn[..., None] * mq
                cols[q] = sn[..., None] * mp + c[..., None] * mq
                return torch.stack(cols, dim=-1)

            A, V = turn(A), turn(V)
    s = torch.linalg.norm(A, dim=-2)  # (..., 3)
    keep = torch.arange(3, device=E.device) != torch.argmin(s, dim=-1, keepdim=True)
    inv = torch.where(keep & (s > 0.0), 1.0 / torch.where(s > 0.0, s, torch.ones_like(s)),
                      torch.zeros_like(s))
    return (A * inv[..., None, :]) @ V.transpose(-1, -2)


class Ransac5Result(NamedTuple):
    E: torch.Tensor  # (B, 3, 3)
    inliers: torch.Tensor  # (B, T)
    inlier_count: torch.Tensor  # (B,)
    ok: torch.Tensor  # (B,)


def ransac5(norm1, norm2, valid, rng_key, threshold, max_iters: int = 256,
            int_bits: int = 32) -> Ransac5Result:
    """Essential-matrix RANSAC over normalized coordinates (B, T, 2): every
    hypothesis's up to 10 five-point solutions are Sampson-scored at once;
    the winner is projected onto the essential manifold and re-scored.
    ``threshold`` is in normalized units."""
    dtype, dev = norm1.dtype, norm1.device
    Bn, T = valid.shape
    n_tracked = torch.sum(valid, dim=1)
    one = torch.ones((Bn, T, 1), dtype=dtype, device=dev)
    h1 = torch.cat([norm1, one], dim=-1)
    h2 = torch.cat([norm2, one], dim=-1)
    key1 = jr.split(rng_key)[:, 0]
    idx = jr.randint(key1, (max_iters, 5), 0, torch.clamp(n_tracked, min=1), int_bits)
    slots = _lane_take(_valid_first(valid), idx)  # (B, K, 5)
    Es, val = five_point_essential(_lane_take(norm1, slots), _lane_take(norm2, slots))
    distinct = torch.sum(slots[..., :, None] == slots[..., None, :], dim=(-2, -1)) == 5
    Es = Es.reshape(Bn, -1, 3, 3)  # (B, K*10, 3, 3)
    val = (val & distinct[..., None]).reshape(Bn, -1)
    thr2 = threshold * threshold

    def sampson_inliers(E):  # (B, ..., 3, 3) -> (B, ..., T)
        lead = E.shape[1:-2]
        a = h1.reshape((Bn,) + (1,) * len(lead) + (T, 3))
        b = h2.reshape(a.shape)
        Ex1 = a @ E.transpose(-1, -2)  # rows: E x1
        Etx2 = b @ E  # rows: E^T x2
        num = torch.sum(b * Ex1, dim=-1)
        den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
        d2 = num * num / torch.clamp(den, min=1e-18)
        return valid.reshape(a.shape[:-1]) & (d2 < thr2)

    counts = torch.where(val, torch.sum(sampson_inliers(Es), dim=-1), -1)
    best = torch.argmax(counts, dim=1)
    # project the winner onto the essential manifold and re-score
    E_best = essential_projection(Es[torch.arange(Bn, device=dev), best])
    ok = n_tracked >= 5
    inl = sampson_inliers(E_best) & ok[:, None]
    return Ransac5Result(E=E_best, inliers=inl,
                         inlier_count=torch.sum(inl, dim=1).to(torch.int32), ok=ok)


class HybridRansacResult(NamedTuple):
    inliers: torch.Tensor  # (B, T), False everywhere if skipped
    score: torch.Tensor  # (B,) R2 inlier fraction (stationarity score)
    used_r5: torch.Tensor  # (B,)
    skipped: torch.Tensor  # (B,)


def hybrid_ransac(cam1, cam2, pts1, pts2, norm1, norm2, valid, rng_key, pt,
                  r2_threshold_px, r5_threshold, int_bits: int = 32) -> HybridRansacResult:
    """The reference's RANSAC2-vs-RANSAC5 selection: R2 always runs (its
    score is the stationarity score) and R5 always runs; R5 is not used when
    R2's inliers exceed ransac2InliersToSkipRansac5 of the tracks; either
    is invalid below ransacMinInlierFraction; with both valid, R2 wins when
    its count exceeds ransac2InliersOverRansac5Needed times R5's."""
    keys = jr.split(rng_key)
    r2 = ransac2(cam1, cam2, pts1, pts2, valid, keys[:, 0], r2_threshold_px,
                 max_iters=ROT_RANSAC_MAX_ITERS, int_bits=int_bits)
    n_valid = torch.sum(valid, dim=1)
    n = torch.clamp(n_valid, min=1)
    r2_done = n_valid >= 2
    use_r2_inliers = r2.inlier_count > pt.ransac2InliersToSkipRansac5 * n
    r5 = ransac5(norm1, norm2, valid, keys[:, 1], r5_threshold,
                 max_iters=max(int(pt.ransacMaxIters), 8), int_bits=int_bits)
    r5_done = r5.ok & ~use_r2_inliers
    dtype = pts1.dtype
    r5_frac = r5.inlier_count / n.to(dtype)
    r2_frac = r2.inlier_count / n.to(dtype)
    r5_done = r5_done & (r5_frac >= pt.ransacMinInlierFraction)
    r2_done = r2_done & (r2_frac >= pt.ransacMinInlierFraction)
    pick_r2 = r2_done & (~r5_done | use_r2_inliers
                         | (r2.inlier_count > pt.ransac2InliersOverRansac5Needed * r5.inlier_count))
    pick_r5 = r5_done & ~pick_r2
    inliers = torch.where(pick_r2[:, None], r2.inliers, r5.inliers & pick_r5[:, None])
    return HybridRansacResult(inliers=inliers, score=r2.score, used_r5=pick_r5,
                              skipped=~pick_r2 & ~pick_r5)


class Ransac3Result(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    inlier_count: torch.Tensor
    ok: torch.Tensor


def ransac3(prev_pts3d, cur_pts3d, cur_norm, valid, rng_key, error_thresh: float = 1e-4,
            max_iters: int = 128, int_bits: int = 32) -> Ransac3Result:
    """Stereo 3-point rigid-alignment RANSAC: previous and current
    stereo-triangulated points (B, T, 3), inliers by squared normalized
    reprojection error of the moved previous point against ``cur_norm``."""
    dtype = prev_pts3d.dtype
    Bn = prev_pts3d.shape[0]
    n = torch.sum(valid, dim=1)
    k1 = jr.split(rng_key)[:, 0]
    idx = jr.randint(k1, (max_iters, 3), 0, torch.clamp(n, min=1), int_bits)
    slots = _lane_take(_valid_first(valid), idx)  # (B, K, 3)

    a = _lane_take(prev_pts3d, slots)  # (B, K, 3, 3)
    b = _lane_take(cur_pts3d, slots)
    ca = torch.mean(a, dim=-2)
    cb = torch.mean(b, dim=-2)
    ones = torch.ones(a.shape[:-1], dtype=dtype, device=a.device)
    Rs = rotation_from_cross_cov(_cross_cov(ones, a - ca[..., None, :], b - cb[..., None, :]))
    ts = cb - (Rs @ ca[..., None])[..., 0]

    def count(R, t):  # (B, ..., 3, 3), (B, ..., 3) -> (B, ..., T)
        lead = R.shape[1:-2]
        pp = prev_pts3d.reshape((Bn,) + (1,) * len(lead) + prev_pts3d.shape[1:])
        p = pp @ R.transpose(-1, -2) + t[..., None, :]
        z = p[..., 2]
        okz = z > 1e-6
        proj = p[..., :2] / torch.where(okz, z, torch.ones_like(z))[..., None]
        cn = cur_norm.reshape(pp.shape[:-1] + (2,))
        e2 = torch.sum((proj - cn) ** 2, dim=-1)
        return valid.reshape(pp.shape[:-1]) & okz & (e2 < error_thresh)

    inl_all = count(Rs, ts)
    counts = torch.sum(inl_all, dim=-1)
    distinct = ((slots[..., 0] != slots[..., 1]) & (slots[..., 1] != slots[..., 2])
                & (slots[..., 0] != slots[..., 2]))
    counts = torch.where(distinct, counts, -1)
    best = torch.argmax(counts, dim=1)
    lanes = torch.arange(Bn, device=prev_pts3d.device)
    R_best, t_best = Rs[lanes, best], ts[lanes, best]

    inl0 = inl_all[lanes, best]
    w = inl0.to(dtype)
    sw = torch.clamp(torch.sum(w, dim=1), min=1.0)
    ca = torch.sum(prev_pts3d * w[..., None], dim=1) / sw[:, None]
    cb = torch.sum(cur_pts3d * w[..., None], dim=1) / sw[:, None]
    R_fit = rotation_from_cross_cov(_cross_cov(w, prev_pts3d - ca[:, None], cur_pts3d - cb[:, None]))
    t_fit = cb - (R_fit @ ca[..., None])[..., 0]
    enough = torch.sum(inl0, dim=1) >= 3
    R_f = torch.where(enough[:, None, None], R_fit, R_best)
    t_f = torch.where(enough[:, None], t_fit, t_best)
    ok = n >= 3
    inl = count(R_f, t_f) & ok[:, None]
    return Ransac3Result(R=R_f, t=t_f, inliers=inl,
                         inlier_count=torch.sum(inl, dim=1).to(torch.int32), ok=ok)


class UprightRansacResult(NamedTuple):
    yaw: torch.Tensor  # (B,)
    t: torch.Tensor  # (B, 3)
    inliers: torch.Tensor  # (B, T)
    inlier_count: torch.Tensor  # (B,) int32
    ok: torch.Tensor  # (B,)


def _rz_apply(cy, sy, p):
    """Rz(yaw) p about +z, with cos / sin (...,) and points (..., 3)."""
    x = cy * p[..., 0] - sy * p[..., 1]
    return torch.stack([x, sy * p[..., 0] + cy * p[..., 1], p[..., 2].expand_as(x)], dim=-1)


def _solve_upright_2p(p1, p2, d1, d2):
    """Closed-form gravity-aligned 2-point pose over leading dims: yaw about
    +z and t with Rz(yaw) p_i + t = s_i d_i. Eliminating t, the z row is
    linear in (s1, s2) and the xy norm a quadratic in s1. Returns
    (yaw (..., 2), t (..., 2, 3), valid (..., 2)) for the two roots."""
    v = p2 - p1
    vxy2 = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
    d2z = torch.where(torch.abs(d2[..., 2]) > 1e-9, d2[..., 2], torch.full_like(d2[..., 2], 1e-9))
    alpha = v[..., 2] / d2z
    beta = d1[..., 2] / d2z
    u = alpha[..., None] * d2[..., :2]  # constant part of (s2 d2 - s1 d1)_xy
    w = beta[..., None] * d2[..., :2] - d1[..., :2]  # its s1 coefficient
    a = torch.sum(w * w, dim=-1)
    b = 2 * torch.sum(u * w, dim=-1)
    c = torch.sum(u * u, dim=-1) - vxy2
    disc = b * b - 4 * a * c
    a_ok = torch.abs(a) > 1e-12
    valid = (disc >= 0) & a_ok
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    s1s = torch.stack([-b + sq, -b - sq], dim=-1) / (
        2 * torch.where(a_ok, a, torch.ones_like(a)))[..., None]
    s2s = alpha[..., None] + beta[..., None] * s1s
    rhs = s2s[..., None] * d2[..., None, :] - s1s[..., None] * d1[..., None, :]  # = Rz v
    yaw = (torch.atan2(rhs[..., 1], rhs[..., 0])
           - torch.atan2(v[..., 1], v[..., 0])[..., None])
    t = s1s[..., None] * d1[..., None, :] - _rz_apply(torch.cos(yaw), torch.sin(yaw),
                                                       p1[..., None, :])
    return yaw, t, valid[..., None] & (s1s > 0) & (s2s > 0)


def stereo_upright_2p(prev_pts3d, cur_rays, valid, rng_key, error_thresh: float = 1e-4,
                      max_iters: int = 128, world_to_cam=None, cur_norm=None,
                      int_bits: int = 32) -> UprightRansacResult:
    """Gravity-aligned 2-point pose RANSAC: previous-frame stereo points
    (B, T, 3) and current bearing rays (B, T, 3), both in gravity-aligned
    world axes; solves yaw and translation. Inliers by the squared
    normalized reprojection error of Rz p + t against ``cur_norm`` (B, T, 2),
    in the current camera frame when ``world_to_cam`` (B, 3, 3) is given
    (else the world frame doubles as the camera frame, and the rays'
    normalized points stand in). Every lane draws its hypotheses from its
    own key; the draw's bound is the lane's valid count, a tensor."""
    B = prev_pts3d.shape[0]
    n = torch.sum(valid, dim=1)
    k1 = jr.split(rng_key)[:, 0]
    idx = jr.randint(k1, (max_iters, 2), 0, torch.clamp(n, min=1), int_bits)
    slots = _lane_take(_valid_first(valid), idx)  # (B, K, 2)
    if cur_norm is None:
        z = cur_rays[..., 2:3]
        cur_norm = cur_rays[..., :2] / torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))

    P = _lane_take(prev_pts3d, slots)  # (B, K, 2, 3)
    Dr = _lane_take(cur_rays, slots)
    yaws, ts, ok = _solve_upright_2p(P[..., 0, :], P[..., 1, :], Dr[..., 0, :], Dr[..., 1, :])
    # every root of every hypothesis scored at once: (B, K, 2, T)
    p = _rz_apply(torch.cos(yaws)[..., None], torch.sin(yaws)[..., None],
                  prev_pts3d[:, None, None]) + ts[..., None, :]
    if world_to_cam is not None:
        p = p @ world_to_cam[:, None, None].transpose(-1, -2)
    zc = p[..., 2]
    okz = zc > 1e-6
    proj = p[..., :2] / torch.where(okz, zc, torch.ones_like(zc))[..., None]
    e2 = torch.sum((proj - cur_norm[:, None, None]) ** 2, dim=-1)
    inls = valid[:, None, None] & okz & (e2 < error_thresh)
    counts = torch.where(ok, torch.sum(inls, dim=-1), -1)  # (B, K, 2)
    root = torch.argmax(counts, dim=-1, keepdim=True)
    counts = torch.gather(counts, 2, root)[..., 0]
    distinct = slots[..., 0] != slots[..., 1]
    counts = torch.where(distinct, counts, -1)
    best = torch.argmax(counts, dim=1)
    lanes = torch.arange(B, device=prev_pts3d.device)
    r = root[lanes, best, 0]
    ok_n = n >= 2
    inl = inls[lanes, best, r] & ok_n[:, None]
    return UprightRansacResult(yaw=yaws[lanes, best, r], t=ts[lanes, best, r], inliers=inl,
                               inlier_count=torch.sum(inl, dim=1).to(torch.int32), ok=ok_n)
