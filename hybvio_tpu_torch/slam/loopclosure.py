"""Loop-closure geometric verification (port of the reference package's
``slam/loopclosure.py``): a 3D-3D similarity RANSAC and a 2D-3D PnP RANSAC.

All hypotheses run as one batch: each draws its correspondences among the
valid ones, solves the closed-form Kabsch/Umeyama alignment (3x3 SVD) or
the 11-DOF DLT, counts inliers within the threshold, and the best model is
refit on its inliers. The draws come from the port's threefry
(``random.split`` / ``random.randint`` with a tensor bound), bit-exact with
the reference's ``jax.random``, so a seed gives the reference's samples;
the valid entries are ordered first by a stable argsort, as
``jnp.argsort`` is stable.

The singular value decompositions are a one-sided Jacobi (``_svd``, a
fixed number of sweeps) in plain tensor operations: ``torch.linalg.svd``
reads its convergence flags back to the host, which a CUDA graph cannot
hold (``slam/session.py`` captures each RANSAC). The factors agree with
LAPACK's to rounding; the results do not depend on the factors' signs.
The threshold and the random key are tensors, so that one captured graph
serves every call of a shape.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import random as jr
from ..runtime import constant, default_device, random_int_bits

_SWEEPS = {3: 6, 12: 10}  # Jacobi sweeps by column count (to rounding; the tests hold them)


@functools.lru_cache(maxsize=None)
def _rounds(n: int):
    """The column pairs (p, q) of a round-robin tournament over n columns:
    each round's pairs are disjoint, every pair meets once over the rounds."""
    cols = list(range(n)) + ([-1] if n % 2 else [])
    m, out = len(cols), []
    for _ in range(m - 1):
        pairs = sorted((min(a, b), max(a, b))
                       for a, b in zip(cols[:m // 2], reversed(cols[m // 2:])) if min(a, b) >= 0)
        out.append(tuple(zip(*pairs)))
        cols = [cols[0], cols[-1]] + cols[1:-1]
    return tuple(out)


def _svd(A):
    """Thin SVD of A (..., m, n), m >= n, by one-sided Jacobi (Hestenes):
    rotate column pairs of A until they are orthogonal, accumulating V.
    Returns (U (..., m, n), S (..., n) descending, V (..., n, n)); for
    m == n == 3 the third column of U is completed as U1 x U2 with the sign
    of A v3, so that U is orthonormal when A is rank-deficient."""
    m, n = A.shape[-2:]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape[:-2] + (n, n))
    UV = torch.cat([A, eye], dim=-2)  # U above V: each rotation turns both
    for _ in range(_SWEEPS[n]):
        for p, q in _rounds(n):
            p, q = constant(p, torch.int64, A.device), constant(q, torch.int64, A.device)
            wp, wq = UV.index_select(-1, p), UV.index_select(-1, q)
            up, uq = wp[..., :m, :], wq[..., :m, :]
            a = torch.sum(up * up, dim=-2, keepdim=True)
            b = torch.sum(uq * uq, dim=-2, keepdim=True)
            g = torch.sum(up * uq, dim=-2, keepdim=True)
            zero = g == 0
            zeta = (b - a) / (2.0 * torch.where(zero, torch.ones_like(g), g))
            t = torch.copysign(1.0 / (torch.abs(zeta) + torch.sqrt(1.0 + zeta * zeta)), zeta)
            c = torch.where(zero, torch.ones_like(t), 1.0 / torch.sqrt(1.0 + t * t))
            sn = torch.where(zero, torch.zeros_like(t), c * t)
            UV = UV.index_copy(-1, p, c * wp - sn * wq).index_copy(-1, q, sn * wp + c * wq)
    U, V = UV[..., :m, :], UV[..., m:, :]
    S = torch.linalg.norm(U, dim=-2)
    order = torch.argsort(S, dim=-1, descending=True, stable=True)
    S = S.gather(-1, order)
    U = U.gather(-1, order[..., None, :].expand(U.shape))
    V = V.gather(-1, order[..., None, :].expand(V.shape))
    U = U / torch.where(S > 0, S, torch.ones_like(S))[..., None, :]
    if U.shape[-2:] == (3, 3):
        u3 = torch.linalg.cross(U[..., 0], U[..., 1])
        flip = torch.sum(u3 * U[..., 2], dim=-1, keepdim=True) < 0
        U = torch.cat([U[..., :2], torch.where(flip, -u3, u3)[..., None]], dim=-1)
    return U, S, V


def _proper(U, Vt, dtype):
    """(D, R = U D Vt): D = diag(1, 1, sign(det(U Vt))), batched."""
    d = torch.sign(torch.linalg.det(U @ Vt))
    one = torch.ones_like(d)
    D = torch.diag_embed(torch.stack([one, one, d], dim=-1).to(dtype))
    return D, U @ D @ Vt


def _kabsch(src, dst, w, with_scale):
    """Weighted similarity dst ~ s R src + t, batched over leading dims.
    src/dst (..., M, 3), w (..., M)."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)
    mu_s = torch.sum(src * w[..., None], dim=-2) / wsum[..., None]
    mu_d = torch.sum(dst * w[..., None], dim=-2) / wsum[..., None]
    xs = src - mu_s[..., None, :]
    xd = dst - mu_d[..., None, :]
    C = (xd * w[..., None]).transpose(-1, -2) @ xs / wsum[..., None, None]
    U, S, V = _svd(C)
    D, R = _proper(U, V.transpose(-1, -2), C.dtype)
    var_s = torch.sum(w[..., None] * xs * xs, dim=(-2, -1)) / wsum
    if with_scale:
        s = (torch.sum(S * torch.diagonal(D, dim1=-2, dim2=-1), dim=-1)
             / torch.clamp(var_s, min=1e-12))
    else:
        s = torch.ones_like(var_s)
    t = mu_d - s[..., None] * torch.einsum("...ij,...j->...i", R, mu_s)
    return R, t, s


def _draw(key, n_hyp, k, valid, nv, dtype):
    """(sel (n_hyp, k) indices into the correspondences, distinct (n_hyp,)):
    each hypothesis draws k of the nv valid correspondences."""
    keys = jr.split(key, n_hyp)
    idx = jr.randint(keys, (k,), 0, nv, bits=random_int_bits(dtype))
    order = torch.argsort((~valid).to(torch.uint8), stable=True)  # valid entries first
    sel = order[idx]
    distinct = torch.sum(sel[:, :, None] == sel[:, None, :], dim=(1, 2)) == k
    return sel, distinct


def _best(scores, *models):
    """Each model of the best score (the first among equals), indexed on
    the device: a 0-d index tensor would be read back to the host."""
    best = torch.argmax(scores).reshape(1)
    return tuple(m.index_select(0, best)[0] for m in models)


def ransac_similarity(src, dst, valid, key, n_hyp: int = 100,
                      threshold: float = 0.1, with_scale: bool = False):
    """RANSAC dst ~ s R src + t over (M,3) correspondences with validity
    mask. Returns (R (3,3), t (3,), s (), inlier_mask (M,), n_inliers ())."""
    dtype = src.dtype
    nv = torch.clamp(torch.sum(valid), min=1)
    # draw 3 correspondences among the valid ones; duplicated indices make
    # the Kabsch fit underdetermined, so such hypotheses score -1
    sel, distinct = _draw(key, n_hyp, 3, valid, nv, dtype)
    Rh, th, sh = _kabsch(src[sel], dst[sel], torch.ones(sel.shape, dtype=dtype,
                                                        device=src.device), with_scale)
    pred = sh[:, None, None] * (src @ Rh.transpose(-1, -2)) + th[:, None, :]
    inl = (torch.linalg.norm(pred - dst, dim=-1) < threshold) & valid
    scores = torch.where(distinct, torch.sum(inl, dim=-1), -1)
    R, t, s = _best(scores, Rh, th, sh)

    # refit on the inliers of the best model; keep it if it lost none
    pred = s * (src @ R.T) + t
    inl = (torch.linalg.norm(pred - dst, dim=-1) < threshold) & valid
    R2, t2, s2 = _kabsch(src, dst, inl.to(dtype), with_scale)
    pred2 = s2 * (src @ R2.T) + t2
    inl2 = (torch.linalg.norm(pred2 - dst, dim=-1) < threshold) & valid
    better = torch.sum(inl2) >= torch.sum(inl)
    R = torch.where(better, R2, R)
    t = torch.where(better, t2, t)
    s = torch.where(better, s2, s)
    inl = torch.where(better, inl2, inl)
    return R, t, s, inl, torch.sum(inl)


def _dlt_pose(pts3, obs2, w):
    """Weighted DLT for M = [R|t] (world->camera, normalized pinhole),
    batched: obs2 ~ project(M [pts3, 1]). pts3 (..., M, 3), obs2 (..., M,
    2), w (..., M). Returns (R, t)."""
    dtype = pts3.dtype
    X = torch.cat([pts3, torch.ones_like(pts3[..., :1])], dim=-1)
    z = torch.zeros_like(X)
    # rows: [X 0 -x X] and [0 X -y X], weighted
    r1 = torch.cat([X, z, -obs2[..., :1] * X], dim=-1)
    r2 = torch.cat([z, X, -obs2[..., 1:2] * X], dim=-1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    V = _svd(A)[2]
    m = V[..., :, -1].reshape(V.shape[:-2] + (3, 4))
    # sign: the majority of weighted points must sit in front of the camera
    zc = torch.einsum("...mj,...j->...m", X, m[..., 2, :])
    sgn = torch.where(torch.sum(torch.sign(zc) * w, dim=-1) < 0, -1.0, 1.0).to(dtype)
    m = m * sgn[..., None, None]
    # orthonormalize the rotation block; its singular values carry the
    # projective scale of the whole solution
    U, S, Vr = _svd(m[..., :3])
    D, R = _proper(U, Vr.transpose(-1, -2), dtype)
    scale = torch.sum(S * torch.diagonal(D, dim1=-2, dim2=-1), dim=-1) / 3.0
    t = m[..., 3] / torch.clamp(scale, min=1e-12)[..., None]
    return R, t


def _pnp_errors(pts3, obs2, R, t):
    pc = pts3 @ R.transpose(-1, -2) + t[..., None, :]
    zc = pc[..., 2]
    proj = pc[..., :2] / torch.clamp(torch.abs(zc[..., None]), min=1e-9)
    err = torch.linalg.norm(proj - obs2, dim=-1)
    return torch.where(zc > 1e-6, err, torch.full_like(err, float("inf")))


def ransac_pnp(pts3, obs2, valid, key, n_hyp: int = 100, threshold: float = 0.02):
    """RANSAC perspective-n-point: world->camera pose from 3D map points and
    their 2D NORMALIZED observations (the 2D-3D loop-closure fallback).
    Each hypothesis draws 6 correspondences and solves the DLT; the best
    model is refit by a weighted DLT on its inliers. Returns (R (3,3), t
    (3,), inlier_mask (M,), n_inliers ()); ``threshold`` and ``key`` as
    ransac_similarity's."""
    dtype = pts3.dtype
    nv = torch.clamp(torch.sum(valid), min=1)
    sel, distinct = _draw(key, n_hyp, 6, valid, nv, dtype)
    Rh, th = _dlt_pose(pts3[sel], obs2[sel], torch.ones(sel.shape, dtype=dtype,
                                                        device=pts3.device))
    inl = (_pnp_errors(pts3[None], obs2[None], Rh, th) < threshold) & valid
    scores = torch.where(distinct, torch.sum(inl, dim=-1), -1)
    R, t = _best(scores, Rh, th)

    inl = (_pnp_errors(pts3, obs2, R, t) < threshold) & valid
    R2, t2 = _dlt_pose(pts3, obs2, inl.to(dtype))
    inl2 = (_pnp_errors(pts3, obs2, R2, t2) < threshold) & valid
    better = torch.sum(inl2) >= torch.sum(inl)
    R = torch.where(better, R2, R)
    t = torch.where(better, t2, t)
    inl = torch.where(better, inl2, inl)
    return R, t, inl, torch.sum(inl)


def _padded(arrays, pad: int, seed: int, threshold: float, device):
    """The (M, d) float64 arrays zero-padded to P rows (pad doubled until it
    holds M) on ``device``, the validity mask (P,), the threefry key of
    ``seed`` and the threshold as a float64 0-d tensor there."""
    M = arrays[0].shape[0]
    P = pad
    while P < M:
        P *= 2
    out = []
    for a in arrays:
        p = np.zeros((P, a.shape[1]))
        p[:M] = a
        out.append(torch.as_tensor(p).to(device))
    key = jr.prng_key(torch.as_tensor(seed).to(device))
    return (out, torch.as_tensor(np.arange(P) < M).to(device), key,
            torch.as_tensor(np.float64(threshold)).to(device))


def pnp_on_host(ransac, pts3, obs2, seed: int, n_hyp: int, threshold: float, pad: int, device):
    """``ransac`` (ransac_pnp or a captured form of it) on numpy inputs, as
    ransac_pnp_np runs it: numpy (R, t, inliers (M,), n_inliers)."""
    pts3 = np.asarray(pts3, np.float64)
    M = pts3.shape[0]
    (pp, op), vp, key, thr = _padded([pts3, np.asarray(obs2, np.float64)], pad, seed, threshold,
                                     device)
    R, t, inl, n = ransac(pp, op, vp, key, n_hyp=n_hyp, threshold=thr)
    return R.cpu().numpy(), t.cpu().numpy(), inl.cpu().numpy()[:M], int(n)


def similarity_on_host(ransac, src, dst, seed: int, n_hyp: int, threshold: float,
                       with_scale: bool, pad: int, device):
    """``ransac`` (ransac_similarity or a captured form of it) on numpy
    inputs, as ransac_similarity_np runs it: numpy (R, t, s, inliers (M,),
    n_inliers)."""
    src = np.asarray(src, np.float64)
    M = src.shape[0]
    (sp, dp), vp, key, thr = _padded([src, np.asarray(dst, np.float64)], pad, seed, threshold,
                                     device)
    R, t, s, inl, n = ransac(sp, dp, vp, key, n_hyp=n_hyp, threshold=thr, with_scale=with_scale)
    return (R.cpu().numpy(), t.cpu().numpy(), float(s), inl.cpu().numpy()[:M], int(n))


def ransac_pnp_np(pts3, obs2, seed: int = 0, n_hyp: int = 100,
                  threshold: float = 0.02, pad: int = 256, device=None):
    """Host wrapper for ransac_pnp on ``device``, the card unless given
    (float64, padded to a power-of-two multiple of ``pad`` as the reference
    pads for its jit)."""
    device = default_device() if device is None else device
    return pnp_on_host(ransac_pnp, pts3, obs2, seed, n_hyp, threshold, pad, device)


def ransac_similarity_np(src, dst, seed: int = 0, n_hyp: int = 100,
                         threshold: float = 0.1, with_scale: bool = False,
                         pad: int = 256, device=None):
    """Host wrapper for ransac_similarity on ``device``, the card unless
    given (float64, padded as ransac_pnp_np)."""
    device = default_device() if device is None else device
    return similarity_on_host(ransac_similarity, src, dst, seed, n_hyp, threshold, with_scale,
                              pad, device)
