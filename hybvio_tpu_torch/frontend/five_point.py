"""Nister/Stewenius five-point essential-matrix solver (port of the
reference's ``frontend/five_point.py``), over leading dimensions: every
step is batched linear algebra over any number of 5-point samples.

  1. nullspace of the 5x9 epipolar system (complete QR) -> E = xX + yY + zZ + W;
  2. the 10 cubic constraints expanded into their 20 monomial coefficients
     by evaluating them at fixed sample points and multiplying by the
     constant Vandermonde pseudo-inverse;
  3. one solve of the (10, 20) system -> the action matrix of x;
  4. its eigenvalues via the Faddeev-LeVerrier characteristic polynomial and
     32 Durand-Kerner iterations in complex arithmetic;
  5. each eigenvector by inverse iteration -> (x, y, z) -> up to 10 E.

Singular systems become non-finite and are replaced, as in the reference;
no step checks for errors on the host.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# monomial exponents (x, y, z): 10 cubics then the 10-dim quotient basis
_MONO3 = [(3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1),
          (1, 0, 2), (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3)]
_MONO2 = [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
          (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_MONOS = _MONO3 + _MONO2

# fixed, well-conditioned sample design for the numeric polynomial expansion
# (the reference's numpy code verbatim: the same numbers)
_NS = 32
_rng = np.random.RandomState(61)
_SAMPLES = _rng.randn(_NS, 3)
_SAMPLES /= np.linalg.norm(_SAMPLES, axis=1, keepdims=True)
_SAMPLES *= (0.6 + 0.8 * _rng.rand(_NS, 1))
_V = np.stack([
    [s[0] ** ex * s[1] ** ey * s[2] ** ez for (ex, ey, ez) in _MONOS]
    for s in _SAMPLES])  # (NS, 20)
_PINV = np.linalg.pinv(_V)  # (20, NS), constant

# indices into the quotient basis _MONO2
_IX2, _IXY, _IXZ, _IY2, _IYZ, _IZ2, _IX, _IY, _IZ, _I1 = range(10)
_N = 10  # degree of the characteristic polynomial


@functools.lru_cache(maxsize=None)
def _constants(dtype, device):
    """(samples, pinv, w0) in ``dtype`` on ``device``, copied there once (a
    copy from the host would wait for the card at every call): the sample
    design, its pseudo-inverse, and the Durand-Kerner start points
    (0.4 + 0.9j)^k worked out in complex128 and cast to the solver's
    complex type."""
    w0 = torch.tensor(0.4 + 0.9j, dtype=torch.complex128) ** torch.arange(1, _N + 1)
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    return (torch.as_tensor(_SAMPLES, dtype=dtype).to(device),
            torch.as_tensor(_PINV, dtype=dtype).to(device), w0.to(cdtype).to(device))


def _det3(E):
    """Determinants of (..., 3, 3) by cofactors (elementwise: no library
    factorization)."""
    e = lambda i, j: E[..., i, j]
    return (e(0, 0) * (e(1, 1) * e(2, 2) - e(1, 2) * e(2, 1))
            - e(0, 1) * (e(1, 0) * e(2, 2) - e(1, 2) * e(2, 0))
            + e(0, 2) * (e(1, 0) * e(2, 1) - e(1, 1) * e(2, 0)))


def _constraints(E):
    """The 10 cubic constraint values of (..., 3, 3) E: [det E;
    vec(2 E E^T E - tr(E E^T) E)] -> (..., 10)."""
    EEt = E @ E.transpose(-1, -2)
    tr = torch.diagonal(EEt, dim1=-2, dim2=-1).sum(-1)
    C = 2.0 * (EEt @ E) - tr[..., None, None] * E
    return torch.cat([_det3(E)[..., None], C.reshape(E.shape[:-2] + (9,))], dim=-1)


def _coeff_matrix(X, Y, Z, W):
    """(..., 10, 20) coefficients of the 10 constraints over _MONOS."""
    s, pinv, _ = _constants(X.dtype, X.device)
    e = lambda a: a[..., None, :, :]
    E = (s[:, 0, None, None] * e(X) + s[:, 1, None, None] * e(Y)
         + s[:, 2, None, None] * e(Z) + e(W))  # (..., NS, 3, 3)
    G = _constraints(E)  # (..., NS, 10)
    return (pinv @ G).transpose(-1, -2)


def _action_matrix(M):
    """The multiplication-by-x action matrix on the quotient basis from the
    (..., 10, 20) system; a singular system gives NaN, like the reference's
    LU solve."""
    R, info = torch.linalg.solve_ex(M[..., :10], M[..., 10:])
    R = torch.where((info != 0)[..., None, None], torch.full_like(R, float("nan")), R)
    Ax = torch.zeros(M.shape[:-2] + (10, 10), dtype=M.dtype, device=M.device)
    for col, m3row in zip((_IX2, _IXY, _IXZ, _IY2, _IYZ, _IZ2), range(6)):
        Ax[..., :, col] = -R[..., m3row, :]
    Ax[..., _IX2, _IX] = 1.0
    Ax[..., _IXY, _IY] = 1.0
    Ax[..., _IXZ, _IZ] = 1.0
    Ax[..., _IX, _I1] = 1.0
    return Ax


def _charpoly(A):
    """Coefficients c (..., 10) of det(tI - A) = t^10 + c[0] t^9 + ... + c[9]
    via Faddeev-LeVerrier."""
    eye = torch.eye(_N, dtype=A.dtype, device=A.device)
    Mk = eye.expand(A.shape)
    cs = []
    for k in range(1, _N + 1):
        AM = A @ Mk
        ck = -torch.diagonal(AM, dim1=-2, dim2=-1).sum(-1) / k
        Mk = AM + ck[..., None, None] * eye
        cs.append(ck)
    return torch.stack(cs, dim=-1)


def _roots_durand_kerner(coeffs, iters: int = 32):
    """All 10 complex roots (..., 10) of t^10 + c[0] t^9 + ... + c[9]:
    complex128 for a float64 input, complex64 otherwise."""
    cdtype = torch.complex128 if coeffs.dtype == torch.float64 else torch.complex64
    c = coeffs.to(cdtype)
    # scale the roots into ~the unit ball: t = s*u
    s = torch.clamp(torch.amax(torch.abs(c), dim=-1) ** (1.0 / _N), min=1e-6).to(cdtype)
    powers = s[..., None] ** torch.arange(1, _N + 1, dtype=coeffs.dtype, device=c.device)
    cu = c / powers
    eye = torch.eye(_N, dtype=cdtype, device=c.device)
    w = _constants(coeffs.dtype, c.device)[2].expand(c.shape).clone()
    for _ in range(iters):
        pw = torch.ones_like(w)
        for k in range(_N):
            pw = pw * w + cu[..., k:k + 1]
        diff = w[..., :, None] - w[..., None, :] + eye
        step = pw / torch.prod(diff, dim=-1)
        a = torch.abs(step)
        step = torch.where(a > 10.0, step / a * 10.0, step)
        w = w - step
    return w * s[..., None]


def five_point_essential(pts1, pts2):
    """Up to 10 essential matrices per sample of 5 normalized
    correspondences: pts1, pts2 (..., 5, 2) -> (Es (..., 10, 3, 3),
    valid (..., 10) bool)."""
    dtype, dev = pts1.dtype, pts1.device
    lead = pts1.shape[:-2]
    one = torch.ones(lead + (5, 1), dtype=dtype, device=dev)
    h1 = torch.cat([pts1, one], dim=-1)
    h2 = torch.cat([pts2, one], dim=-1)
    A = (h2[..., :, None] * h1[..., None, :]).reshape(lead + (5, 9))
    # nullspace of the 5x9 system: the last 4 columns of the complete
    # Householder QR of A^T
    Q, _ = torch.linalg.qr(A.transpose(-1, -2), mode="complete")
    X, Y, Z, W = (Q[..., :, 5 + i].reshape(lead + (3, 3)) for i in range(4))

    Ax = _action_matrix(_coeff_matrix(X, Y, Z, W))
    finite = torch.all(torch.isfinite(Ax).reshape(lead + (-1,)), dim=-1)
    eye = torch.eye(10, dtype=dtype, device=dev)
    Ax = torch.where(finite[..., None, None], Ax, eye)

    roots = _roots_durand_kerner(_charpoly(Ax))  # (..., 10) complex x-roots
    # the imaginary-part gate is loose on purpose; the on-variety residual
    # below is the real validity filter
    scale = torch.clamp(torch.amax(torch.abs(roots.real), dim=-1, keepdim=True), min=1.0)
    is_real = torch.abs(roots.imag) < 0.3 * scale
    xr = roots.real.to(dtype)

    # eigenvector of Ax^T at each real root by inverse iteration: one LU
    # factorization of (Ax^T - x I + 1e-10 I), three solves
    Bm = (Ax.transpose(-1, -2)[..., None, :, :] - xr[..., None, None] * eye) + 1e-10 * eye
    LU, piv, _ = torch.linalg.lu_factor_ex(Bm)
    v = torch.ones(lead + (10, 10, 1), dtype=dtype, device=dev)
    for _ in range(3):
        v = torch.linalg.lu_solve(LU, piv, v)
        nv = torch.linalg.norm(v, dim=-2, keepdim=True)
        v = v / torch.where(nv > 1e-300, nv, torch.ones_like(nv))
    v = v[..., 0]  # (..., 10 roots, 10)
    v = torch.where(torch.all(torch.isfinite(v), dim=-1, keepdim=True), v, torch.ones_like(v))
    v1 = v[..., _I1]
    ok_v = torch.abs(v1) > 1e-12
    denom = torch.where(ok_v, v1, torch.ones_like(v1))
    x, y, z = (v[..., i] / denom for i in (_IX, _IY, _IZ))
    e = lambda a: a[..., None, :, :]
    E = (x[..., None, None] * e(X) + y[..., None, None] * e(Y)
         + z[..., None, None] * e(Z) + e(W))
    n = torch.linalg.norm(E.reshape(E.shape[:-2] + (9,)), dim=-1)
    E = E / torch.where(n > 1e-12, n, torch.ones_like(n))[..., None, None]
    # on-variety check: near-real complex roots can pass the imaginary-part
    # gate yet give an E off the essential variety
    cres = torch.linalg.norm(_constraints(E), dim=-1)
    tol = 1e-3 if dtype == torch.float32 else 1e-6
    valid = ok_v & (n > 1e-12) & (cres < tol) & is_real & finite[..., None]
    return E, valid
