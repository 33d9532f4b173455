"""Square-root covariance primitives (port of the reference's
``ekf/sqrt.py``), batch-first over lanes.

The filter carries W with P = W W^T (``odometry.useSquareRootEkf``): P is
positive semidefinite by construction and W spans only the square root of
P's dynamic range, which keeps a float32 filter healthy where the dense
downdate drifts indefinite. Every operation is one QR of a small array:

  predict   W' = qr_factor([F W | G sqrt(Q)])
  update    pre-array M = [[sqrt(R)  H W]   LQ-factored  N = [[S_half    0  ]
                           [   0      W ]]                    [  B     W_new]]
            S_half S_half^T = S = H P H^T + R,  W_new W_new^T = P - P H^T S^-1 H P,
            m += B (S_half^-1 (y - H m))

The factor's column signs are free (only W W^T is defined). No function
here reads a value back to the host: the innovation's Cholesky is
``cholesky_ex``, a matrix that is not positive definite gives a chi^2
that is not finite, and a singular triangular factor a non-finite update
that the callers drop.
"""
from __future__ import annotations

import torch


def qr_factor(A):
    """Lower-triangular W (..., d, d) with W W^T = A A^T, for A (..., d, k)
    with k >= d: the LQ factor, as the transposed R of A^T's QR."""
    return torch.linalg.qr(A.transpose(-1, -2), mode="r")[1].transpose(-1, -2)


def sr_update(m, W, v, H, r_sqrt):
    """One square-root KF update of every lane.

    ``m`` (B, d); ``W`` (B, d, d), any factor; ``v`` (B, n) the residual
    y - H m (masked rows 0); ``H`` (n, d) or (B, n, d) (masked rows zero);
    ``r_sqrt`` the measurement noise standard deviation of each row: a
    float, a 0-d tensor or a tensor broadcastable to (B, n), > 0.
    Returns (m_new, W_new, S_half), S_half (B, n, n) the lower-triangular
    factor of the innovation covariance."""
    B, d = m.shape
    n = v.shape[-1]
    HW = torch.matmul(H, W).expand(B, n, d)
    rs = torch.ones_like(v) * r_sqrt
    top = torch.cat([torch.diag_embed(rs), HW], dim=2)
    bottom = torch.cat([torch.zeros((B, d, n), dtype=W.dtype, device=W.device), W], dim=2)
    N = qr_factor(torch.cat([top, bottom], dim=1))
    S_half, Bm, W_new = N[:, :n, :n], N[:, n:, :n], N[:, n:, n:]
    z = torch.linalg.solve_triangular(S_half, v[..., None], upper=False)
    return m + (Bm @ z)[..., 0], W_new, S_half


def sr_add_diag_noise(W, qdiag):
    """The factor of W W^T + diag(qdiag) (qdiag (d,) or (B, d), >= 0), by
    one QR of [W | diag(sqrt(qdiag))]."""
    cols = torch.diag_embed(torch.sqrt(torch.clamp(qdiag, min=0.0)).to(W.dtype))
    return qr_factor(torch.cat([W, cols.expand(W.shape)], dim=-1))


def sr_innovation_chi2(W, H, v, r_var):
    """chi^2 = v^T (H P H^T + r_var I)^-1 v from the factor, over the
    leading dims of ``H`` (..., n, d) and ``v`` (..., n), as
    ``update.innovation_chi2``."""
    from .update import innovation_chi2

    HW = torch.matmul(H, W)
    return innovation_chi2(torch.matmul(HW, HW.transpose(-1, -2)), v, r_var)


def cov_block(W, rows: slice):
    """The dense covariance block P[rows, rows] (B, k, k) from the factor."""
    Wr = W[:, rows, :]
    return torch.matmul(Wr, Wr.transpose(-1, -2))


def cov_diag(W):
    """diag(P) (B, d) from the factor."""
    return torch.sum(W * W, dim=-1)


def cov_full(W):
    return torch.matmul(W, W.transpose(-1, -2))
