"""Trajectory evaluation: the umeyama-aligned ATE RMSE and the relative
pose error (the reference's ``eval/ate.py``)."""
from __future__ import annotations

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform aligning x -> y; x, y: (N,3).
    Returns (R, t, s) with y ~ s R x + t (s = 1 without ``with_scale``)."""
    mx = x.mean(axis=0)
    my = y.mean(axis=0)
    xc = x - mx
    C = (y - my).T @ xc / x.shape[0]
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = np.trace(np.diag(D) @ S) / ((xc**2).sum() / x.shape[0]) if with_scale else 1.0
    return R, my - s * R @ mx, s


def ate_rmse(estimated: np.ndarray, ground_truth: np.ndarray, align: bool = True,
             with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE, after umeyama alignment unless
    ``align`` is False (with a scale too where ``with_scale``)."""
    est = np.asarray(estimated, dtype=np.float64)
    gt = np.asarray(ground_truth, dtype=np.float64)
    if est.shape != gt.shape:
        raise ValueError(f"estimated {est.shape} and ground truth {gt.shape} differ in shape")
    if align:
        R, t, s = umeyama_alignment(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    e = est - gt
    return float(np.sqrt((e * e).sum(axis=1).mean()))


def rpe_rmse(estimated: np.ndarray, ground_truth: np.ndarray, delta: int = 1) -> float:
    """Relative pose (translation) error RMSE over position deltas."""
    est = np.asarray(estimated, dtype=np.float64)
    gt = np.asarray(ground_truth, dtype=np.float64)
    e = (est[delta:] - est[:-delta]) - (gt[delta:] - gt[:-delta])
    return float(np.sqrt((e * e).sum(axis=1).mean()))
