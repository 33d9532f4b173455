"""Trajectory evaluation: the umeyama-aligned ATE RMSE (the reference's
``eval/ate.py``)."""
from __future__ import annotations

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray):
    """Least-squares rigid transform aligning x -> y; x, y: (N,3).
    Returns (R, t) with y ~ R x + t."""
    mx = x.mean(axis=0)
    my = y.mean(axis=0)
    C = (y - my).T @ (x - mx) / x.shape[0]
    U, _, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    return R, my - R @ mx


def ate_rmse(estimated: np.ndarray, ground_truth: np.ndarray) -> float:
    """Absolute trajectory error RMSE after umeyama alignment."""
    est = np.asarray(estimated, dtype=np.float64)
    gt = np.asarray(ground_truth, dtype=np.float64)
    assert est.shape == gt.shape
    R, t = umeyama_alignment(est, gt)
    e = (R @ est.T).T + t - gt
    return float(np.sqrt((e * e).sum(axis=1).mean()))
