"""The plain reference that ``check.py`` judges the timed path's outputs
against. It imports nothing of the port and takes nothing the port made:
it works from the world (``world.py``) and the frames the benchmark made.

* Poses: the world's ground-truth positions, and the umeyama alignment of
  a lane's estimated trajectory onto them (a frozen copy of the port's
  ``eval/ate.py``).
* Pyramid: the tracker's image pyramid and Scharr gradients of a frame in
  float64 (a 5-tap [1 4 6 4 1] / 16 blur with replicated edges, then every
  second pixel; the Scharr [-1 0 1] x [3 10 3] / 32 pair).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


# -- poses ----------------------------------------------------------------
def umeyama(x: np.ndarray, y: np.ndarray):
    """(R, t) of the least-squares rigid motion x -> y; x, y (N, 3)."""
    mx, my = x.mean(axis=0), y.mean(axis=0)
    C = (y - my).T @ (x - mx) / x.shape[0]
    U, _, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    return R, my - R @ mx


def aligned_errors(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(N,) distance of each aligned estimated position from the truth;
    inf everywhere if any estimate is not finite."""
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    if not np.isfinite(est).all():
        return np.full(len(est), np.inf)
    R, t = umeyama(est, gt)
    return np.linalg.norm(est @ R.T + t - gt, axis=1)


# -- pyramid --------------------------------------------------------------
_BLUR = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], dtype=torch.float64) / 16.0
_DIFF = torch.tensor([-1.0, 0.0, 1.0], dtype=torch.float64)
_SMOOTH = torch.tensor([3.0, 10.0, 3.0], dtype=torch.float64) / 32.0


def _separable(img: torch.Tensor, kx: torch.Tensor, ky: torch.Tensor) -> torch.Tensor:
    """(B, H, W) float64 convolved with kx along rows and ky along
    columns, edges replicated."""
    x = img[:, None]
    rx, ry = len(kx) // 2, len(ky) // 2
    x = F.pad(x, (rx, rx, ry, ry), mode="replicate")
    x = F.conv2d(x, kx.to(x.device).reshape(1, 1, 1, -1))
    x = F.conv2d(x, ky.to(x.device).reshape(1, 1, -1, 1))
    return x[:, 0]


def pyramid(image_u8: torch.Tensor, levels: int) -> tuple:
    """(levels 0..levels, their (Ix, Iy)) of (B, H, W) 8-bit frames, in
    float64 on their device; level 0 is the frame over 255."""
    lv = [image_u8.to(torch.float64) / 255.0]
    for _ in range(levels):
        lv.append(_separable(lv[-1], _BLUR, _BLUR)[:, ::2, ::2])
    grads = [(_separable(x, _DIFF, _SMOOTH), _separable(x, _SMOOTH, _DIFF)) for x in lv]
    return lv, grads
