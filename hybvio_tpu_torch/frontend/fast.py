"""FAST-9/16 corner response (port of the reference's ``frontend/fast.py``
``_ring_taps`` and ``fast_score``), used by the SLAM module's multi-scale
keypoint detector (``slam/keypoints.py``).

A pixel is a corner if 9 contiguous pixels of the 16-pixel Bresenham circle
are all brighter than centre + t or all darker than centre - t; its score
is the max over such arcs of the arc's min |p_i - centre|. The 16 taps are
16 rolls of the image (``torch.roll`` wraps at the border as ``jnp.roll``
does; the 3-px border is zeroed). The tracker's FAST detector option
(``tracker.featureDetector``) is not ported: ``frontend/tracker.py`` raises.
"""
from __future__ import annotations

import numpy as np
import torch

# Bresenham circle of radius 3, clockwise from 12 o'clock (dy, dx)
_CIRCLE = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], dtype=np.int32)


def _ring_taps(img: torch.Tensor) -> torch.Tensor:
    """(16, H, W): circle neighbour intensities via rolls (edges wrap;
    callers mask a 3-px border)."""
    return torch.stack([torch.roll(img, (-int(dy), -int(dx)), dims=(0, 1))
                        for dy, dx in _CIRCLE], dim=0)


def fast_score(img: torch.Tensor, threshold: float, arc: int = 9) -> torch.Tensor:
    """FAST-N/16 corner response. img (H, W) float in [0, 1]; threshold in
    the same units. Returns (H, W) scores, 0 where not a corner; 3-px border
    zeroed."""
    H, W = img.shape
    d = _ring_taps(img) - img[None]
    mag = torch.abs(d)
    zero = torch.zeros((), dtype=img.dtype, device=img.device)

    def arc_response(mask):
        # max over the 16 cyclic windows of `arc` ring positions that are all
        # on, of the window's min |d|
        best = torch.zeros_like(img)
        for s in range(16):
            idx = [(s + k) % 16 for k in range(arc)]
            all_on = mask[idx[0]]
            mmin = mag[idx[0]]
            for j in idx[1:]:
                all_on = all_on & mask[j]
                mmin = torch.minimum(mmin, mag[j])
            best = torch.maximum(best, torch.where(all_on, mmin, zero))
        return best

    score = torch.maximum(arc_response(d > threshold), arc_response(d < -threshold))
    border = torch.zeros((H, W), dtype=torch.bool, device=img.device)
    border[3:H - 3, 3:W - 3] = True
    return torch.where(border, score, zero)
