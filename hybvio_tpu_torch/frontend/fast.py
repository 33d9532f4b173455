"""FAST-9/16 corners (port of the reference's ``frontend/fast.py``): the
response ``fast_score``, used by the SLAM module's multi-scale keypoint
detector (``slam/keypoints.py``), and the tracker's FAST detector option
``detect_fast`` (``tracker.featureDetector = FAST``).

A pixel is a corner if 9 contiguous pixels of the 16-pixel Bresenham circle
are all brighter than centre + t or all darker than centre - t; its score
is the max over such arcs of the arc's min |p_i - centre|. The 16 taps are
16 rolls of the image (``torch.roll`` wraps at the border as ``jnp.roll``
does; the 3-px border is zeroed).
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
    """(16, ..., H, W): circle neighbour intensities via rolls (edges wrap;
    callers mask a 3-px border)."""
    return torch.stack([torch.roll(img, (-int(dy), -int(dx)), dims=(-2, -1))
                        for dy, dx in _CIRCLE], dim=0)


def fast_score(img: torch.Tensor, threshold: float, arc: int = 9) -> torch.Tensor:
    """FAST-N/16 corner response. img (..., H, W) float in [0, 1]; threshold
    in the same units. Returns scores of img's shape, 0 where not a corner;
    3-px border zeroed."""
    H, W = img.shape[-2:]
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


def detect_fast(img, n_out: int, existing_xy, existing_valid, mask_radius,
                min_distance: float, threshold: float = 20.0 / 255.0):
    """FAST corners with ``gftt.detect_corners``'s selection: block maxima,
    the 256 best (``lax.top_k`` order: descending, ties in index order),
    rejection within ``mask_radius`` (B,) of a lane's live tracks
    ``existing_xy`` (B, T, 2), and the greedy min-distance walk (the greedy
    kernel at K = 256). ``img`` is one (H, W) frame shared by the lanes or
    one (B, H, W) frame per lane. Returns (xy (B, n_out, 2), score, valid)."""
    from ..ops.nms import greedy_min_distance
    from .gftt import block_max_candidates

    B = existing_xy.shape[0]
    resp = fast_score(img, threshold)
    cell = max(int(min_distance) // 2, 2)
    scores, xy = block_max_candidates(resp, cell)  # (NC,) or (B, NC)
    scores = torch.where(scores > 0.0, scores, torch.full_like(scores, float("-inf")))
    k = min(256, scores.shape[-1])
    top_scores, top_idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top_scores[..., :k], top_idx[..., :k]
    top_xy = torch.gather(xy, -2, top_idx[..., None].expand(top_idx.shape + (2,))).to(img.dtype)
    d2 = torch.sum((top_xy[..., :, None, :] - top_xy[..., None, :, :]) ** 2, dim=-1)
    if img.dim() == 2:  # one frame: the lanes read its candidates through stride-0 views
        top_scores, top_xy, d2 = (top_scores.expand(B, k), top_xy.expand(B, k, 2),
                                  d2.expand(B, k, k))
    d2_exist = torch.sum((top_xy[:, :, None, :] - existing_xy[:, None, :, :]) ** 2, dim=-1)
    rad2 = (mask_radius * mask_radius)[:, None, None]
    near_exist = torch.any((d2_exist < rad2) & existing_valid[:, None, :], dim=2)
    cand_ok = torch.isfinite(top_scores) & ~near_exist
    taken = greedy_min_distance(d2, cand_ok.contiguous(), min_distance * min_distance)
    order = torch.argsort((~taken).to(torch.uint8), dim=1, stable=True)[:, :n_out]
    return (torch.gather(top_xy, 1, order[..., None].expand(B, order.shape[1], 2)),
            torch.gather(top_scores, 1, order), torch.gather(taken, 1, order))
