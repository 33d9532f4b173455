"""GFTT (Shi-Tomasi) corner detection and subpixel refinement (port of the
reference's ``frontend/gftt.py``).

The frame is shared by every lane, so the response map, the block maxima
and the top candidates are computed once per step; the per-lane parts are
the rejection near each lane's live tracks and the greedy min-distance walk
(the greedy kernel, one block per lane).
"""
from __future__ import annotations

import torch

from ..ops.gftt import corner_response
from ..ops.nms import greedy_min_distance
from .lk import gather_window_patches, window_shift_sample


def block_max_candidates(response, cell: int):
    """Max response and its (x, y) per cell: (scores (NC,), xy (NC, 2))."""
    H, W = response.shape
    Hc, Wc = H // cell, W // cell
    r = response[:Hc * cell, :Wc * cell].reshape(Hc, cell, Wc, cell)
    r = r.permute(0, 2, 1, 3).reshape(Hc, Wc, cell * cell)
    scores = torch.amax(r, dim=-1)
    idx = torch.argmax(r, dim=-1)
    ys = torch.arange(Hc, device=r.device)[:, None] * cell + idx // cell
    xs = torch.arange(Wc, device=r.device)[None, :] * cell + idx % cell
    return scores.reshape(-1), torch.stack([xs, ys], dim=-1).reshape(-1, 2)


def detect_corners(img, n_out: int, existing_xy, existing_valid, mask_radius,
                   min_distance: float, block_size: int = 3, min_response: float = 1e-3,
                   n_candidates: int = 256, margin: int = 5, crop_fraction: float = 1.0,
                   quality_level: float = 0.0):
    """Up to ``n_out`` new corners per lane in the shared (H, W) ``img``.

    existing_xy (B, T, 2) / existing_valid (B, T): live tracks; candidates
    within ``mask_radius`` (B,) of one, or within ``min_distance`` of a
    stronger taken candidate, are rejected. Returns (xy (B, n_out, 2),
    score (B, n_out), valid (B, n_out))."""
    H, W = img.shape
    resp = corner_response(img, block_size)
    cell = max(int(min_distance) // 2, 2)
    scores, xy = block_max_candidates(resp, cell)
    x, y = xy[:, 0], xy[:, 1]
    ok = (x >= margin) & (x < W - margin) & (y >= margin) & (y < H - margin)
    if crop_fraction < 1.0:
        xd = W * (1 - crop_fraction) / 2
        yd = H * (1 - crop_fraction) / 2
        ok = ok & (x >= xd) & (x < W - xd) & (y >= yd) & (y < H - yd)
    ok = ok & (scores > min_response)
    if quality_level > 0.0:
        ok = ok & (scores > quality_level * torch.amax(scores))
    scores = torch.where(ok, scores, torch.full_like(scores, float("-inf")))

    # lax.top_k order: descending, equal scores in index order
    k = min(max(n_candidates, n_out), scores.shape[0])
    top_scores, top_idx = torch.sort(scores, descending=True, stable=True)
    top_scores, top_idx = top_scores[:k], top_idx[:k]
    top_xy = xy[top_idx].to(img.dtype)

    B = existing_xy.shape[0]
    d2_exist = torch.sum((top_xy[None, :, None, :] - existing_xy[:, None, :, :]) ** 2, dim=-1)
    rad2 = (mask_radius * mask_radius)[:, None, None]
    near_exist = torch.any((d2_exist < rad2) & existing_valid[:, None, :], dim=2)
    cand_ok = torch.isfinite(top_scores)[None, :] & ~near_exist

    d2 = torch.sum((top_xy[:, None, :] - top_xy[None, :, :]) ** 2, dim=-1)
    taken = greedy_min_distance(d2.expand(B, k, k), cand_ok.contiguous(),
                                min_distance * min_distance)
    order = torch.argsort((~taken).to(torch.uint8), dim=1, stable=True)[:, :n_out]
    return (top_xy[order], top_scores[order], torch.gather(taken, 1, order))


def subpixel_refine(img, xy, window: int = 10, iters: int = 5, epsilon: float = 0.0):
    """Corner subpixel refinement (cv::cornerSubPix-style centroid
    iteration) of ``xy`` (B, N, 2) in the shared (H, W) ``img``. With
    ``epsilon > 0`` a lane stops once no corner of it moved by epsilon."""
    H, W = img.shape
    r = window
    w = 2 * r + 1
    B, N = xy.shape[:2]
    dtype = img.dtype
    gx_img = torch.zeros_like(img)
    gx_img[:, 1:-1] = (img[:, 2:] - img[:, :-2]) * 0.5
    gy_img = torch.zeros_like(img)
    gy_img[1:-1, :] = (img[2:, :] - img[:-2, :]) * 0.5
    ps = 2 * w + 3
    (gxp, gyp), c = gather_window_patches((gx_img.expand(B, H, W), gy_img.expand(B, H, W)),
                                          xy, ps)
    ax = torch.arange(-r, r + 1, dtype=dtype, device=img.device)
    oy, ox = torch.meshgrid(ax, ax, indexing="ij")

    def body(p):
        gx = window_shift_sample(gxp, c, p, w, ps)
        gy = window_shift_sample(gyp, c, p, w, ps)
        px = p[..., 0][..., None, None] + ox
        py = p[..., 1][..., None, None] + oy
        gxx = torch.sum(gx * gx, dim=(-2, -1))
        gyy = torch.sum(gy * gy, dim=(-2, -1))
        gxy = torch.sum(gx * gy, dim=(-2, -1))
        bx = torch.sum(gx * gx * px + gx * gy * py, dim=(-2, -1))
        by = torch.sum(gx * gy * px + gy * gy * py, dim=(-2, -1))
        det = gxx * gyy - gxy * gxy
        ok = torch.abs(det) > 1e-12
        safe_det = torch.where(ok, det, torch.ones_like(det))
        nx = (gyy * bx - gxy * by) / safe_det
        ny = (-gxy * bx + gxx * by) / safe_det
        return torch.where(ok[..., None], torch.stack([nx, ny], dim=-1), p)

    p = xy
    active = torch.ones((B,), dtype=torch.bool, device=xy.device)
    for _ in range(iters):
        p2 = body(p)
        if epsilon > 0.0:
            shift = torch.amax(torch.linalg.norm(p2 - p, dim=-1), dim=1)
            p = torch.where(active[:, None, None], p2, p)
            active = active & (shift >= epsilon)
        else:
            p = p2
    in_bounds = (p[..., 0] >= 0) & (p[..., 0] < W) & (p[..., 1] >= 0) & (p[..., 1] < H)
    moved_ok = torch.linalg.norm(p - xy, dim=-1) < 2.0 * window
    return torch.where((in_bounds & moved_ok)[..., None], p, xy)
