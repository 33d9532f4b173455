"""GFTT (Shi-Tomasi) corner detection and subpixel refinement (port of the
reference's ``frontend/gftt.py``).

A frame shared by every lane, (H, W), has its response map, block maxima
and top candidates computed once per step; per-lane frames, (B, H, W), have
them computed per lane. Per lane in both cases are the rejection near each
lane's live tracks and the greedy min-distance walk (the greedy kernel, one
block per lane).
"""
from __future__ import annotations

import torch

from ..ops.gftt import corner_response
from ..ops.nms import greedy_min_distance
from .lk import gather_window_patches, window_shift_sample


def block_max_candidates(response, cell: int):
    """Max response and its (x, y) per cell of (..., H, W) responses:
    (scores (..., NC), xy (..., NC, 2))."""
    lead = response.shape[:-2]
    H, W = response.shape[-2:]
    Hc, Wc = H // cell, W // cell
    r = response[..., :Hc * cell, :Wc * cell].reshape(lead + (Hc, cell, Wc, cell))
    r = r.transpose(-3, -2).reshape(lead + (Hc, Wc, cell * cell))
    scores = torch.amax(r, dim=-1)
    idx = torch.argmax(r, dim=-1)
    ys = torch.arange(Hc, device=r.device)[:, None] * cell + idx // cell
    xs = torch.arange(Wc, device=r.device)[None, :] * cell + idx % cell
    return scores.reshape(lead + (-1,)), torch.stack([xs, ys], dim=-1).reshape(lead + (-1, 2))


def block_max_packed(response, cell: int):
    """``block_max_candidates`` of one (H, W) response as one packed
    reduction, as the reference's SLAM keyframe detector does: scores in
    [0, 1] quantized to 16 bits (granularity 1.5e-5, which only perturbs
    tie-breaking) and packed with the in-cell pixel index into one int32,
    so one max gives both (on ties the larger in-cell index wins). Returns
    (scores (NC,), xy (NC, 2)) with NC = (H // cell) * (W // cell)."""
    H, W = response.shape
    Hc, Wc = H // cell, W // cell
    r = response[:Hc * cell, :Wc * cell].reshape(Hc, cell, Wc, cell)
    r = r.transpose(1, 2).reshape(Hc, Wc, cell * cell)
    nidx = cell * cell
    shift = 1
    while shift < nidx:
        shift *= 2
    q = torch.round(torch.clamp(r, 0.0, 1.0) * 65535.0).to(torch.int32)
    packed = q * shift + torch.arange(nidx, dtype=torch.int32, device=r.device)
    best = torch.amax(packed, dim=-1)
    idx = best % shift
    scores = (best // shift).to(response.dtype) / 65535.0
    ys = torch.arange(Hc, device=r.device)[:, None] * cell + idx // cell
    xs = torch.arange(Wc, device=r.device)[None, :] * cell + idx % cell
    return scores.reshape(-1), torch.stack([xs, ys], dim=-1).reshape(-1, 2)


def detect_corners(img, n_out: int, existing_xy, existing_valid, mask_radius,
                   min_distance: float, block_size: int = 3, min_response: float = 1e-3,
                   n_candidates: int = 256, margin: int = 5, crop_fraction: float = 1.0,
                   quality_level: float = 0.0):
    """Up to ``n_out`` new corners per lane in ``img``: one (H, W) frame
    shared by the lanes, or one (B, H, W) frame per lane.

    existing_xy (B, T, 2) / existing_valid (B, T): live tracks; candidates
    within ``mask_radius`` (B,) of one, or within ``min_distance`` of a
    stronger taken candidate, are rejected. Returns (xy (B, n_out, 2),
    score (B, n_out), valid (B, n_out))."""
    H, W = img.shape[-2:]
    B = existing_xy.shape[0]
    resp = corner_response(img, block_size)
    cell = max(int(min_distance) // 2, 2)
    scores, xy = block_max_candidates(resp, cell)  # (NC,) or (B, NC)
    x, y = xy[..., 0], xy[..., 1]
    ok = (x >= margin) & (x < W - margin) & (y >= margin) & (y < H - margin)
    if crop_fraction < 1.0:
        xd = W * (1 - crop_fraction) / 2
        yd = H * (1 - crop_fraction) / 2
        ok = ok & (x >= xd) & (x < W - xd) & (y >= yd) & (y < H - yd)
    ok = ok & (scores > min_response)
    if quality_level > 0.0:
        ok = ok & (scores > quality_level * torch.amax(scores, dim=-1, keepdim=True))
    scores = torch.where(ok, scores, torch.full_like(scores, float("-inf")))

    # lax.top_k order: descending, equal scores in index order
    k = min(max(n_candidates, n_out), scores.shape[-1])
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
    return (torch.gather(top_xy, 1, order[..., None].expand(B, n_out, 2)),
            torch.gather(top_scores, 1, order), torch.gather(taken, 1, order))


def subpixel_refine(img, xy, window: int = 10, iters: int = 5, epsilon: float = 0.0):
    """Corner subpixel refinement (cv::cornerSubPix-style centroid
    iteration) of ``xy`` (B, N, 2) in ``img``, one (H, W) frame shared by
    the lanes or one (B, H, W) frame per lane. With ``epsilon > 0`` a lane
    stops once no corner of it moved by epsilon."""
    H, W = img.shape[-2:]
    r = window
    w = 2 * r + 1
    B, N = xy.shape[:2]
    dtype = img.dtype
    gx_img = torch.zeros(img.shape, dtype=dtype, device=img.device)
    gx_img[..., :, 1:-1] = (img[..., :, 2:] - img[..., :, :-2]) * 0.5
    gy_img = torch.zeros(img.shape, dtype=dtype, device=img.device)
    gy_img[..., 1:-1, :] = (img[..., 2:, :] - img[..., :-2, :]) * 0.5
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
