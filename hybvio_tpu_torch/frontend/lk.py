"""Pyramidal Lucas-Kanade optical flow (port of the reference's
``frontend/lk.py``), batch-first: points (B, N, 2), images (B, H, W) whose
batch stride may be 0 (one frame shared by every lane).

Each level gathers the template, Ix and Iy patches per feature in one
patch-gather launch and the search patch in another, then samples the rigid
window at a subpixel shift as two small products with bilinear selection
matrices, as the reference does.
The iteration count is fixed at ``max_iter`` with converged points frozen,
which gives the reference's while-loop result without a host sync.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.patch_gather import gather_patches

FLOW_OK = 0
FLOW_FAILED = 1
FLOW_OUT_OF_RANGE = 2

# our min-eigenvalue units -> cv::calcOpticalFlowPyrLK's
MIN_EIG_CV_SCALE = (32.0 * 255.0) ** 2 / float(1 << 20)


class LKParams(NamedTuple):
    window_size: int = 31
    max_level: int = 3
    max_iter: int = 20
    epsilon: float = 0.03
    min_eig_threshold: float = 1e-3


def gather_window_patches(images, centers, ps: int):
    """The (B, N, ps, ps) integer-aligned patches around ``centers`` (B, N, 2)
    of each of ``images`` (one launch for all of them), and their int
    origins (B, N, 2) as (x, y)."""
    H, W = images[0].shape[-2:]
    r = ps // 2
    cx = torch.clamp(torch.floor(centers[..., 0]).to(torch.int32) - r, 0, W - ps)
    cy = torch.clamp(torch.floor(centers[..., 1]).to(torch.int32) - r, 0, H - ps)
    return gather_patches(images, cy, cx, ps), torch.stack([cx, cy], dim=-1)


def window_shift_sample(patches, corner, q, w: int, ps: int):
    """The rigid (w x w) window centred at subpixel ``q`` (B, N, 2) out of
    per-feature patches: window = Sy @ patch @ Sx^T with bilinear (tent)
    selection matrices. Returns (B, N, w, w)."""
    r = w // 2
    local = q - corner.to(q.dtype)
    x = torch.clamp(local[..., 0] - r, 0.0, ps - w - 0.001)
    y = torch.clamp(local[..., 1] - r, 0.0, ps - w - 0.001)
    rows = torch.arange(w, dtype=q.dtype, device=q.device)[:, None]
    cols = torch.arange(ps, dtype=q.dtype, device=q.device)[None, :]
    diff = cols - rows  # (w, ps)

    def sel(shift):
        return torch.clamp(1.0 - torch.abs(diff - shift[..., None, None]), min=0.0)

    return (sel(y) @ patches) @ sel(x).transpose(-1, -2)


def lk_track_level(prev_img, prev_ix, prev_iy, cur_img, prev_pts, guesses,
                   params: LKParams, final_level: bool = True, margin: int = 8):
    """One pyramid level for all features: (new_pts, ok, min_eig)."""
    dtype = prev_img.dtype
    H, W = prev_img.shape[-2:]
    w = params.window_size
    r = w // 2
    B, N = prev_pts.shape[:2]
    margin = max(min(margin, (min(H, W) - w - 3) // 2), 1)

    ps_t = w + 3
    (tp, xp, yp), tc = gather_window_patches((prev_img, prev_ix, prev_iy), prev_pts, ps_t)
    t = window_shift_sample(tp, tc, prev_pts, w, ps_t).reshape(B, N, -1)
    ix = window_shift_sample(xp, tc, prev_pts, w, ps_t).reshape(B, N, -1)
    iy = window_shift_sample(yp, tc, prev_pts, w, ps_t).reshape(B, N, -1)

    gxx = torch.sum(ix * ix, dim=-1)
    gyy = torch.sum(iy * iy, dim=-1)
    gxy = torch.sum(ix * iy, dim=-1)
    nk = w * w
    tr2 = 0.5 * (gxx + gyy) / nk
    det_n = (gxx * gyy - gxy * gxy) / (nk * nk)
    min_eig = tr2 - torch.sqrt(torch.clamp(tr2 * tr2 - det_n, min=0.0))
    det_g = gxx * gyy - gxy * gxy
    ok_g = det_g > 1e-12
    safe_det = torch.where(ok_g, det_g, torch.ones_like(det_g))

    ps_c = w + 2 * margin + 3
    (cp,), cc = gather_window_patches((cur_img,), guesses, ps_c)
    t_zm = t - torch.mean(t, dim=-1, keepdim=True)
    templ_ok = ((prev_pts[..., 0] >= r) & (prev_pts[..., 0] < W - r)
                & (prev_pts[..., 1] >= r) & (prev_pts[..., 1] < H - r))

    q = guesses
    done = ~ok_g | ~templ_ok
    eps2 = params.epsilon ** 2
    for _ in range(params.max_iter):
        wv = window_shift_sample(cp, cc, q, w, ps_c).reshape(B, N, -1)
        di = (wv - torch.mean(wv, dim=-1, keepdim=True)) - t_zm
        bx = torch.sum(di * ix, dim=-1)
        by = torch.sum(di * iy, dim=-1)
        dx = (gyy * bx - gxy * by) / safe_det
        dy = (-gxy * bx + gxx * by) / safe_det
        delta = torch.stack([dx, dy], dim=-1)
        converged = torch.sum(delta * delta, dim=-1) < eps2
        q = torch.where(done[..., None], q, q - delta)
        done = done | converged
    q = torch.where(templ_ok[..., None], q, guesses)

    if not final_level:
        return q, torch.ones_like(ok_g), min_eig

    local = q - cc.to(dtype)
    in_patch = ((local[..., 0] >= r + 1) & (local[..., 0] < ps_c - r - 2)
                & (local[..., 1] >= r + 1) & (local[..., 1] < ps_c - r - 2))
    in_bounds = (q[..., 0] >= r) & (q[..., 0] < W - r) & (q[..., 1] >= r) & (q[..., 1] < H - r)
    w_final = window_shift_sample(cp, cc, q, w, ps_c).reshape(B, N, -1)
    d_final = (w_final - torch.mean(w_final, dim=-1, keepdim=True)
               - (t - torch.mean(t, dim=-1, keepdim=True)))
    resid = torch.mean(torch.abs(d_final), dim=-1)
    contrast = torch.clamp(torch.amax(t, dim=-1) - torch.amin(t, dim=-1), min=1e-6)
    ok_resid = resid <= torch.clamp(0.25 * contrast, min=0.02)
    return q, ok_g & templ_ok & in_bounds & in_patch & ok_resid, min_eig


def lk_track_pyramid(prev_pyr, prev_grads, cur_pyr, prev_pts, initial_pts=None,
                     params: LKParams = LKParams()):
    """Full pyramidal LK: prev_pts / initial_pts (B, N, 2) at level 0;
    pyramid levels (B, H_l, W_l). Returns (pts, status int32, min_eig)."""
    L = params.max_level
    scale_top = 2.0 ** L
    g = (prev_pts if initial_pts is None else initial_pts) / scale_top
    ok_all = torch.ones(prev_pts.shape[:2], dtype=torch.bool, device=prev_pts.device)
    min_eig = None
    for lvl in range(L, -1, -1):
        p_lvl = prev_pts / (2.0 ** lvl)
        new_pts, ok, min_eig = lk_track_level(
            prev_pyr[lvl], prev_grads[lvl][0], prev_grads[lvl][1], cur_pyr[lvl],
            p_lvl, g, params, final_level=(lvl == 0),
            margin=16 if lvl == L and L > 0 else 8)
        ok_all = ok_all & ok
        g = new_pts * 2.0 if lvl > 0 else new_pts
    ok_all = ok_all & (min_eig * MIN_EIG_CV_SCALE >= params.min_eig_threshold)
    H, W = cur_pyr[0].shape[-2:]
    x, y = g[..., 0], g[..., 1]
    in_range = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    status = torch.where(~in_range, FLOW_OUT_OF_RANGE,
                         torch.where(ok_all, FLOW_OK, FLOW_FAILED)).to(torch.int32)
    return g, status, min_eig
