"""Dense stereo disparity by SAD block matching, and depth (port of the
reference's ``frontend/disparity.py``).

The cost volume of a rectified pair, one or one per lane, is one
(B, H, D, W) tensor: the right image at every shift d along W at once (an
index gather) and the absolute differences, in place; the separable box sum
goes along W into one more volume and along H back into the first, so the
peak holds two volumes. The argmin, the uniqueness test and the parabola
refinement reduce over D.
Plain PyTorch, as the reference's is plain XLA.
"""
from __future__ import annotations

import torch

from .pyramid import box_sum


def default_max_disparity(width: int) -> int:
    """10% of the width rounded to 32, at least 32 (64 at 752 px)."""
    return max(32, int(round(width * 0.1 / 32.0)) * 32)


def compute_disparity(left, right, max_disparity: int, block_size: int = 15,
                      uniqueness: float = 0.97):
    """SAD disparity of a rectified pair, (H, W) or (B, H, W) each: a point
    at left x appears at right x - d. Returns (disparity, valid) of the
    images' shape: the winner must beat the best cost outside +-1 of it by
    ``uniqueness`` and lie inside (0, D - 1)."""
    lead = left.shape[:-2]
    H, W = left.shape[-2:]
    D = max_disparity
    dev = left.device
    left = left.reshape((-1, H, W))
    right = right.reshape((-1, H, W))
    shift = torch.arange(D, device=dev)[:, None]
    cols = torch.arange(W, device=dev)[None, :]
    # right shifted right by d (jnp.roll wraps; the wrapped columns x < d
    # are invalidated), (B, H, D, W)
    costs = right[:, :, torch.remainder(cols - shift, W)]
    costs.neg_().add_(left[:, :, None, :]).abs_()  # |left - shifted|, in place
    costs.masked_fill_((cols < shift)[None, None], 1e3)
    # the box sum along W into a second volume, then along H back into the
    # first: two volumes at the peak, no padded copy
    along_w = box_sum(costs, block_size, 3)
    box_sum(along_w, block_size, 1, out=costs)
    del along_w

    best = torch.argmin(costs, dim=2, keepdim=True)  # first minimum, as jnp.argmin
    cmin = torch.gather(costs, 2, best)
    idx = torch.clamp(best, 1, D - 2)
    c_m = torch.gather(costs, 2, idx - 1)
    c_0 = torch.gather(costs, 2, idx)
    c_p = torch.gather(costs, 2, idx + 1)
    # the runner-up outside +-1 of the winner
    for off in (-1, 0, 1):
        costs.scatter_(2, torch.clamp(best + off, 0, D - 1), float("inf"))
    c2 = torch.amin(costs, dim=2, keepdim=True)
    del costs
    valid = (cmin <= uniqueness * c2) & (best > 0) & (best < D - 1)
    denom = torch.clamp(c_m - 2 * c_0 + c_p, min=1e-9)
    delta = torch.clamp(0.5 * (c_m - c_p) / denom, -0.5, 0.5)
    disp = best.to(left.dtype) + delta
    return disp.reshape(lead + (H, W)), valid.reshape(lead + (H, W))


def _homogeneous(Q, xs, ys, d):
    """Q @ [x, y, d, 1] over the grid: (..., 4)."""
    v = torch.stack([xs.expand_as(d), ys.expand_as(d), d, torch.ones_like(d)], dim=-1)
    return v @ Q.transpose(0, 1)


def disparity_to_depth(disp, valid, Q):
    """Per-pixel z-depth through Q (4, 4), of (..., H, W) disparities:
    (depth, valid); depth -1 where invalid."""
    H, W = disp.shape[-2:]
    dev = disp.device
    xs = torch.arange(W, device=dev).to(disp.dtype)[None, :]
    ys = torch.arange(H, device=dev).to(disp.dtype)[:, None]
    p = _homogeneous(Q, xs, ys, disp)
    w = p[..., 3]
    ok = valid & (torch.abs(w) > 1e-9)
    depth = torch.where(ok, p[..., 2] / torch.where(ok, w, torch.ones_like(w)),
                        torch.full_like(w, -1.0))
    return depth, ok & (depth > 0)


def point_cloud(disp, valid, Q, stride: int = 5):
    """Strided 3D point cloud in cam0 coordinates of one (H, W) disparity:
    (points (N, 3), ok (N,))."""
    H, W = disp.shape
    dev = disp.device
    xs = torch.arange(0, W, stride, device=dev).to(disp.dtype)[None, :]
    ys = torch.arange(0, H, stride, device=dev).to(disp.dtype)[:, None]
    d = disp[::stride, ::stride]
    ok = valid[::stride, ::stride]
    p = _homogeneous(Q, xs, ys, d)
    w = p[..., 3:4]
    pts = p[..., :3] / torch.where(torch.abs(w) > 1e-9, w, torch.ones_like(w))
    return pts.reshape(-1, 3), (ok & (pts[..., 2] > 0)).reshape(-1)


def sample_depth(depth, valid, xy):
    """Depth at (sub)pixel positions, nearest pixel, -1 where invalid: of
    one (H, W) map at xy (..., 2), or per lane of (B, H, W) at (B, N, 2)."""
    H, W = depth.shape[-2:]
    x = torch.clamp(torch.round(xy[..., 0]).to(torch.int64), 0, W - 1)
    y = torch.clamp(torch.round(xy[..., 1]).to(torch.int64), 0, H - 1)
    flat = y * W + x
    if depth.dim() == 3:
        d = torch.gather(depth.reshape(depth.shape[0], -1), 1, flat)
        ok = torch.gather(valid.reshape(valid.shape[0], -1), 1, flat)
    else:
        d, ok = depth.reshape(-1)[flat], valid.reshape(-1)[flat]
    return torch.where(ok, d, torch.full_like(d, -1.0))
