"""Image pyramids, Scharr gradients, box sums and image sampling (port of
the reference's ``frontend/pyramid.py``); the pyramid stencils are the
kernels of ``ops.pyramid``. ``_sep_conv2d`` and ``bilinear_sample`` are the
plain helpers the SLAM module's ORB sampler uses (``slam/orb.py``);
``bilinear_sample`` is also the rectification remap
(``frontend/rectify.py``) and ``box_filter`` the SAD window of the dense
disparity (``frontend/disparity.py``)."""
from __future__ import annotations

import torch

from ..ops.pyramid import pyramid_with_gradients


def build_pyramids_with_gradients(images, max_level: int):
    """(pyramids, gradients): the pyramids (levels 0..max_level) of one or
    two images of one shape, e.g. the left and right frames of a stereo
    pair, and the (Ix, Iy) of levels 0..max_level of ``images[0]`` (the
    tracker's left frame; the right frame's gradients are never needed):
    one kernel launch for all of it. Each image is (H, W), one frame shared
    by every lane, or (B, H, W), one frame per lane; so is every level."""
    images = tuple(images)
    levels, grads = pyramid_with_gradients(images, max_level)
    return [[img, *lv] for img, lv in zip(images, levels)], grads


def _edge_index(n: int, r: int, device) -> torch.Tensor:
    return torch.clamp(torch.arange(-r, n + r, device=device), 0, n - 1)


def _sep_conv2d(img: torch.Tensor, kx, ky) -> torch.Tensor:
    """Separable 2D convolution with replicate padding; img (..., H, W),
    kx / ky sequences of floats. The taps are summed in the reference's
    order."""
    H, W = img.shape[-2:]
    rx, ry = len(kx) // 2, len(ky) // 2
    x = img[..., :, _edge_index(W, rx, img.device)]
    x = sum(float(kx[i]) * x[..., :, i:i + W] for i in range(len(kx)))
    x = x[..., _edge_index(H, ry, img.device), :]
    return sum(float(ky[i]) * x[..., i:i + H, :] for i in range(len(ky)))


def box_sum(x: torch.Tensor, size: int, dim: int, out=None) -> torch.Tensor:
    """Sum of ``size`` neighbours along ``dim`` with replicate padding, into
    ``out`` (a new tensor unless given; it must not overlap ``x``). The
    terms are added in the reference's order (left to right, from the
    first), each straight from a view of ``x``: its edge clamped by
    broadcasting the border slice, so no padded copy is made."""
    n = x.shape[dim]
    r = size // 2
    out = torch.empty_like(x) if out is None else out
    for i in range(size):
        s = i - r  # term i at position p reads x[clamp(p + s, 0, n - 1)]
        lo = min(n, max(0, -s))
        hi = max(lo, min(n, n - s))
        op = torch.Tensor.add_ if i else torch.Tensor.copy_
        if hi > lo:
            op(out.narrow(dim, lo, hi - lo), x.narrow(dim, lo + s, hi - lo))
        if lo > 0:
            op(out.narrow(dim, 0, lo), x.narrow(dim, 0, 1))
        if hi < n:
            op(out.narrow(dim, hi, n - hi), x.narrow(dim, n - 1, 1))
    return out


def box_filter(img: torch.Tensor, size: int) -> torch.Tensor:
    """size x size box sum (not normalized) of (..., H, W), replicate
    padding: along W, then along H, as the reference's separable form."""
    return box_sum(box_sum(img, size, -1), size, -2)


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of img (..., H, W) at points xy (P..., 2) in
    (x, y) pixel coordinates: (..., P...). Out-of-bounds clamped (callers
    check validity)."""
    H, W = img.shape[-2:]
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = (x - x0).to(img.dtype)
    fy = (y - y0).to(img.dtype)
    v00 = img[..., y0, x0]
    v01 = img[..., y0, x1]
    v10 = img[..., y1, x0]
    v11 = img[..., y1, x1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)
