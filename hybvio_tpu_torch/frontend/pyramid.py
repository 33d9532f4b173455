"""Image pyramids, Scharr gradients and image sampling (port of the
reference's ``frontend/pyramid.py``); the pyramid stencils are the kernels
of ``ops.pyramid``. ``_sep_conv2d`` and ``bilinear_sample`` are the plain
helpers the SLAM module's ORB sampler uses (``slam/orb.py``)."""
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


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of img (H, W) at points xy (..., 2) in (x, y)
    pixel coordinates. Out-of-bounds clamped (callers check validity)."""
    H, W = img.shape[-2:]
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = (x - x0).to(img.dtype)
    fy = (y - y0).to(img.dtype)
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)
