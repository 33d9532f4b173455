"""Pyramid stencils (kernels in ``csrc/pyramid.cu``; replace the reference's
``ops/pyramid_pallas.py`` pyr_down_pallas and scharr_pallas) and their
plain PyTorch versions, composed exactly like the reference's XLA path."""
from __future__ import annotations

import numpy as np
import torch

from ._lib import launch, require_cuda

PYR_K = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
SCHARR_D = np.array([-1.0, 0.0, 1.0])
SCHARR_S = np.array([3.0, 10.0, 3.0]) / 32.0


def sep_conv2d(img, kx, ky):
    """Separable 2-D convolution with edge replication, as shifted slices:
    the x pass over edge-padded columns, then the y pass over edge-padded
    rows of its result; sums run left to right. ``img`` (..., H, W)."""
    H, W = img.shape[-2:]
    rx, ry = len(kx) // 2, len(ky) // 2
    x = torch.cat([img[..., :, :1].expand(img.shape[:-1] + (rx,)), img,
                   img[..., :, -1:].expand(img.shape[:-1] + (rx,))], dim=-1)
    acc = None
    for i, k in enumerate(kx):
        term = float(k) * x[..., :, i:i + W]
        acc = term if acc is None else acc + term
    y = torch.cat([acc[..., :1, :].expand(acc.shape[:-2] + (ry, W)), acc,
                   acc[..., -1:, :].expand(acc.shape[:-2] + (ry, W))], dim=-2)
    out = None
    for i, k in enumerate(ky):
        term = float(k) * y[..., i:i + H, :]
        out = term if out is None else out + term
    return out


def pyr_down_plain(img):
    return sep_conv2d(img, PYR_K, PYR_K)[..., ::2, ::2]


def scharr_plain(img):
    return sep_conv2d(img, SCHARR_D, SCHARR_S), sep_conv2d(img, SCHARR_S, SCHARR_D)


def _check_image(img):
    require_cuda(img, dtype=torch.float32)
    if img.dim() != 2 or not img.is_contiguous():
        raise ValueError(f"expected one contiguous (H, W) image, got {tuple(img.shape)}")


def pyr_down(img):
    """Blur + 2x decimation: (H, W) -> ((H+1)//2, (W+1)//2)."""
    if img.device.type == "cpu":
        return pyr_down_plain(img)
    _check_image(img)
    H, W = img.shape
    out = torch.empty(((H + 1) // 2, (W + 1) // 2), dtype=img.dtype, device=img.device)
    launch("pyr_down", "hv_pyr_down", img.data_ptr(), H, W, out.data_ptr())
    return out


def scharr(img):
    """(Ix, Iy) Scharr gradients of an (H, W) image."""
    if img.device.type == "cpu":
        return scharr_plain(img)
    _check_image(img)
    H, W = img.shape
    ix = torch.empty_like(img)
    iy = torch.empty_like(img)
    launch("scharr", "hv_scharr", img.data_ptr(), H, W, ix.data_ptr(), iy.data_ptr())
    return ix, iy
