"""Shi-Tomasi corner response (kernel ``csrc/corner_response.cu``; replaces
the reference's ``ops/gftt_pallas.py`` corner_response_pallas) and its
plain PyTorch version, the reference's XLA composition."""
from __future__ import annotations

import numpy as np
import torch

from ..runtime import constant
from ._lib import lane_layout, launch, require_cuda
from .pyramid import sep_conv2d

_SOBEL_D = np.array([-1.0, 0.0, 1.0])
_SOBEL_S = np.array([1.0, 2.0, 1.0])
MAX_BLOCK = 15  # the kernel's largest box


def corner_response_plain(img, block_size: int = 3):
    """Unnormalized Sobel -> box-mean structure matrix -> min eigenvalue, of
    (..., H, W) images."""
    ix = sep_conv2d(img, _SOBEL_D, _SOBEL_S)
    iy = sep_conv2d(img, _SOBEL_S, _SOBEL_D)
    box = np.ones(block_size)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the IEEE quotient the kernel computes
    n = constant(float(block_size * block_size), img.dtype, img.device)
    sxx = sep_conv2d(ix * ix, box, box) / n
    syy = sep_conv2d(iy * iy, box, box) / n
    sxy = sep_conv2d(ix * iy, box, box) / n
    tr2 = 0.5 * (sxx + syy)
    det = sxx * syy - sxy * sxy
    # the square root in float64, rounded once: the correctly rounded root in
    # float32 (the CPU's float32 root is not), as the kernel's sqrtf and XLA
    disc = torch.sqrt(torch.clamp(tr2 * tr2 - det, min=0.0).to(torch.float64)).to(img.dtype)
    return tr2 - disc


def corner_response(img, block_size: int = 3):
    """The (H, W) response of an (H, W) image, or the (B, H, W) responses of
    B lanes' images (rows contiguous, any lane stride); kernel on CUDA (odd
    block sizes up to MAX_BLOCK, one launch for every lane), plain on CPU.
    A launch is counted under (lanes, H, W, block_size)."""
    if img.device.type == "cpu":
        return corner_response_plain(img, block_size)
    require_cuda(img, dtype=torch.float32)
    lanes, stride = lane_layout((img,))
    if not (1 <= block_size <= MAX_BLOCK and block_size % 2 == 1):
        raise ValueError(f"block size {block_size}: the kernel takes odd sizes up to {MAX_BLOCK}")
    H, W = img.shape[-2:]
    out = torch.empty(img.shape, dtype=img.dtype, device=img.device)
    launch("corner_response", "hv_corner_response", img.data_ptr(), lanes, stride, H, W,
           block_size, out.data_ptr(), shape=(lanes, H, W, block_size))
    return out
