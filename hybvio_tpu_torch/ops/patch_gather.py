"""Patch gather (kernel ``csrc/patch_gather.cu``; replaces the reference's
``ops/patch_gather_pallas.py``) and its plain PyTorch version."""
from __future__ import annotations

import torch

from ._lib import launch, require_cuda


def gather_patches_plain(img, y0, x0, ps: int):
    """(B, N, ps, ps) windows of ``img`` (B, H, W) at origins ``y0``/``x0``
    (B, N), clamped to [0, dim - ps] like ``lax.dynamic_slice``."""
    B, N = y0.shape
    H, W = img.shape[-2:]
    r = torch.arange(ps, device=y0.device)
    ys = torch.clamp(y0.to(torch.int64), 0, H - ps)[..., None] + r
    xs = torch.clamp(x0.to(torch.int64), 0, W - ps)[..., None] + r
    idx = (ys[..., :, None] * W + xs[..., None, :]).reshape(B, -1)
    return torch.gather(img.reshape(B, H * W), 1, idx).reshape(B, N, ps, ps)


def gather_patches(img, y0, x0, ps: int):
    """Kernel on CUDA tensors, plain version on CPU tensors. ``img`` rows
    must be contiguous; its batch stride may be 0 (one image shared by all
    lanes, e.g. ``img.expand(B, H, W)``). ``y0``/``x0``: int32 (B, N)."""
    if img.device.type == "cpu":
        return gather_patches_plain(img, y0, x0, ps)
    require_cuda(img, dtype=torch.float32)
    require_cuda(y0, x0, dtype=torch.int32)
    B, H, W = img.shape
    if y0.shape != x0.shape or y0.dim() != 2 or y0.shape[0] != B:
        raise ValueError(f"origins {tuple(y0.shape)} / {tuple(x0.shape)} for images {tuple(img.shape)}")
    if img.stride(2) != 1 or img.stride(1) != W:
        raise ValueError("image rows must be contiguous")
    if not (y0.is_contiguous() and x0.is_contiguous()):
        raise ValueError("origins must be contiguous")
    if not 0 < ps <= min(H, W):
        raise ValueError(f"patch {ps} does not fit a {H}x{W} image")
    N = y0.shape[1]
    out = torch.empty((B, N, ps, ps), dtype=img.dtype, device=img.device)
    launch("patch_gather", "hv_patch_gather", img.data_ptr(), img.stride(0) if B > 1 else 0,
           H, W, y0.data_ptr(), x0.data_ptr(), B, N, ps, out.data_ptr())
    return out
