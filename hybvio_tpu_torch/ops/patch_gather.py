"""Patch gather (kernel ``csrc/patch_gather.cu``; replaces the reference's
``ops/patch_gather_pallas.py``) and its plain PyTorch version. One launch
gathers the windows of up to three images at the same origins."""
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


MAX_IMAGES = 3  # the template, Ix and Iy of one LK level


def gather_patches(images, y0, x0, ps: int):
    """The (B, N, ps, ps) windows of each of ``images`` (1 to MAX_IMAGES
    (B, H, W) tensors of one shape) at the same origins ``y0``/``x0``, int32
    (B, N): one kernel launch on CUDA tensors, the plain version on CPU
    tensors. Image rows must be contiguous; a batch stride may be 0 (one
    image shared by all lanes, e.g. ``img.expand(B, H, W)``)."""
    images = tuple(images)
    if images[0].device.type == "cpu":
        return tuple(gather_patches_plain(img, y0, x0, ps) for img in images)
    require_cuda(*images, dtype=torch.float32)
    require_cuda(y0, x0, dtype=torch.int32)
    B, H, W = images[0].shape
    if not 1 <= len(images) <= MAX_IMAGES:
        raise ValueError(f"{len(images)} images: the kernel takes 1 to {MAX_IMAGES}")
    for img in images:
        if img.shape != (B, H, W):
            raise ValueError(f"images of shapes {[tuple(i.shape) for i in images]}")
        if img.stride(2) != 1 or img.stride(1) != W:
            raise ValueError("image rows must be contiguous")
    if y0.shape != x0.shape or y0.dim() != 2 or y0.shape[0] != B:
        raise ValueError(f"origins {tuple(y0.shape)} / {tuple(x0.shape)} for images {(B, H, W)}")
    if not (y0.is_contiguous() and x0.is_contiguous()):
        raise ValueError("origins must be contiguous")
    if not 0 < ps <= min(H, W):
        raise ValueError(f"patch {ps} does not fit a {H}x{W} image")
    N = y0.shape[1]
    out = torch.empty((len(images), B, N, ps, ps), dtype=torch.float32, device=y0.device)
    padded = images + images[-1:] * (MAX_IMAGES - len(images))
    launch("patch_gather", "hv_patch_gather", *(img.data_ptr() for img in padded),
           *(img.stride(0) if B > 1 else 0 for img in padded), len(images), H, W,
           y0.data_ptr(), x0.data_ptr(), B, N, ps, out.data_ptr())
    return tuple(out)
