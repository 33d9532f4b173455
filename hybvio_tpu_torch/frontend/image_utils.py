"""Image utilities (port of the reference package's
``frontend/image_utils.py``; reference: src/tracker/util.{hpp,cpp}):
90-degree rotations and intensity matching between stereo / successive
frames on tensors, and the host-side colour conversion and resize as numpy
copies."""
from __future__ import annotations

import numpy as np
import torch


def rotate_cw90(img: torch.Tensor) -> torch.Tensor:
    """Rotate 90 degrees clockwise (reference: rotateMatrixCW90)."""
    return torch.flip(torch.swapaxes(img, -1, -2), dims=(-1,))


def rotate(img: torch.Tensor, cw90_steps: int) -> torch.Tensor:
    out = img
    for _ in range(cw90_steps % 4):
        out = rotate_cw90(out)
    return out


def match_intensities(target_like: torch.Tensor, img: torch.Tensor,
                      strength: float = 1.0) -> torch.Tensor:
    """Linearly match img's mean/std to target_like's (population std, as
    jnp.std) (reference: matchIntensities, used to equalize stereo pairs /
    successive frames, tracker.cpp via main.cpp:763-777)."""
    mt = torch.mean(target_like)
    st = torch.std(target_like, correction=0) + 1e-9
    mi = torch.mean(img)
    si = torch.std(img, correction=0) + 1e-9
    matched = (img - mi) * (st / si) + mt
    out = img + strength * (matched - img)
    return torch.clamp(out, 0.0, 1.0)


def rgb_to_gray(img):
    """Color -> gray with the reference's luma weights 0.299/0.587/0.114
    (reference: Image factory conversion op, image.cpp:345-367).
    img: (..., H, W, 3) in [0, 1] or uint8; returns float in [0, 1]."""
    a = np.asarray(img)
    if a.dtype == np.uint8:
        a = a.astype(np.float32) / 255.0
    return (0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2])


def resize_bilinear_np(img, new_h: int, new_w: int):
    """Host-side bilinear resize (reference: targetFrameWidth input scaling,
    main.cpp:334-394 via VideoInput resize); runs per frame on the input
    thread, not on the device."""
    src = np.asarray(img)
    # integer frames resize in float and return uint8 (raw 0-255 frames stay
    # raw through the input-scaling path; the device normalizes)
    int_in = src.dtype.kind in "ui"
    a = src.astype(np.float32)
    H, W = a.shape[:2]
    if (H, W) == (new_h, new_w):
        return src if int_in else a
    y = (np.arange(new_h) + 0.5) * H / new_h - 0.5
    x = (np.arange(new_w) + 0.5) * W / new_w - 0.5
    y0 = np.clip(np.floor(y).astype(np.int64), 0, H - 1)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = np.clip(y - y0, 0.0, 1.0)[:, None]
    wx = np.clip(x - x0, 0.0, 1.0)[None, :]
    top = a[y0][:, x0] * (1 - wx) + a[y0][:, x1] * wx
    bot = a[y1][:, x0] * (1 - wx) + a[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if int_in:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out
