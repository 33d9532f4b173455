"""Pyramid stencils (kernels in ``csrc/pyramid.cu``; replace the reference's
``ops/pyramid_pallas.py`` pyr_down_pallas and scharr_pallas) and their
plain PyTorch versions, composed exactly like the reference's XLA path.

``pyramid_with_gradients`` builds several levels of one or two images (the
cameras; one frame shared by every lane, or one per lane) and the Scharr
gradients of every level of the first image in one launch (the tracker's
path); ``pyr_down_levels`` is the same kernel without the gradients,
``pyr_down`` that at one image and one level, and ``scharr`` the gradients
of one image alone. The plain versions take any leading dimensions."""
from __future__ import annotations

import numpy as np
import torch

from ._lib import lane_layout, launch, require_cuda

PYR_K = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
SCHARR_D = np.array([-1.0, 0.0, 1.0])
SCHARR_S = np.array([3.0, 10.0, 3.0]) / 32.0
LEVELS_PER_LAUNCH = 3  # deeper pyramids chain launches (a deep tile would be tiny)
MAX_IMAGES = 2  # cameras: the left and right frames of a stereo pair


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


def pyr_down_levels_plain(images, levels: int):
    """Levels 1..levels of each image: pyr_down_plain repeated."""
    out = []
    for img in images:
        pyr = [img]
        for _ in range(levels):
            pyr.append(pyr_down_plain(pyr[-1]))
        out.append(pyr[1:])
    return out


def pyramid_with_gradients_plain(images, levels: int):
    """pyr_down_levels_plain, and scharr_plain of each level of the first
    image."""
    pyrs = pyr_down_levels_plain(images, levels)
    return pyrs, [scharr_plain(img) for img in (images[0], *pyrs[0])]


def _check_images(images):
    """(lanes, lane stride) of 1 to MAX_IMAGES images (cameras) of one shape
    on one CUDA device: each (H, W), or (B, H, W) with contiguous rows and
    one lane stride."""
    require_cuda(*images, dtype=torch.float32)
    if not 1 <= len(images) <= MAX_IMAGES:
        raise ValueError(f"the kernel takes 1 to {MAX_IMAGES} cameras, got {len(images)}")
    return lane_layout(images)


def pyr_down_levels(images, levels: int):
    """Levels 1..levels (each ((H+1)//2, (W+1)//2) of the one before) of one
    or two images of one shape, (H, W) each or (B, H, W) each (one per
    lane), a list of ``levels`` tensors per image: on CUDA tensors one kernel
    launch for up to LEVELS_PER_LAUNCH levels of every lane, on CPU tensors
    the plain version."""
    images = tuple(images)
    if all(img.device.type == "cpu" for img in images):
        return pyr_down_levels_plain(images, levels)
    _check_images(images)
    return _chained(images, levels, gradients=False)[0]


def pyramid_with_gradients(images, levels: int):
    """(pyramids, gradients): levels 1..levels of one or two images of one
    shape (the cameras; (H, W) each, or (B, H, W) each with one image per
    lane), as pyr_down_levels gives them, and the Scharr (Ix, Iy) of levels
    0..levels of ``images[0]`` (of every lane). On CUDA tensors one kernel
    launch for up to LEVELS_PER_LAUNCH levels (deeper pyramids chain
    launches; none computes a level's gradients twice), on CPU tensors the
    plain version."""
    images = tuple(images)
    if all(img.device.type == "cpu" for img in images):
        return pyramid_with_gradients_plain(images, levels)
    _check_images(images)
    if levels == 0:
        return [[] for _ in images], [scharr(images[0])]
    return _chained(images, levels, gradients=True)


def _chained(images, levels, gradients):
    out, grads = [[] for _ in images], []
    while len(out[0]) < levels:
        srcs = tuple(row[-1] for row in out) if out[0] else images
        new, more = _pyramid(srcs, min(levels - len(out[0]), LEVELS_PER_LAUNCH), gradients,
                             base=not out[0])
        for row, lv in zip(out, new):
            row.extend(lv)
        grads.extend(more)
    return out, grads


def _pyramid(images, levels, gradients, base):
    """One launch: levels 1..levels of each image (camera) of every lane
    and, with ``gradients``, the (Ix, Iy) of levels 1..levels of images[0]
    (and of level 0 with ``base``). The levels are views of one buffer laid
    out (lanes, cameras, levels), the gradients of one laid out (lanes,
    levels, Ix / Iy). A launch is counted under (cameras, lanes, H, W,
    levels)."""
    lanes, stride = lane_layout(images)
    lead = images[0].shape[:-2]  # () for a shared frame, (B,) per lane
    H, W = images[0].shape[-2:]
    shapes = [(H, W)]
    for _ in range(levels):
        shapes.append(((shapes[-1][0] + 1) // 2, (shapes[-1][1] + 1) // 2))
    sizes = [h * w for h, w in shapes[1:]]
    dev = images[0].device
    out = torch.empty((lanes, len(images), sum(sizes)), dtype=torch.float32, device=dev)
    args = (images[0].data_ptr(), images[-1].data_ptr(), len(images), lanes, stride, H, W, levels,
            out.data_ptr())
    key = (len(images), lanes, H, W, levels)
    grads = []
    if gradients:
        gshapes = shapes if base else shapes[1:]
        gsizes = [n for h, w in gshapes for n in (h * w, h * w)]
        gbuf = torch.empty((lanes, sum(gsizes)), dtype=torch.float32, device=dev)
        launch("pyramid_scharr", "hv_pyramid_scharr", *args, gbuf.data_ptr(), int(base),
               shape=key)
        flat = gbuf.split(gsizes, dim=1)
        grads = [(flat[2 * i].view(lead + s), flat[2 * i + 1].view(lead + s))
                 for i, s in enumerate(gshapes)]
    else:
        launch("pyr_down", "hv_pyramid", *args, shape=key)
    pyrs = [[level.view(lead + shape) for level, shape in zip(out[:, c].split(sizes, dim=1),
                                                              shapes[1:])]
            for c in range(len(images))]
    return pyrs, grads


def pyr_down(img):
    """Blur + 2x decimation: (H, W) -> ((H+1)//2, (W+1)//2)."""
    return pyr_down_levels((img,), 1)[0][0]


def scharr(img):
    """(Ix, Iy) Scharr gradients of an (H, W) image, or of each lane of a
    (B, H, W) one (rows contiguous); a launch is counted under (lanes, H,
    W)."""
    if img.device.type == "cpu":
        return scharr_plain(img)
    lanes, stride = _check_images((img,))
    H, W = img.shape[-2:]
    ix = torch.empty(img.shape, dtype=img.dtype, device=img.device)
    iy = torch.empty(img.shape, dtype=img.dtype, device=img.device)
    launch("scharr", "hv_scharr", img.data_ptr(), lanes, stride, H, W, ix.data_ptr(),
           iy.data_ptr(), shape=(lanes, H, W))
    return ix, iy
