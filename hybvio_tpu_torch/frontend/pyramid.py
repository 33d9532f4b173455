"""Image pyramids and Scharr gradients (port of the reference's
``frontend/pyramid.py``); the stencils are the kernels of ``ops.pyramid``."""
from __future__ import annotations

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
