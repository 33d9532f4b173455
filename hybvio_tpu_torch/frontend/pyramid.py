"""Image pyramids and Scharr gradients (port of the reference's
``frontend/pyramid.py``); the stencils are the kernels of ``ops.pyramid``."""
from __future__ import annotations

from ..ops.pyramid import pyramid_with_gradients


def build_pyramids_with_gradients(images, max_level: int):
    """(pyramids, gradients): the pyramids (levels 0..max_level) of one or
    two (H, W) images of one shape, e.g. the left and right frames of a
    stereo pair, and the (Ix, Iy) of levels 0..max_level of ``images[0]``
    (the tracker's left frame; the right frame's gradients are never
    needed): one kernel launch for all of it."""
    images = tuple(images)
    levels, grads = pyramid_with_gradients(images, max_level)
    return [[img, *lv] for img, lv in zip(images, levels)], grads
