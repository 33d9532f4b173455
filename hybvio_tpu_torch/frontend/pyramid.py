"""Image pyramids and Scharr gradients (port of the reference's
``frontend/pyramid.py``); the stencils are the kernels of ``ops.pyramid``."""
from __future__ import annotations

from typing import List

from ..ops.pyramid import pyr_down_levels, scharr


def build_pyramid(img, max_level: int) -> List:
    """Levels 0..max_level of an (H, W) image (level 0 = the image): one
    kernel launch for all its levels."""
    return build_pyramids((img,), max_level)[0]


def build_pyramids(images, max_level: int) -> List[List]:
    """The pyramids (levels 0..max_level) of one or two (H, W) images of one
    shape, e.g. the left and right frames of a stereo pair: one kernel
    launch for all their levels."""
    images = tuple(images)
    return [[img, *levels] for img, levels in zip(images, pyr_down_levels(images, max_level))]


def scharr_gradients(img):
    """(Ix, Iy) of an (H, W) image."""
    return scharr(img)
