"""Image pyramids and Scharr gradients (port of the reference's
``frontend/pyramid.py``); the stencils are the kernels of ``ops.pyramid``."""
from __future__ import annotations

from typing import List

from ..ops.pyramid import pyr_down, scharr


def build_pyramid(img, max_level: int) -> List:
    """Levels 0..max_level of an (H, W) image (level 0 = the image)."""
    levels = [img]
    for _ in range(max_level):
        levels.append(pyr_down(levels[-1]))
    return levels


def scharr_gradients(img):
    """(Ix, Iy) of an (H, W) image."""
    return scharr(img)
