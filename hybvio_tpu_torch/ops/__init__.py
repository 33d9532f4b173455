"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper runs its kernel for CUDA tensors (or raises) and its plain
version only for CPU tensors; ``_lib.LAUNCHES`` counts kernel launches.
"""
from ._lib import LAUNCHES, SHAPE_LAUNCHES, build, launch_empty, reset_launch_counts  # noqa: F401
from .gftt import corner_response, corner_response_plain  # noqa: F401
from .nms import greedy_min_distance, greedy_min_distance_plain  # noqa: F401
from .patch_gather import gather_patches, gather_patches_plain  # noqa: F401
from .pyramid import (pyr_down, pyr_down_levels, pyr_down_levels_plain,  # noqa: F401
                      pyr_down_plain, pyramid_with_gradients, pyramid_with_gradients_plain,
                      scharr, scharr_plain)
