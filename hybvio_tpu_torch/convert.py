"""Carry state between the reference package and the port.

The system has no learned weights: its parameters are the camera
intrinsics and extrinsics, and its "weights" are the filter, trail and
tracker state. ``from_jax`` builds the port's cameras and state tuples from
the reference's, given as numpy trees (``jax.tree.map(np.asarray, ...)``);
``to_numpy`` goes back. Field names are the same in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from .ekf.state import EKFState
from .frontend.tracker import TrackerOutput, TrackerState
from .geometry.cameras import FISHEYE, PINHOLE, Camera, build_pinhole
from .odometry.backend import BackendState, FrameOutput, ImuBatch, TrackerInput
from .odometry.trail import TrailState
from .odometry.vio import VioState
from .runtime import default_device

_TYPES = {cls.__name__: cls for cls in (
    VioState, BackendState, EKFState, TrailState, TrackerState, TrackerInput,
    ImuBatch, FrameOutput, TrackerOutput)}


def camera_from_jax(cam) -> Camera:
    """Port camera from a reference ``Camera`` (arrays or numpy): the
    pinhole with its radial coefficients and rectification rotation, or the
    KB4 fisheye. The values are the reference's own, float32-rounded where
    its arrays are."""
    f = lambda a: float(np.asarray(a))
    if cam.kind == FISHEYE:
        return Camera(f(cam.fx), f(cam.fy), f(cam.cx), f(cam.cy), cam.width, cam.height,
                      kind=FISHEYE, coeffs=tuple(float(c) for c in np.asarray(cam.coeffs)),
                      max_valid_theta=f(cam.max_valid_theta), max_valid_r=f(cam.max_valid_r),
                      has_distortion=bool(cam.has_distortion))
    if cam.kind != PINHOLE:
        raise NotImplementedError(f"{cam.kind} camera")
    coeffs = tuple(float(c) for c in np.asarray(cam.coeffs)[:3]) if cam.has_distortion else ()
    return build_pinhole(f(cam.fx), f(cam.fy), f(cam.cx), f(cam.cy), coeffs=coeffs,
                         width=cam.width, height=cam.height,
                         rotation=np.asarray(cam.rot, np.float64) if cam.has_rotation else None)


def from_jax(tree, device=None):
    """Reference NamedTuples / tuples of numpy arrays -> port tensors, on the
    card unless ``device`` says otherwise. Threefry keys (uint32) become
    int64; other dtypes are kept."""
    if tree is None:
        return None
    if device is None:
        device = default_device()
    if hasattr(tree, "kind") and hasattr(tree, "fx"):
        return camera_from_jax(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = _TYPES[type(tree).__name__]
        return cls(*(from_jax(getattr(tree, f), device) for f in cls._fields))
    if isinstance(tree, (tuple, list)):
        return tuple(from_jax(x, device) for x in tree)
    arr = np.asarray(tree)
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    return torch.from_numpy(np.array(arr)).to(device)


def to_numpy(tree):
    """Port tensors -> the same NamedTuples of numpy arrays."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return tuple(to_numpy(x) for x in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree
