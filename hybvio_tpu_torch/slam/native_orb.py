"""ctypes bindings for the native (C++) multi-scale ORB keypoint detector
(port of the reference package's ``slam/native_orb.py``).

Same contract as ``slam/keypoints.make_multiscale_orb`` (the torch
detector): fn(image) -> (pts (N,2) level-0 xy, level (N,) int32, desc
(N,256) +/-1 float32, valid (N,)) as numpy arrays. The BRIEF pattern is
passed IN from ``slam/orb.py`` so native and torch descriptors sample
identical pairs. The image may be a tensor on any device (one copy to the
host) or a numpy array.

Why native: the SLAM worker runs at keyframe rate beside the VIO step and
shares its host; the torch detector is a few hundred small launches a
keyframe. The C++ detector (``native/orb_detect.cpp``, built by
``utils/native.py``) runs the same contract in milliseconds on the host,
as the reference's SLAM thread is native C++ for the same reason.
``HYBVIO_NATIVE_ORB=0`` turns it off (the reference's switch).
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils import native

_F32 = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {  # name -> (restype, argtypes)
    "orb_create": (ctypes.c_void_p, [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                                     ctypes.c_double, ctypes.c_double, ctypes.c_int,
                                     ctypes.c_int, _F32, _F32, ctypes.c_int]),
    "orb_destroy": (None, [ctypes.c_void_p]),
    "orb_capacity": (ctypes.c_int, [ctypes.c_void_p]),
    "orb_detect": (ctypes.c_int, [ctypes.c_void_p, _F32, _F32, ctypes.POINTER(ctypes.c_int32),
                                  ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_uint8)]),
}


def native_orb_available() -> bool:
    return (os.environ.get("HYBVIO_NATIVE_ORB", "1") != "0"
            and native.bind(_SIGNATURES) is not None)


class _Handle:
    """Owns one native detector for the lifetime of its closure."""

    def __init__(self, lib, handle):
        self.lib, self.handle = lib, handle

    def __del__(self):
        if self.handle:
            self.lib.orb_destroy(self.handle)
            self.handle = None


def make_native_orb(H: int, W: int, n_levels: int = 8,
                    scale_factor: float = 1.2, total_kps: int = 256,
                    thr_init: float = 20.0 / 255.0,
                    thr_min: float = 7.0 / 255.0, cell: int = 16):
    """Drop-in for keypoints.make_multiscale_orb backed by C++: (fn, N)."""
    lib = native.bind(_SIGNATURES)
    if lib is None:
        raise RuntimeError(f"the native library is unavailable: {native.unavailable_reason()}")
    from .orb import _PAIRS_A, _PAIRS_B, N_BITS

    pa = np.ascontiguousarray(_PAIRS_A, np.float32)
    pb = np.ascontiguousarray(_PAIRS_B, np.float32)
    holder = _Handle(lib, lib.orb_create(H, W, n_levels, float(scale_factor), float(thr_init),
                                         float(thr_min), int(total_kps), int(cell),
                                         pa.ctypes.data_as(_F32), pb.ctypes.data_as(_F32),
                                         N_BITS))
    N = lib.orb_capacity(holder.handle)

    def detect(img):
        if hasattr(img, "detach"):  # a tensor, on any device
            img = img.detach().cpu().numpy()
        img = np.ascontiguousarray(img, np.float32)
        if img.shape != (H, W):
            raise ValueError(f"image shape {img.shape}, detector built for {(H, W)}")
        pts = np.empty((N, 2), np.float32)
        lvl = np.empty((N,), np.int32)
        desc = np.empty((N, N_BITS), np.int8)
        ok = np.empty((N,), np.uint8)
        lib.orb_detect(
            holder.handle, img.ctypes.data_as(_F32), pts.ctypes.data_as(_F32),
            lvl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            desc.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return pts, lvl, desc.astype(np.float32), ok.astype(bool)

    return detect, N
