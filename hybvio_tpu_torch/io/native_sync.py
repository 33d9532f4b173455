"""ctypes bindings for the native (C++) sample synchronizer (port of the
reference package's ``io/native_sync.py``).

The native library (``native/sample_sync.cpp``, built by
``utils/native.py``) implements the same leader/follower/frame pairing as
``odometry/sample_sync.py`` (reference semantics:
src/odometry/sample_sync.cpp); this wrapper keeps the frame payloads (the
host or device images) on the Python side, passing only integer handles
through the C ABI. ``VioApi`` takes the Python synchronizer where the
library does not load, as the reference does, and logs why.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

from ..odometry.sample_sync import ProcessedFrame, SyncedSample
from ..utils import native

_D3 = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {  # name -> (restype, argtypes)
    "sample_sync_create": (ctypes.c_void_p, [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_double]),
    "sample_sync_destroy": (None, [ctypes.c_void_p]),
    "sample_sync_add_leader": (None, [ctypes.c_void_p, ctypes.c_double, _D3]),
    "sample_sync_add_follower": (None, [ctypes.c_void_p, ctypes.c_double, _D3]),
    "sample_sync_add_frame": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_double, ctypes.c_int64]),
    "sample_sync_set_time_shift": (None, [ctypes.c_void_p, ctypes.c_double]),
    "sample_sync_poll": (ctypes.c_int, [ctypes.c_void_p, _D3, _D3, _D3, _D3,
                                        ctypes.POINTER(ctypes.c_int64),
                                        ctypes.POINTER(ctypes.c_int64), _D3]),
    "sample_sync_frame_queue_size": (ctypes.c_int, [ctypes.c_void_p]),
}


def native_available() -> bool:
    return native.bind(_SIGNATURES) is not None


class NativeSampleSync:
    """Drop-in replacement for odometry.sample_sync.SampleSync backed by C++."""

    def __init__(self, po):
        lib = native.bind(_SIGNATURES)
        if lib is None:
            raise RuntimeError(f"the native library is unavailable: {native.unavailable_reason()}")
        self._lib = lib
        self._h = lib.sample_sync_create(
            int(po.sampleSyncLag), int(po.sampleSyncFrameBufferSize),
            int(po.sampleSyncFrameCount), 1 if po.visualUpdateEnabled else 0,
            float(po.imuToCameraShiftSeconds))
        self._frames: Dict[int, ProcessedFrame] = {}
        self._next_handle = 1

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.sample_sync_destroy(h)

    @staticmethod
    def _vec(v):
        return (ctypes.c_double * 3)(float(v[0]), float(v[1]), float(v[2]))

    def add_sample_leader(self, t, p):
        self._lib.sample_sync_add_leader(self._h, float(t), self._vec(p))

    def add_sample_follower(self, t, p):
        self._lib.sample_sync_add_follower(self._h, float(t), self._vec(p))

    def add_frame(self, t, first_image=None, second_image=None, tag=None, intrinsics=None):
        handle = self._next_handle
        self._next_handle += 1
        fr = ProcessedFrame(t=float(t), first_image=first_image, second_image=second_image,
                            tag=tag, intrinsics=intrinsics)
        if self._lib.sample_sync_add_frame(self._h, float(t), handle):
            self._frames[handle] = fr
        # drop stale payloads if the native side culled its queue
        qn = self._lib.sample_sync_frame_queue_size(self._h)
        if len(self._frames) > max(qn * 2, 16):
            keep = sorted(self._frames)[-max(qn * 2, 16):]
            self._frames = {k: self._frames[k] for k in keep}

    def set_imu_to_camera_time_shift(self, t):
        self._lib.sample_sync_set_time_shift(self._h, float(t))

    def poll_synced_sample(self) -> Optional[SyncedSample]:
        t, tF, ft = ctypes.c_double(), ctypes.c_double(), ctypes.c_double()
        gyro, acc = (ctypes.c_double * 3)(), (ctypes.c_double * 3)()
        fh, fn = ctypes.c_int64(), ctypes.c_int64()
        ok = self._lib.sample_sync_poll(
            self._h, ctypes.byref(t), gyro, ctypes.byref(tF), acc,
            ctypes.byref(fh), ctypes.byref(fn), ctypes.byref(ft))
        if not ok:
            return None
        out = SyncedSample(t=t.value, l=tuple(gyro), tF=tF.value, f=tuple(acc))
        if fh.value >= 0:
            fr = self._frames.pop(fh.value, None)
            if fr is not None:
                fr.num = int(fn.value)
                fr.t = ft.value
                out.frame = fr
        return out
