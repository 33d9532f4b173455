"""Leader/follower/frame sample synchronization (host side): a copy of the
reference package's ``odometry/sample_sync.py``, the pure-Python
synchronizer (``VioApi`` runs the native one, ``io/native_sync.py``, where
the library builds).

Port of the reference SampleSync (reference: src/odometry/sample_sync.cpp):
gyroscope samples are the "leader" clock, accelerometer samples ("follower")
are matched by nearest timestamp, and camera frames attach to their nearest
leader sample. Handles out-of-order samples, sensors starting/stopping,
buffer-overflow culling, an optional smart frame-rate limiter, and the
EKF-estimated variable IMU-to-camera time shift.

This is IO-shape logic, not math, so it stays as plain Python on the host
(the reference keeps it on its input thread for the same reason); the device
side receives fixed-size IMU batches per frame assembled from this stream.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Optional

LEADER_FILL_RATIO = 5


@dataclass
class Sample:
    t: float
    p: tuple  # (x, y, z)


@dataclass
class ProcessedFrame:
    t: float
    num: int = 0
    leader_index: int = 0
    leader_time_diff: float = -1.0
    first_image: Any = None
    second_image: Any = None
    tag: Any = None
    intrinsics: Any = None  # per-frame (fx, fy, cx, cy[, coeffs]) or None


@dataclass
class SyncedSample:
    t: float  # leader timestamp
    l: tuple  # leader (gyro) sample
    tF: float  # follower timestamp
    f: tuple  # follower (acc) sample
    frame: Optional[ProcessedFrame] = None


class ThroughputCounter:
    """Events/second over a short sliding window (reference:
    src/odometry/util.hpp ThroughputCounter)."""

    def __init__(self, window: float = 2.0):
        self.window = window
        self.times: List[float] = []

    def put(self, t: float):
        self.times.append(t)
        t0 = t - self.window
        while self.times and self.times[0] < t0:
            self.times.pop(0)

    def throughput_per_second(self) -> float:
        if len(self.times) < 2:
            return 0.0
        dt = self.times[-1] - self.times[0]
        if dt <= 0:
            return 0.0
        return (len(self.times) - 1) / dt


class SampleSync:
    def __init__(self, po):
        self.po = po
        size = 100 + LEADER_FILL_RATIO * po.sampleSyncLag
        self.size = size
        self.sL: List[Sample] = [Sample(-1.0, (0, 0, 0)) for _ in range(size)]
        self.sF: List[Sample] = [Sample(-1.0, (0, 0, 0)) for _ in range(size)]
        self.availableL = [False] * size
        self.countL = 0
        self.countF = 0
        self.indexL = 0
        self.indexF = 0
        self.frames: List[ProcessedFrame] = []
        self.frame_count = 0
        self.variable_imu_to_camera_shift = 0.0
        self._in_tp = ThroughputCounter()
        self._out_tp = ThroughputCounter()

    # --- input ---

    def add_sample_leader(self, t: float, p) -> None:
        if self.countL < self.size:
            self.countL += 1
        else:
            # the slot being overwritten may have frames attached
            for i in range(len(self.frames) - 1, -1, -1):
                if self.frames[i].leader_index == self.indexL:
                    del self.frames[i]
        self.sL[self.indexL] = Sample(t, tuple(p))
        # re-match frames to the new leader if closer
        for fr in self.frames:
            dti = abs(t - fr.t)
            if dti < fr.leader_time_diff:
                fr.leader_index = self.indexL
                fr.leader_time_diff = dti
        self.availableL[self.indexL] = True
        self.indexL = (self.indexL + 1) % self.size

    def add_sample_follower(self, t: float, p) -> None:
        if self.countF < self.size:
            self.countF += 1
        self.sF[self.indexF] = Sample(t, tuple(p))
        self.indexF = (self.indexF + 1) % self.size

    def add_frame(self, t: float, first_image=None, second_image=None, tag=None,
                  intrinsics=None) -> None:
        shift = self.po.imuToCameraShiftSeconds
        if self.po.secondImuToCameraShiftSeconds != 0.0:
            # stereo frames share one timestamp, so per-camera shifts average
            # (reference: tracker/util.cpp:113-120)
            shift = 0.5 * (shift + self.po.secondImuToCameraShiftSeconds)
        t = t - shift - self.variable_imu_to_camera_shift

        if len(self.frames) >= self.po.sampleSyncFrameBufferSize:
            # heavy-handed culling: keep every 2nd (reference: cullBuffer)
            self.frames = self.frames[::2]

        frame = ProcessedFrame(t=t, first_image=first_image, second_image=second_image, tag=tag,
                               intrinsics=intrinsics)
        self.frame_count += 1
        frame.num = self.frame_count

        if self.po.sampleSyncSmartFrameRateLimiter:
            self._in_tp.put(t)
            if len(self.frames) > 2:
                itp = self._in_tp.throughput_per_second()
                otp = self._out_tp.throughput_per_second()
                if itp > 0.0 and otp > 0.0:
                    drop_frac = (1.0 - otp / itp) * 1.1
                    if drop_frac > 0.0:
                        n = int(math.ceil(1.0 / drop_frac))
                        if frame.num % n == 0:
                            self.frames.pop()
                            return

        # match to nearest available leader
        best, best_dt = -1, -1.0
        for i in range(self.size):
            if not self.availableL[i]:
                continue
            dti = abs(self.sL[i].t - frame.t)
            if best < 0 or dti < best_dt:
                best, best_dt = i, dti
        if best < 0:
            return  # frame before any leader samples: discard
        if self.frames and self.frames[-1].t == t:
            return  # duplicate timestamp
        frame.leader_index = best
        frame.leader_time_diff = best_dt
        self.frames.append(frame)

    # --- output ---

    def is_ready(self) -> bool:
        return (
            (not self.po.visualUpdateEnabled or len(self.frames) >= self.po.sampleSyncFrameCount)
            and self.countL >= self.po.sampleSyncLag
            and self.countF > 0
        )

    def poll_synced_sample(self) -> Optional[SyncedSample]:
        if not self.is_ready():
            return None
        # oldest leader sample
        idx, t = -1, 0.0
        for i in range(self.size):
            if self.availableL[i] and (idx < 0 or self.sL[i].t < t):
                idx, t = i, self.sL[i].t
        assert idx >= 0
        leader = self.sL[idx]
        self.sL[idx] = Sample(-1.0, leader.p)
        self.countL -= 1
        self.availableL[idx] = False

        # closest follower (reusable)
        fbest, fdt = -1, -1.0
        for i in range(self.countF):
            dti = abs(self.sF[i].t - leader.t)
            if fbest < 0 or dti < fdt:
                fbest, fdt = i, dti
        follower = self.sF[fbest]

        out = SyncedSample(t=leader.t, l=leader.p, tF=follower.t, f=follower.p)
        for i in range(len(self.frames) - 1, -1, -1):
            if self.frames[i].leader_index == idx:
                out.frame = self.frames[i]
                del self.frames[i]
        if self.po.sampleSyncSmartFrameRateLimiter and out.frame is not None:
            self._out_tp.put(out.t)
        return out

    def set_imu_to_camera_time_shift(self, t: float) -> None:
        self.variable_imu_to_camera_shift = t
