"""Odometry <-> SLAM coupling: asynchronous submission + coordinate
transform (port of the reference package's ``odometry/slam_coupling.py``).

Port of the backend's SLAM glue (reference: backend.cpp:32-96
SlamOdometryCoordinateTransformer, 399-539 applySlam/applySlamResult):
every keyframeCandidateInterval-th keyframe is pushed to the SLAM session
(on its own worker thread when slam.slamThread); the result is consumed
delayIntervalMultiplier intervals later; a rigid odometry->SLAM transform is
re-anchored from each (odometry pose, SLAM pose) pair and applied to all
outputs thereafter.

Device and streams: the session runs on the coupling's device (the card
unless the caller asks for the CPU). A frame on the card is quantized to
uint8 on the caller's stream into a tensor of the coupling's own (the
caller's frame buffers are reused once their frame retires), and an event
is recorded after it; the worker runs on a CUDA stream of its own, which
waits on that event before it reads the frame, so the session's work
overlaps the next VIO steps. On the card the quantizer and the worker's
``ray_to_pixel`` run as captured CUDA graphs (``graphs.CapturedStep``, as
the reference jits both): the quantizer in the VIO steps' pools (it replays
on the caller's stream, between the steps), ``ray_to_pixel`` in the
session's (it replays on the worker's stream).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..geometry import cameras
from ..graphs import CapturedStep, capturing_into
from ..runtime import default_device
from ..slam.host import np_quat_to_rmat, np_rmat_to_quat
from ..slam.session import Slam
from ..utils import timer


def _np_remove_z_tilt(R):
    rotated_x = R[:, 0]
    a = np.arctan2(rotated_x[1], rotated_x[0])
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


class SlamOdometryCoordinateTransformer:
    """Maintains world_odo -> world_slam rigid transform
    (reference: backend.cpp:32-96)."""

    def __init__(self, remove_z_tilt: bool = True):
        self.T = np.eye(4)
        self.ready = False
        self.remove_z_tilt = remove_z_tilt

    def set_coordinates(self, odo_cw: np.ndarray, slam_cw: np.ndarray) -> None:
        """Re-anchor so that T @ odo_cw == slam_cw (reference: setCoordinates)."""
        T = slam_cw @ np.linalg.inv(odo_cw)
        if self.remove_z_tilt:
            Rxy = _np_remove_z_tilt(T[:3, :3])
            # keep the anchor point fixed: T' p_anchor = T p_anchor
            p = odo_cw[:3, 3]
            t_new = (T[:3, :3] @ p + T[:3, 3]) - Rxy @ p
            T = np.eye(4)
            T[:3, :3] = Rxy
            T[:3, 3] = t_new
        self.T = T
        self.ready = True

    def transform_pose_cw(self, odo_cw: np.ndarray) -> np.ndarray:
        return self.T @ odo_cw if self.ready else odo_cw

    def transform_point(self, p: np.ndarray) -> np.ndarray:
        if not self.ready:
            return p
        return self.T[:3, :3] @ p + self.T[:3, 3]

    def transform_position_orientation(self, pos, quat):
        if not self.ready:
            return pos, quat
        R = self.T[:3, :3]
        p = R @ np.asarray(pos) + self.T[:3, 3]
        Rq = np_quat_to_rmat(np.asarray(quat))  # world->imu
        q = np_rmat_to_quat(Rq @ R.T)
        return p, q


@dataclasses.dataclass
class _Pending:
    future: "concurrent.futures.Future"
    odo_cw: np.ndarray
    frame: float = None  # the recorder's frame id (the frame's time)
    submit_ns: int = None  # the recorder's clock at the submission, while it is on


def quantize_u8(image: torch.Tensor) -> torch.Tensor:
    """A float frame in [0, 1] as uint8 levels (the reference's
    ``(clip(x, 0, 1) * 255 + 0.5).astype(uint8)``), in a new tensor."""
    return (torch.clamp(image, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


class SlamCoupling:
    """Drives the Slam session at the reference cadence with async results,
    on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, params, imu_to_camera: np.ndarray, use_thread: Optional[bool] = None,
                 camera=None, device=None):
        ps = params.slam
        self.ps = ps
        self.device = torch.device(device) if device is not None else default_device()
        self.slam = Slam(params, device=self.device)
        self._quantize_u8 = CapturedStep(quantize_u8, "slam uint8 quantizer")
        with capturing_into(self.slam.graph_pools):
            self._ray_to_pixel = CapturedStep(cameras.ray_to_pixel, "slam ray_to_pixel")
        self.i2c = np.asarray(imu_to_camera)
        # the real camera model: ORB descriptor patches go to the TRUE pixel
        # positions of the tracker features (a nominal-focal reconstruction
        # is wrong across most of a fisheye FOV)
        self.camera = camera
        self.interval = max(int(ps.keyframeCandidateInterval), 1)
        self.delay_mult = ps.delayIntervalMultiplier
        self.coord = SlamOdometryCoordinateTransformer(ps.removeOdometryTransformZAxisTilt)
        self.frame_counter = 0
        self.pending: List[_Pending] = []
        use_thread = ps.slamThread if use_thread is None else use_thread
        self.pool = (concurrent.futures.ThreadPoolExecutor(max_workers=1)
                     if use_thread else None)
        self.stream = (torch.cuda.Stream(self.device)
                       if use_thread and self.device.type == "cuda" else None)
        self.point_cloud: List[Tuple[int, int, np.ndarray]] = []
        # backlog policy: with the async worker, ingestion NEVER blocks on
        # SLAM (reference contract: real-time odometry with an async SLAM
        # thread, backend.cpp:507-518). If the worker falls behind by more
        # than max_backlog submissions past the delay contract, new keyframe
        # candidates are DROPPED — the analog of sample sync's smart frame
        # limiter (reference: sample_sync.cpp:140-162) — and counted.
        self.max_backlog = 2
        self.dropped = 0

    def _project_pixels(self, norm_pts: np.ndarray) -> np.ndarray:
        """Normalized points -> pixels through the REAL camera model
        (reference: the SLAM module samples ORB on the distorted image at the
        feature's actual pixel), float32 on the coupling's device, padded to
        the reference's static count."""
        n = len(norm_pts)
        P = 256
        while P < n:
            P *= 2
        rays = np.ones((P, 3), np.float32)
        rays[:n, :2] = norm_pts
        pix, _ok = self._ray_to_pixel(self.camera, torch.as_tensor(rays).to(self.device))
        return pix.cpu().numpy()[:n]

    def imu_pose_to_camera_cw(self, pos, quat) -> np.ndarray:
        """IMU pose (world->imu q) -> camera-to-world 4x4."""
        R = np_quat_to_rmat(np.asarray(quat))  # world -> imu
        w2c = self.i2c[:3, :3] @ R
        t = -w2c @ np.asarray(pos) + self.i2c[:3, 3]
        T = np.eye(4)
        T[:3, :3] = w2c.T
        T[:3, 3] = -w2c.T @ t
        return T

    def _frame_for_worker(self, image):
        """(frame, event): a frame tensor the worker owns — a float frame
        quantized to uint8 (the SLAM pipeline consumes 8-bit gray, as the
        reference's does, image.cpp:345-367), an integer one copied — and
        the CUDA event after which the worker may read it (None off the
        card). A numpy frame passes as it is."""
        if not isinstance(image, torch.Tensor):
            return image, None
        frame = self._quantize_u8(image) if image.is_floating_point() else image.clone()
        if self.stream is None or not frame.is_cuda:
            return frame, None
        frame.record_stream(self.stream)  # the worker's stream uses it last
        event = torch.cuda.Event()
        event.record()
        return frame, event

    def maybe_submit(self, image, pos, quat, track_ids, norm_pts, t, frame_num) -> bool:
        """Call on every KEYFRAME (reference: applySlam); submits every
        interval-th. ``image``: the frame (H, W), a tensor on any device or a
        numpy array. Returns True if a slam frame was submitted.

        The span recorder: every interval-th keyframe counts in
        ``slam.candidates``, then in ``slam.submitted`` or ``slam.dropped``;
        the ``slam.submit`` span covers the consumption of due results, the
        quantization and the enqueue; a submitted frame's ``slam.queue``
        runs to the worker's start, its ``slam.frame`` span over the
        worker's work (the session's stages its children), and its
        ``slam.pending`` to its result's consumption. The frame id is the
        frame's time."""
        self.frame_counter += 1
        if (self.frame_counter - 1) % self.interval != 0:
            return False
        timer.count("slam.candidates")
        with timer.span("slam.submit", frame=float(t)):
            return self._submit(image, pos, quat, track_ids, norm_pts, t, frame_num)

    def _submit(self, image, pos, quat, track_ids, norm_pts, t, frame_num) -> bool:
        odo_cw = self.imu_pose_to_camera_cw(pos, quat)

        # consume delayed results first (reference: backend.cpp:405-434)
        max_pending = max(self.delay_mult, 0)
        if self.delay_mult < 0:
            # synchronous contract (delayIntervalMultiplier < 0,
            # backend.cpp:416,514-517): block for every result
            while self.pending:
                self._consume(self.pending.pop(0))
        else:
            # async contract: consume results past their delay that are
            # READY; never stall frame ingestion on the SLAM worker
            while len(self.pending) > max_pending and (
                    self.pool is None or self.pending[0].future.done()):
                self._consume(self.pending.pop(0))
            if len(self.pending) > max_pending + self.max_backlog:
                self.dropped += 1
                timer.count("slam.dropped")
                return False

        # after the drop check: a dropped candidate costs no quantization
        image, event = self._frame_for_worker(image)
        submit_ns = timer.now_ns() if timer.recording() else None

        def work(img=image, ev=event, ocw=odo_cw, ids=np.array(track_ids),
                 pts=np.array(norm_pts), tt=float(t), fn=int(frame_num)):
            if submit_ns is not None:
                timer.interval("slam.queue", submit_ns, timer.now_ns(), frame=tt)
            with timer.span("slam.frame", frame=tt):
                return self._work(img, ev, ocw, ids, pts, tt, fn)

        if self.pool is not None:
            fut = self.pool.submit(self._on_worker_stream, work)
        else:
            fut = concurrent.futures.Future()
            fut.set_result(work())
        self.pending.append(_Pending(fut, odo_cw, float(t), submit_ns))
        timer.count("slam.submitted")
        return True

    def _work(self, img, ev, ocw, ids, pts, tt, fn):
        """The worker's part of a submitted frame: the frame as the session
        takes it, its features' pixels, ``Slam.add_frame``."""
        sel = ids >= 0
        if img is not None:
            if ev is not None:
                torch.cuda.current_stream().wait_event(ev)
            # integer frames are raw 0-255; the SLAM detectors and
            # descriptors take [0, 1]
            if isinstance(img, torch.Tensor):
                img = (img.to(torch.float32) / 255.0 if not img.is_floating_point()
                       else img.to(torch.float32))
            else:
                raw = np.asarray(img)
                img = (raw.astype(np.float32) / 255.0 if raw.dtype.kind in "ui"
                       else np.asarray(raw, np.float32))
        pix = self._project_pixels(pts[sel]) if self.camera is not None else None
        return self.slam.add_frame(img, ocw, ids[sel], pts[sel], tt, fn, pix_pts=pix), ocw

    def _on_worker_stream(self, work):
        if self.stream is None:
            return work()
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            return work()

    def _consume(self, pending: _Pending) -> None:
        result, odo_cw = pending.future.result()
        if pending.submit_ns is not None:
            timer.interval("slam.pending", pending.submit_ns, timer.now_ns(), frame=pending.frame)
        self.coord.set_coordinates(odo_cw, result.pose_cw)
        self.point_cloud = result.point_cloud

    def wait_idle(self) -> None:
        """Block until every submitted frame's session work has run (its
        result stays pending until its delay has passed)."""
        for p in self.pending:
            p.future.result()
        if self.stream is not None:
            self.stream.synchronize()

    def finish(self, map_save_path=None) -> None:
        while self.pending:
            self._consume(self.pending.pop(0))
        self.slam.end(map_save_path=map_save_path)
        if self.pool is not None:
            self.pool.shutdown(wait=True)
