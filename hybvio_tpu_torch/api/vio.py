"""Public VIO API: thread-safe sample ingestion -> outputs via callback
(port of the reference package's ``api/vio.py``).

Port of the reference public API + control layer (reference: src/api/vio.hpp
VioApi, src/odometry/control.cpp Control): add_gyro / add_acc /
add_frame_mono / add_frame_stereo feed a SampleSync; synced samples drain into
the VIO step on the card; tracking-status-driven auto-reset (retry-until-init,
reset-keeping-pose on LOST_TRACKING, timed re-init) wraps the session like the
reference Control; outputs are delivered through on_output.

Host/device split: SampleSync and the reset state machine stay on the host;
everything per frame runs as the port's batch-first ``Vio.step`` at one lane
(B = 1). Frames ride pooled pinned host buffers and IMU samples one pinned
(S, 7) batch per frame, each copied to the card without blocking the host;
each frame's output comes back in one packed copy into pinned memory,
retired one frame late (after the next frame's step is queued), so the host
never waits on the card inside a step.

With ``slam.useSlam`` the SLAM session (``odometry/slam_coupling.py``,
``slam/``) runs on the API's device beside the step: every keyframe's
output submits its frame, quantized to uint8 on the card, and every
output is corrected by the SLAM map's transform, with the map's points
merged into its cloud (negative ids); ``finish`` runs the final global
adjustment and saves the map.

With ``tracker.computeStereoPointCloud`` every output's cloud also holds
the strided dense-disparity cloud of the last stereo pair (id -2), from a
rectification built once and kept on the device; with dense stereo depth on
the tracks (``computeDenseStereoDepth``) their depth points join it under
the tracks' ids. GPS echoes (``gps`` / ``rtkgps``) land in the pose
histories in a local ENU frame (``utils/gps.py``).

Per-frame intrinsics (``add_frame_mono_varying``, mono) ride each frame's
packed IMU copy to the card (no blocking copy), where they become the
step's first camera (``geometry.cameras.with_intrinsics``). With
``odometry.useSquareRootEkf`` the filter carries the square-root factor of
its covariance (``ekf/sqrt.py``), the state surgery included.

Not ported (each raises ``NotImplementedError`` naming its module when asked
for): the visualizations (``api/visualizations.py``), the debug publisher
(``odometry/debug.py``) and the native synchronizer (``io/native_sync.py``).
"""
from __future__ import annotations

import collections
import dataclasses
import os
import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import random as jr
from ..config import DerivedParameters, Parameters
from ..config.loader import load_parameters
from ..ekf import ORI, POS, condition_on_last_pose as _condition, initialize_orientation
from ..ekf import lock_biases as _lock_biases, transform_to
from ..geometry.cameras import build_camera_from_params, with_intrinsics
from ..io.jsonl import Recorder, output_to_json
from ..odometry.backend import FrameOutput, ImuBatch
from ..odometry.sample_sync import SampleSync, SyncedSample
from ..runtime import (IMAGE_DTYPE, constant, default_device, filter_dtype, full_precision,
                       hold_precision, release_precision)
from ..utils.allocator import Allocator
from ..utils.timer import TimeStats, wait_for

GRAVITY_UP = (0.0, 0.0, 9.819)

_NUMPY_DTYPE = {torch.float64: np.float64, torch.float32: np.float32, torch.int32: np.int32,
                torch.int64: np.int64, torch.bool: np.bool_, torch.uint8: np.uint8}


@dataclasses.dataclass
class VioOutput:
    status: int
    t: float
    position: np.ndarray
    orientation: np.ndarray
    velocity: np.ndarray
    position_covariance: np.ndarray
    point_cloud: np.ndarray  # (N, 4): id, x, y, z
    pose_trail: Optional[np.ndarray] = None  # (L, 8): t, p(3), q(4)
    bias_gyro: Optional[np.ndarray] = None
    bias_acc: Optional[np.ndarray] = None
    stationary_visual: bool = False
    velocity_covariance: Optional[np.ndarray] = None
    bias_covariance_diagonal: Optional[np.ndarray] = None  # (9,) BGA+BAA+BAT

    def as_json(self, with_trail: bool = False, extras: Optional[dict] = None) -> str:
        trail = None
        if with_trail and self.pose_trail is not None:
            trail = self.pose_trail[:, 1:]
        return output_to_json(self.t, self.position, self.orientation,
                              self.velocity, trail, extras)


class _Fetch(collections.namedtuple("_Fetch", "host event layout aux")):
    """One frame's output on its way to the host: the pinned byte buffer,
    the CUDA event recorded after its copy (None on the CPU), the fields'
    (numpy dtype, shape, byte offset, byte count), the frame's images (as
    given, and the first as the step took it, (1, H, W) on the device)."""


def _pack(out: FrameOutput):
    """(bytes, layout): every field of lane 0 of ``out`` as raw bytes in one
    tensor on its device (one concatenation), and how to unpack it."""
    parts, layout, offset = [], [], 0
    for f in out:
        f = f[0]
        b = f.reshape(-1).contiguous().view(torch.uint8)
        parts.append(b)
        layout.append((_NUMPY_DTYPE[f.dtype], tuple(f.shape), offset, b.numel()))
        offset += b.numel()
    return torch.cat(parts), layout


def _unpack(raw: np.ndarray, layout) -> FrameOutput:
    """The host FrameOutput (numpy, no lane axis) from packed bytes."""
    return FrameOutput(*(raw[o:o + n].view(dt).reshape(shape).copy()
                         for dt, shape, o, n in layout))


class VioApi:
    """Build with build_vio(); feed samples; read outputs via on_output.

    Runs on the card unless ``device`` is "cpu"; ``dtype`` (the filter's)
    defaults to ``runtime.filter_dtype(device)``: float64 on the CPU (as the
    reference API under x64), float32 on the card."""

    def __init__(self, params: Parameters, width: int, height: int,
                 dtype=None, max_imu_per_frame: int = 64,
                 recording_only: bool = False,
                 native_sync: Optional[bool] = None, device=None):
        from ..odometry.vio import Vio

        self.device = torch.device(device) if device is not None else default_device()
        if self.device.type == "cuda":
            default_device()  # raises without a card
        # record inputs without running the algorithm (reference:
        # DebugParameters::recordingOnly, internal.hpp:113-115 — the control
        # pipeline is never built and every add* returns after recording,
        # api.cpp:80,119,420,542,585)
        self.recording_only = bool(recording_only)
        self.params = params
        self.derived = DerivedParameters.from_parameters(params)
        self.width, self.height = width, height
        self._dtype = filter_dtype(self.device) if dtype is None else dtype
        # the P field holds the square-root factor W (ekf/sqrt.py)
        self._sqrt_mode = bool(getattr(params.odometry, "useSquareRootEkf", False))
        cams = [build_camera_from_params(params.tracker, width, height)]
        if params.tracker.useStereo:
            cams.append(build_camera_from_params(params.tracker, width, height, second=True))
        self.cameras = tuple(cams)

        self._vio = None
        if not self.recording_only:
            self._vio = Vio(params, self.derived, self.cameras, dtype=self._dtype).to(self.device)

        # sample synchronizer: the pure-Python one (the reference's
        # native_sync=False); its native binding is not ported
        if native_sync:
            raise NotImplementedError("native_sync: io/native_sync.py is not ported")
        self.sample_sync = SampleSync(params.odometry)
        self.on_output: Optional[Callable[[VioOutput], None]] = None
        self.recorder: Optional[Recorder] = None
        self._lock = threading.Lock()

        # -timer profiling (reference: util/timer.hpp TIME_STATS; enabled by
        # the CLI -timer flag)
        self.time_stats = TimeStats(enabled=False)
        # per-track visual-update outcome counters (reference:
        # odometry.printVisualUpdateStats -> VisualUpdateStats,
        # visual_update_stats.hpp:9-40, printed per frame + totals)
        from ..odometry.stats import VisualUpdateStats

        self.vu_stats = VisualUpdateStats(
            enabled=bool(params.odometry.printVisualUpdateStats))
        # pose histories: method name -> [(t, x, y, z), ...]
        # (reference: api.cpp:287-305,447-489 ARKit/ARCore ingestion)
        self.pose_histories: dict = {}
        self._gps_converter = None  # utils/gps.py, at the first GPS echo
        self._display_rectify = None  # the point cloud's rectification, at its first use
        self._frozen: Optional[tuple] = None  # freezeOnFailedTracking

        self._state = None
        self._pending_imu: List = []
        self.S = max_imu_per_frame
        # pooled gray-frame buffers for _to_gray (reference: util::Allocator),
        # pinned on the card's host so their copies to the card do not block.
        # A buffer is reused once nothing else references it: the sample
        # sync, the frame in flight and the last images hold theirs until
        # the frame is retired, after its copy has run.
        pin = self.device.type == "cuda"
        self._gray_pool = Allocator(
            lambda: torch.empty((height, width), dtype=torch.float32, pin_memory=pin), max_size=64)
        # 8-bit frames ride a separate pool and stay uint8 until the card
        # (4x smaller copy; the step normalizes on the card)
        self._u8_pool = Allocator(
            lambda: torch.empty((height, width), dtype=torch.uint8, pin_memory=pin), max_size=64)
        self._status = 0
        self._last_reset_time = 0.0
        self.last_frame_output = None
        self._last_images: tuple = (None, None)
        self._stage_probes = None  # built on first -timer frame
        self._frame_count = 0
        # pipelined output retirement: queue frame N's step before fetching
        # frame N-1's output, so the card's work and the copy back overlap
        # the host's (the analog of the reference's input-thread /
        # odometry-thread pipeline, api.cpp:1019). Depth 0 = fully
        # synchronous (forced for -timer sessions). Host-side consumers
        # (status machine, on_output) see each output exactly once, one
        # frame late; finish()/wait_idle() flush the tail.
        self._inflight = collections.deque()
        env_depth = os.environ.get("HYBVIO_PIPELINE_DEPTH")
        self._pipeline_depth = (int(env_depth) if env_depth is not None
                                else (0 if recording_only else 1))

        # latency-smoothing output buffer (reference: api::OutputBuffer,
        # output_buffer.hpp; active when targetOutputDelaySeconds > 0)
        self.output_buffer = None
        if params.odometry.targetOutputDelaySeconds > 0:
            from .output_buffer import OutputBuffer

            self.output_buffer = OutputBuffer(
                params.odometry.targetOutputDelaySeconds)

        # optional odometry worker thread (reference: processingQueueSize)
        self._queue = None
        self._worker = None
        if params.odometry.processingQueueSize > 0:
            self._start_worker(params.odometry.processingQueueSize)

        # optional async SLAM backend (reference: slam.useSlam + applySlam),
        # on the API's device; the precision policy holds for its worker
        # thread until finish()
        self.slam = None
        self._slam_running = False
        if params.slam.useSlam and not self.recording_only:
            from ..odometry.slam_coupling import SlamCoupling

            self.slam = SlamCoupling(params, self.derived.imu_to_camera,
                                     camera=self.cameras[0], device=self.device)
            self._slam_running = True
            hold_precision()

    @property
    def debug_api(self):
        """The debug publisher's API (reference: odometry/debug.py): not
        ported, so never set."""
        return None

    @debug_api.setter
    def debug_api(self, value):
        if value is not None:
            raise NotImplementedError("debug_api: the debug publisher (odometry/debug.py) is "
                                      "not ported")

    # --- input (reference: VioApi::addGyro/addAcc/addFrame*) ---

    def add_gyro(self, t: float, xyz) -> None:
        with self._lock:
            if self.recorder:
                self.recorder.gyro(t, xyz)
            if self.recording_only:
                return  # (reference: api.cpp:119)
            self.sample_sync.add_sample_leader(t, xyz)
        self.process_pending()

    def add_acc(self, t: float, xyz) -> None:
        with self._lock:
            if self.recorder:
                self.recorder.acc(t, xyz)
            if self.recording_only:
                return
            self.sample_sync.add_sample_follower(t, xyz)

    def _to_gray(self, image):
        """A frame as the step takes it: a CUDA tensor passes straight
        through (the analog of the reference's GPU-texture ingestion,
        addFrameMonoOpenGl, internal.hpp:216-244: the caller already owns a
        buffer on the card); anything else becomes gray and is copied into a
        pooled host buffer (pinned for the card), so the caller may reuse
        its frame buffer at once: uint8 stays uint8 (4x smaller copy; the
        step normalizes on the card), other dtypes become float32."""
        if isinstance(image, torch.Tensor) and image.is_cuda and image.dim() == 2:
            if image.dtype == torch.float32 or not image.is_floating_point():
                return image
            return image.to(torch.float32)
        a = np.asarray(image)
        if a.ndim == 3 and a.shape[-1] in (3, 4):
            # color input -> reference luma conversion (image.cpp:345-367)
            from ..frontend.image_utils import rgb_to_gray

            a = rgb_to_gray(a[..., :3])
        pool = self._u8_pool if a.dtype == np.uint8 else self._gray_pool
        if a.shape == (self.height, self.width):
            buf = pool.next()
            np.copyto(buf.numpy(), a, casting="unsafe")
            return buf
        return torch.from_numpy(a.copy() if a.dtype == np.uint8 else a.astype(np.float32))

    def add_frame_mono(self, t: float, image) -> None:
        with self._lock:
            if self.recorder:
                self.recorder.frame(t, [image])
            if self.recording_only:
                return  # (reference: api.cpp:542,585)
            self.sample_sync.add_frame(t, first_image=self._to_gray(image))

    def add_frame_mono_varying(self, t: float, image, intrinsics) -> None:
        """Mono frame with per-frame intrinsics (reference:
        InternalAPI::addFrameMonoVarying, internal.hpp:216-230: an autofocus
        or zooming lens). ``intrinsics``: a dict with focalLengthX /
        focalLengthY / principalPointX / principalPointY (the JSONL
        cameraParameters spelling, optionally distortionCoefficients) or a
        (fx, fy[, cx, cy[, coeffs]]) sequence; a principal point <= 0 is the
        session camera's."""
        if self.params.tracker.useStereo:
            raise ValueError("varying intrinsics are supported for mono only")
        intr = self._normalize_intrinsics(intrinsics)
        with self._lock:
            if self.recorder:
                self.recorder.frame(t, [image], camera_params=[{
                    "focalLengthX": intr[0], "focalLengthY": intr[1],
                    "principalPointX": intr[2], "principalPointY": intr[3]}])
            if self.recording_only:
                return
            self.sample_sync.add_frame(t, first_image=self._to_gray(image), intrinsics=intr)

    def _normalize_intrinsics(self, intrinsics):
        """-> (fx, fy, cx, cy, coeffs or None) floats."""
        if isinstance(intrinsics, dict):
            fx = intrinsics.get("focalLengthX", intrinsics.get("fx", -1.0))
            fy = intrinsics.get("focalLengthY", intrinsics.get("fy", fx))
            cx = intrinsics.get("principalPointX", intrinsics.get("cx", -1.0))
            cy = intrinsics.get("principalPointY", intrinsics.get("cy", -1.0))
            coeffs = intrinsics.get("distortionCoefficients", intrinsics.get("coeffs"))
        else:
            seq = list(intrinsics)
            fx = seq[0]
            fy = seq[1] if len(seq) > 1 else fx
            cx = seq[2] if len(seq) > 2 else -1.0
            cy = seq[3] if len(seq) > 3 else -1.0
            coeffs = seq[4] if len(seq) > 4 else None
        if fx <= 0:
            raise ValueError("varying intrinsics need a positive focal length")
        if fy <= 0:
            fy = fx
        base = self.cameras[0]
        if cx <= 0:
            cx = base.cx
        if cy <= 0:
            cy = base.cy
        return (float(fx), float(fy), float(cx), float(cy),
                tuple(float(c) for c in coeffs) if coeffs is not None else None)

    def add_frame_stereo(self, t: float, first, second) -> None:
        with self._lock:
            if self.recorder:
                self.recorder.frame(t, [first, second])
            if self.recording_only:
                return
            self.sample_sync.add_frame(t, first_image=self._to_gray(first),
                                       second_image=self._to_gray(second))

    def add_echo(self, raw: dict) -> None:
        """Ingest an auxiliary pose line from the input (groundTruth / ARKit /
        arcore / realsense / gps / rtkgps; reference: api.cpp:287-305,447-489)
        for pose overlays; GPS is converted WGS84 -> local ENU."""
        t = raw.get("time", 0.0)
        for name in ("groundTruth", "ARKit", "arcore", "arengine", "realsense",
                     "output", "zed"):
            d = raw.get(name)
            if isinstance(d, dict) and "position" in d:
                p = d["position"]
                self.pose_histories.setdefault(name, []).append(
                    (t, p.get("x", 0.0), p.get("y", 0.0), p.get("z", 0.0)))
                return
        for name in ("gps", "rtkgps"):
            d = raw.get(name)
            if isinstance(d, dict) and "latitude" in d:
                if self._gps_converter is None:
                    from ..utils.gps import GpsToLocalConverter

                    self._gps_converter = GpsToLocalConverter()
                xyz = self._gps_converter.convert(
                    d["latitude"], d["longitude"], d.get("altitude", 0.0))
                self.pose_histories.setdefault(name, []).append((t, xyz[0], xyz[1], xyz[2]))
                return

    def finish(self, slam_map_poses_path=None) -> None:
        """Drain the worker, retire every output in flight, flush the output
        buffer, flush the SLAM session and run its final global adjustment
        (reference: slam::Slam::end() via main.cpp teardown;
        ``slam_map_poses_path`` saves the keyframe map), and close the
        recorder."""
        if self._queue is not None:
            self._queue.join()
            self._queue.put(None)
            self._worker.join(timeout=30)
            self._queue = None
        self._flush_pipeline()
        if self.output_buffer is not None and self.on_output:
            # drain outputs still held for their scheduled emit time
            while self.output_buffer.buf:
                self.on_output(self.output_buffer.buf.popleft())
        if self.slam is not None and self._slam_running:
            self._slam_running = False
            try:
                self.slam.finish(map_save_path=slam_map_poses_path)
            finally:
                release_precision()
        if self.recorder is not None:
            self.recorder.close()

    def set_parameter_string(self, s: str) -> None:
        """Runtime parameter assignment "key value;key value" (reference:
        api.cpp:491-496 setParameterString). Parameters the step was built
        with take effect when a new VioApi is built."""
        from ..config.loader import set_key_value

        for part in s.replace(";", "\n").splitlines():
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition(" ")
            set_key_value(self.params, k.strip(), v.strip() or "true")

    # --- processing (reference: Control::processSyncedSamples) ---

    def process_pending(self) -> int:
        """Drain synced samples; returns number of frames processed/queued."""
        frames = 0
        while True:
            s = self.sample_sync.poll_synced_sample()
            if s is None:
                break
            self._pending_imu.append(s)
            if s.frame is not None:
                if self._queue is not None:
                    # odometry worker thread (reference:
                    # odometry.processingQueueSize > 0 -> controlProcessingQueue,
                    # api.cpp:1019, util/bounded_processing_queue.hpp):
                    # bounded; enqueue blocks when full like the reference
                    imu = self._pending_imu
                    self._pending_imu = []
                    self._queue.put((imu, s))
                else:
                    self._process_frame(s)
                frames += 1
        return frames

    def _start_worker(self, max_size: int) -> None:
        """The worker launches on the device and stream the caller's thread
        had when the API was built."""
        import queue

        self._queue = queue.Queue(maxsize=max_size)
        stream = (torch.cuda.current_stream(self.device) if self.device.type == "cuda"
                  else None)

        def work():
            while True:
                item = self._queue.get()
                if item is None:
                    return
                imu, s = item
                try:
                    self._pending_imu = imu + self._pending_imu
                    if stream is not None:
                        with torch.cuda.device(self.device), torch.cuda.stream(stream):
                            self._process_frame(s)
                    else:
                        self._process_frame(s)
                except Exception:  # pragma: no cover - surfacing only
                    import traceback

                    traceback.print_exc()
                finally:
                    self._queue.task_done()

        self._worker = threading.Thread(target=work, daemon=True)
        self._worker.start()

    def wait_idle(self) -> None:
        """Block until the odometry worker has drained its queue and every
        in-flight pipelined output has been retired (synchronization point
        for callers that need the latest output delivered)."""
        if self._queue is not None:
            self._queue.join()
        self._flush_pipeline()

    def _as_input(self, image):
        """A pooled host frame (or a CUDA tensor) -> the step's (1, H, W)
        input on the device: copied without blocking from pinned memory;
        integer dtypes stay integer (the step normalizes on the device). On
        the CPU a copy too, as the tracker keeps the frame as its previous
        pyramid's base level and the pool would reuse the buffer."""
        if image is None:
            return None
        if self.device.type == "cpu":
            return image.clone()[None]
        return image.to(self.device, non_blocking=True)[None]

    def _imu_batch(self, chunk, t_frame, intrinsics=None):
        """(ImuBatch of one lane and S columns, valid count, the frame's
        camera or None): the samples, and a frame's per-frame intrinsics
        where it has them, in one pinned host buffer copied to the device
        without blocking; the tail repeats the last time and is invalid
        (reference: api/vio.py:525-539)."""
        S, n = self.S, len(chunk)
        a = np.zeros(S * 7 + (8 if intrinsics is not None else 0))
        imu = a[:S * 7].reshape(S, 7)
        imu[:, 0] = chunk[-1].t if chunk else t_frame
        for i, s in enumerate(chunk):
            imu[i, 0] = s.t
            imu[i, 1:4] = s.l
            imu[i, 4:7] = s.f
        if intrinsics is not None:
            a[S * 7:S * 7 + 4] = intrinsics[:4]
            if intrinsics[4] is not None:
                a[S * 7 + 4:] = (tuple(intrinsics[4]) + (0.0,) * 4)[:4]
        host = torch.empty(a.shape, dtype=self._dtype, pin_memory=self.device.type == "cuda")
        host.copy_(torch.from_numpy(a))
        dev = (host.to(self.device, non_blocking=True) if self.device.type == "cuda"
               else host)
        cam0 = None
        if intrinsics is not None:
            k = dev[S * 7:]
            cam0 = with_intrinsics(self.cameras[0], k[0], k[1], k[2], k[3],
                                   coeffs=k[4:] if intrinsics[4] is not None else None,
                                   dtype=self._dtype)
        dev = dev[:S * 7].reshape(S, 7)
        valid = constant((tuple(i < n for i in range(S)),), torch.bool, self.device)
        return ImuBatch(dev[None, :, 0], dev[None, :, 1:4], dev[None, :, 4:7], valid), n, cam0

    def _rng_keys(self):
        seed = (int(self.params.odometry.rngSeed),)
        return jr.prng_key(constant(seed, torch.int64, self.device))

    def _ensure_state(self, image, t, second_image=None):
        if self._state is None:
            t0 = torch.full((1,), float(t), dtype=self._dtype, device=self.device)
            with full_precision():
                self._state = self._vio.init_state(
                    self._as_input(image), t0, self._rng_keys(),
                    self._as_input(second_image))

    def _process_frame(self, synced: SyncedSample) -> None:
        samples = self._pending_imu
        self._pending_imu = []
        frame = synced.frame
        image = frame.first_image
        second = frame.second_image

        if self._state is None:
            self._ensure_state(image, synced.t, second)
            return
        self._step_frame(samples, synced.t, image, second, getattr(frame, "intrinsics", None))
        self._retire_due()

    def _step_frame(self, samples, t_frame, image, second, intrinsics=None) -> None:
        """Queue one frame's step and its output's copy to the host; no host
        sync unless ``-timer`` is on. ``intrinsics``: the frame's own lens
        (``_normalize_intrinsics``), or None for the session camera."""
        vio, S = self._vio, self.S
        with full_precision():
            # Process ALL pending samples: every chunk of S beyond the last
            # rides an IMU-only propagation step, the final <=S samples ride
            # the frame step. The reference integrates every synced sample
            # (control.cpp:79-155); truncating to the last S would silently
            # drop motion at high IMU rates (e.g. 800 Hz IMU at 10 FPS).
            # Each loop ends at the batch's valid count (a host int).
            if len(samples) > S:
                lead, samples = samples[:-S], samples[-S:]
                for i in range(0, len(lead), S):
                    self._state = vio.imu_only(self._state,
                                               *self._imu_batch(lead[i:i + S], t_frame)[:2])
            batch, n, cam0 = self._imu_batch(samples, t_frame, intrinsics)
            img, img2 = self._as_input(image), self._as_input(second)
            self.time_stats.start_frame()
            if self.time_stats.enabled:
                out = self._staged_step(batch, n, img, img2, cam0)
            else:
                self._state, out = vio.step(self._state, batch, img, img2, n_valid=n,
                                            camera0=cam0)
            raw, layout = _pack(out)
            if self.device.type == "cuda":
                host = torch.empty(raw.shape, dtype=torch.uint8, pin_memory=True)
                host.copy_(raw, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host, event = raw, None
        self._inflight.append(_Fetch(host, event, layout, (image, second, img)))

    def _staged_step(self, batch, n, img, img2, cam0=None):
        """The step in its three stages, each scope waiting on the card
        before it closes (reference per-label report, main.cpp:1008-1016),
        then one sample per sub-stage label from StageProbes on this frame."""
        vio, ts = self._vio, self.time_stats
        with ts.scope("KF predict (IMU scan)"):
            self._state = vio.imu_only(self._state, batch, n)
            wait_for(self._state.backend.ekf.m)
        with ts.scope("tracker (flow+LK+detect+RANSAC)"):
            self._state, tin = vio.track_stage(self._state, batch.t[:, -1], img, img2, cam0)
            wait_for(tin.pixels)
        with ts.scope("visual update + augmentation"):
            self._state, out = vio.backend_stage(self._state, tin, cam0)
            wait_for(out.position)
        if self._stage_probes is None:
            from ..utils.stage_attribution import StageProbes

            self._stage_probes = StageProbes(vio.tracker, self.params.tracker.useStereo)
        for label, sec in self._stage_probes.run_frame(
                self._norm_gray(img), self._norm_gray(img2), tin.pixels[:, :, 0, :].to(IMAGE_DTYPE),
                tin.track_ids >= 0).items():
            ts.add_sample(label, sec)
        return out

    def _retire_due(self) -> None:
        depth = 0 if self.time_stats.enabled else self._pipeline_depth
        while len(self._inflight) > depth:
            self._retire_next()

    def _retire_next(self) -> None:
        f = self._inflight.popleft()
        if f.event is not None:
            f.event.synchronize()
        self._retire(_unpack(f.host.numpy(), f.layout), f.aux)

    @staticmethod
    def _norm_gray(image):
        """Frame tensor (float or integer) -> float32 in [0,1] (integer
        dtypes are raw 0-255), for the stage probes."""
        if image is None:
            return None
        if not image.is_floating_point():
            return image.to(IMAGE_DTYPE) / 255.0
        return image.to(IMAGE_DTYPE)

    def _flush_pipeline(self) -> None:
        """Retire every in-flight output (end of stream / sync points)."""
        while self._inflight:
            self._retire_next()

    def _retire(self, out, aux) -> None:
        """Host-side consumption of one fetched FrameOutput (numpy, no lane
        axis): time-shift feedback, stats, SLAM submit, status
        machine/auto-reset, output conversion + delivery."""
        image, second, frame = aux

        # time-shift feedback into sample sync (reference: control.cpp:97-106;
        # the estimate rides the output, no extra state fetch). Clamped: a
        # shift larger than the sync pairing horizon would silently unpair
        # every future frame, which is strictly worse than ignoring the
        # estimate (SFT is a sub-frame-interval quantity by construction).
        if self.params.odometry.estimateImuCameraTimeShift:
            sft = float(out.sft)
            if np.isfinite(sft):
                self.sample_sync.set_imu_to_camera_time_shift(
                    float(np.clip(sft, -0.2, 0.2)))

        self._frame_count += 1
        self.last_frame_output = out
        self._last_images = (image, second)
        if self.vu_stats.enabled:
            self.vu_stats.count_from_output(out.point_cloud_status)
            line = self.vu_stats.finish_frame()
            if line:
                from ..utils.logging import log_info

                log_info("visual updates: %s", line)
        if self.slam is not None and bool(out.keyframe):
            with self.time_stats.scope("slam submit"):
                # the frame as the step took it, on the device: the coupling
                # quantizes it there, after its every-Nth-interval check
                self.slam.maybe_submit(frame[0], out.position, out.orientation, out.track_ids,
                                       out.track_norm, float(out.t), self._frame_count)

        self._handle_status_and_reset(out)
        if self.on_output:
            with self.time_stats.scope("output conversion"):
                vo = self._convert_output(out)
            po = self.params.odometry
            if po.freezeOnFailedTracking:
                # freeze the published pose while tracking is failed
                # (reference: control.cpp:124-128)
                if vo.status == 2 and self._frozen is not None:
                    vo.position, vo.orientation, vo.velocity = self._frozen
                elif vo.status != 2:
                    self._frozen = (vo.position, vo.orientation, vo.velocity)
            if self.output_buffer is not None:
                self.output_buffer.add_processed_frame(vo)
                while True:
                    buffered = self.output_buffer.poll_output()
                    if buffered is None:
                        break
                    self.on_output(buffered)
            else:
                self.on_output(vo)

    def _handle_status_and_reset(self, out) -> None:
        """Status latch + auto-reset table (reference: control.cpp:117-150).

        Latch: any non-INIT session status is adopted as-is; the published
        status never demotes back to INIT (a freshly reset session reports
        INIT while the API keeps the latched status).

        Reset table — first matching row wins:

          status   condition                                   action
          INIT     resetUntilInitSucceeds and timer expired    reset, fresh pose
          any      resetOnFailedTracking and session LOST      reset, keep pose
          >INIT    session reports INIT and timer expired      reset, keep pose

        where `timer expired` = more than resetAfterTrackingFailsToInitialize
        seconds since the last reset.
        """
        po = self.params.odometry
        session_status = int(out.tracking_status)
        if session_status != 0:
            self._status = session_status

        t = float(out.t)
        timer_expired = (self._last_reset_time
                         + po.resetAfterTrackingFailsToInitialize < t)
        if self._status == 0 and po.resetUntilInitSucceeds and timer_expired:
            self.reset(keep_pose=False, t=t)
        elif po.resetOnFailedTracking and session_status == 2:
            self.reset(keep_pose=True, t=t)
        elif self._status != 0 and session_status == 0 and timer_expired:
            self.reset(keep_pose=True, t=t)

    def attribute_stages(self, reps: int = 5) -> dict:
        """Fill in per-stage attribution for the `-timer` report IF the
        per-frame accumulation did not run (the sub-stage labels normally
        accumulate one sample per frame during the run via StageProbes —
        the reference's accumulate-every-frame semantics,
        util/timer.hpp:15-55 + main.cpp:1008-1016). Kept as a fallback for
        sessions where time_stats was enabled only at exit; times the
        sub-stages on the LAST frame's images. Returns the {label: ms} dict."""
        if self._stage_probes is not None or self._vio is None:
            return {}  # per-frame samples already accumulated in time_stats
        gray, second = (None if i is None else self._norm_gray(i.to(self.device))
                        for i in self._last_images)
        if gray is None:
            return {}
        from ..utils.stage_attribution import attribute_stages

        labels = attribute_stages(self._vio.tracker, gray, second, reps=reps)
        for k, ms in labels.items():
            self.time_stats.add_attribution(k, ms)
        return labels

    def _surgery(self, fn) -> None:
        """Replace the filter state of the session by ``fn(ekf)`` on the
        device; no-op before the first frame."""
        if self._state is not None:
            with full_precision():
                backend = self._state.backend
                self._state = self._state._replace(backend=backend._replace(ekf=fn(backend.ekf)))

    def lock_biases(self) -> None:
        """Freeze IMU bias estimates (reference: InternalAPI::lockBiases,
        internal.hpp:246; ekf.cpp:944-947). No-op before the first frame."""
        self._surgery(lambda ekf: _lock_biases(ekf, self._sqrt_mode))

    def condition_on_last_pose(self) -> None:
        """Schur-condition the state on the newest pose (reference:
        InternalAPI::conditionOnLastPose, internal.hpp:247; ekf.cpp:928-942).
        No-op before the first frame."""
        L = self.params.odometry.cameraTrailLength
        self._surgery(lambda ekf: _condition(ekf, L, self._sqrt_mode))

    def set_visualization(self, mode) -> None:
        raise NotImplementedError("visualizations: api/visualizations.py is not ported")

    def render_visualization(self, mode=None, epipolar_select=None):
        raise NotImplementedError("visualizations: api/visualizations.py is not ported")

    def reset(self, keep_pose: bool = False, t: Optional[float] = None) -> None:
        """(reference: Control::reset) A fresh filter with the tracker's
        image context kept; with ``keep_pose`` the fresh filter is rigidly
        moved onto the old pose (all on the device)."""
        self._last_reset_time = t if t is not None else 0.0
        old = self._state
        if old is None:
            return
        with full_precision():
            state = old._replace(backend=self._vio.backend.init_state(self._rng_keys()))
            if keep_pose:
                po = self.params.odometry
                m = old.backend.ekf.m
                ekf = initialize_orientation(
                    state.backend.ekf, constant((GRAVITY_UP,), self._dtype, self.device),
                    po.noiseInitialOri, po.noiseScale**2, self._sqrt_mode)
                ekf = transform_to(ekf, m[:, POS:POS + 3], m[:, ORI:ORI + 4],
                                   po.cameraTrailLength, sqrt_mode=self._sqrt_mode)
                state = state._replace(backend=state.backend._replace(
                    ekf=ekf, orientation_initialized=torch.ones_like(
                        state.backend.orientation_initialized)))
        self._state = state

    def _get_display_rectify(self):
        """The stereo rectification of the point-cloud path, built once on
        the device: (remap0, remap1, Q, rect_cam0, rect_cam1), with the
        step's rectification zoom so the cloud lines up with its pixels."""
        if self._display_rectify is None:
            from ..frontend.rectify import build_remap, stereo_rectify
            from ..odometry.vio import REMAP_DTYPE

            rc0, rc1, Q, _, _ = stereo_rectify(
                self.cameras[0], self.cameras[1], self.derived.imu_to_camera,
                self.derived.second_imu_to_camera, self.width, self.height,
                zoom=self.params.tracker.rectificationZoom)
            maps = tuple(build_remap(c, rc, self.width, self.height, REMAP_DTYPE, self.device)
                         for c, rc in zip(self.cameras, (rc0, rc1)))
            self._display_rectify = (*maps, torch.as_tensor(Q, dtype=IMAGE_DTYPE).to(self.device),
                                     rc0, rc1)
        return self._display_rectify

    def _camera_to_world(self, position, orientation):
        """The first camera's 4x4 camera-to-world pose (numpy) of an IMU pose."""
        from ..geometry.poses import to_camera_to_world

        as64 = lambda a: torch.tensor(np.asarray(a, np.float64))
        return to_camera_to_world(as64(position), as64(orientation),
                                  as64(self.derived.imu_to_camera)).numpy()

    def _stereo_cloud(self, out):
        """(N, 4) rows id, x, y, z in world coordinates: the tracks' dense
        depth points (their ids), then with computeStereoPointCloud the
        strided disparity cloud of the last stereo pair (id -2)."""
        parts = []
        depth = np.asarray(out.track_depth)
        if depth.size and (depth > 0).any():
            dsel = (depth > 0) & (np.asarray(out.track_ids) >= 0)
            z = depth[dsel][:, None]
            p_cam = np.concatenate([np.asarray(out.track_norm)[dsel] * z, z], axis=1)
            c2w = self._camera_to_world(out.position, out.orientation)
            ids = np.asarray(out.track_ids)[dsel][:, None].astype(np.float64)
            parts.append(np.concatenate([ids, p_cam @ c2w[:3, :3].T + c2w[:3, 3]], axis=1))
        if self.params.tracker.computeStereoPointCloud and self._last_images[1] is not None:
            from ..frontend.disparity import compute_disparity, default_max_disparity, point_cloud
            from ..frontend.rectify import remap

            m0, m1, Q, _, _ = self._get_display_rectify()
            gl, gr = (remap(self._norm_gray(torch.as_tensor(img).to(self.device)), m)
                      for img, m in zip(self._last_images, (m0, m1)))
            with full_precision():
                disp, dv = compute_disparity(gl, gr, default_max_disparity(self.width))
                pts, ok = point_cloud(disp, dv, Q, stride=max(
                    int(self.params.tracker.stereoPointCloudStride), 1))
            pts, ok = pts.cpu().numpy(), ok.cpu().numpy()
            if ok.any():
                c2w = self._camera_to_world(out.position, out.orientation)
                p_w = pts[ok] @ c2w[:3, :3].T + c2w[:3, 3]
                parts.append(np.concatenate([np.full((len(p_w), 1), -2.0), p_w], axis=1))
        return parts

    def _convert_output(self, out) -> VioOutput:
        pc_ids = np.asarray(out.point_cloud_ids)
        pc = np.asarray(out.point_cloud)
        sel = pc_ids >= 0
        cloud = np.concatenate(
            [pc_ids[sel, None].astype(np.float64), pc[sel]], axis=1) if sel.any() else np.zeros((0, 4))
        for part in self._stereo_cloud(out):
            cloud = np.concatenate([cloud, part]) if len(cloud) else part
        trail = np.concatenate([
            np.asarray(out.pose_trail_times)[:, None], np.asarray(out.pose_trail)], axis=1)
        position = np.asarray(out.position)
        orientation = np.asarray(out.orientation)
        velocity = np.asarray(out.velocity)
        if self.params.odometry.outputCameraPose:
            # output the first camera pose instead of the IMU pose
            # (reference: odometry.outputCameraPose -> imuToOutput,
            # tracker/util.cpp:106-108), on the host
            from ..geometry.poses import to_camera_to_world
            from ..geometry.quaternion import rmat_to_quat

            as64 = lambda a: torch.tensor(np.asarray(a, np.float64))
            c2w = to_camera_to_world(as64(position), as64(orientation),
                                     as64(self.derived.imu_to_output)).numpy()
            position = c2w[:3, 3]
            orientation = rmat_to_quat(as64(c2w[:3, :3].T)).numpy()
        if self.slam is not None and self.slam.coord.ready:
            # SLAM-corrected outputs (reference: computePose, backend.cpp:1364-1381)
            T = self.slam.coord.T
            position, orientation = self.slam.coord.transform_position_orientation(
                position, orientation)
            velocity = T[:3, :3] @ velocity
            if len(cloud):
                cloud = cloud.copy()
                cloud[:, 1:4] = (T[:3, :3] @ cloud[:, 1:4].T).T + T[:3, 3]
            # merge SLAM map points (reference: getPointCloud, backend.cpp:255-280)
            if self.slam.point_cloud:
                slam_pts = np.array([[-pid, p[0], p[1], p[2]]
                                     for pid, tid, p in self.slam.point_cloud])
                cloud = np.concatenate([cloud, slam_pts]) if len(cloud) else slam_pts
        return VioOutput(
            status=int(out.tracking_status),
            t=float(out.t),
            position=position,
            orientation=orientation,
            velocity=velocity,
            position_covariance=np.asarray(out.position_cov),
            velocity_covariance=np.asarray(out.velocity_cov),
            bias_covariance_diagonal=np.asarray(out.bias_cov_diag),
            point_cloud=cloud,
            pose_trail=trail,
            bias_gyro=np.asarray(out.bias_gyro),
            bias_acc=np.asarray(out.bias_acc),
            stationary_visual=bool(out.stationary_visual),
        )


def build_vio(calibration_json: Optional[str] = None,
              config_yaml: Optional[str] = None,
              width: int = 640, height: int = 480, **kwargs) -> VioApi:
    """Factory matching the reference buildVio(calibrationJson, configYaml)
    (reference: src/api/vio.hpp:122, api.cpp:1027-1039); ``kwargs`` go to
    VioApi (``device="cpu"`` to run on the CPU)."""
    params = load_parameters(yaml_text=config_yaml, calibration_json=calibration_json)
    return VioApi(params, width, height, **kwargs)
