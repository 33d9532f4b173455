"""The odometry backend (port of the reference's ``odometry/backend.py``):
IMU propagation and the per-frame estimator step, batch-first over B lanes.

    imu_scan(state, imu) -> state
    process_frame(state, tracker_input) -> (state, FrameOutput)

The IMU samples of a frame run as a Python loop of batched EKF predicts,
over every column of the batch or, given the count of valid columns, over
those alone.
The visual update is the sequential form (the reference's default) or,
with ``batchVisualUpdate``, the batched one; both carry the hybrid EKF-SLAM
map (``hybridMapSize`` > 0) and every track sampling. With
``visualUpdateForEveryNFrame`` N > 1 only every N-th frame may be a
keyframe; with ``visualUpdateEnabled = false`` the frame skips the trail
and the visual update. With ``useIndependentStereoTriangulation`` (stereo)
every frame's tracks are triangulated from their own stereo pair, their
range taken from the dense stereo depth where the tracker gives one, and
the visual update fuses a track's triangulations. With ``useSquareRootEkf``
the filter carries the factor W of its covariance (``ekf/sqrt.py``) through
every predict, update, augmentation and map insert, and the outputs'
covariances are formed from it. ``process_frame`` takes an optional
per-frame first camera (``geometry.cameras.with_intrinsics``, mono): the
tracks normalize through it and the measurement noise and gates scale with
its focal length, as tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .. import random as jr
from ..ekf import (
    BGA, CAM, ORI, POS, POSE_DIM, SFT, VEL, EKFState, augment_pose, init_state,
    initialize_orientation, make_predict, state_dim, undo_augmentation, update_pseudo_velocity,
    update_zupt, update_zupt_initialization,
)
from ..ekf.sqrt import cov_block, cov_diag
from ..ekf.update import normalize_current_quat
from ..geometry.cameras import normalize_pixel
from ..lanes import tuple_where
from . import trail as tr
from .batched_update import make_batched_visual_update
from .sequential_update import make_sequential_visual_update
from .triangulation import inverse_depth, triangulate_stereo_idp
from .visual_update import make_prepare_track_update

STATUS_INIT = 0
STATUS_TRACKING = 1
STATUS_LOST_TRACKING = 2


class TrackerInput(NamedTuple):
    track_ids: torch.Tensor  # (B, T) int32, -1 = empty slot
    pixels: torch.Tensor  # (B, T, C, 2)
    keyframe: torch.Tensor  # (B,) bool
    stereo_depth: torch.Tensor  # (B, T), -1 = none
    track_status: Optional[torch.Tensor] = None  # (B, T) int32
    prev_pixels: Optional[torch.Tensor] = None  # (B, T, C, 2)
    viz_pixels: Optional[torch.Tensor] = None  # (B, T, C, 2)


class ImuBatch(NamedTuple):
    t: torch.Tensor  # (B, S)
    gyro: torch.Tensor  # (B, S, 3)
    acc: torch.Tensor  # (B, S, 3)
    valid: torch.Tensor  # (B, S) bool


class BackendState(NamedTuple):
    ekf: EKFState
    trail: tr.TrailState
    blacklist_flags: torch.Tensor  # (B, T) bool
    blacklist_ids: torch.Tensor  # (B, T) int32
    frames_since_keyframe: torch.Tensor  # (B,) int32
    orientation_initialized: torch.Tensor  # (B,) bool
    vu_window: torch.Tensor  # (B, W)
    vu_window_t: torch.Tensor  # (B, W)
    vu_window_count: torch.Tensor  # (B,) int32
    vu_window_pos: torch.Tensor  # (B,) int32
    tracking_status: torch.Tensor  # (B,) int32
    rng: torch.Tensor  # (B, 2) threefry keys
    frame_number: torch.Tensor  # (B,) int32


class FrameOutput(NamedTuple):
    t: torch.Tensor
    position: torch.Tensor
    velocity: torch.Tensor
    orientation: torch.Tensor
    bias_gyro: torch.Tensor
    bias_acc: torch.Tensor
    position_cov: torch.Tensor
    velocity_cov: torch.Tensor
    bias_cov_diag: torch.Tensor
    tracking_status: torch.Tensor
    stationary_visual: torch.Tensor
    point_cloud: torch.Tensor
    point_cloud_status: torch.Tensor
    point_cloud_ids: torch.Tensor
    pose_trail: torch.Tensor
    pose_trail_times: torch.Tensor
    good_frame: torch.Tensor
    keyframe: torch.Tensor
    track_ids: torch.Tensor
    track_norm: torch.Tensor
    track_depth: torch.Tensor
    track_status: torch.Tensor
    track_prev_pixels: torch.Tensor
    track_pixels: torch.Tensor
    vu_tri_status: torch.Tensor
    vu_prepare_status: torch.Tensor
    sft: torch.Tensor


def bucket_n_valid(n: int, S: int) -> int:
    """``n`` valid IMU columns rounded up to the next power of two, at most
    ``S``: the loop of ``Backend.imu_scan`` over that many columns gives the
    same state bit for bit (an invalid column leaves a lane's state as it
    was) with a few loop lengths, so a captured step has a few signatures."""
    return min(1 << max(int(n) - 1, 0).bit_length(), S) if n > 0 else 0


def _set_lane_pos(a, pos, v):
    """a[b, pos[b]] = v[b]."""
    return a.scatter(1, pos[:, None].to(torch.int64), v[:, None].to(a.dtype))


class Backend(nn.Module):
    """The estimator for static parameters; buffers hold the extrinsics."""

    def __init__(self, params, derived, cameras, max_tracks=None, dtype=torch.float64):
        super().__init__()
        po, pt = params.odometry, params.tracker
        self.po = po
        self.sqrt_mode = bool(getattr(po, "useSquareRootEkf", False))
        self.stereo = bool(pt.useStereo)
        self.n_cams = 2 if self.stereo else 1
        self.cameras = tuple(cameras)
        self.T = max_tracks if max_tracks is not None else pt.maxTracks
        self.L = po.cameraTrailLength
        self.d = state_dim(self.L, po.hybridMapSize)
        self.dtype = dtype
        self.noise_scale = po.noiseScale**2
        self.NV = min(self.T, (po.maxVisualUpdates if po.maxVisualUpdates > 0 else self.T) + 12)
        self.W_arm = max(int(pt.targetFps / max(po.visualUpdateForEveryNFrame, 1)
                             * po.goodFramesTimeWindowSeconds), 1)
        self.W = max(2 * self.W_arm, 4)
        self.register_buffer("imu_to_camera", torch.as_tensor(derived.imu_to_camera, dtype=dtype))
        self.register_buffer("second_imu_to_camera",
                             torch.as_tensor(derived.second_imu_to_camera, dtype=dtype))
        self.indep_stereo = self.stereo and bool(po.useIndependentStereoTriangulation)
        if self.indep_stereo:  # second-camera to first-camera transform
            self.register_buffer("second_to_first", torch.as_tensor(
                np.asarray(derived.imu_to_camera)
                @ np.linalg.inv(np.asarray(derived.second_imu_to_camera)), dtype=dtype))
        self._predict = make_predict(po, self.sqrt_mode)
        self._visual_update()  # an option the port lacks raises here, not at the first step

    def focal_thresholds(self, camera0=None):
        """(visual_r, rmse_thr0, chi_r0): the measurement noise and the gate
        thresholds in normalized units, the pixel parameters over the first
        camera's focal length: floats for the static camera, 0-d tensors in
        the filter's dtype for a per-frame ``camera0``. A gate is on or off
        by its parameter's sign alone (off: -1.0)."""
        po = self.po
        if camera0 is None:
            f = self.cameras[0].focal_length
        else:
            f = ((camera0.fx + camera0.fy) * 0.5).to(self.dtype)
        visual_r = po.visualR / f
        rmse_thr0 = po.trackRmseThreshold / f if po.trackRmseThreshold >= 0 else -1.0
        chi_r0 = po.trackChiTestOutlierR / f if po.trackChiTestOutlierR >= 0 else -1.0
        return visual_r, rmse_thr0, chi_r0

    def _visual_update(self, camera0=None):
        # built per call so the closure sees the buffers on their current device
        prepare = make_prepare_track_update(
            self.po, self.imu_to_camera, self.second_imu_to_camera, self.stereo, self.d)
        make = (make_batched_visual_update if getattr(self.po, "batchVisualUpdate", False)
                else make_sequential_visual_update)
        return make(self.po, prepare, self.d, self.NV, self.n_cams,
                    *self.focal_thresholds(camera0), sqrt_mode=self.sqrt_mode)

    def init_state(self, rng_keys) -> BackendState:
        """rng_keys: (B, 2) threefry keys."""
        B = rng_keys.shape[0]
        dev = self.imu_to_camera.device
        T, W, dt = self.T, self.W, self.dtype
        i32 = dict(dtype=torch.int32, device=dev)
        return BackendState(
            ekf=init_state(self.po, B, dt, dev, sqrt_mode=self.sqrt_mode),
            trail=tr.init_trail(self.po, B, T, self.n_cams, dt, dev),
            blacklist_flags=torch.zeros((B, T), dtype=torch.bool, device=dev),
            blacklist_ids=torch.full((B, T), -1, **i32),
            frames_since_keyframe=torch.zeros((B,), **i32),
            orientation_initialized=torch.zeros((B,), dtype=torch.bool, device=dev),
            vu_window=torch.zeros((B, W), dtype=dt, device=dev),
            vu_window_t=torch.full((B, W), float("-inf"), dtype=dt, device=dev),
            vu_window_count=torch.zeros((B,), **i32),
            vu_window_pos=torch.zeros((B,), **i32),
            tracking_status=torch.full((B,), STATUS_INIT, **i32),
            rng=rng_keys.to(dev),
            frame_number=torch.zeros((B,), **i32),
        )

    def imu_scan(self, state: BackendState, batch: ImuBatch,
                 n_valid: Optional[int] = None) -> BackendState:
        """Propagate through the batch's samples in order; an invalid column
        leaves a lane's state as it was. ``n_valid``, a host int where the
        caller knows that no column from there on is valid in any lane,
        ends the loop there: the same function in fewer launches."""
        po, ns, sq = self.po, self.noise_scale, self.sqrt_mode
        S = batch.t.shape[1]
        for s in range(S if n_valid is None else min(n_valid, S)):
            t, g, a = batch.t[:, s], batch.gyro[:, s], batch.acc[:, s]
            ekf = state.ekf
            ekf = tuple_where(state.orientation_initialized, ekf,
                              initialize_orientation(ekf, a, po.noiseInitialOri, ns, sq))
            ekf = self._predict(ekf, t, g, a)
            ekf = ekf._replace(m=normalize_current_quat(ekf.m))
            if po.useDecayingZeroVelocityUpdate:
                ekf = update_zupt_initialization(ekf, po.initZuptR, ns, sq)
            if po.usePseudoVelocity:
                h = torch.linalg.norm(ekf.m[:, VEL:VEL + 2], dim=-1)
                ekf = tuple_where(h > po.pseudoVelocityLimit, update_pseudo_velocity(
                    ekf, po.pseudoVelocityTarget, po.pseudoVelocityR, ns, sq), ekf)
            valid = batch.valid[:, s]
            state = state._replace(
                ekf=tuple_where(valid, ekf, state.ekf),
                orientation_initialized=state.orientation_initialized | valid)
        return state

    def process_frame(self, state: BackendState, tin: TrackerInput, camera0=None):
        """The frame's estimator step; ``camera0``, a per-frame first camera
        (``with_intrinsics``), replaces the static one for this frame."""
        po, L = self.po, self.L
        ekf = state.ekf
        B = ekf.m.shape[0]
        t_frame = ekf.prev_sample_t
        frame_number = state.frame_number + 1
        keyframe = tin.keyframe
        frames_since_kf = torch.where(keyframe, torch.zeros_like(state.frames_since_keyframe),
                                      state.frames_since_keyframe + 1)
        stationary_visual = frames_since_kf >= po.visualStationarityFrameCountThreshold
        if po.useVisualStationarity:
            ekf = tuple_where(stationary_visual,
                              update_zupt(ekf, po.visualZuptR, self.noise_scale,
                                          self.sqrt_mode), ekf)
        state = state._replace(ekf=ekf, frames_since_keyframe=frames_since_kf,
                               frame_number=frame_number)
        if po.visualUpdateForEveryNFrame > 1:  # only every N-th frame may be a keyframe
            keyframe_eff = keyframe & (frame_number % po.visualUpdateForEveryNFrame == 0)
        else:
            keyframe_eff = keyframe
        if po.visualUpdateEnabled:
            state, pc, good_frame = self._visual_frame(state, tin, keyframe_eff,
                                                       stationary_visual, t_frame, camera0)
        else:
            dev, NV = ekf.m.device, self.NV
            zeros = torch.zeros((B, NV), dtype=torch.int32, device=dev)
            pc = (torch.zeros((B, NV, 3), dtype=ekf.m.dtype, device=dev), zeros,
                  torch.full_like(zeros, -1), zeros, zeros)
            good_frame = torch.zeros_like(keyframe)

        ekf = state.ekf
        m, P = ekf.m, ekf.P
        T_in = tin.track_ids.shape[1]
        C_in = tin.pixels.shape[2]
        dev = m.device
        out = FrameOutput(
            t=t_frame,
            position=m[:, POS:POS + 3],
            velocity=m[:, VEL:VEL + 3],
            orientation=m[:, ORI:ORI + 4],
            bias_gyro=m[:, BGA:BGA + 3],
            bias_acc=m[:, 13:16],
            position_cov=(cov_block(P, slice(POS, POS + 3)) if self.sqrt_mode
                          else P[:, POS:POS + 3, POS:POS + 3]),
            velocity_cov=(cov_block(P, slice(VEL, VEL + 3)) if self.sqrt_mode
                          else P[:, VEL:VEL + 3, VEL:VEL + 3]),
            bias_cov_diag=(cov_diag(P) if self.sqrt_mode
                           else torch.diagonal(P, dim1=1, dim2=2))[:, BGA:BGA + 9],
            tracking_status=state.tracking_status,
            stationary_visual=stationary_visual,
            point_cloud=pc[0], point_cloud_status=pc[1], point_cloud_ids=pc[2],
            pose_trail=m[:, CAM:CAM + POSE_DIM * L].reshape(B, L, POSE_DIM),
            pose_trail_times=ekf.pose_times,
            good_frame=good_frame,
            keyframe=keyframe,
            track_ids=state.trail.kf_track_id[:, 1],
            track_norm=state.trail.kf_norm[:, 1, :, 0, :],
            track_depth=tin.stereo_depth,
            track_status=(tin.track_status if tin.track_status is not None
                          else torch.full((B, T_in), -1, dtype=torch.int32, device=dev)),
            track_prev_pixels=(tin.prev_pixels if tin.prev_pixels is not None
                               else torch.zeros((B, T_in, C_in, 2), dtype=tin.pixels.dtype,
                                                device=dev)),
            track_pixels=tin.viz_pixels if tin.viz_pixels is not None else tin.pixels,
            vu_tri_status=pc[3],
            vu_prepare_status=pc[4],
            sft=m[:, SFT],
        )
        # the key handed on in the init state's layout, whichever draw left
        # it (a column of a split): a captured step then has one signature
        return state._replace(rng=state.rng.contiguous()), out

    def _stereo_rows(self, norm0, norm1, depth, valid):
        """Each track's stereo triangulation in its left camera's inverse-
        depth coordinates with its sensitivity covariance (B, T, ...); a
        dense z-depth ``depth`` > 0 rescales the point to that depth and
        keeps the covariance."""
        sidp, scov, sok = triangulate_stereo_idp(norm0, norm1, self.second_to_first)
        dd = depth.to(sidp.dtype)
        pf3 = inverse_depth(sidp)
        z = pf3[..., 2:3]
        sidp_dd = inverse_depth(pf3 * (dd[..., None] / torch.where(torch.abs(z) > 1e-9, z,
                                                                    torch.ones_like(z))))
        finite = lambda a: torch.all(torch.isfinite(a), dim=-1)
        use_dd = (dd > 0) & sok & (torch.abs(pf3[..., 2]) > 1e-9) & finite(sidp_dd)
        sidp = torch.where(use_dd[..., None], sidp_dd, sidp)
        return dict(stereo_idp=sidp, stereo_cov=scov, stereo_valid=sok & valid & finite(sidp))

    def _visual_frame(self, state: BackendState, tin: TrackerInput, keyframe, stationary_visual,
                      t_frame, camera0=None):
        """The frame's trail and visual update: (state, point cloud tuple,
        good_frame (B,))."""
        po, L = self.po, self.L
        frame_number = state.frame_number
        # non-keyframe: drop the head keyframe and undo its augmentation
        state = state._replace(
            trail=tuple_where(keyframe, state.trail, tr.pop_head_keyframe(state.trail)),
            ekf=tuple_where(keyframe, state.ekf, undo_augmentation(state.ekf, L, self.sqrt_mode)))
        norm0, ok0 = normalize_pixel(self.cameras[0] if camera0 is None else camera0,
                                     tin.pixels[:, :, 0, :])
        if self.stereo:
            norm1, ok1 = normalize_pixel(self.cameras[1], tin.pixels[:, :, 1, :])
            norm = torch.stack([norm0, norm1], dim=2)
            ok0 = ok0 & ok1
        else:
            norm = norm0[:, :, None, :]
        valid = (tin.track_ids >= 0) & ok0
        ids = torch.where(valid, tin.track_ids, torch.full_like(tin.track_ids, -1))
        stereo = {}
        if self.indep_stereo:
            stereo = self._stereo_rows(norm0, norm1, tin.stereo_depth, valid)
        trail = tr.insert_head_features(
            state.trail, tin.track_ids, norm, tin.pixels[:, :, 0, :], valid,
            timestamp=t_frame, estimate_velocities=bool(po.estimateImuCameraTimeShift), **stereo)
        kf_frame_num = trail.kf_frame_num.clone()
        kf_frame_num[:, 0] = frame_number
        trail = tr.prune(trail._replace(kf_frame_num=kf_frame_num), ids)
        keys = jr.split(state.rng)
        state = state._replace(trail=trail, rng=keys[:, 0])
        state, pc, need_more, too_many_failures = self._visual_update(camera0)(
            state, ids, valid, keys[:, 1])
        good_frame = (stationary_visual | ~need_more) & ~too_many_failures

        removed, counter = tr.removed_keyframe_index(state.trail, po)
        trail = tr.push_head_keyframe(state.trail._replace(frame_counter=counter),
                                      removed, frame_number, t_frame)
        state = state._replace(ekf=augment_pose(state.ekf, removed - 1, po, self.sqrt_mode),
                               trail=trail)

        W = self.W
        vu_window = _set_lane_pos(state.vu_window, state.vu_window_pos,
                                  good_frame.to(state.vu_window.dtype))
        vu_window_t = _set_lane_pos(state.vu_window_t, state.vu_window_pos, t_frame)
        pos_ = (state.vu_window_pos + 1) % W
        count = torch.clamp(state.vu_window_count + 1, max=W)
        window = po.goodFramesTimeWindowSeconds
        in_window = vu_window_t >= (t_frame - window)[:, None]
        n_in = torch.sum(in_window, dim=1)
        mean_vu = (torch.sum(torch.where(in_window, vu_window, torch.zeros_like(vu_window)), dim=1)
                   / torch.clamp(n_in, min=1))
        t_oldest = torch.min(torch.where(vu_window_t > float("-inf"), vu_window_t,
                                         torch.full_like(vu_window_t, float("inf"))), dim=1).values
        span_ok = (count > 1) & (t_frame - t_oldest >= window)
        enough = (count > self.W_arm // 2) | span_ok
        status = state.tracking_status
        status = torch.where(enough & (status != STATUS_TRACKING)
                             & (mean_vu > po.goodFramesToTracking),
                             torch.full_like(status, STATUS_TRACKING), status)
        status = torch.where(enough & (status == STATUS_TRACKING)
                             & (mean_vu < po.goodFramesToTrackingFailed),
                             torch.full_like(status, STATUS_LOST_TRACKING), status)
        state = state._replace(vu_window=vu_window, vu_window_t=vu_window_t,
                               vu_window_pos=pos_.to(torch.int32),
                               vu_window_count=count.to(torch.int32),
                               tracking_status=status.to(torch.int32))
        return state, pc, good_frame
