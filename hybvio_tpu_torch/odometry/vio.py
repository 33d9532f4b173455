"""Full VIO step, stereo or mono: image front-end + odometry backend (port
of the reference's ``odometry/vio.py``), batch-first over B lanes that share
each frame (stereo: each pair) or have one frame each.

    step = imu_only -> track_stage (predict_flow, Tracker.track_frame)
           -> backend_stage (Backend.process_frame)

with a stage marker (an empty kernel of its own name, on the card) after
each of the first two.

``predict_flow`` gives each track an LK guess: its distance from the
widest-baseline two-view triangulation over the pose trail (at least
predictOpticalFlowMinTriangulationDistance), the previous corner unprojected
at that distance and reprojected with the current EKF pose (in stereo into
both cameras); with ``predictOpticalFlow = false`` LK starts from the
previous corners.

Stereo options: ``useRectification`` resamples both frames into a pair of
rectified pinholes (their rotation carried by the cameras, so rays stay in
the original camera frames and the extrinsics are unchanged);
``computeDenseStereoDepth`` attaches the SAD disparity's depth to every
track (``TrackerInput.stereo_depth``); upright-2P (``useStereoUpright2p``
without ``useRansac3``) gets the previous and current camera-to-world
rotations. The remap fields and Q are built once, at construction, and
moved with the module.

Per-frame intrinsics (mono): ``step(..., camera0=...)`` takes the frame's
own first camera (``geometry.cameras.with_intrinsics``, its fields 0-d
tensors on the device, shared by the lanes), which replaces the static one
in the flow prediction, the tracker's normalization and RANSAC and the
estimator's normalization, noise and gates; a new lens rebuilds nothing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from .. import random as jr
from ..ekf import CAM, ORI, POS, POSE_DIM
from ..frontend.disparity import (
    compute_disparity, default_max_disparity, disparity_to_depth, sample_depth,
)
from ..frontend.rectify import build_remap, remap, stereo_rectify
from ..frontend.tracker import Tracker, TrackerState
from ..geometry.cameras import pixel_to_ray, ray_to_pixel
from ..geometry.poses import to_camera_to_world, to_world_to_camera, transform_vec3
from ..ops._lib import mark_stage
from ..runtime import IMAGE_DTYPE, constant, random_int_bits, scoped_precision
from . import trail as tr
from .backend import Backend, BackendState, ImuBatch, TrackerInput
from .batched_update import gather_pose_states
from .triangulation import camera_poses_from_states, triangulate_two_cameras


class VioState(NamedTuple):
    backend: BackendState
    tracker: TrackerState
    tracker_ready: torch.Tensor  # (B,) bool


def normalize_input(img):
    """Integer frames (e.g. uint8, any shape) -> [0, 1] float32 on the
    device."""
    if img is None or img.is_floating_point():
        return img
    return img.to(IMAGE_DTYPE) * constant(1.0 / 255.0, IMAGE_DTYPE, img.device)


def _lane_gather(a, idx):
    """a[b, idx[b, t], t, :] for a (B, K, T, D) and idx (B, T)."""
    view = idx[:, None, :, None].expand(a.shape[0], 1, a.shape[2], a.shape[3])
    return torch.gather(a, 1, view)[:, 0]


# the rectification's remap fields are evaluated in float64, as the
# reference evaluates them in its cameras' dtype, float64 where its API and
# CLI build them
REMAP_DTYPE = torch.float64


class Vio(nn.Module):
    """The stereo or mono VIO for static parameters; ``dtype`` is the
    filter's."""

    def __init__(self, params, derived, cameras, max_tracks=None, dtype=torch.float64):
        super().__init__()
        pt = params.tracker
        self.pt = pt
        self.dtype = dtype
        stereo = bool(pt.useStereo)
        self.rectify = stereo and bool(pt.useRectification)
        self.dense_depth = stereo and bool(pt.computeDenseStereoDepth)
        self.upright = stereo and bool(pt.useStereoUpright2p) and not pt.useRansac3
        if self.rectify or self.dense_depth:
            W, H = cameras[0].width, cameras[0].height
            rc0, rc1, Q, _, _ = stereo_rectify(
                cameras[0], cameras[1], derived.imu_to_camera, derived.second_imu_to_camera,
                W, H, zoom=pt.rectificationZoom)
            self.rect_cameras = (rc0, rc1)
            self.register_buffer("Q", torch.as_tensor(Q, dtype=IMAGE_DTYPE))
            # built on the host once; the buffers move with the module
            self.register_buffer("remap0", build_remap(cameras[0], rc0, W, H, REMAP_DTYPE,
                                                       device="cpu"))
            self.register_buffer("remap1", build_remap(cameras[1], rc1, W, H, REMAP_DTYPE,
                                                       device="cpu"))
            self.max_disparity = default_max_disparity(W)
            if self.rectify:
                cameras = (rc0, rc1)
        self.cameras = tuple(cameras)
        self.T = max_tracks if max_tracks is not None else pt.maxTracks
        self.L = params.odometry.cameraTrailLength
        self.backend = Backend(params, derived, cameras, max_tracks=self.T, dtype=dtype)
        self.tracker = Tracker(params, cameras, derived, max_tracks=self.T,
                               int_bits=random_int_bits(dtype))

    def rectify_inputs(self, image, second_image):
        """Both frames resampled into the rectified cameras, with
        ``useRectification``; else as given."""
        if not self.rectify:
            return image, second_image
        return remap(image, self.remap0), remap(second_image, self.remap1)

    def track_dense_depth(self, image, second_image, pixels, valid):
        """Dense z-depth (B, T) at the tracks' left pixels (B, T, 2), -1
        where there is none: SAD disparity of the rectified pair (rectified
        here unless the inputs already are), depth through Q, sampled at
        each track's pixel in the rectified left camera."""
        if not self.rectify:
            image, second_image = remap(image, self.remap0), remap(second_image, self.remap1)
        disp, dvalid = compute_disparity(image, second_image, self.max_disparity)
        depth, dok = disparity_to_depth(disp, dvalid, self.Q)
        rays, ok_r = pixel_to_ray(self.cameras[0], pixels.to(IMAGE_DTYPE))
        rpix, ok_p = ray_to_pixel(self.rect_cameras[0], rays)
        d = sample_depth(depth, dok, rpix)
        return torch.where(valid & ok_r & ok_p, d, torch.full_like(d, -1.0)).to(self.dtype)

    def pose_rotations(self, m):
        """(previous, current) camera-to-world rotations (B, 3, 3): the
        trail's newest pose and the current EKF pose."""
        i2c = self.backend.imu_to_camera
        prev = to_camera_to_world(m[:, CAM:CAM + 3], m[:, CAM + 3:CAM + POSE_DIM], i2c)
        cur = to_camera_to_world(m[:, POS:POS + 3], m[:, ORI:ORI + 4], i2c)
        return prev[:, :3, :3], cur[:, :3, :3]

    @scoped_precision
    def init_state(self, first_image, t0, rng_keys, second_image=None) -> VioState:
        first_image = normalize_input(first_image)
        second_image = normalize_input(second_image)
        if self.rectify:
            first_image, second_image = self.rectify_inputs(first_image, second_image)
        return VioState(
            backend=self.backend.init_state(rng_keys),
            tracker=self.tracker.init_state(first_image, t0, second_image),
            tracker_ready=torch.ones_like(t0, dtype=torch.bool))

    def predict_flow(self, bstate: BackendState, tstate: TrackerState, camera0=None):
        """(guess, stereo_guess, has_baseline): per-slot predicted pixels
        (B, T, 2) in the left and (stereo; else None) the right camera, and
        (B, T) whether the slot's distance came from the trail's
        two-view triangulation (trail slots at least 10 apart) instead of
        the minimum distance."""
        m = bstate.ekf.m
        B = m.shape[0]
        K = self.L + 1
        i2c = self.backend.imu_to_camera
        pose_states = gather_pose_states(m, self.L)
        cp = camera_poses_from_states(pose_states, i2c)
        exists = tr.feature_exists(bstate.trail, tstate.track_ids)  # (B, K, T)
        ks = torch.arange(K, device=m.device)[None, :, None]
        k0 = torch.amin(torch.where(exists, ks, K), dim=1)
        k1 = torch.amax(torch.where(exists, ks, -1), dim=1)
        has_baseline = (k1 - k0) >= 10
        k0c = torch.clamp(k0, 0, K - 1)
        k1c = torch.clamp(k1, 0, K - 1)
        kn = bstate.trail.kf_norm[:, :, :, 0, :]
        pick = lambda a, k: torch.gather(a, 1, k.reshape(k.shape + (1,) * (a.dim() - 2)).expand(
            k.shape + a.shape[2:]))
        pf = triangulate_two_cameras(pick(cp.p, k0c), pick(cp.R, k0c), pick(cp.p, k1c),
                                     pick(cp.R, k1c), _lane_gather(kn, k0c), _lane_gather(kn, k1c))
        dist = torch.where(has_baseline & (pf[..., 2] > 0.0), torch.linalg.norm(pf, dim=-1),
                           torch.full_like(pf[..., 2], -1.0))
        dist = torch.clamp(dist, min=self.pt.predictOpticalFlowMinTriangulationDistance)

        c0 = self.cameras[0] if camera0 is None else camera0
        prev_px = tstate.px[:, :, 0, :].to(m.dtype)
        ray0, ok0 = pixel_to_ray(c0, prev_px)
        cam_to_world = to_camera_to_world(pose_states[:, 1, :3], pose_states[:, 1, 3:], i2c)
        pos, ori = m[:, POS:POS + 3], m[:, ORI:ORI + 4]
        world_to_cam = to_world_to_camera(pos, ori, i2c)
        pw = transform_vec3(cam_to_world[:, None], ray0 * dist[..., None])
        pix1, ok1 = ray_to_pixel(c0, transform_vec3(world_to_cam[:, None], pw))
        guess = torch.where((ok0 & ok1)[..., None], pix1, prev_px)
        guess2 = None
        if self.pt.useStereo:
            world_to_cam2 = to_world_to_camera(pos, ori, self.backend.second_imu_to_camera)
            pix2, ok2 = ray_to_pixel(self.cameras[1], transform_vec3(world_to_cam2[:, None], pw))
            guess2 = torch.where((ok0 & ok2)[..., None], pix2, guess).to(IMAGE_DTYPE)
        return guess.to(IMAGE_DTYPE), guess2, has_baseline

    def imu_only(self, state: VioState, imu: ImuBatch, n_valid=None) -> VioState:
        """IMU propagation with no frame; ``n_valid`` as ``Backend.imu_scan``."""
        return state._replace(backend=self.backend.imu_scan(state.backend, imu, n_valid))

    def track_stage(self, state: VioState, t, image, second_image=None, camera0=None):
        if camera0 is not None and (self.pt.useStereo or self.dense_depth):
            raise ValueError("varying intrinsics are supported for mono only")
        image = normalize_input(image)
        second_image = normalize_input(second_image)
        image, second_image = self.rectify_inputs(image, second_image)
        bstate = state.backend
        guess = stereo_guess = None
        if self.pt.predictOpticalFlow:
            guess, stereo_guess, _ = self.predict_flow(bstate, state.tracker, camera0)
        keys = jr.split(bstate.rng)
        tkey = jr.fold_in(keys[:, 1], self.pt.ransacRngSeed)
        bstate = bstate._replace(rng=keys[:, 0])
        tstate, tout = self.tracker.track_frame(
            state.tracker, image, tkey, t, flow_guess=guess,
            blacklist_flags=bstate.blacklist_flags, blacklist_ids=bstate.blacklist_ids,
            second_image=second_image, stereo_guess=stereo_guess,
            pose_rot=self.pose_rotations(bstate.ekf.m) if self.upright else None,
            camera0=camera0)
        dtype = self.dtype
        if self.dense_depth:
            depth = self.track_dense_depth(image, second_image, tout.pixels[:, :, 0, :],
                                           tout.track_ids >= 0)
        else:
            depth = torch.full(tout.track_ids.shape, -1.0, dtype=dtype, device=t.device)
        tin = TrackerInput(
            track_ids=tout.track_ids, pixels=tout.pixels.to(dtype), keyframe=tout.keyframe,
            stereo_depth=depth,
            track_status=tout.status, prev_pixels=tout.prev_pixels, viz_pixels=tout.viz_pixels)
        return VioState(backend=bstate, tracker=tstate, tracker_ready=state.tracker_ready), tin

    def backend_stage(self, state: VioState, tin: TrackerInput, camera0=None):
        bstate, out = self.backend.process_frame(state.backend, tin, camera0)
        return state._replace(backend=bstate), out

    @scoped_precision
    def step(self, state: VioState, imu: ImuBatch, image, second_image=None, n_valid=None,
             camera0=None):
        """IMU propagation first, so the flow prediction uses the pose at
        the frame time. Its products run at "highest" with TF32 off,
        whatever the caller set (restored on return). ``n_valid``: the
        count of valid IMU columns, where the caller knows it (the rest are
        then skipped, as ``Backend.imu_scan``); ``camera0``: the frame's
        own first camera (mono). On the card an empty kernel marks the end
        of the IMU propagation and of the front end (``ops._lib.mark_stage``)."""
        state = self.imu_only(state, imu, n_valid)
        mark_stage("imu", imu.t)
        state, tin = self.track_stage(state, imu.t[:, -1], image, second_image, camera0)
        mark_stage("frontend", imu.t)
        return self.backend_stage(state, tin, camera0)
