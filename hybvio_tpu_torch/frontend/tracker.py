"""Tracker core: the track-lifecycle engine (port of the reference's
``frontend/tracker.py``), batch-first.

Per frame: the pyramid of the frame (of the left and right frames in
stereo; once per step for a frame shared by every lane, (H, W), or per lane
for per-lane frames, (B, H, W), in the same one launch), LK of every lane's
tracks prev -> cur with
odometry-predicted guesses, in stereo left -> right LK with the epipolar
check, RANSAC2 (stationarity score) and in stereo RANSAC3 or the
gravity-aligned upright-2P (given the pose rotations), else the hybrid
RANSAC2/RANSAC5 selection (or RANSAC2 alone without ``useHybridRansac``),
keyframe / stationarity decision, capacity culling, and GFTT (or FAST)
top-up of the free slots. Detection runs in every lane and is masked per
lane, as the reference's ``lax.cond`` does under ``vmap``. The cameras may
be rectified pinholes carrying their rectification rotation.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from .. import random as jr
from ..geometry.cameras import normalize_pixel
from ..odometry.triangulation import triangulate_stereo_idp
from ..runtime import constant
from .fast import detect_fast
from .gftt import detect_corners, subpixel_refine
from .lk import FLOW_OK, FLOW_OUT_OF_RANGE, LKParams, lk_track_pyramid
from .pyramid import build_pyramids_with_gradients
from .ransac import hybrid_ransac, ransac2, ransac3, stereo_upright_2p
from .stereo import epipolar_check

ST_TRACKED = 0
ST_NEW = 1
ST_FAILED_FLOW = 2
ST_RANSAC_OUTLIER = 3
ST_FLOW_OUT_OF_RANGE = 4
ST_OUT_OF_RANGE = 5
ST_FAILED_EPIPOLAR_CHECK = 6
ST_CULLED = 7
ST_BLACKLISTED = 8


class TrackerState(NamedTuple):
    track_ids: torch.Tensor  # (B, T) int32, -1 = free slot
    px: torch.Tensor  # (B, T, C, 2)
    prev_pyr: Tuple[torch.Tensor, ...]  # (B, H_l, W_l); lane stride 0 when shared
    prev_ix: Tuple[torch.Tensor, ...]
    prev_iy: Tuple[torch.Tensor, ...]
    mask_scale: torch.Tensor  # (B,)
    next_track_id: torch.Tensor  # (B,) int32
    last_kf_px: torch.Tensor  # (B, T, 2)
    last_kf_id: torch.Tensor  # (B, T) int32
    frame_num: torch.Tensor  # (B,) int32
    prev_time: torch.Tensor  # (B,)


class TrackerOutput(NamedTuple):
    track_ids: torch.Tensor
    pixels: torch.Tensor
    keyframe: torch.Tensor
    ransac_score: torch.Tensor
    n_tracks: torch.Tensor
    status: torch.Tensor
    prev_pixels: torch.Tensor
    viz_pixels: torch.Tensor


def _lanes(levels, B):
    """Levels as (B, H, W): shared (H, W) ones as views with lane stride 0,
    per-lane ones as they are."""
    return [lv.expand((B,) + lv.shape[-2:]) if lv.dim() == 2 else lv for lv in levels]


def _scatter(a, idx, v):
    """a.at[idx].set(v) per lane, for a permutation idx (B, T)."""
    view = idx.reshape(idx.shape + (1,) * (a.dim() - 2)).expand(a.shape)
    return a.scatter(1, view, v)


class Tracker(nn.Module):
    """Stereo or mono tracker for static parameters; images are f32 in
    [0, 1], (H, W) shared by the B lanes or (B, H, W) one per lane."""

    def __init__(self, params, cameras, derived, max_tracks=None, int_bits: int = 32):
        super().__init__()
        pt = params.tracker
        self.stereo = bool(pt.useStereo)
        self.fast = pt.featureDetector.upper() == "FAST"
        self.pt = pt
        self.T = max_tracks if max_tracks is not None else pt.maxTracks
        self.int_bits = int_bits
        self.cam0 = cameras[0]
        self.cam1 = cameras[1] if self.stereo else None
        H, W = self.cam0.height, self.cam0.width
        if H <= 0 or W <= 0:
            raise ValueError("tracker camera needs width/height")
        min_dim = min(H, W)
        self.min_dim = min_dim
        su = min_dim / 720.0
        max_level = pt.pyrLKMaxLevel
        while max_level > 0 and (min_dim >> max_level) < pt.pyrLKWindowSize + 19:
            max_level -= 1
        self.lk = LKParams(window_size=pt.pyrLKWindowSize, max_level=max_level,
                           max_iter=pt.pyrLKMaxIter, epsilon=pt.pyrLKEpsilon,
                           min_eig_threshold=pt.pyrLKMinEigThreshold)
        self.ransac2_threshold = pt.ransac2Threshold * su
        # in normalized units (the reference's 2 * threshold / (f0 + f1))
        self.ransac5_threshold = 2.0 * pt.ransac5Threshold / (
            cameras[0].focal_length + cameras[-1].focal_length)
        if self.stereo:
            c0c1 = (np.asarray(derived.second_imu_to_camera)
                    @ np.linalg.inv(np.asarray(derived.imu_to_camera)))
            c0c1 = torch.as_tensor(c0c1, dtype=torch.float32)
            self.register_buffer("cam0_to_cam1", c0c1)
            self.register_buffer("second_to_first", torch.linalg.inv(c0c1))
            self.epipolar_dist = pt.maxStereoEpipolarDistance * su
        self.min_distance = max(pt.gfttMinDistance * su, 2.0)

    def mask_radius(self, mask_scale):
        r = torch.pow(constant(1.3, mask_scale.dtype, mask_scale.device),
                      mask_scale) * self.min_dim * self.pt.relativeMaskRadius
        return torch.clamp(torch.round(r), min=2.0)

    def detect(self, img, existing_xy, existing_valid, mask_scale, n_out):
        pt = self.pt
        if self.fast:  # cv::FAST's default threshold, 20 of 255
            xy, score, valid = detect_fast(
                img, n_out, existing_xy, existing_valid,
                mask_radius=self.mask_radius(mask_scale), min_distance=self.min_distance,
                threshold=20.0 / 255.0)
        else:
            xy, score, valid = detect_corners(
                img, n_out, existing_xy, existing_valid,
                mask_radius=self.mask_radius(mask_scale), min_distance=self.min_distance,
                block_size=pt.gfttBlockSize, min_response=pt.gfttMinResponse,
                n_candidates=max(2 * self.T, 128),
                crop_fraction=pt.partOfImageToDetectFeatures,
                quality_level=pt.gfttQualityLevel)
        if pt.subPixMaxIter > 0:
            xy = subpixel_refine(img, xy, window=min(pt.subPixWindowSize, 7),
                                 iters=min(pt.subPixMaxIter, 5), epsilon=pt.subPixEpsilon)
        return xy, score, valid

    def stereo_match(self, left_pyr, left_grads, right_pyr, pts_left, valid, guesses=None):
        """Left -> right LK + epipolar validation."""
        B = pts_left.shape[0]
        lk = self.lk
        nl = 2 if (guesses is not None and lk.max_level > 1) else lk.max_level + 1
        params = lk._replace(max_level=nl - 1)
        g = pts_left if guesses is None else guesses
        pts_right, status, _ = lk_track_pyramid(
            _lanes(left_pyr[:nl], B), [tuple(_lanes(gr, B)) for gr in left_grads[:nl]],
            _lanes(right_pyr[:nl], B), pts_left, initial_pts=g, params=params)
        ok = valid & (status == FLOW_OK)
        if self.pt.maxStereoEpipolarDistance > 0:
            ok = ok & epipolar_check(self.cam0, self.cam1, pts_left, pts_right, ok,
                                     self.cam0_to_cam1, self.epipolar_dist)
        return pts_right, ok

    def pyramids(self, image, second_image):
        """The frame's pyramid (and the right frame's in stereo) and the
        frame's gradients, in one kernel launch, of a shared (H, W) frame or
        of every lane's (B, H, W) one."""
        images = (image, second_image) if self.stereo else (image,)
        pyrs, grads = build_pyramids_with_gradients(
            tuple(im.to(torch.float32) for im in images), self.lk.max_level)
        return pyrs[0], pyrs[1] if self.stereo else None, grads

    def init_state(self, first_image, t0, second_image=None) -> TrackerState:
        """Detect in the first frame (shared (H, W) or per lane (B, H, W));
        t0 (B,)."""
        B, T = t0.shape[0], self.T
        dev = first_image.device
        img = first_image.to(torch.float32)
        pyr, rpyr, grads = self.pyramids(img, second_image)
        xy, _, valid = self.detect(
            img, torch.zeros((B, 1, 2), device=dev), torch.zeros((B, 1), dtype=torch.bool, device=dev),
            torch.zeros((B,), device=dev), T)
        if self.stereo:
            rxy, rok = self.stereo_match(pyr, grads, rpyr, xy, valid)
            valid = valid & rok
            px = torch.stack([xy, rxy], dim=2)
        else:
            px = xy[:, :, None, :]
        slots = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
        ids = torch.where(valid, slots + 1, -1).to(torch.int32)
        i32 = lambda v: torch.full((B,), v, dtype=torch.int32, device=dev)
        return TrackerState(
            track_ids=ids, px=px, prev_pyr=tuple(_lanes(pyr, B)),
            prev_ix=tuple(_lanes([g[0] for g in grads], B)),
            prev_iy=tuple(_lanes([g[1] for g in grads], B)),
            mask_scale=torch.zeros((B,), device=dev), next_track_id=i32(T + 1),
            last_kf_px=xy, last_kf_id=ids, frame_num=i32(1),
            prev_time=t0.to(torch.float32))

    def track_frame(self, ts: TrackerState, image, rng_key, t, flow_guess,
                    blacklist_flags, blacklist_ids, second_image=None, stereo_guess=None,
                    pose_rot=None, camera0=None):
        """One new frame (stereo: pair), shared (H, W) or per lane
        (B, H, W): (state, TrackerOutput). rng_key (B, 2); t (B,);
        flow_guess / stereo_guess (B, T, 2), flow_guess None for the
        previous positions; pose_rot, for upright-2P, the (previous,
        current) camera-to-world rotations (B, 3, 3); camera0, mono only, a
        per-frame first camera (``with_intrinsics``) that replaces the
        static one for this frame, RANSAC5's threshold scaled by its focal
        length."""
        pt, lk, T = self.pt, self.lk, self.T
        c0, r5_threshold = self.cam0, self.ransac5_threshold
        if camera0 is not None:
            if self.stereo:
                raise ValueError("varying intrinsics are supported for mono only")
            c0 = camera0
            r5_threshold = pt.ransac5Threshold / ((c0.fx + c0.fy) * 0.5)
        B = ts.track_ids.shape[0]
        dev = ts.px.device
        img = image.to(torch.float32)
        cur_pyr, right_pyr, cur_grads = self.pyramids(img, second_image)

        alive = ts.track_ids >= 0
        black = blacklist_flags & (blacklist_ids == ts.track_ids) & alive

        prev_px = ts.px[:, :, 0, :]
        guesses = (prev_px if flow_guess is None
                   else torch.where(alive[..., None], flow_guess, prev_px))
        new_px, flow_status, _ = lk_track_pyramid(
            list(ts.prev_pyr), list(zip(ts.prev_ix, ts.prev_iy)), _lanes(cur_pyr, B),
            prev_px, initial_pts=guesses, params=lk)
        flow_ok = alive & (flow_status == FLOW_OK) & ~black
        tracked = flow_ok
        if self.stereo:
            right_px, stereo_ok = self.stereo_match(cur_pyr, cur_grads, right_pyr, new_px,
                                                    flow_ok, guesses=stereo_guess)
            tracked = flow_ok & stereo_ok

        keys = jr.split(rng_key)
        rng_key, r_key = keys[:, 0], keys[:, 1]
        n1, ok_n1 = normalize_pixel(c0, prev_px)
        n2, ok_n2 = normalize_pixel(c0, new_px)
        valid_n = tracked & ok_n1 & ok_n2
        if self.stereo and (pt.useRansac3 or (pt.useStereoUpright2p and pose_rot is not None)):
            ransac_inliers, ransac_skipped, score = self.ransac_stereo(
                ts, prev_px, new_px, right_px, n1, n2, valid_n, r_key, rng_key, pose_rot)
        elif pt.useHybridRansac:
            hr = hybrid_ransac(c0, c0, prev_px, new_px, n1, n2, valid_n, r_key, pt,
                               self.ransac2_threshold, r5_threshold,
                               int_bits=self.int_bits)
            ransac_inliers, ransac_skipped, score = hr.inliers, hr.skipped, hr.score
        else:  # RANSAC2 gives the stationarity score and rejects nothing
            score = ransac2(c0, c0, prev_px, new_px, valid_n, r_key,
                            self.ransac2_threshold, int_bits=self.int_bits).score
            ransac_inliers, ransac_skipped = valid_n, torch.zeros_like(score, dtype=torch.bool)
        inlier = tracked & ransac_inliers
        few = torch.sum(tracked, dim=1) < 2
        inlier = torch.where((ransac_skipped & ~few)[:, None], False, inlier)
        inlier = torch.where(few[:, None], tracked, inlier)

        # keyframe / visual stationarity
        kf_known = (ts.last_kf_id == ts.track_ids) & alive
        move = torch.linalg.norm(new_px - ts.last_kf_px, dim=-1)
        move = torch.where(tracked & kf_known, move, torch.full_like(move, -1.0))
        max_move = torch.amax(move, dim=1)
        stationary = ((max_move >= 0.0) & (max_move < pt.visualStationarityMovementThreshold)
                      & (score > pt.visualStationarityScoreThreshold))
        keyframe = (ts.frame_num < pt.maxTrackLength) | ~stationary

        # capacity culling: when full, drop the larger slot of the closest pairs
        n_alive = torch.sum(inlier, dim=1)
        d2 = torch.sum((new_px[:, :, None, :] - new_px[:, None, :, :]) ** 2, dim=-1)
        iu = torch.triu_indices(T, T, offset=1, device=dev)
        pairmask = (inlier[:, :, None] & inlier[:, None, :])[:, iu[0], iu[1]]
        pd = torch.where(pairmask, d2[:, iu[0], iu[1]], torch.full_like(pairmask, float("inf"),
                                                                         dtype=d2.dtype))
        n_cull = max(T // 20, 1)
        small = torch.argsort(pd, dim=1, stable=True)[:, :n_cull]
        cull_slots = torch.maximum(iu[0][small], iu[1][small])
        cull_valid = torch.isfinite(torch.gather(pd, 1, small)) & (n_alive >= T)[:, None]
        cull = torch.zeros((B, T), dtype=torch.int32, device=dev).scatter_reduce(
            1, cull_slots, cull_valid.to(torch.int32), reduce="amax").to(torch.bool)

        keep = inlier & ~cull
        ids = torch.where(keep, ts.track_ids, -1).to(torch.int32)
        cur = (new_px, right_px) if self.stereo else (new_px,)
        px = torch.stack([torch.where(keep[..., None], c, torch.zeros_like(c)) for c in cur], dim=2)

        # detection top-up (every lane runs it; lanes with < 10% free slots
        # discard the result, like the reference's cond under vmap)
        missing = T - torch.sum(keep, dim=1)
        do_detect = missing >= T // 10
        det_xy, _, det_valid = self.detect(img, px[:, :, 0, :], keep, ts.mask_scale, T)
        det = [det_xy]
        if self.stereo:
            det_right, det_sok = self.stereo_match(cur_pyr, cur_grads, right_pyr, det_xy,
                                                   det_valid, guesses=det_xy)
            det_valid = det_valid & det_sok
            det.append(det_right)
        det_valid = det_valid & do_detect[:, None]
        det_px = torch.stack([torch.where(do_detect[:, None, None], d, torch.zeros_like(d))
                              for d in det], dim=2)

        free = ~keep
        free_order = torch.argsort((~free).to(torch.uint8), dim=1, stable=True)
        take = torch.minimum(torch.sum(free, dim=1), torch.sum(det_valid, dim=1))
        det_order = torch.argsort((~det_valid).to(torch.uint8), dim=1, stable=True)
        fill = torch.arange(T, device=dev)[None, :] < take[:, None]
        rank = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
        ids_at = torch.gather(ids, 1, free_order)
        ids = _scatter(ids, free_order,
                       torch.where(fill, ts.next_track_id[:, None] + rank, ids_at).to(torch.int32))
        px_at = torch.gather(px, 1, free_order[..., None, None].expand(px.shape))
        det_at = torch.gather(det_px, 1, det_order[..., None, None].expand(px.shape))
        px = _scatter(px, free_order, torch.where(fill[..., None, None], det_at, px_at))
        next_id = (ts.next_track_id + take).to(torch.int32)

        n_after = torch.sum(ids >= 0, dim=1)
        mscale = ts.mask_scale
        mscale = torch.where(n_after < (3 * T) // 4, mscale - 1.0, mscale)
        mscale = torch.where(n_after == T, mscale + 0.5, mscale)
        mscale = torch.clamp(mscale, -5.0, 5.0)

        upd = keyframe[:, None] & keep
        last_kf_px = torch.where(upd[..., None], px[:, :, 0, :], ts.last_kf_px)
        last_kf_id = torch.where(upd, ids, ts.last_kf_id)
        last_kf_id = torch.where(last_kf_id == ids, last_kf_id, -1).to(torch.int32)

        new_state = TrackerState(
            track_ids=ids, px=px, prev_pyr=tuple(_lanes(cur_pyr, B)),
            prev_ix=tuple(_lanes([g[0] for g in cur_grads], B)),
            prev_iy=tuple(_lanes([g[1] for g in cur_grads], B)),
            mask_scale=mscale, next_track_id=next_id, last_kf_px=last_kf_px,
            last_kf_id=last_kf_id, frame_num=ts.frame_num + 1,
            prev_time=t.to(torch.float32).clone(memory_format=torch.contiguous_format))

        status = torch.where(alive, ST_FAILED_FLOW, -1)
        status = torch.where(alive & (flow_status == FLOW_OUT_OF_RANGE), ST_FLOW_OUT_OF_RANGE, status)
        status = torch.where(flow_ok, ST_TRACKED, status)
        if self.stereo:
            status = torch.where(flow_ok & ~stereo_ok, ST_FAILED_EPIPOLAR_CHECK, status)
        status = torch.where(alive & black, ST_BLACKLISTED, status)
        status = torch.where(tracked & ~inlier, ST_RANSAC_OUTLIER, status)
        status = torch.where(inlier & cull, ST_CULLED, status)
        status = _scatter(status, free_order,
                          torch.where(fill, ST_NEW, torch.gather(status, 1, free_order)))
        settled = (keep | ~alive)[..., None]
        viz_px = torch.stack([torch.where(settled, px[:, :, c, :], a) for c, a in enumerate(cur)],
                             dim=2)
        out = TrackerOutput(
            track_ids=torch.where(keep, ts.track_ids, -1).to(torch.int32),
            pixels=torch.where(keep[..., None, None], px, torch.zeros_like(px)),
            keyframe=keyframe, ransac_score=score,
            n_tracks=torch.sum(keep, dim=1).to(torch.int32),
            status=status.to(torch.int32), prev_pixels=ts.px, viz_pixels=viz_px)
        return new_state, out

    def ransac_stereo(self, ts, prev_px, new_px, right_px, n1, n2, valid_n, r_key, rng_key,
                      pose_rot=None):
        """RANSAC2 for the stationarity score, then on the stereo
        triangulations of the previous frame either RANSAC3 (against the
        current frame's) or, without ``useRansac3``, upright-2P (against the
        current left rays, in world axes through ``pose_rot``): (inliers,
        skipped, score)."""
        pt = self.pt
        r2 = ransac2(self.cam0, self.cam0, prev_px, new_px, valid_n, r_key,
                     self.ransac2_threshold, int_bits=self.int_bits)
        ransac_inliers = r2.inliers
        ransac_skipped = torch.sum(valid_n, dim=1) < 2

        key = jr.split(rng_key)[:, 1]
        n1r, ok1r = normalize_pixel(self.cam1, ts.px[:, :, 1, :])
        idp_prev, _, okt1 = triangulate_stereo_idp(n1, n1r, self.second_to_first, with_cov=False)
        if pt.useRansac3:
            n2r, ok2r = normalize_pixel(self.cam1, right_px)
            idp_cur, _, okt2 = triangulate_stereo_idp(n2, n2r, self.second_to_first,
                                                      with_cov=False)

            def idp_to_xyz(idp):
                z = 1.0 / torch.where(torch.abs(idp[..., 2]) > 1e-9, idp[..., 2],
                                      torch.ones_like(idp[..., 2]))
                return torch.stack([idp[..., 0] * z, idp[..., 1] * z, z], dim=-1)

            v3 = (valid_n & ok1r & ok2r & okt1 & okt2
                  & (idp_prev[..., 2] > 1e-4) & (idp_cur[..., 2] > 1e-4))
            res = ransac3(idp_to_xyz(idp_prev), idp_to_xyz(idp_cur), n2, v3, key,
                          error_thresh=pt.ransac3ErrorThresh, max_iters=64,
                          int_bits=self.int_bits)
        else:
            R0, R1 = (r.to(n2.dtype) for r in pose_rot)
            okd = idp_prev[..., 2] > 1e-4
            z = 1.0 / torch.where(okd, idp_prev[..., 2], torch.ones_like(idp_prev[..., 2]))
            p_cam = torch.stack([idp_prev[..., 0] * z, idp_prev[..., 1] * z, z], dim=-1)
            rays = torch.cat([n2, torch.ones_like(n2[..., :1])], dim=-1)
            rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
            res = stereo_upright_2p(
                p_cam @ R0.transpose(-1, -2), rays @ R1.transpose(-1, -2),
                valid_n & ok1r & okt1 & okd, key,
                error_thresh=pt.ransacStereoUpright2pErrorThresh,
                world_to_cam=R1.transpose(-1, -2), cur_norm=n2, int_bits=self.int_bits)
        frac = res.inlier_count / torch.clamp(torch.sum(valid_n, dim=1), min=1).to(n2.dtype)
        good = res.ok & (frac >= pt.ransacMinInlierFraction)
        ransac_inliers = torch.where(good[:, None], res.inliers, ransac_inliers)
        ransac_skipped = torch.where(good, False, ransac_skipped)
        return ransac_inliers, ransac_skipped, r2.score
