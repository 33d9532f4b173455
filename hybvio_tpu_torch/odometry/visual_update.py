"""Visual-update measurement model (port of the reference's
``odometry/visual_update.py``): (H, f, y) for a batch of feature tracks.

The measurement function

    h(poses, sft) = project_all(poses, triangulate(poses, feats + sft*vels))
                    - sft * vels

is written once per track and ``torch.func.vmap(torch.func.jacfwd(h))``
gives the full Jacobian, including the chain through the triangulation (GN,
linear, or with ``useIndependentStereoTriangulation`` the fusion of the
track's per-keyframe stereo triangulations) and the IMU-camera time-shift
column. A hybrid map-point track skips the triangulation: its point is a
state block, so h takes the point as three more inputs and H gets their
columns.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ekf.state import CAM, ORI, POS, POSE_DIM, SFT
from .triangulation import (
    TRI_BAD_COND, TRI_BAD_DEPTH, TRI_HYBRID, TRI_OK, CameraPoses, camera_poses_from_states,
    triangulate_gn, triangulate_linear, triangulate_stereo_fused,
)

PREPARE_VU_OK = 0
PREPARE_VU_BEHIND = 1
PREPARE_VU_ZERO_DEPTH = 2


class TrackUpdateData(NamedTuple):
    H: torch.Tensor  # (..., rows, d) full-width Jacobian, masked rows zero
    f: torch.Tensor  # (..., rows)
    y: torch.Tensor  # (..., rows)
    row_mask: torch.Tensor  # (..., rows) bool
    tri_status: torch.Tensor  # (...,) int64
    prepare_status: torch.Tensor  # (...,) int64
    pf: torch.Tensor  # (..., 3) triangulated world point


def _project(poses: CameraPoses, pf):
    pfc = (poses.R @ (pf[None, :] - poses.p)[..., None])[..., 0]
    z = pfc[:, 2]
    safe_z = torch.where(torch.abs(z) > 1e-12, z, torch.ones_like(z))
    return pfc[:, :2] / safe_z[:, None], z


def make_prepare_track_update(po, imu_to_camera, second_imu_to_camera, use_stereo, d):
    """prepare(pose_states (..., N, 7), ips (..., C*N, 2), vels (..., C*N, 2),
    mask (..., N), map_point=None, map_point_offset=None, stereo_idp=None,
    stereo_cov=None, stereo_valid=None) -> TrackUpdateData, where row k of
    the poses is trail index k (0 = current pose) and masked rows hold a
    finite stand-in pose.

    With ``map_point`` (..., 3) and ``map_point_offset`` (...,) given (the
    hybrid form), the track's point is that hybrid map point: it is not
    triangulated, its status is TRI_HYBRID and H gets d proj / d pf at the
    three state columns from the offset (an offset of ``d`` drops them).
    Otherwise the point is triangulated by Gauss-Newton, or in closed form
    with ``useLinearTriangulation``; in stereo with
    ``useIndependentStereoTriangulation`` and ``stereo_idp`` (..., N, 3),
    ``stereo_cov`` (..., N, 3, 3), ``stereo_valid`` (..., N) given (the
    track's per-keyframe stereo triangulations), by their information-
    weighted fusion, which needs one usable row (else TRI_BAD_COND); the
    time shift moves each row along its left-camera feature velocity.

    ``imu_to_camera`` / ``second_imu_to_camera`` are 4x4 tensors in the
    filter dtype."""
    use_indep_stereo = use_stereo and bool(po.useIndependentStereoTriangulation)
    est_sft = bool(po.estimateImuCameraTimeShift)
    n_cams = 2 if use_stereo else 1
    i2c = imu_to_camera
    i2c2 = second_imu_to_camera

    def trail_from_states(ps):
        t0 = camera_poses_from_states(ps, i2c)
        if not use_stereo:
            return t0
        t1 = camera_poses_from_states(ps, i2c2)
        return CameraPoses(torch.cat([t0.p, t1.p], dim=-2), torch.cat([t0.R, t1.R], dim=-3))

    def triangulate(trail, feats, mask):
        if po.useLinearTriangulation:
            return triangulate_linear(trail, feats, mask.repeat(n_cams))
        rcond_thr = po.triangulationRcondThreshold
        if feats.dtype == torch.float32:
            rcond_thr = max(rcond_thr, 1e-5)
        return triangulate_gn(
            trail, feats, mask.repeat(n_cams),
            gn_iterations=int(po.triangulationGaussNewtonIterations),
            convergence_threshold=po.triangulationConvergenceThreshold,
            convergence_r=po.triangulationConvergenceR,
            rcond_threshold=rcond_thr, stereo=use_stereo)

    def measure(trail, pf, sft, vels):
        out = _project(trail, pf)[0].reshape(-1)
        return out - sft * vels.reshape(-1) if est_sft else out

    def one_track(x, ips, vels, mask):
        """h of one track and its triangulation outcome (as aux)."""
        N = mask.shape[0]
        sft = x[N * 7]
        trail = trail_from_states(x[:N * 7].reshape(N, 7))
        pf, status = triangulate(trail, ips + sft * vels if est_sft else ips, mask)
        out = measure(trail, pf, sft, vels)
        return out, (out, pf, status)

    def one_map_track(x, vels, pf_in):
        """h of one hybrid map-point track: x = poses, time shift, map point
        delta."""
        N = (x.shape[0] - 4) // 7
        trail = trail_from_states(x[:N * 7].reshape(N, 7))
        out = measure(trail, pf_in + x[N * 7 + 1:N * 7 + 4], x[N * 7], vels)
        return out, out

    def one_stereo_track(x, vels, mask, sidp, scov, svalid):
        """h of one track from its fused stereo triangulations."""
        N = mask.shape[0]
        sft = x[N * 7]
        ps = x[:N * 7].reshape(N, 7)
        if est_sft:
            sidp = sidp + sft * torch.cat([vels[:N], torch.zeros_like(vels[:N, :1])], dim=1)
        pf, status, _ = triangulate_stereo_fused(camera_poses_from_states(ps, i2c), sidp, scov,
                                                 svalid & mask)
        status = torch.where(torch.sum(svalid & mask) >= 1, status, TRI_BAD_COND)
        out = measure(trail_from_states(ps), pf, sft, vels)
        return out, (out, pf, status)

    jac = torch.func.vmap(torch.func.jacfwd(one_track, has_aux=True))
    jac_map = torch.func.vmap(torch.func.jacfwd(one_map_track, has_aux=True))
    jac_stereo = torch.func.vmap(torch.func.jacfwd(one_stereo_track, has_aux=True))

    def prepare(pose_states, ips, vels, mask, map_point=None, map_point_offset=None,
                stereo_idp=None, stereo_cov=None, stereo_valid=None) -> TrackUpdateData:
        lead = mask.shape[:-1]
        N = mask.shape[-1]
        rows = 2 * n_cams * N
        dtype = pose_states.dtype
        hybrid = map_point_offset is not None
        flat = lambda a: a.reshape((-1,) + a.shape[len(lead):])
        ps_f, ips_f, vels_f, mask_f = flat(pose_states), flat(ips), flat(vels), flat(mask)
        NB = mask_f.shape[0]
        x0 = torch.cat([ps_f.reshape(NB, N * 7),
                        torch.zeros((NB, 4 if hybrid else 1), dtype=dtype, device=ps_f.device)],
                       dim=1)
        trail = trail_from_states(ps_f)
        if hybrid:
            pf = flat(map_point)
            J, f = jac_map(x0, vels_f, pf)
            tri_status = torch.full((NB,), TRI_HYBRID, dtype=torch.int64, device=pf.device)
        else:
            if use_indep_stereo and stereo_idp is not None:
                J, (f, pf, tri_status) = jac_stereo(x0, vels_f, mask_f, flat(stereo_idp),
                                                    flat(stereo_cov), flat(stereo_valid))
            else:
                J, (f, pf, tri_status) = jac(x0, ips_f, vels_f, mask_f)
            depth = torch.linalg.norm(pf - trail.p[:, 0], dim=-1)
            max_dist = po.triangulationMaxDist
            if max_dist > torch.finfo(dtype).max:
                max_dist = float("inf")
            bad_depth = (depth < po.triangulationMinDist) | (depth > max_dist)
            tri_status = torch.where((tri_status == TRI_OK) & bad_depth, TRI_BAD_DEPTH,
                                     tri_status)

        full_mask = mask_f.repeat(1, n_cams)
        z = (trail.R @ (pf[:, None, :] - trail.p)[..., None])[..., 2, 0]
        zero_depth = torch.any(full_mask & (torch.abs(z) < 1e-12), dim=1)
        behind = torch.any(full_mask & (z < 0), dim=1)
        prepare_status = torch.where(zero_depth, PREPARE_VU_ZERO_DEPTH,
                                     torch.where(behind, PREPARE_VU_BEHIND, PREPARE_VU_OK))

        # place the per-pose Jacobian columns: pose 0 -> POS / ORI blocks,
        # pose k >= 1 -> trail block k-1; masked poses contribute nothing
        Jp = J[:, :, :N * 7].reshape(NB, rows, N, 7)
        Jp = torch.where(mask_f[:, None, :, None], Jp, torch.zeros_like(Jp))
        H = torch.zeros((NB, rows, d), dtype=dtype, device=J.device)
        H[:, :, POS:POS + 3] = Jp[:, :, 0, :3]
        H[:, :, ORI:ORI + 4] = Jp[:, :, 0, 3:]
        H[:, :, CAM:CAM + POSE_DIM * (N - 1)] = Jp[:, :, 1:].reshape(NB, rows, -1)
        if est_sft:
            H[:, :, SFT] = J[:, :, N * 7]
        if hybrid:  # the map point's three columns from its offset (d: none)
            rel = (torch.arange(d, device=J.device)[None, :]
                   - flat(map_point_offset).to(torch.int64)[:, None])
            in_block = ((rel >= 0) & (rel < 3))[:, None, :]
            J_map = torch.gather(J[:, :, N * 7 + 1:N * 7 + 4], 2,
                                 torch.clamp(rel, 0, 2)[:, None, :].expand(NB, rows, d))
            H = torch.where(in_block, J_map, H)
        row_mask = full_mask.repeat_interleave(2, dim=1)
        rmf = row_mask.to(dtype)
        H = H * rmf[:, :, None]
        unflat = lambda a: a.reshape(lead + a.shape[1:])
        return TrackUpdateData(
            H=unflat(H), f=unflat(f * rmf), y=unflat(ips_f.reshape(NB, -1) * rmf),
            row_mask=unflat(row_mask), tri_status=unflat(tri_status),
            prepare_status=unflat(prepare_status), pf=unflat(pf))

    return prepare
