"""The sequential visual update (port of the reference backend's
``visual_update_phase``, the reference's default ``batchVisualUpdate =
false``): the NV ordered candidates update the filter one after another,
each against the mean and covariance the previous one left.

Candidate j's trail poses come from the mean after candidate j - 1, so the
NV steps cannot run at once; each step runs for all B lanes together, with
per-lane masks for activity, the update budget, gating, map-point
promotion, the blacklist and threshold growth, and no lane stops the loop.
With the hybrid map (M > 0) a map-point track updates its map block
directly, and an accepted track that finds a free map slot is inserted into
it on top of the state its own update left, as the reference does.
"""
from __future__ import annotations

import torch

from ..ekf import MAP_POINT_DIM, insert_map_point, visual_track_update
from ..lanes import lane_where
from . import trail as tr
from .batched_update import (
    PF_HYBRID, PF_OUTLIER, PF_POSE_TRAIL, PF_UNUSED, gather_pose_states, prepare_candidates,
    select_candidates,
)
from .triangulation import TRI_OK


def make_sequential_visual_update(po, prepare, d, NV, n_cams, visual_r, rmse_thr0, chi_r0,
                                  sqrt_mode: bool = False):
    """``visual_r``, ``rmse_thr0``, ``chi_r0``: floats or 0-d tensors (a
    per-frame lens); a gate is on or off by its parameter's sign.
    ``sqrt_mode``: the filter carries the factor W (``ekf/sqrt.py``)."""
    L = po.cameraTrailLength
    M = po.hybridMapSize
    sampling = tr.SAMPLING[po.trackSampling]
    noise_scale = po.noiseScale**2
    growth = po.trackOutlierThresholdGrowthFactor
    rmse_on = po.trackRmseThreshold >= 0
    chi_on = po.trackChiTestOutlierR >= 0

    def need_more_of(attempts, successes):
        ok = torch.ones_like(attempts, dtype=torch.bool)
        if po.maxSuccessfulVisualUpdates > 0:
            ok = ok & (successes < po.maxSuccessfulVisualUpdates)
        if po.maxVisualUpdates > 0:
            ok = ok & (attempts < po.maxVisualUpdates)
        return ok

    def phase(state, track_ids, valid, rng):
        """Returns (state, point cloud tuple, need_more (B,), too_many_failures (B,))."""
        trail = state.trail
        ekf = state.ekf
        B, T = track_ids.shape
        dtype, dev = ekf.m.dtype, ekf.m.device
        c = select_candidates(po, state, track_ids, valid, rng, NV, n_cams)
        ids_o = torch.gather(track_ids, 1, c.order)
        slots = torch.arange(T, device=dev)[None, :]

        # a gate is on or off for the whole frame, from its parameter's sign
        zeros = torch.zeros((B,), dtype=dtype, device=dev)
        rmse_thr = zeros + rmse_thr0 if rmse_on else -1.0
        chi_r = zeros + chi_r0 if chi_on else -1.0
        m, P = ekf.m, ekf.P
        kf_used, mp_ids = trail.kf_used, trail.map_point_ids
        attempts = torch.zeros((B,), dtype=torch.int32, device=dev)
        successes = torch.zeros_like(attempts)
        bl_flags = torch.zeros_like(valid)
        bl_ids = torch.full_like(track_ids, -1)
        pcs = []
        for j in range(NV):
            active, mp, sel = c.active[:, j], c.map_point[:, j], c.selected[:, j]
            need_more = need_more_of(attempts, successes)
            pose_states = gather_pose_states(m, L)
            ps = torch.where(sel[..., None], pose_states, pose_states[:, :1])
            out = prepare_candidates(prepare, ps, c.ips[:, j], c.vels[:, j], sel, m, mp,
                                     c.map_index[:, j], M,
                                     {k: v[:, j] for k, v in c.stereo.items()})
            tri_ok = (out.tri_status == TRI_OK) | mp
            do_update = active & need_more & tri_ok & (out.prepare_status == 0)
            res = visual_track_update(m, P, out.H, out.f, out.y, out.row_mask, visual_r,
                                      noise_scale, chi_r, rmse_thr, apply_update=do_update,
                                      sqrt_mode=sqrt_mode)
            inlier = res.is_inlier & do_update
            m, P = res.m, res.P

            if M > 0:  # promotion into a free map slot, inserted on top of the update
                promote = inlier & ~mp & (c.n_selected[:, j] >= po.trackMinFrames)
                idx, offered = tr.offer_map_point(trail._replace(map_point_ids=mp_ids), ids_o[:, j])
                can_promote = promote & (idx >= 0)
                mp_ids = torch.where(can_promote[:, None], offered.map_point_ids, mp_ids)
                off = d - MAP_POINT_DIM * (M - torch.clamp(idx, min=0))
                ins = insert_map_point(ekf._replace(m=m, P=P), off, out.pf, sqrt_mode)
                m, P = lane_where(can_promote, ins.m, m), lane_where(can_promote, ins.P, P)

            used = tr.mark_track_used(trail._replace(kf_used=kf_used), c.order[:, j], sel,
                                      sampling, track_ids).kf_used
            kf_used = torch.where(inlier[:, None, None], used, kf_used)

            outlier = do_update & ~res.is_inlier
            if rmse_on:
                rmse_thr = torch.where(outlier, rmse_thr * growth, rmse_thr)
            if chi_on:
                chi_r = torch.where(outlier, chi_r * growth, chi_r)
            if po.blacklistTracks:
                at = (slots == c.order[:, j:j + 1]) & (active & need_more & ~inlier)[:, None]
                bl_flags = bl_flags | at
                bl_ids = torch.where(at, track_ids, bl_ids)
            attempts = attempts + (active & ~mp & need_more).to(torch.int32)
            successes = successes + inlier.to(torch.int32)

            pc_valid = active & tri_ok
            pc_status = torch.where(
                ~active, PF_UNUSED,
                torch.where(mp, PF_HYBRID,
                            torch.where(inlier, PF_POSE_TRAIL,
                                        torch.where(do_update, PF_OUTLIER, PF_UNUSED))))
            pcs.append((torch.where(pc_valid[:, None], out.pf, torch.zeros_like(out.pf)),
                        pc_status.to(torch.int32),
                        torch.where(pc_valid, ids_o[:, j], torch.full_like(ids_o[:, j], -1)),
                        out.tri_status.to(torch.int32), out.prepare_status.to(torch.int32)))

        # blacklisted-last-frame tracks stay blacklisted until replaced
        if po.blacklistTracks:
            bl_flags = bl_flags | c.was_blacklisted
            bl_ids = torch.where(c.was_blacklisted, track_ids, bl_ids)
        if not sqrt_mode:  # the factor is PSD by construction and not symmetric
            P = 0.5 * (P + P.transpose(-1, -2))
        too_many_failures = (attempts - successes) > 5
        state = state._replace(
            ekf=ekf._replace(m=m, P=P), trail=trail._replace(kf_used=kf_used, map_point_ids=mp_ids),
            rng=c.rng, blacklist_flags=bl_flags, blacklist_ids=bl_ids)
        pc = tuple(torch.stack(x, dim=1) for x in zip(*pcs))
        return state, pc, need_more_of(attempts, successes), too_many_failures

    return phase
