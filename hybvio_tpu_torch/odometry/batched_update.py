"""The batched visual update (port of the reference backend's
``visual_update_phase_batched``): all candidate tracks triangulate and gate
in parallel against the same pre-update state, and the accepted ones apply
as stacked EKF updates of at most ``d * batchVisualUpdateMaxSizeMultiplier``
rows each. Hybrid map-point tracks join the stack with their map columns;
accepted tracks that claim a free map slot stay out of it and are inserted
afterwards in one vectorized write. Batch-first over lanes.

``select_candidates`` (scoring, pose selection, eligibility and the
randomized order, map points first) is shared with the sequential form.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import random as jr
from ..ekf import (
    CAM, MAP_POINT_DIM, MAP_POINT_PRIOR_STD, ORI, POS, POSE_DIM, visual_track_gate,
    visual_track_update,
)
from ..ekf.sqrt import sr_add_diag_noise
from ..lanes import lane_where
from . import trail as tr
from .triangulation import TRI_OK

PF_UNUSED = 0
PF_POSE_TRAIL = 1
PF_HYBRID = 2
PF_SLAM = 3
PF_OUTLIER = 4
PF_STEREO = 5


def gather_pose_states(m, L):
    """(B, K, 7): row 0 = current pose, row k = trail pose k-1."""
    cur = torch.cat([m[:, POS:POS + 3], m[:, ORI:ORI + 4]], dim=1)
    trail = m[:, CAM:CAM + POSE_DIM * L].reshape(m.shape[0], L, POSE_DIM)
    return torch.cat([cur[:, None], trail], dim=1)


def _take(a, idx):
    """a[b, idx[b, j], ...] for (B, T, ...) a and (B, J) idx."""
    view = idx.reshape(idx.shape + (1,) * (a.dim() - 2)).expand(idx.shape + a.shape[2:])
    return torch.gather(a, 1, view)


def _scatter_lanes(idx, values, T):
    """zeros(B, T).at[idx].set(values) for distinct idx per lane."""
    out = torch.zeros(values.shape[:1] + (T,), dtype=values.dtype, device=values.device)
    return out.scatter(1, idx, values)


class Candidates(NamedTuple):
    """The visual-update candidates of a frame, per lane: the NV track slots
    in update order and, gathered in that order, what the update needs."""
    rng: torch.Tensor  # (B, 2) the key left after the draws
    order: torch.Tensor  # (B, NV) track slots
    active: torch.Tensor  # (B, NV) eligible
    map_point: torch.Tensor  # (B, NV) the track is a hybrid map point
    map_index: torch.Tensor  # (B, NV) its map slot, -1 if none
    selected: torch.Tensor  # (B, NV, K) its trail poses
    n_selected: torch.Tensor  # (B, NV)
    ips: torch.Tensor  # (B, NV, C*K, 2) its normalized points, camera-major
    vels: torch.Tensor  # (B, NV, C*K, 2) their velocities
    selected_all: torch.Tensor  # (B, T, K) every slot's trail poses
    was_blacklisted: torch.Tensor  # (B, T)
    exists_head: torch.Tensor  # (B, K, T) feature_exists
    # useIndependentStereoTriangulation: prepare()'s stereo_idp (B, NV, K, 3),
    # stereo_cov (B, NV, K, 3, 3) and stereo_valid (B, NV, K); else empty
    stereo: dict


def select_candidates(po, state, track_ids, valid, rng, NV, n_cams) -> Candidates:
    """Score the tracks, select each one's trail poses (GAP / ALL / RANDOM,
    RANDOM with one key per track from ``split(sel_key, T)``), find the
    hybrid map points, and order the eligible tracks randomly, map points
    first; ``rng`` (B, 2) is each lane's key."""
    trail = state.trail
    B, T = track_ids.shape
    dtype = state.ekf.m.dtype
    sampling = tr.SAMPLING[po.trackSampling]
    exists_head = tr.feature_exists(trail, track_ids)
    scores = tr.track_scores(trail, track_ids, sampling)
    keys = jr.split(rng)
    rng = keys[:, 0]
    sel_keys = jr.split(keys[:, 1], T) if sampling == tr.SAMPLING_RANDOM else None
    selected_all, _ = tr.select_track_poses(trail, track_ids, sampling, sel_keys,
                                            po.randomTrackSamplingRatio)  # (B, T, K)
    n_sel = torch.sum(selected_all, dim=2)
    was_blacklisted = state.blacklist_flags & (state.blacklist_ids == track_ids) & valid

    if po.hybridMapSize > 0:
        hits = ((track_ids[:, :, None] == trail.map_point_ids[:, None, :])
                & (track_ids[:, :, None] >= 0))  # (B, T, M)
        is_map_point = torch.any(hits, dim=2)
        map_index = torch.where(is_map_point, torch.argmax(hits.to(torch.int8), dim=2),
                                torch.full_like(track_ids, -1, dtype=torch.int64))
    else:
        is_map_point = torch.zeros_like(valid)
        map_index = torch.full_like(track_ids, -1, dtype=torch.int64)

    cand = valid & exists_head[:, 0]
    if po.scoreVisualUpdateTracks:
        cscores = torch.where(cand, scores, torch.full_like(scores, float("inf")))
        n_cand = torch.sum(cand, dim=1)
        sorted_scores = torch.sort(cscores, dim=1).values
        mid = torch.gather(sorted_scores, 1, torch.clamp(n_cand // 2, 0, T - 1)[:, None])[:, 0]
        min_score = torch.where(n_cand > 0, mid, torch.full_like(mid, -1.0))
        ok_score = (scores >= min_score[:, None]) | is_map_point
    else:
        ok_score = torch.ones_like(cand)
    ok_len = (n_sel >= po.trackMinFrames) | is_map_point
    eligible = cand & ok_score & ok_len & ~was_blacklisted

    keys = jr.split(rng)
    rng, perm_key = keys[:, 0], keys[:, 1]
    noise = jr.uniform(perm_key, (T,), dtype)
    priority = ((torch.where(eligible, 0.0, 10.0) + torch.where(is_map_point, 0.0, 1.0)).to(dtype)
                + noise * 0.5)
    order = torch.argsort(priority, dim=1, stable=True)[:, :NV]  # (B, NV)

    K = selected_all.shape[2]

    def rows_of(a):  # (B, K, T, C, 2) -> (B, NV, C*K, 2)
        a = _take(a.transpose(1, 2), order)  # (B, NV, K, C, 2)
        return a.transpose(2, 3).reshape(B, NV, n_cams * K, 2)

    stereo = {}
    if n_cams == 2 and po.useIndependentStereoTriangulation:
        stereo = {name: _take(getattr(trail, "kf_" + name).transpose(1, 2), order)
                  for name in ("stereo_idp", "stereo_cov", "stereo_valid")}

    return Candidates(
        rng=rng, order=order, active=torch.gather(eligible, 1, order),
        map_point=torch.gather(is_map_point, 1, order),
        map_index=torch.gather(map_index, 1, order), selected=_take(selected_all, order),
        n_selected=torch.gather(n_sel, 1, order), ips=rows_of(trail.kf_norm),
        vels=rows_of(trail.kf_vel), selected_all=selected_all,
        was_blacklisted=was_blacklisted, exists_head=exists_head, stereo=stereo)


def map_point_of(m, is_map_point, map_index, M):
    """(point (..., 3), state offset (...,)) of hybrid map-point tracks from
    the mean ``m`` (B, d): their map block's mean and offset; zeros and the
    offset d (dropped) for other tracks. ``is_map_point`` / ``map_index``
    are (B,) or (B, NV)."""
    d = m.shape[1]
    off = torch.where(is_map_point, d - MAP_POINT_DIM * M + MAP_POINT_DIM
                      * torch.clamp(map_index, min=0), torch.full_like(map_index, d))
    at = torch.clamp(off, 0, d - MAP_POINT_DIM)
    at = at.reshape(m.shape[0], -1, 1) + torch.arange(MAP_POINT_DIM, device=m.device)
    point = torch.gather(m, 1, at.reshape(m.shape[0], -1)).reshape(off.shape + (MAP_POINT_DIM,))
    return torch.where(is_map_point[..., None], point, torch.zeros_like(point)), off


def prepare_candidates(prepare, pose_states, ips, vels, sel, m, is_map_point, map_index, M,
                       stereo=None):
    """prepare() of candidate tracks (``stereo``: their stereo rows, as
    ``Candidates.stereo``); with M > 0 run twice, in the hybrid form (from
    the map point in ``m``) and triangulated, and keep the form each
    track's ``is_map_point`` says."""
    out = prepare(pose_states, ips, vels, sel, **(stereo or {}))
    if M == 0:
        return out
    point, off = map_point_of(m, is_map_point, map_index, M)
    hyb = prepare(pose_states, ips, vels, sel, map_point=point, map_point_offset=off)
    return type(out)(*(lane_where(is_map_point, a, b) for a, b in zip(hyb, out)))


def make_batched_visual_update(po, prepare, d, NV, n_cams, visual_r, rmse_thr0, chi_r0,
                               sqrt_mode: bool = False):
    """Thresholds and ``sqrt_mode`` as ``make_sequential_visual_update``."""
    L = po.cameraTrailLength
    M = po.hybridMapSize
    sampling = tr.SAMPLING[po.trackSampling]
    noise_scale = po.noiseScale**2
    A_cap = po.maxSuccessfulVisualUpdates if po.maxSuccessfulVisualUpdates > 0 else NV

    def phase(state, track_ids, valid, rng):
        """Returns (state, point cloud tuple, need_more (B,), too_many_failures (B,))."""
        trail = state.trail
        ekf = state.ekf
        B, T = track_ids.shape
        dtype = ekf.m.dtype
        c = select_candidates(po, state, track_ids, valid, rng, NV, n_cams)
        order, active, mp = c.order, c.active, c.map_point

        pose_states = gather_pose_states(ekf.m, L)
        ps = torch.where(c.selected[..., None], pose_states[:, None], pose_states[:, None, :1])
        outs = prepare_candidates(prepare, ps, c.ips, c.vels, c.selected, ekf.m, mp,
                                  c.map_index, M, c.stereo)
        tri_ok = (outs.tri_status == TRI_OK) | mp
        prep_ok = outs.prepare_status == 0
        gate_ok, _ = visual_track_gate(ekf.P[:, None], outs.H, outs.f, outs.y,
                                       outs.row_mask, noise_scale, chi_r0, rmse_thr0, sqrt_mode)

        # map-point updates do not count against the attempt budget
        attempt = active & ~mp
        attempts_before = torch.cumsum(attempt.to(torch.int64), 1) - attempt.to(torch.int64)
        inlier_raw = active & tri_ok & prep_ok & gate_ok
        successes_before = torch.cumsum(inlier_raw.to(torch.int64), 1) - inlier_raw.to(torch.int64)
        need_more = torch.ones_like(active)
        if po.maxVisualUpdates > 0:
            need_more = need_more & (attempts_before < po.maxVisualUpdates)
        if po.maxSuccessfulVisualUpdates > 0:
            need_more = need_more & (successes_before < po.maxSuccessfulVisualUpdates)
        accepted = inlier_raw & need_more
        attempted = attempt & need_more

        # accepted non-map tracks claim the free map slots in order; they
        # skip the stacked update and are inserted afterwards
        can_promote = torch.zeros_like(accepted)
        mp_ids = trail.map_point_ids
        if M > 0:
            free = mp_ids < 0
            n_free = torch.sum(free, dim=1)
            free_slots = torch.argsort((~free).to(torch.int8), dim=1, stable=True)
            promote = accepted & ~mp
            rank = torch.cumsum(promote.to(torch.int64), 1) - promote.to(torch.int64)
            can_promote = promote & (rank < n_free[:, None])
            slot_of = torch.gather(free_slots, 1, torch.clamp(rank, 0, M - 1))  # (B, NV)
        accepted_stack = accepted & ~can_promote

        acc_idx = torch.argsort((~accepted_stack).to(torch.uint8), dim=1, stable=True)[:, :A_cap]
        acc_ok = torch.gather(accepted_stack, 1, acc_idx)
        rows = outs.H.shape[2]
        per_chunk = max(int(d * po.batchVisualUpdateMaxSizeMultiplier + 0.5) // max(rows, 1), 1)
        m, P = ekf.m, ekf.P
        for c0 in range(0, A_cap, per_chunk):
            idx_c = acc_idx[:, c0:c0 + per_chunk]
            ok_c = acc_ok[:, c0:c0 + per_chunk]
            okf = ok_c.to(dtype)
            n_c = idx_c.shape[1]
            res = visual_track_update(
                m, P,
                (_take(outs.H, idx_c) * okf[..., None, None]).reshape(B, n_c * rows, d),
                (_take(outs.f, idx_c) * okf[..., None]).reshape(B, -1),
                (_take(outs.y, idx_c) * okf[..., None]).reshape(B, -1),
                (_take(outs.row_mask, idx_c) & ok_c[..., None]).reshape(B, -1),
                visual_r, noise_scale, chi_outlier_r=-1.0, rmse_threshold=-1.0,
                apply_update=torch.any(ok_c, dim=1), sqrt_mode=sqrt_mode)
            m, P = res.m, res.P

        if M > 0:
            # one masked covariance reset and mean write for every promoted
            # track (the blocks are disjoint), then the slots are claimed
            offs = d - MAP_POINT_DIM * M + MAP_POINT_DIM * slot_of  # (B, NV)
            idx = torch.arange(d, device=m.device)
            in_block = torch.any(can_promote[..., None] & (idx >= offs[..., None])
                                 & (idx < offs[..., None] + MAP_POINT_DIM), dim=1)  # (B, d)
            keep = (~in_block).to(dtype)
            prior = torch.where(in_block, MAP_POINT_PRIOR_STD * MAP_POINT_PRIOR_STD, 0.0).to(dtype)
            if sqrt_mode:  # zeroed factor rows, the prior folded in by one QR
                P_ins = sr_add_diag_noise(P * keep[:, :, None], prior)
            else:
                P_ins = P * (keep[:, :, None] * keep[:, None, :]) + torch.diag_embed(prior)
            put = torch.zeros((B, d + 1), dtype=dtype, device=m.device)
            for ci in range(MAP_POINT_DIM):
                put = put.scatter_add(
                    1, torch.where(can_promote, offs + ci, d),
                    torch.where(can_promote, outs.pf[..., ci], torch.zeros_like(outs.pf[..., ci])))
            m_ins = torch.where(in_block, torch.zeros_like(m), m) + put[:, :d]
            do_ins = torch.any(can_promote, dim=1)
            m, P = lane_where(do_ins, m_ins, m), lane_where(do_ins, P_ins, P)
            ids = torch.where(can_promote, torch.gather(track_ids, 1, order).to(mp_ids.dtype),
                              torch.full_like(mp_ids[:, :1], -1))
            # column M: dropped; contiguous, so that the stepped state keeps the
            # init state's layout (one captured graph, graphs.py)
            mp_ids = torch.cat([mp_ids, torch.full_like(mp_ids[:, :1], -1)], dim=1).scatter(
                1, torch.where(can_promote, slot_of, M), ids)[:, :M].contiguous()
        if not sqrt_mode:
            P = 0.5 * (P + P.transpose(-1, -2))

        accepted_per_slot = _scatter_lanes(order, accepted, T)
        kf_used = trail.kf_used
        if sampling == tr.SAMPLING_GAP:
            kf_used = kf_used | (c.exists_head & accepted_per_slot[:, None, :])
        elif sampling == tr.SAMPLING_RANDOM:
            kf_used = kf_used | (c.selected_all.transpose(1, 2) & accepted_per_slot[:, None, :])
        rejected = attempted & ~inlier_raw
        bl_flags = _scatter_lanes(order, rejected, T)
        if po.blacklistTracks:
            bl_flags = bl_flags | c.was_blacklisted
        bl_ids = torch.where(bl_flags, track_ids, torch.full_like(track_ids, -1))

        n_attempts = torch.sum(attempted, dim=1)
        n_success = torch.sum(accepted, dim=1)
        pc_valid = active & tri_ok
        pc_points = torch.where(pc_valid[..., None], outs.pf, torch.zeros_like(outs.pf))
        pc_status = torch.where(
            ~active, PF_UNUSED,
            torch.where(mp, PF_HYBRID,
                        torch.where(accepted, PF_POSE_TRAIL,
                                    torch.where(attempted & ~inlier_raw, PF_OUTLIER,
                                                PF_UNUSED)))).to(torch.int32)
        pc_ids = torch.where(pc_valid, torch.gather(track_ids, 1, order),
                             torch.full_like(order, -1, dtype=track_ids.dtype))
        too_many_failures = (n_attempts - n_success) > 5
        need_more_final = torch.ones_like(too_many_failures)
        if po.maxSuccessfulVisualUpdates > 0:
            need_more_final = need_more_final & (n_success < po.maxSuccessfulVisualUpdates)
        if po.maxVisualUpdates > 0:
            need_more_final = need_more_final & (n_attempts < po.maxVisualUpdates)
        state = state._replace(
            ekf=ekf._replace(m=m, P=P),
            trail=trail._replace(kf_used=kf_used, map_point_ids=mp_ids),
            rng=c.rng, blacklist_flags=bl_flags, blacklist_ids=bl_ids)
        pc = (pc_points, pc_status, pc_ids, outs.tri_status.to(torch.int32),
              outs.prepare_status.to(torch.int32))
        return state, pc, need_more_final, too_many_failures

    return phase
