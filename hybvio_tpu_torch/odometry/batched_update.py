"""The batched visual update (port of the reference backend's
``visual_update_phase_batched``): all candidate tracks triangulate and gate
in parallel against the same pre-update state, and the accepted ones apply
as stacked EKF updates of at most ``d * batchVisualUpdateMaxSizeMultiplier``
rows each. Batch-first over lanes; the hybrid map (M > 0) is not ported.
"""
from __future__ import annotations

import torch

from .. import random as jr
from ..ekf import CAM, ORI, POS, POSE_DIM, visual_track_gate, visual_track_update
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


def make_batched_visual_update(po, prepare, d, NV, n_cams, visual_r, rmse_thr0, chi_r0):
    L = po.cameraTrailLength
    K = L + 1
    noise_scale = po.noiseScale**2
    A_cap = po.maxSuccessfulVisualUpdates if po.maxSuccessfulVisualUpdates > 0 else NV

    def phase(state, track_ids, valid, rng):
        """Returns (state, point cloud tuple, need_more (B,), too_many_failures (B,))."""
        trail = state.trail
        ekf = state.ekf
        B, T = track_ids.shape
        dtype = ekf.m.dtype

        exists_head = tr.feature_exists(trail, track_ids)
        scores = tr.track_scores(trail, track_ids)
        rng = jr.split(rng)[:, 0]  # the RANDOM-sampling key split (unused by GAP)
        selected_all, _ = tr.select_track_poses(trail, track_ids)  # (B, T, K)
        n_sel = torch.sum(selected_all, dim=2)
        was_blacklisted = state.blacklist_flags & (state.blacklist_ids == track_ids) & valid

        cand = valid & exists_head[:, 0]
        if po.scoreVisualUpdateTracks:
            cscores = torch.where(cand, scores, torch.full_like(scores, float("inf")))
            n_cand = torch.sum(cand, dim=1)
            sorted_scores = torch.sort(cscores, dim=1).values
            mid = torch.gather(sorted_scores, 1, torch.clamp(n_cand // 2, 0, T - 1)[:, None])[:, 0]
            min_score = torch.where(n_cand > 0, mid, torch.full_like(mid, -1.0))
            ok_score = scores >= min_score[:, None]
        else:
            ok_score = torch.ones_like(cand)
        ok_len = n_sel >= po.trackMinFrames
        eligible = cand & ok_score & ok_len & ~was_blacklisted

        keys = jr.split(rng)
        rng, perm_key = keys[:, 0], keys[:, 1]
        noise = jr.uniform(perm_key, (T,), dtype)
        priority = (torch.where(eligible, 0.0, 10.0).to(dtype) + 1.0) + noise * 0.5
        order = torch.argsort(priority, dim=1, stable=True)[:, :NV]  # (B, NV)

        pose_states = gather_pose_states(ekf.m, L)
        sel = _take(selected_all, order)  # (B, NV, K)
        ps = torch.where(sel[..., None], pose_states[:, None], pose_states[:, None, :1])

        def rows_of(a):  # (B, K, T, C, 2) -> (B, NV, C*K, 2)
            a = _take(a.transpose(1, 2), order)  # (B, NV, K, C, 2)
            return a.transpose(2, 3).reshape(B, NV, n_cams * K, 2)

        outs = prepare(ps, rows_of(trail.kf_norm), rows_of(trail.kf_vel), sel)
        active = torch.gather(eligible, 1, order)
        tri_ok = outs.tri_status == TRI_OK
        prep_ok = outs.prepare_status == 0
        gate_ok, _ = visual_track_gate(ekf.P[:, None], outs.H, outs.f, outs.y,
                                       outs.row_mask, noise_scale, chi_r0, rmse_thr0)

        attempt = active
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

        acc_idx = torch.argsort((~accepted).to(torch.uint8), dim=1, stable=True)[:, :A_cap]
        acc_ok = torch.gather(accepted, 1, acc_idx)
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
                apply_update=torch.any(ok_c, dim=1))
            m, P = res.m, res.P
        P = 0.5 * (P + P.transpose(-1, -2))

        accepted_per_slot = _scatter_lanes(order, accepted, T)
        kf_used = trail.kf_used | (exists_head & accepted_per_slot[:, None, :])
        rejected = attempted & ~inlier_raw
        bl_flags = _scatter_lanes(order, rejected, T)
        if po.blacklistTracks:
            bl_flags = bl_flags | was_blacklisted
        bl_ids = torch.where(bl_flags, track_ids, torch.full_like(track_ids, -1))

        n_attempts = torch.sum(attempted, dim=1)
        n_success = torch.sum(accepted, dim=1)
        pc_valid = active & tri_ok
        pc_points = torch.where(pc_valid[..., None], outs.pf, torch.zeros_like(outs.pf))
        pc_status = torch.where(
            ~active, PF_UNUSED,
            torch.where(accepted, PF_POSE_TRAIL,
                        torch.where(attempted & ~inlier_raw, PF_OUTLIER, PF_UNUSED))).to(torch.int32)
        pc_ids = torch.where(pc_valid, torch.gather(track_ids, 1, order),
                             torch.full_like(order, -1, dtype=track_ids.dtype))
        too_many_failures = (n_attempts - n_success) > 5
        need_more_final = torch.ones_like(too_many_failures)
        if po.maxSuccessfulVisualUpdates > 0:
            need_more_final = need_more_final & (n_success < po.maxSuccessfulVisualUpdates)
        if po.maxVisualUpdates > 0:
            need_more_final = need_more_final & (n_attempts < po.maxVisualUpdates)
        state = state._replace(
            ekf=ekf._replace(m=m, P=P), trail=trail._replace(kf_used=kf_used),
            rng=rng, blacklist_flags=bl_flags, blacklist_ids=bl_ids)
        pc = (pc_points, pc_status, pc_ids, outs.tri_status.to(torch.int32),
              outs.prepare_status.to(torch.int32))
        return state, pc, need_more_final, too_many_failures

    return phase
