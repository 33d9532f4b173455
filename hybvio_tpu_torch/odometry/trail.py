"""Keyframe / feature-track bookkeeping as fixed-shape tensors (port of the
reference's ``odometry/trail.py``), batch-first: (B, K, T) tables with
K = cameraTrailLength + 1 keyframe slots (0 = head) and T track slots.

GAP, ALL and RANDOM track sampling and the Hanoi retention scheme are
ported as the reference has them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import random as jr

SAMPLING_GAP = 0
SAMPLING_ALL = 1
SAMPLING_RANDOM = 2
SAMPLING = {"GAP": SAMPLING_GAP, "ALL": SAMPLING_ALL, "RANDOM": SAMPLING_RANDOM}


class TrailState(NamedTuple):
    kf_track_id: torch.Tensor  # (B, K, T) int32, -1 empty
    kf_norm: torch.Tensor  # (B, K, T, C, 2)
    kf_vel: torch.Tensor  # (B, K, T, C, 2)
    kf_pix: torch.Tensor  # (B, K, T, 2)
    kf_stereo_idp: torch.Tensor  # (B, K, T, 3)
    kf_stereo_cov: torch.Tensor  # (B, K, T, 3, 3)
    kf_stereo_valid: torch.Tensor  # (B, K, T) bool
    kf_used: torch.Tensor  # (B, K, T) bool
    kf_frame_num: torch.Tensor  # (B, K) int32
    kf_time: torch.Tensor  # (B, K)
    frame_counter: torch.Tensor  # (B,) int32
    map_point_ids: torch.Tensor  # (B, M) int32


def init_trail(po, batch: int, max_tracks: int, n_cams: int, dtype, device) -> TrailState:
    K = po.cameraTrailLength + 1
    T = max_tracks
    M = max(po.hybridMapSize, 1)
    B = batch
    kw = dict(dtype=dtype, device=device)
    return TrailState(
        kf_track_id=torch.full((B, K, T), -1, dtype=torch.int32, device=device),
        kf_norm=torch.zeros((B, K, T, n_cams, 2), **kw),
        kf_vel=torch.zeros((B, K, T, n_cams, 2), **kw),
        kf_pix=torch.zeros((B, K, T, 2), **kw),
        kf_stereo_idp=torch.zeros((B, K, T, 3), **kw),
        kf_stereo_cov=torch.zeros((B, K, T, 3, 3), **kw),
        kf_stereo_valid=torch.zeros((B, K, T), dtype=torch.bool, device=device),
        kf_used=torch.zeros((B, K, T), dtype=torch.bool, device=device),
        kf_frame_num=torch.full((B, K), -1, dtype=torch.int32, device=device),
        kf_time=torch.full((B, K), -1.0, **kw),
        frame_counter=torch.zeros((B,), dtype=torch.int32, device=device),
        map_point_ids=torch.full((B, M), -1, dtype=torch.int32, device=device),
    )


def feature_exists(trail: TrailState, track_ids) -> torch.Tensor:
    """(B, K, T): keyframe k holds a feature of the current track of slot t
    (contiguous-prefix AND enforces the no-gaps invariant)."""
    raw = (trail.kf_track_id == track_ids[:, None, :]) & (track_ids[:, None, :] >= 0)
    return torch.cumprod(raw.to(torch.int32), dim=1).to(torch.bool)


def _shift_up(a, fill):
    return torch.cat([a[:, 1:], torch.full_like(a[:, :1], fill)], dim=1)


def pop_head_keyframe(trail: TrailState) -> TrailState:
    """Drop the head keyframe, shifting everything one slot toward it."""
    return trail._replace(
        kf_track_id=_shift_up(trail.kf_track_id, -1),
        kf_norm=_shift_up(trail.kf_norm, 0),
        kf_vel=_shift_up(trail.kf_vel, 0),
        kf_pix=_shift_up(trail.kf_pix, 0),
        kf_stereo_idp=_shift_up(trail.kf_stereo_idp, 0),
        kf_stereo_cov=_shift_up(trail.kf_stereo_cov, 0),
        kf_stereo_valid=_shift_up(trail.kf_stereo_valid, False),
        kf_used=_shift_up(trail.kf_used, False),
        kf_frame_num=_shift_up(trail.kf_frame_num, -1),
        kf_time=_shift_up(trail.kf_time, 0),
    )


def removed_keyframe_index(trail: TrailState, po):
    """(removed index (B,) in [1, K-1], updated frame counter (B,)) of the
    keyframe dropped when a new head is pushed (FIFO / strided / Hanoi)."""
    K = trail.kf_track_id.shape[1]
    kf_nonempty = torch.any(trail.kf_track_id >= 0, dim=2)
    free_slot = torch.any(~kf_nonempty[:, 1:], dim=1) & (not po.cameraTrailFixedScheme)
    stride = po.cameraTrailStridedStride if po.cameraTrailStridedLength > 0 else 1
    hanoi_len = po.cameraTrailHanoiLength
    frame_counter = trail.frame_counter + 1
    hanoi_counter = torch.div(frame_counter, stride, rounding_mode="floor")
    removed = torch.full_like(frame_counter, K - 1)
    for i in range(hanoi_len - 1, -1, -1):
        bit = (hanoi_counter >> i) & 1
        removed = torch.where(bit == 1, torch.full_like(removed, K - 1 - hanoi_len + i), removed)
    if stride > 1:
        strided_removed = K - 1 - po.cameraTrailStridedLength - hanoi_len - 1
        removed = torch.where(frame_counter % stride != 0,
                              torch.full_like(removed, strided_removed), removed)
    removed = torch.where(free_slot, torch.full_like(removed, K - 1), removed)
    counter = torch.where(free_slot, trail.frame_counter, frame_counter)
    return removed, counter


def push_head_keyframe(trail: TrailState, removed_idx, frame_num, timestamp) -> TrailState:
    """Insert an empty head keyframe, dropping slot ``removed_idx`` (B,):
    new[0] = empty, new[k] = old[k-1] for k <= removed, else old[k]."""
    B, K = trail.kf_track_id.shape[:2]
    slots = torch.arange(K, device=removed_idx.device)[None, :]
    src = torch.where(slots <= removed_idx[:, None], slots - 1, slots)
    src = torch.clamp(src, 0, K - 1)

    def permute(a, fill):
        idx = src.reshape((B, K) + (1,) * (a.dim() - 2)).expand(a.shape)
        out = torch.gather(a, 1, idx)
        out[:, 0] = fill
        return out

    kf_frame_num = permute(trail.kf_frame_num, -1)
    kf_frame_num[:, 0] = frame_num
    kf_time = permute(trail.kf_time, -1.0)
    kf_time[:, 0] = timestamp
    return trail._replace(
        kf_track_id=permute(trail.kf_track_id, -1),
        kf_norm=permute(trail.kf_norm, 0),
        kf_vel=permute(trail.kf_vel, 0),
        kf_pix=permute(trail.kf_pix, 0),
        kf_stereo_idp=permute(trail.kf_stereo_idp, 0),
        kf_stereo_cov=permute(trail.kf_stereo_cov, 0),
        kf_stereo_valid=permute(trail.kf_stereo_valid, False),
        kf_used=permute(trail.kf_used, False),
        kf_frame_num=kf_frame_num,
        kf_time=kf_time,
    )


def _set_head(a, v):
    return torch.cat([v[:, None].to(a.dtype), a[:, 1:]], dim=1)


def insert_head_features(trail: TrailState, track_ids, norm_pts, pixels, valid,
                         timestamp, estimate_velocities=True, stereo_idp=None,
                         stereo_cov=None, stereo_valid=None) -> TrailState:
    """Write the current frame's features (and, given, their stereo
    triangulations (B, T, 3), covariances (B, T, 3, 3) and validity) into
    head keyframe 0, and refresh the head (and slot 1) feature
    velocities."""
    tid = torch.where(valid, track_ids, torch.full_like(track_ids, -1)).to(torch.int32)
    trail = trail._replace(
        kf_track_id=_set_head(trail.kf_track_id, tid),
        kf_norm=_set_head(trail.kf_norm, norm_pts),
        kf_pix=_set_head(trail.kf_pix, pixels),
        kf_used=_set_head(trail.kf_used, torch.zeros_like(valid)),
        kf_time=_set_head(trail.kf_time, timestamp),
    )
    if stereo_idp is not None:
        trail = trail._replace(
            kf_stereo_idp=_set_head(trail.kf_stereo_idp, stereo_idp),
            kf_stereo_cov=_set_head(trail.kf_stereo_cov, stereo_cov),
            kf_stereo_valid=_set_head(trail.kf_stereo_valid, stereo_valid & valid))
    if estimate_velocities:
        t0, t1, t2 = (trail.kf_time[:, i] for i in range(3))
        exists = feature_exists(trail, tid)
        one = torch.ones_like(t0)
        ok1 = exists[:, 1] & (t0 > t1)[:, None]
        dt1 = torch.where(t0 > t1, t0 - t1, one)
        v0 = (trail.kf_norm[:, 0] - trail.kf_norm[:, 1]) / dt1[:, None, None, None]
        v0 = torch.where(ok1[..., None, None], v0, torch.zeros_like(v0))
        ok2 = exists[:, 2] & (t0 > t2)[:, None]
        dt2 = torch.where(t0 > t2, t0 - t2, one)
        v1 = (trail.kf_norm[:, 0] - trail.kf_norm[:, 2]) / dt2[:, None, None, None]
        v1 = torch.where(ok2[..., None, None], v1, v0)
        v1 = torch.where(ok1[..., None, None], v1, trail.kf_vel[:, 1])
        trail = trail._replace(kf_vel=torch.cat(
            [v0[:, None], v1[:, None], trail.kf_vel[:, 2:]], dim=1))
    return trail


def prune(trail: TrailState, track_ids) -> TrailState:
    """Drop features and keyframes not sharing tracks with the head, and
    map points no longer tracked."""
    exists = feature_exists(trail, track_ids)
    kf_has_any = torch.any(exists, dim=2)
    head = torch.ones_like(kf_has_any[:, :1], dtype=torch.int32)
    kf_keep = torch.cumprod(torch.cat([head, kf_has_any[:, 1:].to(torch.int32)], dim=1),
                            dim=1).to(torch.bool)
    keep = exists & kf_keep[:, :, None]
    kf_track_id = torch.where(keep, trail.kf_track_id, torch.full_like(trail.kf_track_id, -1))
    head_ids = trail.kf_track_id[:, 0]
    mp = trail.map_point_ids
    tracked = torch.any((mp[:, :, None] == head_ids[:, None, :]) & (mp[:, :, None] >= 0), dim=2)
    mp = torch.where(tracked, mp, torch.full_like(mp, -1))
    return trail._replace(kf_track_id=kf_track_id, map_point_ids=mp)


def _gap_selection(trail: TrailState, exists):
    """(B, K, T): the unused points of each track plus its oldest one."""
    ks = torch.arange(exists.shape[1], device=exists.device)[None, :, None]
    start = torch.max(torch.where(exists, ks, torch.full_like(ks, -1)), dim=1, keepdim=True).values
    return exists & (~trail.kf_used | (ks == start))


def select_track_poses(trail: TrailState, track_ids, sampling=SAMPLING_GAP, keys=None,
                       random_ratio=0.75):
    """The trail poses each track's visual update uses: (selected (B, T, K),
    exists (B, T, K)). GAP: the unused points and the oldest; ALL: every
    point; RANDOM: ``round(random_ratio * n)`` of a track's n unused points,
    drawn with its key of ``keys`` (B, T, 2) as uniforms of the filter
    dtype (the reference draws in its default float type: float64 under
    x64), plus its head point."""
    dtype = trail.kf_norm.dtype
    exists = feature_exists(trail, track_ids)
    if sampling == SAMPLING_ALL:
        return exists.transpose(1, 2), exists.transpose(1, 2)
    if sampling == SAMPLING_GAP:
        return _gap_selection(trail, exists).transpose(1, 2), exists.transpose(1, 2)
    exists_t = exists.transpose(1, 2)  # (B, T, K)
    avail = exists_t & ~trail.kf_used.transpose(1, 2)
    K = avail.shape[2]
    n_take = torch.round(random_ratio * torch.sum(avail, dim=2).to(dtype))
    u = jr.uniform(keys, (K,), dtype)  # (B, T, K)
    scores = torch.where(avail, u, torch.full_like(u, -1.0))
    order = torch.argsort(-scores, dim=2, stable=True)
    ks = torch.arange(K, device=avail.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(2, order, ks)
    sel = avail & (rank < n_take[..., None])
    sel = torch.cat([exists_t[..., :1], sel[..., 1:]], dim=2)
    return sel, exists_t


def track_scores(trail: TrailState, track_ids, sampling=SAMPLING_GAP) -> torch.Tensor:
    """(B, T) track score: the L1 path length over the selected points
    (GAP, ALL), or the number of unused points (RANDOM)."""
    exists = feature_exists(trail, track_ids)
    if sampling == SAMPLING_RANDOM:
        return torch.sum(exists & ~trail.kf_used, dim=1).to(trail.kf_norm.dtype)
    sel = _gap_selection(trail, exists) if sampling == SAMPLING_GAP else exists
    p = trail.kf_pix
    step = torch.sum(torch.abs(p[:, :-1] - p[:, 1:]), dim=-1)
    contrib = sel[:, :-1] & exists[:, 1:]
    return torch.sum(torch.where(contrib, step, torch.zeros_like(step)), dim=1)


def mark_track_used(trail: TrailState, slot, selected, sampling, track_ids) -> TrailState:
    """Mark the points of track slot ``slot`` (B,) used, per lane: every
    point of the track (GAP), the ``selected`` (B, K) ones (RANDOM), none
    (ALL)."""
    if sampling == SAMPLING_ALL:
        return trail
    T = track_ids.shape[1]
    onehot = torch.arange(T, device=slot.device)[None, :] == slot[:, None]  # (B, T)
    if sampling == SAMPLING_GAP:
        col = torch.any(feature_exists(trail, track_ids) & onehot[:, None, :], dim=2)
    else:
        col = selected
    return trail._replace(kf_used=trail.kf_used | (col[:, :, None] & onehot[:, None, :]))


def offer_map_point(trail: TrailState, track_id):
    """Claim the first free hybrid map slot of each lane for ``track_id``
    (B,): (slot index (B,), -1 where none is free; the trail)."""
    mp = trail.map_point_ids
    free = mp < 0
    idx = torch.argmax(free.to(torch.int8), dim=1)
    available = torch.any(free, dim=1)
    first = torch.arange(mp.shape[1], device=mp.device)[None, :] == idx[:, None]
    new = torch.where(first & available[:, None], track_id.to(mp.dtype)[:, None], mp)
    return (torch.where(available, idx, torch.full_like(idx, -1)).to(torch.int32),
            trail._replace(map_point_ids=new))
