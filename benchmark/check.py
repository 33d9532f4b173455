"""Whether what the timed path produced is correct: the numbers compared
with the plain reference (``reference.py``) and the limit of each, from
the cell's workload file.

* ``pose_err_m``: the largest, over the lanes, their rounds and the frames
  the window stepped, distance of an output position from the world's
  truth after the lane's round is aligned onto it (the filter's per-frame
  poses). Every lane is held to the limit: a fault in a few lanes fails.
* ``pyramid_err``: the largest absolute difference of the last frame's
  pyramid levels and Scharr gradients, as the tracker kept them in its
  state, from the float64 reference (the fused pyramid kernel).
"""
from __future__ import annotations

import numpy as np
import torch

from . import reference

NAMES = ("pose_err_m", "pyramid_err")


def lane_pose_errs(seqs, poses) -> list:
    """Each lane's largest aligned error (m), lane order: ``poses`` is a
    list of (lane, sample indices (N,), positions (N, 3)), a lane's round
    each."""
    worst = {}
    for lane, samples, est in poses:
        worst.setdefault(lane, 0.0)
        if len(est) < 2:
            continue
        seq = seqs[lane]
        gt = seq.pos[samples] - seq.pos[seq.frame_sample_idx[0]]
        worst[lane] = max(worst[lane], float(reference.aligned_errors(est, gt).max()))
    return [worst[lane] for lane in sorted(worst)]


def pyramid_err(frames_u8, levels, grads) -> float:
    """Largest |program - reference| over the pyramid levels and gradients
    of (B, H, W) 8-bit frames; ``levels`` and ``grads`` as the tracker's
    state keeps them (its levels with or without level 0, the (Ix, Iy) of
    every level)."""
    n = len(grads) - 1
    ref_lv, ref_g = reference.pyramid(frames_u8, n)
    if levels[0].shape[-2:] != ref_lv[0].shape[-2:]:
        ref_lv = ref_lv[1:]
    worst = 0.0
    pairs = list(zip(levels, ref_lv)) + [(a, b) for g, r in zip(grads, ref_g)
                                         for a, b in zip(g, r)]
    for got, want in pairs:
        got = got.to(want.device, torch.float64).expand(want.shape)
        if not torch.isfinite(got).all():
            return float("inf")
        worst = max(worst, float((got - want).abs().max()))
    return worst


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit is not correct."""
    out, ok = {}, True
    for name in NAMES:
        value, limit = numbers.get(name), limits.get(name)
        out[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and limit is not None and np.isfinite(value) \
            and value <= limit
    return ok, out


def numbers(seqs, poses, pyramid) -> tuple:
    """(numbers, details) of one run's outputs; ``pyramid`` is (frames
    (B, H, W) uint8, levels, grads)."""
    lanes = lane_pose_errs(seqs, poses)
    out = {"pose_err_m": max(lanes), "pyramid_err": pyramid_err(*pyramid)}
    return out, {"pose_err_lanes_m": lanes}
