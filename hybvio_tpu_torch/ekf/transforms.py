"""State transforms (port of the reference's ``ekf/transforms.py``):
orientation initialization from the first accelerometer sample (heading
variance pinned to zero) and the insertion of a hybrid map point."""
from __future__ import annotations

import torch

from ..geometry.quaternion import quat_from_two_vectors
from ..runtime import constant
from .state import MAP_POINT_DIM, ORI, EKFState

MAP_POINT_PRIOR_STD = 1e3


def insert_map_point(s: EKFState, offset, pf) -> EKFState:
    """Write map point ``pf`` (B, 3) into the state block at ``offset``
    (B,) of every lane: the block's mean becomes ``pf``, its covariance rows
    and columns zero and its variance ``MAP_POINT_PRIOR_STD**2``. Index
    masks, no host sync."""
    m = s.m
    idx = torch.arange(m.shape[-1], device=m.device)[None, :]
    rel = idx - offset.to(idx.dtype)[:, None]
    in_block = (rel >= 0) & (rel < MAP_POINT_DIM)
    keep = (~in_block).to(m.dtype)
    prior = torch.where(in_block, MAP_POINT_PRIOR_STD * MAP_POINT_PRIOR_STD, 0.0).to(m.dtype)
    P = s.P * (keep[:, :, None] * keep[:, None, :]) + torch.diag_embed(prior)
    pf_at = torch.gather(pf, 1, torch.clamp(rel, 0, MAP_POINT_DIM - 1))
    return s._replace(m=torch.where(in_block, pf_at, m), P=P)


def initialize_orientation(s: EKFState, xa, noise_initial_ori, noise_scale) -> EKFState:
    dtype, dev = s.m.dtype, s.m.device
    up = constant((0.0, 0.0, 1.0), dtype, dev).expand_as(xa)
    q = quat_from_two_vectors(up, xa)
    m = torch.cat([s.m[:, :ORI], q, s.m[:, ORI + 4:]], dim=1)
    block_var = constant((1.0, 1.0, 1.0, 0.0), dtype, dev) * (
        noise_initial_ori**2 * noise_scale)
    P = s.P.clone()
    P[:, ORI:ORI + 4, ORI:ORI + 4] = torch.diag(block_var)
    return s._replace(m=m, P=P)
