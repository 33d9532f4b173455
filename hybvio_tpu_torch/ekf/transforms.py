"""Orientation initialization from the first accelerometer sample (port of
the reference's ``ekf/transforms.py initialize_orientation``); heading
variance pinned to zero."""
from __future__ import annotations

import torch

from ..geometry.quaternion import quat_from_two_vectors
from ..runtime import constant
from .state import ORI, EKFState


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
