"""EKF state layout and initialization (port of the reference's
``ekf/state.py``), batch-first: ``m`` (B, d), ``P`` (B, d, d).

    m = [pos(3), vel(3), quat(4, wxyz), bga(3), baa(3), bat(3), sft(1),
         trail poses (7 each) x L, hybrid map points (3 each) x M]
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..runtime import default_device

POS = 0
VEL = 3
ORI = 6
BGA = 10
BAA = 13
BAT = 16
SFT = 19
CAM = 20
INER_DIM = CAM
POSE_DIM = 7
MAP_POINT_DIM = 3

Q_ACC = 0
Q_GYRO = 3
Q_BGA_DRIFT = 6
Q_BAA_DRIFT = 9
Q_DIM = 12


class EKFState(NamedTuple):
    m: torch.Tensor  # (B, d)
    P: torch.Tensor  # (B, d, d): the covariance, or its factor W in sqrt mode
    time: torch.Tensor  # (B,) seconds since first sample
    prev_sample_t: torch.Tensor  # (B,)
    first_sample_t: torch.Tensor  # (B,)
    got_first_sample: torch.Tensor  # (B,) bool
    zupt_time: torch.Tensor  # (B,)
    zrupt_time: torch.Tensor  # (B,)
    init_zupt_time: torch.Tensor  # (B,)
    was_stationary: torch.Tensor  # (B,) bool
    augment_count: torch.Tensor  # (B,) int32
    pose_times: torch.Tensor  # (B, L)


def state_dim(camera_trail_length: int, hybrid_map_size: int) -> int:
    return INER_DIM + POSE_DIM * camera_trail_length + MAP_POINT_DIM * hybrid_map_size


def init_state(po, batch: int, dtype=torch.float64, device=None,
               sqrt_mode: bool = False) -> EKFState:
    """The initial filter state of ``batch`` lanes, on the card unless
    ``device`` says otherwise. ``sqrt_mode``: the P field holds the
    square-root factor W (P = W W^T, ``ekf/sqrt.py``); the initial diagonal
    covariance factors elementwise."""
    if device is None:
        device = default_device()
    L = po.cameraTrailLength
    d = state_dim(L, po.hybridMapSize)
    noise_scale = po.noiseScale * po.noiseScale
    m = np.zeros(d)
    m[ORI] = 1.0
    m[BAT:BAT + 3] = 1.0
    Pd = np.zeros(d)
    Pd[POS:POS + 3] = po.noiseInitialPos**2
    Pd[VEL:VEL + 3] = po.noiseInitialVel**2
    Pd[ORI:ORI + 4] = 1.0  # placeholder until initialize_orientation
    Pd[BGA:BGA + 3] = po.noiseInitialBGA**2
    Pd[BAA:BAA + 3] = po.noiseInitialBAA**2
    Pd[BAT:BAT + 3] = po.noiseInitialBAT**2
    Pd[SFT] = po.noiseInitialSFT**2
    for i in range(L):
        s = CAM + POSE_DIM * i
        Pd[s:s + 3] = po.noiseInitialPosTrail**2
        Pd[s + 3:s + 7] = po.noiseInitialOriTrail**2
    P = np.diag(Pd) * noise_scale
    if sqrt_mode:
        P = np.sqrt(P)

    def lanes(a, dt=dtype):
        t = torch.as_tensor(np.asarray(a), dtype=dt, device=device)
        return t.expand((batch,) + t.shape).clone()

    return EKFState(
        m=lanes(m), P=lanes(P), time=lanes(0.0), prev_sample_t=lanes(-1.0),
        first_sample_t=lanes(-1.0), got_first_sample=lanes(False, torch.bool),
        zupt_time=lanes(-1.0), zrupt_time=lanes(-1.0), init_zupt_time=lanes(-1.0),
        was_stationary=lanes(False, torch.bool),
        augment_count=lanes(0, torch.int32), pose_times=lanes(np.full(L, -1.0)),
    )


def process_noise_values(po) -> tuple:
    """Constant acc & gyro part of the process-noise diagonal, Q_DIM floats."""
    noise_scale = po.noiseScale * po.noiseScale
    q = np.zeros(Q_DIM)
    q[Q_ACC:Q_ACC + 3] = po.noiseProcessAcc**2
    q[Q_GYRO:Q_GYRO + 3] = po.noiseProcessGyro**2
    return tuple((q * noise_scale).tolist())


def process_noise_q(po, dtype=torch.float64, device=None) -> torch.Tensor:
    """``process_noise_values`` as a (Q_DIM,) tensor, on the card unless
    ``device`` says otherwise."""
    if device is None:
        device = default_device()
    return torch.as_tensor(process_noise_values(po), dtype=dtype, device=device)
