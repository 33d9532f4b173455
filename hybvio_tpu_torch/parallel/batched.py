"""Batched multi-sequence VIO on one device (port of the reference's
``parallel/batched.py make_batched_vio`` with ``shared_frames=True``).

Every state tensor has a leading lane axis of size B; one unbatched stereo
frame per step is shared by all lanes (its pyramid is computed once and
read by every lane through stride-0 views), while the IMU batch is per
lane, so lane states diverge normally. The device mesh and the scanned
offline mode of the reference are not ported.
"""
from __future__ import annotations

import torch

from .. import random as jr
from ..odometry.vio import Vio
from ..runtime import default_device, filter_dtype


def make_batched_vio(params, derived, cameras, batch_size: int, max_tracks=None,
                     dtype=None, shared_frames: bool = True, device="cuda"):
    """(batched_init, batched_step, vio), on the card unless ``device`` is
    "cpu"; ``dtype`` (the filter's) defaults to ``runtime.filter_dtype``.

    batched_init((left, right), t0s (B,), seeds (B,)) -> VioState
    batched_step(states, imu, (left, right)) -> (VioState, FrameOutput)
    """
    if not shared_frames:
        raise NotImplementedError("per-lane frames (shared_frames=False)")
    device = torch.device(device)
    if device.type == "cuda":
        default_device()  # raises without a card
    if dtype is None:
        dtype = filter_dtype(device)
    vio = Vio(params, derived, cameras, max_tracks=max_tracks, dtype=dtype).to(device)

    def batched_init(first_images, t0s, seeds):
        left, right = first_images
        keys = jr.prng_key(torch.as_tensor(seeds, dtype=torch.int64, device=left.device))
        t0 = torch.as_tensor(t0s, dtype=dtype, device=left.device)
        if t0.shape[0] != batch_size:
            raise ValueError(f"{t0.shape[0]} start times for batch {batch_size}")
        return vio.init_state(left, t0, keys, right)

    def batched_step(states, imu, frames):
        left, right = frames
        return vio.step(states, imu, left, right)

    return batched_init, batched_step, vio
