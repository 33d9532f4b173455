"""Batched multi-sequence VIO on one device (port of the reference's
``parallel/batched.py make_batched_vio``).

Every state tensor has a leading lane axis of size B, and the IMU batch is
per lane, so lane states diverge normally. With ``shared_frames=False``
(the default, as in the reference) every lane has its own frames: B
distinct sequences on one card (BASELINE config 5), each frame a (B, H, W)
tensor with lane b's image at index b. With ``shared_frames=True`` one
unbatched (H, W) frame per step is shared by all lanes: its pyramid is
computed once and read by every lane through stride-0 views. The device
mesh and the scanned offline mode of the reference are not ported.
"""
from __future__ import annotations

import torch

from .. import random as jr
from ..odometry.vio import Vio
from ..runtime import default_device, filter_dtype


def make_batched_vio(params, derived, cameras, batch_size: int, max_tracks=None,
                     dtype=None, shared_frames: bool = False, device="cuda"):
    """(batched_init, batched_step, vio), on the card unless ``device`` is
    "cpu"; ``dtype`` (the filter's) defaults to ``runtime.filter_dtype``.

    batched_init(frame, t0s (B,), seeds (B,)) -> VioState
    batched_step(states, imu, frame) -> (VioState, FrameOutput)

    A frame is a (left, right) pair of images in stereo and one image in
    mono; an image is (B, H, W), one per lane, or with ``shared_frames``
    one (H, W) image for every lane. Integer (e.g. uint8) images are
    normalized to [0, 1] on the device.
    """
    device = torch.device(device)
    if device.type == "cuda":
        default_device()  # raises without a card
    if dtype is None:
        dtype = filter_dtype(device)
    vio = Vio(params, derived, cameras, max_tracks=max_tracks, dtype=dtype).to(device)
    want = (2,) if shared_frames else (3,)

    def frame(images):
        images = tuple(images) if vio.pt.useStereo else (images,)
        for img in images:
            if img.dim() not in want or (not shared_frames and img.shape[0] != batch_size):
                raise ValueError(
                    f"expected {'(H, W)' if shared_frames else f'({batch_size}, H, W)'} images "
                    f"(shared_frames={shared_frames}), got {tuple(img.shape)}")
        return images if vio.pt.useStereo else (images[0], None)

    def batched_init(first_images, t0s, seeds):
        left, right = frame(first_images)
        keys = jr.prng_key(torch.as_tensor(seeds, dtype=torch.int64, device=left.device))
        t0 = torch.as_tensor(t0s, dtype=dtype, device=left.device)
        if t0.shape[0] != batch_size:
            raise ValueError(f"{t0.shape[0]} start times for batch {batch_size}")
        return vio.init_state(left, t0, keys, right)

    def batched_step(states, imu, frames):
        return vio.step(states, imu, *frame(frames))

    return batched_init, batched_step, vio
