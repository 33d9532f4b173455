"""The benchmark worlds of the JAX package's ``bench.py`` config families:
``build_config(config, device)`` gives the preset, the cameras, the host
renderer and the sequence's keywords of "stereo", "mono", "fisheye" or
"vislam", with the same environment overrides (BENCH_LK_LEVELS,
BENCH_LK_ITERS, BENCH_RCOND, BENCH_OVERRIDES)."""
from __future__ import annotations

import os

import numpy as np
import torch

from ..geometry.cameras import build_fisheye, build_pinhole
from ..io.synthetic import SYNTH_IMU_TO_CAMERA, render_view, render_view_fisheye
from ..models import synthetic_bench_params

STEREO_BASELINE = 0.11
KB4 = (0.0035, 0.0007, -0.002, 0.0002)


def bench_params(config: str):
    """``synthetic_bench_params(config)`` with BENCH_LK_LEVELS,
    BENCH_LK_ITERS and BENCH_RCOND as its keywords, then BENCH_OVERRIDES
    ("group.name=value,...") applied through ``set_parameter``."""
    lk_levels = os.environ.get("BENCH_LK_LEVELS")
    lk_iters = os.environ.get("BENCH_LK_ITERS")
    rcond = os.environ.get("BENCH_RCOND")
    p = synthetic_bench_params(
        config,
        lk_levels=int(lk_levels) if lk_levels else None,
        lk_iters=int(lk_iters) if lk_iters else None,
        rcond=float(rcond) if rcond else None)
    for kv in filter(None, os.environ.get("BENCH_OVERRIDES", "").split(",")):
        key, val = kv.split("=")
        group, name = key.split(".")
        cur = getattr(getattr(p, group), name)
        p.set_parameter(group, name, float(val) if cur is None else val)
    return p


def build_config(config: str, device=None):
    """(params, cameras, render, seq_kwargs) of a config family.
    ``render(seq, fi)`` renders frame ``fi`` of a ``generate_sequence``
    sequence on the host and returns it as float32 on ``device`` (the CPU
    unless given): one (H, W) image, or a (left, right) pair in stereo."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    p = bench_params(config)
    seq_kwargs = dict(n_landmarks=500, gyro_noise=5e-4, acc_noise=5e-3, seed=0)

    def on_device(img):
        return torch.as_tensor(np.asarray(img, np.float32)).to(device)

    if config == "fisheye":
        W = H = 512
        FX = 190.0
        seq_kwargs["landmark_radius"] = 5.0
        cam = build_fisheye(FX, FX, W / 2, H / 2, coeffs=KB4, max_valid_fov_deg=150.0,
                            width=W, height=H)

        def render(seq, fi):
            k = seq.frame_sample_idx[fi]
            return on_device(render_view_fisheye(
                seq.landmarks, seq.pos[k], seq.quat[k], SYNTH_IMU_TO_CAMERA, FX, FX, W / 2,
                H / 2, W, H, KB4, max_fov_deg=150.0, blob_sigma=1.4))

        return p, (cam,), render, seq_kwargs

    W, H = 752, 480
    FX = 458.0
    cam = build_pinhole(FX, FX, W / 2, H / 2, width=W, height=H)

    def view(seq, fi, imu_to_camera):
        k = seq.frame_sample_idx[fi]
        return on_device(render_view(seq.landmarks, seq.pos[k], seq.quat[k], imu_to_camera,
                                     FX, FX, W / 2, H / 2, W, H, blob_sigma=1.4))

    if config in ("stereo", "vislam"):
        second = np.asarray(SYNTH_IMU_TO_CAMERA).copy()
        second[0, 3] = -STEREO_BASELINE

        def render(seq, fi):
            return view(seq, fi, SYNTH_IMU_TO_CAMERA), view(seq, fi, second)

        return p, (cam, cam), render, seq_kwargs

    def render(seq, fi):
        return view(seq, fi, SYNTH_IMU_TO_CAMERA)

    return p, (cam,), render, seq_kwargs
