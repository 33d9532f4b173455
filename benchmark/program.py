"""The benchmark's one door into the system under test, the PyTorch and
CUDA port ``hybvio_tpu_torch``: its parameters for a configuration, its
batched step and its host API, its graphs for the stage split, and its
kernel launch counters. Nothing here imports JAX or the JAX package."""
from __future__ import annotations

import time

import torch

FILTER_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def build_params(config: dict):
    """(params, derived, cameras) of a configuration: the port's preset
    (``hybvio_tpu_torch.models.<preset>``) at the camera's size with the
    file's overrides."""
    from hybvio_tpu_torch import models

    cam = config["camera"]
    preset = getattr(models, config["preset"])
    overrides = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in config["overrides"].items()}
    return preset(cam["width"], cam["height"], **overrides)


def batched_vio(config: dict, lanes: int, device):
    """(init, step, vio): the port's batched step over ``lanes`` sequences
    with a frame of their own each (``shared_frames=False``), in the
    configuration's filter precision; on the card the step replays a CUDA
    graph."""
    from hybvio_tpu_torch.parallel.batched import make_batched_vio

    p, derived, cams = build_params(config)
    return make_batched_vio(p, derived, cams, batch_size=lanes, max_tracks=p.tracker.maxTracks,
                            dtype=FILTER_DTYPES[config["filter_dtype"]], shared_frames=False,
                            device=device)


def vio_api(config: dict, device):
    """The port's host entry point as the CLI builds it, with the
    configuration's parameters."""
    from hybvio_tpu_torch.api.vio import VioApi

    p, _, _ = build_params(config)
    cam = config["camera"]
    return VioApi(p, cam["width"], cam["height"], dtype=FILTER_DTYPES[config["filter_dtype"]],
                  device=device)


def imu_batch(t, gyro, acc, valid):
    from hybvio_tpu_torch.odometry.backend import ImuBatch

    return ImuBatch(t, gyro, acc, valid)


def reset_launches() -> None:
    from hybvio_tpu_torch.ops import _lib

    _lib.reset_launch_counts()


def launches() -> dict:
    """(kernel, shape) -> launches since the last reset, replays included."""
    from hybvio_tpu_torch.ops import _lib

    return dict(_lib.SHAPE_LAUNCHES)


def stage_split(vio, state, imu, images, reps: int, n_valid=None) -> dict:
    """ms a call of the step's three stages at the window's shapes, from
    ``state``: IMU propagation (``Vio.imu_only``), the front end
    (``Vio.track_stage``) and the estimator (``Vio.backend_stage``), each
    captured as its own ``CapturedStep`` and timed over ``reps`` replays
    between CUDA events after its capture (the method of the port's
    ``tools/profile_step.py``)."""
    from hybvio_tpu_torch.graphs import CapturedStep
    from hybvio_tpu_torch.runtime import full_precision

    left, right = images
    with full_precision():
        imu_only = CapturedStep(vio.imu_only, "benchmark imu_only")
        track = CapturedStep(vio.track_stage, "benchmark track_stage")
        backend = CapturedStep(vio.backend_stage, "benchmark backend_stage")
        ms = {}
        s1, ms["imu"] = _timed(imu_only, (state, imu, n_valid), reps)
        (s2, tin), ms["frontend"] = _timed(track, (s1, imu.t[:, -1], left, right), reps)
        _, ms["estimator"] = _timed(backend, (s2, tin), reps)
    return ms


def _timed(fn, args, reps):
    out = fn(*args)  # the capture
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn(*args)
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b) / reps


def settle(device) -> float:
    """Wait for the card; the host clock after."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()
