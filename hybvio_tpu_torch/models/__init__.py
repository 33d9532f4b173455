"""Benchmark preset of the port (the reference's
``models.synthetic_bench_params`` and ``_finalize``)."""
from __future__ import annotations

import numpy as np

from ..config import DerivedParameters, Parameters
from ..geometry.cameras import build_camera_from_params
from ..io.synthetic import SYNTH_IMU_TO_CAMERA


def _finalize(p: Parameters, width: int, height: int):
    """(params, derived, cameras) for a parameter set."""
    cams = [build_camera_from_params(p.tracker, width, height)]
    if p.tracker.useStereo:
        cams.append(build_camera_from_params(p.tracker, width, height, second=True))
    return p, DerivedParameters.from_parameters(p), tuple(cams)


def synthetic_bench_params(config: str = "stereo") -> Parameters:
    """The benchmark preset for the synthetic EuRoC-like world; only the
    stereo configuration runs in the port so far."""
    if config != "stereo":
        raise NotImplementedError(f"preset {config!r}")
    p = Parameters()
    p.odometry.cameraTrailLength = 12
    p.tracker.maxTracks = 96
    p.tracker.pyrLKWindowSize = 15
    p.tracker.pyrLKMaxLevel = 2
    p.tracker.pyrLKMaxIter = 8
    p.tracker.gfttMinDistance = 35.0
    p.odometry.imuToCameraMatrix = tuple(SYNTH_IMU_TO_CAMERA.T.flatten())
    p.odometry.visualR = 0.3
    p.odometry.batchVisualUpdate = True
    p.odometry.triangulationRcondThreshold = 1e-5
    p.odometry.maxVisualUpdates = 12
    p.tracker.ransac2Threshold = 8.0
    p.tracker.ransac5Threshold = 4.0
    W, H = 752, 480
    p.tracker.focalLength = 458.0
    p.tracker.principalPointX = W / 2
    p.tracker.principalPointY = H / 2
    second = np.asarray(SYNTH_IMU_TO_CAMERA).copy()
    second[0, 3] = -0.11  # EuRoC-like baseline
    p.tracker.useStereo = True
    p.odometry.secondImuToCameraMatrix = tuple(second.T.flatten())
    return p
