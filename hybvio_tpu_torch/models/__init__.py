"""Presets of the port (the reference's ``models``): the EuRoC-like
``euroc_mono`` and ``euroc_stereo`` at the reference's defaults (BASELINE
configs 1 and 2, as the CLI runs them), full VISLAM ``vislam`` (BASELINE
config 3), the TUM-VI-style KB4 fisheye ``tumvi_fisheye`` (BASELINE config
4), the benchmark preset ``synthetic_bench_params`` and ``_finalize``."""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import DerivedParameters, Parameters
from ..geometry.cameras import build_camera_from_params
from ..io.synthetic import SYNTH_IMU_TO_CAMERA

CONFIGS = ("stereo", "mono", "fisheye", "vislam")


def _finalize(p: Parameters, width: int, height: int):
    """(params, derived, cameras) for a parameter set: one camera, or two
    with ``useStereo``."""
    cams = [build_camera_from_params(p.tracker, width, height)]
    if p.tracker.useStereo:
        cams.append(build_camera_from_params(p.tracker, width, height, second=True))
    return p, DerivedParameters.from_parameters(p), tuple(cams)


def _override(p: Parameters, overrides) -> None:
    for k, v in overrides.items():
        g, n = k.split(".")
        p.set_parameter(g, n, v)


def euroc_mono(width: int = 752, height: int = 480, **overrides):
    """Monocular VIO, EuRoC-like intrinsics (BASELINE config 1): (params,
    derived, cameras); ``overrides`` as ``{"group.name": value}``."""
    p = Parameters()
    p.tracker.focalLength = 458.0
    p.tracker.principalPointX = width / 2
    p.tracker.principalPointY = height / 2
    p.odometry.visualR = 0.3
    _override(p, overrides)
    return _finalize(p, width, height)


def euroc_stereo(width: int = 752, height: int = 480, baseline: float = 0.11, **overrides):
    """Stereo VIO (-useStereo; BASELINE config 2), the second camera
    ``baseline`` m along -x of the first."""
    p = Parameters()
    p.tracker.useStereo = True
    p.tracker.focalLength = 458.0
    p.tracker.principalPointX = width / 2
    p.tracker.principalPointY = height / 2
    p.odometry.stereoCameraTranslation = (-baseline, 0.0, 0.0)
    p.odometry.visualR = 0.3
    _override(p, overrides)
    return _finalize(p, width, height)


def vislam(width: int = 752, height: int = 480, **overrides):
    """Full VISLAM (-useSlam; BASELINE config 3): ``euroc_mono`` with the
    SLAM session on."""
    p, derived, cams = euroc_mono(width, height, **overrides)
    p.slam.useSlam = True
    return p, derived, cams


def tumvi_fisheye(width: int = 512, height: int = 512, **overrides):
    """Fisheye KB4 (TUM-VI-style; BASELINE config 4): a 150 degree field of
    view, 190 px focal length, centred principal point."""
    p = Parameters()
    p.tracker.fisheyeCamera = True
    p.tracker.validCameraFov = 150.0
    p.tracker.focalLength = 190.0
    p.tracker.principalPointX = width / 2
    p.tracker.principalPointY = height / 2
    p.tracker.distortionCoeffs = (0.0035, 0.0007, -0.002, 0.0002)
    p.odometry.visualR = 0.4
    _override(p, overrides)
    return _finalize(p, width, height)


def synthetic_bench_params(config: str = "stereo", lk_levels: Optional[int] = None,
                           lk_iters: Optional[int] = None,
                           rcond: Optional[float] = None) -> Parameters:
    """The benchmark preset for the synthetic EuRoC-like world: "stereo"
    and "mono" at 752x480 (BASELINE configs 2 and 1), "fisheye" (KB4,
    512x512, BASELINE config 4), and "vislam" (BASELINE config 3): stereo
    with the SLAM session, loop closures applied, a SLAM candidate every
    4th keyframe.
    ``lk_levels``, ``lk_iters`` and ``rcond``, where given, replace the
    preset's pyrLKMaxLevel (2), pyrLKMaxIter (8) and
    triangulationRcondThreshold (1e-5), as the reference's keywords do."""
    if config not in CONFIGS:
        raise NotImplementedError(f"preset {config!r}")
    p = Parameters()
    p.odometry.cameraTrailLength = 12
    p.tracker.maxTracks = 96
    p.tracker.pyrLKWindowSize = 15
    p.tracker.pyrLKMaxLevel = 2 if lk_levels is None else lk_levels
    p.tracker.pyrLKMaxIter = 8 if lk_iters is None else lk_iters
    p.tracker.gfttMinDistance = 35.0
    p.odometry.imuToCameraMatrix = tuple(SYNTH_IMU_TO_CAMERA.T.flatten())
    p.odometry.visualR = 0.3
    p.odometry.batchVisualUpdate = True
    p.odometry.triangulationRcondThreshold = 1e-5 if rcond is None else rcond
    p.odometry.maxVisualUpdates = 12
    p.tracker.ransac2Threshold = 8.0
    p.tracker.ransac5Threshold = 4.0
    if config == "fisheye":
        W = H = 512
        p.tracker.fisheyeCamera = True
        p.tracker.validCameraFov = 150.0
        p.tracker.focalLength = 190.0
        p.tracker.principalPointX = W / 2
        p.tracker.principalPointY = H / 2
        p.tracker.distortionCoeffs = (0.0035, 0.0007, -0.002, 0.0002)
        p.odometry.visualR = 0.4
        return p
    W, H = 752, 480
    p.tracker.focalLength = 458.0
    p.tracker.principalPointX = W / 2
    p.tracker.principalPointY = H / 2
    if config in ("stereo", "vislam"):
        second = np.asarray(SYNTH_IMU_TO_CAMERA).copy()
        second[0, 3] = -0.11  # EuRoC-like baseline
        p.tracker.useStereo = True
        p.odometry.secondImuToCameraMatrix = tuple(second.T.flatten())
    if config == "vislam":
        p.slam.useSlam = True
        p.slam.applyLoopClosures = True
        p.slam.keyframeCandidateInterval = 4
    return p
