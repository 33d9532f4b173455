"""Derived parameters: the 4x4 extrinsic matrices computed from the flat
parameter vectors (the reference's ``config/derived.py``)."""
from __future__ import annotations

import dataclasses

import numpy as np

from ..geometry.poses import vec2matrix
from .params_generated import Parameters


@dataclasses.dataclass
class DerivedParameters:
    imu_to_camera: np.ndarray  # (4,4)
    second_imu_to_camera: np.ndarray  # (4,4)
    imu_to_output: np.ndarray  # (4,4)

    @staticmethod
    def from_parameters(p: Parameters) -> "DerivedParameters":
        imu_to_camera = vec2matrix(p.odometry.imuToCameraMatrix)
        if len(p.odometry.secondImuToCameraMatrix) > 1:
            second = vec2matrix(p.odometry.secondImuToCameraMatrix)
        else:
            second = imu_to_camera.copy()
        if len(p.odometry.secondImuToCameraMatrix) < 16:
            second[:3, 3] += np.asarray(p.odometry.stereoCameraTranslation, dtype=np.float64)
        imu_to_output = imu_to_camera if p.odometry.outputCameraPose else np.eye(4)
        return DerivedParameters(imu_to_camera, second, imu_to_output)
