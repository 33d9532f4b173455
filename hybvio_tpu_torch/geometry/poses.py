"""World/IMU/camera pose conversions over leading dims (port of the
reference's ``geometry/poses.py``). The IMU pose is (p, q) with
``quat_to_rmat(q)`` mapping world -> IMU; ``imu_to_camera`` is 4x4."""
from __future__ import annotations

import numpy as np
import torch

from .quaternion import quat_to_rmat, rmat_to_quat


def _homogeneous(R, t):
    """[[R, t], [0, 0, 0, 1]] over leading dims."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def to_world_to_camera(p, q, imu_to_camera):
    """4x4 world-to-camera matrix from the IMU pose."""
    R = quat_to_rmat(q)
    return imu_to_camera @ _homogeneous(R, -(R @ p[..., None])[..., 0])


def to_camera_to_world(p, q, imu_to_camera):
    """Inverse of ``to_world_to_camera`` in closed form."""
    R = quat_to_rmat(q)
    A = imu_to_camera[..., :3, :3] @ R
    b = -(A @ p[..., None])[..., 0] + imu_to_camera[..., :3, 3]
    At = A.transpose(-1, -2)
    return _homogeneous(At, -(At @ b[..., None])[..., 0])


def to_odometry_pose(world_to_camera, imu_to_camera):
    """World-to-camera matrix (..., 4, 4) -> the IMU position (..., 3) and
    orientation quaternion (..., 4) (reference: util::toOdometryPose)."""
    world_to_imu = torch.linalg.solve(imu_to_camera, world_to_camera)
    R = world_to_imu[..., :3, :3]
    t = world_to_imu[..., :3, 3]
    p = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    return p, rmat_to_quat(R)


def transform_vec3(mat4, v):
    """Apply a homogeneous 4x4 to 3-vectors: ``mat4`` (..., 4, 4) against
    ``v`` (..., 3) with matching leading dims."""
    return (mat4[..., :3, :3] @ v[..., None])[..., 0] + mat4[..., :3, 3]


def vec2matrix(v) -> np.ndarray:
    """Flat parameter vector -> homogeneous 4x4 (3: diagonal, 9: column-major
    rotation, 16: column-major full)."""
    v = np.asarray(v, dtype=np.float64)
    m = np.eye(4)
    if v.size == 3:
        m[0, 0], m[1, 1], m[2, 2] = v
    elif v.size == 9:
        m[:3, :3] = v.reshape(3, 3).T
    elif v.size == 16:
        m = v.reshape(4, 4).T
    else:
        raise ValueError(f"invalid matrix vector size {v.size}")
    return m
