"""Plain-numpy pose and quaternion helpers of the SLAM module's host
bookkeeping (a copy of the reference package's ``slam/host.py`` numpy
twins).

The reference also compiles its SLAM programs for the host CPU there
(``host_jit``, ``cpu_device``), because each accelerator call of its
remote TPU cost a ~30 ms round trip. The port's SLAM session runs its
image work and solves as torch functions on the session's device (the card
by default, which holds the frame already), so those two have no
counterpart here.

Conventions: wxyz Hamilton quaternions, branch-free Shepperd rmat -> quat.
"""
from __future__ import annotations

import numpy as np


def np_quat_to_rmat(q):
    w, x, y, z = q[0], q[1], q[2], q[3]
    return np.array([
        [w*w + x*x - y*y - z*z, 2*(x*y - w*z), 2*(x*z + w*y)],
        [2*(x*y + w*z), w*w - x*x + y*y - z*z, 2*(y*z - w*x)],
        [2*(x*z - w*y), 2*(y*z + w*x), w*w - x*x - y*y + z*z],
    ])


def np_rmat_to_quat(R):
    m = np.asarray(R)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    qw = np.sqrt(max(1 + tr, 0.0)) / 2
    qx = np.sqrt(max(1 + m[0, 0] - m[1, 1] - m[2, 2], 0.0)) / 2
    qy = np.sqrt(max(1 - m[0, 0] + m[1, 1] - m[2, 2], 0.0)) / 2
    qz = np.sqrt(max(1 - m[0, 0] - m[1, 1] + m[2, 2], 0.0)) / 2
    qx = -qx if m[2, 1] - m[1, 2] < 0 else qx
    qy = -qy if m[0, 2] - m[2, 0] < 0 else qy
    qz = -qz if m[1, 0] - m[0, 1] < 0 else qz
    q = np.array([qw, qx, qy, qz])
    return q / np.linalg.norm(q)


def np_quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw*bw - ax*bx - ay*by - az*bz,
        aw*bx + ax*bw + ay*bz - az*by,
        aw*by - ax*bz + ay*bw + az*bx,
        aw*bz + ax*by - ay*bx + az*bw,
    ])


def np_pose_to_mat(pose7):
    """[p, q(wxyz)] camera-to-world -> 4x4 camera-to-world matrix."""
    T = np.eye(4)
    T[:3, :3] = np_quat_to_rmat(np.asarray(pose7)[3:])
    T[:3, 3] = np.asarray(pose7)[:3]
    return T


def np_mat_to_pose(T):
    T = np.asarray(T)
    return np.concatenate([T[:3, 3], np_rmat_to_quat(T[:3, :3])])


def np_relative_pose(pose_a, pose_b):
    """Relative pose a->b in a's frame (numpy twin of slam/ba._relative_pose)."""
    pose_a = np.asarray(pose_a, np.float64)
    pose_b = np.asarray(pose_b, np.float64)
    qa = pose_a[3:]
    Ra = np_quat_to_rmat(qa)
    dp = Ra.T @ (pose_b[:3] - pose_a[:3])
    qab = np_quat_mul(qa * np.array([1.0, -1, -1, -1]), pose_b[3:])
    return np.concatenate([dp, qab])
