"""Stereo rectification and undistortion resampling (port of the
reference's ``frontend/rectify.py``).

``stereo_rectify`` runs once at build time on the host (numpy): a pair of
rectified pinhole cameras carrying the rectification rotation (so rays stay
in the original camera frames), and the disparity-to-depth Q matrix
re-rotated into unrectified cam0 coordinates. ``build_remap`` evaluates the
dense resampling field of a camera pair as one vectorized
``dst.pixel_to_ray -> src.ray_to_pixel`` pass; ``remap`` resamples a frame,
(H, W) or one per lane (B, H, W), through it on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry.cameras import Camera, build_pinhole, pixel_to_ray, ray_to_pixel
from ..runtime import default_device
from .pyramid import bilinear_sample


def _f32(x):
    """``x`` (a float or array) as a float32 array holds it: the reference
    builds its rectified cameras and Q in float32."""
    return np.asarray(x, dtype=np.float32).astype(np.float64)


def _rotvec(R):
    """Rotation vector (axis * angle) of a rotation matrix, through its unit
    quaternion (Markley's method, as scipy's ``Rotation.as_rotvec``)."""
    tr = np.trace(R)
    d = np.array([R[0, 0], R[1, 1], R[2, 2], tr])
    k = int(np.argmax(d))
    q = np.empty(4)  # x, y, z, w
    if k == 3:
        q[0] = R[2, 1] - R[1, 2]
        q[1] = R[0, 2] - R[2, 0]
        q[2] = R[1, 0] - R[0, 1]
        q[3] = 1 + tr
    else:
        i, j, m = k, (k + 1) % 3, (k + 2) % 3
        q[i] = 1 - tr + 2 * R[i, i]
        q[j] = R[j, i] + R[i, j]
        q[m] = R[m, i] + R[i, m]
        q[3] = R[m, j] - R[j, m]
    q /= np.linalg.norm(q)
    if q[3] < 0:
        q = -q
    angle = 2 * np.arctan2(np.linalg.norm(q[:3]), q[3])
    small = angle <= 1e-3
    a2 = angle * angle
    scale = (2 + a2 / 12 + 7 * a2 * a2 / 2880) if small else angle / np.sin(angle / 2)
    return scale * q[:3]


def _from_rotvec(v):
    """Rotation matrix of a rotation vector (Rodrigues)."""
    angle = np.linalg.norm(v)
    if angle < 1e-12:
        return np.eye(3)
    k = v / angle
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def stereo_rectify(cam0: Camera, cam1: Camera, imu_to_cam0, imu_to_cam1, width: int,
                   height: int, zoom: float = 1.0):
    """Rectified cameras and Q (reference: StereoRectifier::build): the
    relative rotation cam0 -> cam1 split evenly between the two, then a
    common rotation putting x along the baseline. Returns (rect_cam0,
    rect_cam1, Q (4, 4) numpy disparity -> homogeneous point in UNRECTIFIED
    cam0 coordinates, R_rect0, R_rect1). The cameras' and Q's values are
    rounded to float32."""
    T01 = (np.asarray(imu_to_cam1, np.float64)
           @ np.linalg.inv(np.asarray(imu_to_cam0, np.float64)))
    R = T01[:3, :3]
    t = T01[:3, 3]
    rotvec = _rotvec(R)
    R_half0 = _from_rotvec(-rotvec / 2)
    R_half1 = _from_rotvec(rotvec / 2)
    t_half = R_half1 @ t
    e1 = -t_half / np.linalg.norm(t_half)
    if e1[0] < 0:
        e1 = -e1
    e2 = np.cross(np.array([0.0, 0.0, 1.0]), e1)
    e2 /= np.linalg.norm(e2)
    e3 = np.cross(e1, e2)
    R_align = np.stack([e1, e2, e3], axis=0)
    R_rect0 = R_align @ R_half0
    R_rect1 = R_align @ R_half1

    f = float(_f32((cam0.fx + cam0.fy) * 0.5 * zoom))
    cx, cy = width / 2.0, height / 2.0
    rc0 = build_pinhole(f, f, cx, cy, width=width, height=height,
                        rotation=_f32(R_rect0.T))
    rc1 = build_pinhole(f, f, cx, cy, width=width, height=height,
                        rotation=_f32(R_rect1.T))
    baseline = float(np.linalg.norm(t))
    Q_rect = np.array([
        [1.0, 0.0, 0.0, -cx],
        [0.0, 1.0, 0.0, -cy],
        [0.0, 0.0, 0.0, (cam0.fx + cam0.fy) * 0.5 * zoom],
        [0.0, 0.0, 1.0 / baseline, 0.0],
    ])
    R4 = np.eye(4)
    R4[:3, :3] = R_rect0.T
    return rc0, rc1, _f32(R4 @ Q_rect), R_rect0, R_rect1


def build_remap(src_cam: Camera, dst_cam: Camera, width: int, height: int,
                dtype=torch.float32, device=None):
    """(H, W, 2) map of ``dtype`` on ``device`` (the card unless given):
    for each DST pixel, the SRC pixel to sample; (-10, -10) (a clamped dark
    border) where the ray misses."""
    dev = default_device() if device is None else torch.device(device)
    ys, xs = torch.meshgrid(torch.arange(height, device=dev), torch.arange(width, device=dev),
                            indexing="ij")
    pix = torch.stack([xs, ys], dim=-1).to(dtype)
    rays, ok1 = pixel_to_ray(dst_cam, pix)
    src_pix, ok2 = ray_to_pixel(src_cam, rays)
    return torch.where((ok1 & ok2)[..., None], src_pix, torch.full_like(src_pix, -10.0))


def remap(image, mapping):
    """Bilinear resample of ``image`` (H, W) or (B, H, W) at ``mapping``
    (H, W, 2)."""
    return bilinear_sample(image, mapping)


def build_mono_undistort(cam: Camera, width: int, height: int, zoom: float = 1.0,
                         dtype=torch.float32, device=None):
    """Mono undistortion target (reference: Undistorter::buildMono): a
    pinhole with the principal point centred (its focal length float32, as
    the reference's), and the remap of ``dtype`` into it on ``device`` (the
    card unless given)."""
    f = float(_f32((cam.fx + cam.fy) * 0.5 * zoom))
    target = build_pinhole(f, f, width / 2, height / 2, width=width, height=height)
    return target, build_remap(cam, target, width, height, dtype, device)
