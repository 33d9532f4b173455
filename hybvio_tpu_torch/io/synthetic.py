"""Synthetic VIO data for the port's smoke run and tests: a circular
trajectory with consistent IMU samples, a landmark field, and rendered
grayscale views (Gaussian blob landmarks over a procedural far-field
background). A numpy-only copy of the reference's ``io/synthetic.py``
(``generate_sequence``, ``render_view``, ``render_view_fisheye``,
``SYNTH_IMU_TO_CAMERA`` and their helpers): same seeds, same arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np

GRAVITY = 9.819


def _np_quat_to_rmat(q):
    """numpy quat->rmat (the formula of geometry.quaternion.quat_to_rmat)."""
    w, x, y, z = q
    return np.array([
        [w*w + x*x - y*y - z*z, 2*(x*y - w*z), 2*(x*z + w*y)],
        [2*(x*y + w*z), w*w - x*x + y*y - z*z, 2*(y*z - w*x)],
        [2*(x*z - w*y), 2*(y*z + w*x), w*w - x*x - y*y + z*z],
    ])


def _np_gyro_update_matrix(w, dt):
    """numpy expm(-dt/2 S(w)) via the closed form (see geometry.quaternion)."""
    wx, wy, wz = w
    S = np.array([
        [0, -wx, -wy, -wz],
        [wx, 0, -wz, wy],
        [wy, wz, 0, -wx],
        [wz, -wy, wx, 0],
    ])
    n = np.linalg.norm(w)
    h = 0.5 * dt
    if n < 1e-12:
        return np.eye(4) - h * S
    return np.cos(n * h) * np.eye(4) - (np.sin(n * h) / n) * S


@dataclasses.dataclass
class SyntheticSequence:
    times: np.ndarray  # (S,) IMU timestamps
    gyro: np.ndarray  # (S,3) measured gyro (with bias+noise)
    acc: np.ndarray  # (S,3) measured acc
    pos: np.ndarray  # (S,3) ground-truth position
    quat: np.ndarray  # (S,4) ground-truth orientation (wxyz, world->imu)
    vel: np.ndarray  # (S,3)
    frame_times: np.ndarray  # (F,)
    frame_sample_idx: np.ndarray  # (F,) index into IMU arrays
    landmarks: np.ndarray  # (NL,3)


def generate_sequence(
    duration: float = 20.0,
    imu_rate: float = 200.0,
    frame_rate: float = 20.0,
    radius: float = 2.0,
    angular_speed: float = 0.4,
    n_landmarks: int = 600,
    landmark_radius: float = 6.0,
    gyro_noise: float = 0.0,
    acc_noise: float = 0.0,
    gyro_bias: float = 0.0,
    acc_bias: float = 0.0,
    seed: int = 0,
    z_wobble: float = 0.15,
) -> SyntheticSequence:
    """Circular trajectory with yaw tracking the motion; camera (imu x axis)
    points outward. Landmarks on a surrounding cylinder."""
    rng = np.random.RandomState(seed)
    S = int(round(duration * imu_rate))
    dt = 1.0 / imu_rate
    tv = np.arange(S) * dt
    times = 10.0 + tv  # nonzero start like real clocks

    # trajectory parameter theta(t) = w0 * t^3 / (t^2 + c^2): starts at rest
    # (theta'(0) = theta''(0) = 0, so v(0) = a(0) = 0 — the filter initializes
    # assuming an initially near-stationary device, like real VIO datasets)
    w0 = angular_speed
    c = 1.5
    den = tv * tv + c * c
    th = w0 * tv**3 / den
    dth = w0 * tv**2 * (tv**2 + 3 * c * c) / den**2
    # theta'' via numeric differentiation of the analytic theta' (accurate to
    # O(dt^2); only enters the acc ground-truth signal)
    ddth = np.gradient(dth, dt)

    sin_t, cos_t = np.sin(th), np.cos(th)
    sin3, cos3 = np.sin(3 * th), np.cos(3 * th)
    pos = np.stack([radius * cos_t, radius * sin_t, z_wobble * sin3], axis=1)
    dp_dth = np.stack([-radius * sin_t, radius * cos_t, 3 * z_wobble * cos3], axis=1)
    d2p_dth2 = np.stack([-radius * cos_t, -radius * sin_t, -9 * z_wobble * sin3], axis=1)
    vel = dp_dth * dth[:, None]
    acc_w = d2p_dth2 * (dth**2)[:, None] + dp_dth * ddth[:, None]

    # orientation: yaw follows theta so imu x points outward (radial); device
    # z stays up. Integrate the quaternion with the EKF's own update so the
    # conventions match exactly.
    quat = np.zeros((S, 4))
    quat[0] = np.array([1.0, 0, 0, 0])
    gyro_true = np.zeros((S, 3))
    for k in range(1, S):
        R = _np_quat_to_rmat(quat[k - 1])
        w_world = np.array([0.0, 0.0, dth[k - 1]])
        w_body = R @ w_world
        gyro_true[k - 1] = w_body
        A = _np_gyro_update_matrix(w_body, dt)
        q = A @ quat[k - 1]
        quat[k] = q / np.linalg.norm(q)
    gyro_true[S - 1] = gyro_true[S - 2]

    g_world = np.array([0.0, 0.0, -GRAVITY])
    acc_true = np.zeros((S, 3))
    for k in range(S):
        R = _np_quat_to_rmat(quat[k])
        acc_true[k] = R @ (acc_w[k] - g_world)

    gyro = gyro_true + gyro_bias * rng.randn(3)[None, :] + gyro_noise * rng.randn(S, 3)
    acc = acc_true + acc_bias * rng.randn(3)[None, :] + acc_noise * rng.randn(S, 3)

    # landmarks on a cylinder around the trajectory
    ang = rng.rand(n_landmarks) * 2 * np.pi
    z = rng.rand(n_landmarks) * 4.0 - 2.0
    landmarks = np.stack([
        landmark_radius * np.cos(ang), landmark_radius * np.sin(ang), z], axis=1)

    stride = int(round(imu_rate / frame_rate))
    frame_sample_idx = np.arange(S // stride) * stride + stride - 1
    frame_times = times[frame_sample_idx]
    return SyntheticSequence(
        times=times, gyro=gyro, acc=acc, pos=pos, quat=quat, vel=vel,
        frame_times=frame_times, frame_sample_idx=frame_sample_idx,
        landmarks=landmarks,
    )


# IMU-to-camera for the synthetic rig: camera forward (+z cam) = +x imu,
# camera right (+x cam) = -y imu, camera down (+y cam) = -z imu
SYNTH_IMU_TO_CAMERA = np.array([
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, -1.0, 0.0],
    [1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
])


def project_landmarks(landmarks, pos, quat, imu_to_camera, fx, fy, cx, cy,
                      width, height, min_depth=0.3):
    """Project landmarks into the camera at pose (pos, quat).

    Returns (pixels (NL,2), depths (NL,), visible (NL,) bool).
    """
    R = _np_quat_to_rmat(np.asarray(quat))
    w2c = imu_to_camera[:3, :3] @ R
    t = imu_to_camera[:3, :3] @ (-R @ pos) + imu_to_camera[:3, 3]
    pc = landmarks @ w2c.T + t
    z = pc[:, 2]
    safe_z = np.where(np.abs(z) > 1e-9, z, 1.0)
    u = fx * pc[:, 0] / safe_z + cx
    v = fy * pc[:, 1] / safe_z + cy
    visible = (z > min_depth) & (u >= 5) & (u < width - 5) & (v >= 5) & (v < height - 5)
    return np.stack([u, v], axis=1), z, visible


def render_frame(landmark_pixels, depths, visible, width, height,
                 blob_sigma=1.5, background=None, seed=0):
    """Render a grayscale frame: Gaussian blobs at landmark projections over a
    smooth background, float32 in [0,1]."""
    img = np.zeros((height, width), dtype=np.float32)
    if background is None:
        yy, xx = np.mgrid[0:height, 0:width]
        background = 0.25 + 0.1 * np.sin(xx / 37.0) * np.cos(yy / 29.0)
    img += background.astype(np.float32)
    r = int(np.ceil(3 * blob_sigma))
    rng = np.random.RandomState(seed)
    for i in np.where(visible)[0]:
        u, v = landmark_pixels[i]
        iu, iv = int(round(u)), int(round(v))
        x0, x1 = max(iu - r, 0), min(iu + r + 1, width)
        y0, y1 = max(iv - r, 0), min(iv + r + 1, height)
        if x1 <= x0 or y1 <= y0:
            continue
        xs = np.arange(x0, x1) - u
        ys = np.arange(y0, y1) - v
        g = np.exp(-(ys[:, None] ** 2 + xs[None, :] ** 2) / (2 * blob_sigma ** 2))
        # deterministic per-landmark contrast (some bright, some dark)
        amp = 0.6 if (i % 2 == 0) else -0.22
        img[y0:y1, x0:x1] += (amp * g).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


# fixed wavevectors for the procedural far-field ("sky sphere") texture
_SKY_K = np.random.RandomState(777).randn(8, 3) * np.array([6.0, 6.0, 6.0])
_SKY_PH = np.random.RandomState(778).rand(8) * 2 * np.pi
_SKY_A = 0.35 / np.arange(1, 9)


def sky_background(quat, imu_to_camera, fx, fy, cx, cy, width, height):
    """Geometrically consistent distant background: a procedural texture on
    the sphere of world ray directions (rotates with the camera, no parallax).
    Gives LK gradient signal everywhere without creating frozen-pixel
    features (a static image-space pattern would act like dirt on the lens)."""
    yy, xx = np.mgrid[0:height, 0:width]
    u = (xx - cx) / fx
    v = (yy - cy) / fy
    rays = np.stack([u, v, np.ones_like(u)], axis=-1)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    R = _np_quat_to_rmat(np.asarray(quat))
    w2c = imu_to_camera[:3, :3] @ R
    world_rays = rays @ w2c  # (H,W,3): rays rotated to world (c2w = w2c^T)
    phase = world_rays @ _SKY_K.T + _SKY_PH[None, None, :]
    tex = 0.35 + np.einsum("hwk,k->hw", np.sin(phase), _SKY_A) * 0.25
    return tex.astype(np.float32)


def render_view(landmarks, pos, quat, imu_to_camera, fx, fy, cx, cy,
                width, height, blob_sigma=1.4, pixel_noise=0.0, seed=0):
    """Render one camera view: sky-sphere background + landmark blobs."""
    pix, depth, vis = project_landmarks(
        landmarks, pos, quat, imu_to_camera, fx, fy, cx, cy, width, height)
    bg = sky_background(quat, imu_to_camera, fx, fy, cx, cy, width, height)
    img = render_frame(pix, depth, vis, width, height, blob_sigma=blob_sigma,
                       background=bg, seed=seed)
    if pixel_noise > 0:
        rng = np.random.RandomState(seed)
        img = np.clip(img + pixel_noise * rng.randn(height, width).astype(np.float32), 0, 1)
    return img


def _np_kb4_project(pc, fx, fy, cx, cy, coeffs, max_theta):
    """numpy Kannala-Brandt-4 projection of camera-frame points (N,3).
    Returns (pixels (N,2), valid (N,))."""
    z = pc[:, 2]
    nrm = np.linalg.norm(pc, axis=1)
    cos_t = np.clip(z / np.maximum(nrm, 1e-12), -1, 1)
    theta = np.arccos(cos_t)
    valid = (z > 0) & (theta <= max_theta)
    k1, k2, k3, k4 = (list(coeffs) + [0.0] * 4)[:4]
    t2 = theta * theta
    r = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    rxy = np.linalg.norm(pc[:, :2], axis=1)
    dxy = pc[:, :2] / np.maximum(rxy, 1e-12)[:, None]
    uv = r[:, None] * dxy
    return np.stack([uv[:, 0] * fx + cx, uv[:, 1] * fy + cy], axis=1), valid


def project_landmarks_fisheye(landmarks, pos, quat, imu_to_camera, fx, fy, cx, cy,
                              width, height, coeffs, max_fov_deg=160.0,
                              min_depth=0.3):
    """KB4 fisheye landmark projection (TUM-VI-style rig)."""
    R = _np_quat_to_rmat(np.asarray(quat))
    w2c = imu_to_camera[:3, :3] @ R
    t = imu_to_camera[:3, :3] @ (-R @ pos) + imu_to_camera[:3, 3]
    pc = landmarks @ w2c.T + t
    pix, valid = _np_kb4_project(pc, fx, fy, cx, cy, coeffs,
                                 np.deg2rad(max_fov_deg / 2))
    valid &= (pc[:, 2] > min_depth)
    valid &= (pix[:, 0] >= 5) & (pix[:, 0] < width - 5)
    valid &= (pix[:, 1] >= 5) & (pix[:, 1] < height - 5)
    return pix, pc[:, 2], valid


def render_view_fisheye(landmarks, pos, quat, imu_to_camera, fx, fy, cx, cy,
                        width, height, coeffs, max_fov_deg=160.0,
                        blob_sigma=1.4, seed=0):
    """Render a fisheye view: KB4 blobs over a ray-direction sky texture."""
    pix, depth, vis = project_landmarks_fisheye(
        landmarks, pos, quat, imu_to_camera, fx, fy, cx, cy, width, height,
        coeffs, max_fov_deg)
    # background: unproject the pixel grid with the KB4 model (numpy Newton)
    yy, xx = np.mgrid[0:height, 0:width]
    u = (xx - cx) / fx
    v = (yy - cy) / fy
    rr = np.sqrt(u * u + v * v)
    k1, k2, k3, k4 = (list(coeffs) + [0.0] * 4)[:4]
    theta = rr.copy()
    for _ in range(6):
        t2 = theta * theta
        f = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - rr
        df = 1 + 3 * t2 * (k1 + 5 / 3 * t2 * (k2 + 7 / 5 * t2 * (k3 + 9 / 7 * t2 * k4)))
        theta = np.maximum(theta - f / df, 0.0)
    safe_rr = np.maximum(rr, 1e-12)
    rays = np.stack([np.sin(theta) * u / safe_rr,
                     np.sin(theta) * v / safe_rr, np.cos(theta)], axis=-1)
    R = _np_quat_to_rmat(np.asarray(quat))
    w2c = imu_to_camera[:3, :3] @ R
    world_rays = rays @ w2c
    phase = world_rays @ _SKY_K.T + _SKY_PH[None, None, :]
    bg = (0.35 + np.einsum("hwk,k->hw", np.sin(phase), _SKY_A) * 0.25).astype(np.float32)
    return render_frame(pix, depth, vis, width, height, blob_sigma=blob_sigma,
                        background=bg, seed=seed)

