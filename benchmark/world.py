"""The benchmark's synthetic worlds: a frozen copy of the port's sequence
generator (``io/synthetic.py generate_sequence`` and the rig's extrinsics)
and of its device renderer (``io/synthetic_device.py make_blob_renderer``),
so that the traffic a cell sends does not move when the port's own copies
do. ``tests/test_bench_world.py`` holds them against the port's at a tiny
size.

A world is a circular trajectory with IMU samples consistent with it and a
field of landmarks on a cylinder; a view is a sky-sphere background (a
procedural texture on world ray directions: no parallax) with a Gaussian
blob at each visible landmark (fixed size in pixels). Pinhole and KB4
fisheye cameras.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

GRAVITY = 9.819

# IMU-to-camera of the rig: camera forward (+z cam) = +x imu, camera right
# (+x cam) = -y imu, camera down (+y cam) = -z imu
IMU_TO_CAMERA = np.array([
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, -1.0, 0.0],
    [1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
])

# fixed wavevectors of the procedural far-field ("sky sphere") texture
SKY_K = np.random.RandomState(777).randn(8, 3) * np.array([6.0, 6.0, 6.0])
SKY_PH = np.random.RandomState(778).rand(8) * 2 * np.pi
SKY_A = 0.35 / np.arange(1, 9)


def rmats(q):
    """(S, 4) wxyz quaternions (world -> imu) -> (S, 3, 3) rotations."""
    w, x, y, z = np.asarray(q).T
    return np.stack([
        w*w + x*x - y*y - z*z, 2*(x*y - w*z), 2*(x*z + w*y),
        2*(x*y + w*z), w*w - x*x + y*y - z*z, 2*(y*z - w*x),
        2*(x*z - w*y), 2*(y*z + w*x), w*w - x*x - y*y + z*z,
    ], axis=1).reshape(-1, 3, 3)


@dataclasses.dataclass
class Sequence:
    times: np.ndarray  # (S,) IMU timestamps
    gyro: np.ndarray  # (S, 3) measured gyro (with bias and noise)
    acc: np.ndarray  # (S, 3) measured acc
    pos: np.ndarray  # (S, 3) ground-truth position
    quat: np.ndarray  # (S, 4) ground-truth orientation (wxyz, world -> imu)
    vel: np.ndarray  # (S, 3)
    frame_times: np.ndarray  # (F,)
    frame_sample_idx: np.ndarray  # (F,) index into the IMU arrays
    landmarks: np.ndarray  # (NL, 3)


def generate_sequence(duration=20.0, imu_rate=200.0, frame_rate=20.0, radius=2.0,
                      angular_speed=0.4, n_landmarks=600, landmark_radius=6.0,
                      gyro_noise=0.0, acc_noise=0.0, gyro_bias=0.0, acc_bias=0.0, seed=0,
                      z_wobble=0.15) -> Sequence:
    """A circular trajectory starting at rest, yaw tracking the motion (the
    camera, imu x, points outward), and landmarks on a surrounding
    cylinder; the same arrays as the port's ``generate_sequence``."""
    rng = np.random.RandomState(seed)
    S = int(round(duration * imu_rate))
    dt = 1.0 / imu_rate
    tv = np.arange(S) * dt
    times = 10.0 + tv  # nonzero start like real clocks

    # theta(t) = w0 t^3 / (t^2 + c^2): theta'(0) = theta''(0) = 0
    w0 = angular_speed
    c = 1.5
    den = tv * tv + c * c
    th = w0 * tv**3 / den
    dth = w0 * tv**2 * (tv**2 + 3 * c * c) / den**2
    ddth = np.gradient(dth, dt)

    sin_t, cos_t = np.sin(th), np.cos(th)
    sin3, cos3 = np.sin(3 * th), np.cos(3 * th)
    pos = np.stack([radius * cos_t, radius * sin_t, z_wobble * sin3], axis=1)
    dp_dth = np.stack([-radius * sin_t, radius * cos_t, 3 * z_wobble * cos3], axis=1)
    d2p_dth2 = np.stack([-radius * cos_t, -radius * sin_t, -9 * z_wobble * sin3], axis=1)
    vel = dp_dth * dth[:, None]
    acc_w = d2p_dth2 * (dth**2)[:, None] + dp_dth * ddth[:, None]

    # the orientation turns about world z alone, so the port's loop of
    # closed-form quaternion updates is a running sum of half-angles: the
    # same arrays to float64 rounding, in one pass
    half = -0.5 * dt * np.concatenate([[0.0], np.cumsum(dth[:-1])])
    quat = np.stack([np.cos(half), np.zeros(S), np.zeros(S), np.sin(half)], axis=1)
    gyro_true = np.stack([np.zeros(S), np.zeros(S), dth], axis=1)
    gyro_true[S - 1] = gyro_true[S - 2]

    g_world = np.array([0.0, 0.0, -GRAVITY])
    acc_true = np.einsum("sij,sj->si", rmats(quat), acc_w - g_world)

    gyro = gyro_true + gyro_bias * rng.randn(3)[None, :] + gyro_noise * rng.randn(S, 3)
    acc = acc_true + acc_bias * rng.randn(3)[None, :] + acc_noise * rng.randn(S, 3)

    ang = rng.rand(n_landmarks) * 2 * np.pi
    z = rng.rand(n_landmarks) * 4.0 - 2.0
    landmarks = np.stack([landmark_radius * np.cos(ang), landmark_radius * np.sin(ang), z],
                         axis=1)

    stride = int(round(imu_rate / frame_rate))
    frame_sample_idx = np.arange(S // stride) * stride + stride - 1
    return Sequence(times=times, gyro=gyro, acc=acc, pos=pos, quat=quat, vel=vel,
                    frame_times=times[frame_sample_idx], frame_sample_idx=frame_sample_idx,
                    landmarks=landmarks)


def camera_extrinsics(camera: dict) -> list:
    """The rig's IMU-to-camera matrices (4x4) of a configuration's
    ``world.camera``: the first camera, and with a ``baseline`` a second
    one that far along the first's +x."""
    cams = [IMU_TO_CAMERA.copy()]
    if camera.get("baseline"):
        second = IMU_TO_CAMERA.copy()
        second[0, 3] = -float(camera["baseline"])
        cams.append(second)
    return cams


def kb4_theta(rr, coeffs):
    """Angle from the axis of the KB4 radius ``rr`` (Newton inversion)."""
    k1, k2, k3, k4 = (list(coeffs) + [0.0] * 4)[:4]
    theta = rr.copy()
    for _ in range(6):
        t2 = theta * theta
        f = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - rr
        df = 1 + 3 * t2 * (k1 + 5 / 3 * t2 * (k2 + 7 / 5 * t2 * (k3 + 9 / 7 * t2 * k4)))
        theta = np.maximum(theta - f / df, 0.0)
    return theta


def ray_grid(camera: dict) -> np.ndarray:
    """(H, W, 3) unit camera-frame rays of the pixel grid."""
    W, H = camera["width"], camera["height"]
    f, cx, cy = camera["focal"], W / 2, H / 2
    yy, xx = np.mgrid[0:H, 0:W]
    u = (xx - cx) / f
    v = (yy - cy) / f
    if camera.get("kb4") is None:
        rays = np.stack([u, v, np.ones_like(u)], axis=-1)
        rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
        return rays.astype(np.float32)
    rr = np.sqrt(u * u + v * v)
    theta = kb4_theta(rr, camera["kb4"])
    safe_rr = np.maximum(rr, 1e-12)
    rays = np.stack([np.sin(theta) * u / safe_rr, np.sin(theta) * v / safe_rr, np.cos(theta)],
                    axis=-1)
    return rays.astype(np.float32)


def _quat_to_rmat_t(q):
    """(..., 4) wxyz -> (..., 3, 3), torch."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


_FIXED_ONE = float(1 << 40)  # fixed-point unit of the blob sums


def make_renderer(camera: dict, device, blob_sigma=1.4):
    """render(landmarks (B, N, 3), pos (B, 3), quat (B, 4)) -> (B, C, H, W)
    float32 views in [0, 1] on ``device``, one per camera of the rig and
    one world per lane. The blobs are summed in 40-bit fixed point, so the
    same inputs give the same bits whatever order the adds run in."""
    device = torch.device(device)
    f32 = dict(dtype=torch.float32, device=device)
    W, H = camera["width"], camera["height"]
    fx = fy = float(camera["focal"])
    cx, cy = W / 2, H / 2
    kb4 = camera.get("kb4")
    i2c = torch.as_tensor(np.stack([np.asarray(m, np.float32)
                                    for m in camera_extrinsics(camera)]), **f32)
    if kb4 is not None:
        max_theta = float(np.deg2rad(camera["fov_deg"] / 2.0))
    grid = torch.as_tensor(ray_grid(camera), **f32)
    sky_k = torch.as_tensor(np.asarray(SKY_K, np.float32), **f32)
    sky_ph = torch.as_tensor(np.asarray(SKY_PH, np.float32), **f32)
    sky_a = torch.as_tensor(np.asarray(SKY_A, np.float32), **f32)
    r = int(np.ceil(3 * blob_sigma))
    d = torch.arange(-r, r + 1, device=device)
    two_s2 = float(np.float32(2 * blob_sigma ** 2))

    def project_pinhole(pc):
        z = pc[..., 2]
        safe_z = torch.where(torch.abs(z) > 1e-9, z, torch.ones_like(z))
        u = fx * pc[..., 0] / safe_z + cx
        v = fy * pc[..., 1] / safe_z + cy
        vis = (z > 0.3) & (u >= 5) & (u < W - 5) & (v >= 5) & (v < H - 5)
        return torch.stack([u, v], dim=-1), vis

    def project_kb4(pc):
        k1, k2, k3, k4 = (list(kb4) + [0.0] * 4)[:4]
        z = pc[..., 2]
        nrm = torch.linalg.norm(pc, dim=-1)
        theta = torch.arccos(torch.clamp(z / torch.clamp(nrm, min=1e-12), -1, 1))
        t2 = theta * theta
        rad = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        rxy = torch.linalg.norm(pc[..., :2], dim=-1)
        dxy = pc[..., :2] / torch.clamp(rxy, min=1e-12)[..., None]
        u = rad * dxy[..., 0] * fx + cx
        v = rad * dxy[..., 1] * fy + cy
        vis = ((z > 0.3) & (theta <= max_theta)
               & (u >= 5) & (u < W - 5) & (v >= 5) & (v < H - 5))
        return torch.stack([u, v], dim=-1), vis

    @torch.no_grad()
    def render(landmarks, pos, quat):
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            landmarks, pos, quat = (torch.as_tensor(a, **f32) for a in (landmarks, pos, quat))
            B, N = landmarks.shape[:2]
            R = _quat_to_rmat_t(quat)  # (B, 3, 3)
            rot = i2c[:, :3, :3]  # (C, 3, 3)
            w2c = rot @ R[:, None]  # (B, C, 3, 3)
            t = (rot @ (-(R @ pos[..., None]))[:, None])[..., 0] + i2c[:, :3, 3]  # (B, C, 3)
            pc = landmarks[:, None] @ w2c.transpose(-1, -2) + t[:, :, None]  # (B, C, N, 3)
            pix, vis = project_kb4(pc) if kb4 is not None else project_pinhole(pc)
            world_rays = grid @ w2c[:, :, None]  # (B, C, H, W, 3)
            phase = world_rays @ sky_k.T + sky_ph
            img = 0.35 + torch.sin(phase) @ sky_a * 0.25  # (B, C, H, W)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        # blobs: (2r+1)^2 subpixel Gaussian patches, scatter-added; invisible
        # landmarks get an off-image sentinel so their (amp 0) patches drop
        pix = torch.where(vis[..., None], pix, torch.full_like(pix, 1.0e5))
        iu = torch.round(pix[..., 0]).to(torch.int64)
        iv = torch.round(pix[..., 1]).to(torch.int64)
        xs = iu[..., None] + d  # (B, C, N, 2r+1)
        ys = iv[..., None] + d
        gx = xs.to(torch.float32) - pix[..., 0:1]
        gy = ys.to(torch.float32) - pix[..., 1:2]
        g = torch.exp(-(gy[..., :, None] ** 2 + gx[..., None, :] ** 2) / two_s2)
        amp = torch.where(torch.arange(N, device=device) % 2 == 0, 0.6, -0.22).to(torch.float32)
        vals = (amp * vis.to(torch.float32))[..., None, None] * g  # (B, C, N, 2r+1, 2r+1)
        inside = (((ys >= 0) & (ys < H))[..., :, None] & ((xs >= 0) & (xs < W))[..., None, :])
        lane_cam = torch.arange(B * pc.shape[1], device=device).reshape(
            B, pc.shape[1], 1, 1, 1) * (H * W + 1)
        flat = torch.where(inside, lane_cam + ys[..., :, None] * W + xs[..., None, :],
                           lane_cam + H * W)  # the last slot of each image takes the drops
        acc = torch.zeros(B * pc.shape[1] * (H * W + 1), dtype=torch.int64, device=device)
        acc.index_add_(0, flat.reshape(-1),
                       torch.round(vals.to(torch.float64) * _FIXED_ONE).to(torch.int64).reshape(-1))
        blobs = acc.reshape(B, -1, H * W + 1)[..., :H * W].to(torch.float64) / _FIXED_ONE
        img = (img.to(torch.float64) + blobs.reshape(B, -1, H, W)).to(torch.float32)
        return torch.clamp(img, 0.0, 1.0)

    return render


def to_u8(frames: torch.Tensor) -> torch.Tensor:
    """[0, 1] float views -> the sensor's 8-bit values."""
    return torch.round(frames * 255.0).to(torch.uint8)


def lane_worlds(seed: int, lanes: int, world: dict, frames: int, frame_rate: float,
                imu_rate: float) -> list:
    """The ``lanes`` sequences of one run: lane b's world seed and its
    trajectory's radius, angular speed and z wobble drawn from ``seed``
    (the ranges in ``world``), each ``frames`` frames long."""
    rng = np.random.RandomState(np.random.SeedSequence(int(seed)).generate_state(1)[0])
    draws = [(int(rng.randint(2**31 - 1)), float(rng.uniform(*world["radius_m"])),
              float(rng.uniform(*world["angular_speed_rad_s"])),
              float(rng.uniform(*world["z_wobble_m"]))) for _ in range(lanes)]
    return [generate_sequence(
        duration=frames / frame_rate, imu_rate=imu_rate, frame_rate=frame_rate,
        radius=radius, angular_speed=speed, z_wobble=wobble,
        n_landmarks=world["n_landmarks"], landmark_radius=world["landmark_radius_m"],
        gyro_noise=world["gyro_noise"], acc_noise=world["acc_noise"], seed=s)
        for s, radius, speed, wobble in draws]
