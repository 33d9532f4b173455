"""On-device renderer of the synthetic blob world for per-lane frames (port
of the reference's ``io/synthetic_jax.py make_blob_renderer``).

The host renderer (``io.synthetic.render_view`` / ``render_view_fisheye``)
takes ~240 ms a frame at 752x480 (reference ``bench.py:755-758``: ~8 s a
step for 16 lanes), which would make a run over B distinct worlds time the
host. This module renders the same world model (sky-sphere background +
subpixel Gaussian landmark blobs) for every lane at once in plain tensor
ops on the device, pinhole (stereo and mono) or KB4. The reference has no
Pallas kernel here, so neither has the port.

The blobs are scatter-added in 40-bit fixed point in int64, whose sums do
not depend on the order of the atomic adds: the same inputs give the same
bits on the card twice (a float scatter-add would not).
"""
from __future__ import annotations

import numpy as np
import torch

from ..runtime import full_precision
from .synthetic import _SKY_A, _SKY_K, _SKY_PH

_FIXED_ONE = float(1 << 40)  # fixed-point unit of the blob sums


def _ray_grid_pinhole(fx, fy, cx, cy, W, H):
    yy, xx = np.mgrid[0:H, 0:W]
    u = (xx - cx) / fx
    v = (yy - cy) / fy
    rays = np.stack([u, v, np.ones_like(u)], axis=-1)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    return rays.astype(np.float32)


def _ray_grid_kb4(fx, fy, cx, cy, W, H, coeffs):
    """Camera-frame ray directions of the pixel grid under the KB4 model
    (numpy Newton inversion, once per camera)."""
    yy, xx = np.mgrid[0:H, 0:W]
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
    rays = np.stack([np.sin(theta) * u / safe_rr, np.sin(theta) * v / safe_rr, np.cos(theta)],
                    axis=-1)
    return rays.astype(np.float32)


def _quat_to_rmat(q):
    """(..., 4) wxyz -> (..., 3, 3), the reference renderer's formula."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def make_blob_renderer(imu_to_cameras, fx, fy, cx, cy, W, H, blob_sigma=1.4,
                       fisheye_coeffs=None, max_fov_deg=160.0, device="cuda"):
    """render(landmarks (B, N, 3), pos (B, 3), quat (B, 4)) -> (B, C, H, W)
    float32 frames on ``device``, one image per camera in
    ``imu_to_cameras`` and one world per lane.

    Matches ``io.synthetic.render_view`` (pinhole) / ``render_view_fisheye``
    (KB4) within float32: sky-sphere background + additive subpixel
    Gaussian blobs with the same per-landmark contrast (amp 0.6 / -0.22 by
    landmark parity) and the same 5-pixel visibility margin. The ray grid,
    the extrinsics and the sky constants go to the device once, here.
    Camera c of the result, ``frames[:, c]``, is a (B, H, W) view with lane
    stride C * H * W, which the pyramid kernel takes without a copy."""
    device = torch.device(device)
    f32 = dict(dtype=torch.float32, device=device)
    i2c = torch.as_tensor(np.stack([np.asarray(m, np.float32) for m in imu_to_cameras]), **f32)
    C = i2c.shape[0]
    if fisheye_coeffs is not None:
        grid = _ray_grid_kb4(fx, fy, cx, cy, W, H, fisheye_coeffs)
        max_theta = float(np.deg2rad(max_fov_deg / 2.0))
    else:
        grid = _ray_grid_pinhole(fx, fy, cx, cy, W, H)
    grid = torch.as_tensor(grid, **f32)  # (H, W, 3), the same for every camera
    sky_k = torch.as_tensor(np.asarray(_SKY_K, np.float32), **f32)  # (8, 3)
    sky_ph = torch.as_tensor(np.asarray(_SKY_PH, np.float32), **f32)
    sky_a = torch.as_tensor(np.asarray(_SKY_A, np.float32), **f32)
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
        k1, k2, k3, k4 = (list(fisheye_coeffs) + [0.0] * 4)[:4]
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
        with full_precision():
            landmarks, pos, quat = (torch.as_tensor(a, **f32) for a in (landmarks, pos, quat))
            B, N = landmarks.shape[:2]
            R = _quat_to_rmat(quat)  # (B, 3, 3)
            rot = i2c[:, :3, :3]  # (C, 3, 3)
            w2c = rot @ R[:, None]  # (B, C, 3, 3)
            t = (rot @ (-(R @ pos[..., None]))[:, None])[..., 0] + i2c[:, :3, 3]  # (B, C, 3)
            pc = landmarks[:, None] @ w2c.transpose(-1, -2) + t[:, :, None]  # (B, C, N, 3)
            pix, vis = project_kb4(pc) if fisheye_coeffs is not None else project_pinhole(pc)
            # sky background: procedural texture on world ray directions
            world_rays = grid @ w2c[:, :, None]  # (B, C, H, W, 3)
            phase = world_rays @ sky_k.T + sky_ph
            img = 0.35 + torch.sin(phase) @ sky_a * 0.25  # (B, C, H, W)
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
        lane_cam = torch.arange(B * C, device=device).reshape(B, C, 1, 1, 1) * (H * W + 1)
        flat = torch.where(inside, lane_cam + ys[..., :, None] * W + xs[..., None, :],
                           lane_cam + H * W)  # the last slot of each image takes the drops
        acc = torch.zeros(B * C * (H * W + 1), dtype=torch.int64, device=device)
        acc.index_add_(0, flat.reshape(-1),
                       torch.round(vals.to(torch.float64) * _FIXED_ONE).to(torch.int64).reshape(-1))
        blobs = acc.reshape(B, C, H * W + 1)[..., :H * W].to(torch.float64) / _FIXED_ONE
        img = (img.to(torch.float64) + blobs.reshape(B, C, H, W)).to(torch.float32)
        return torch.clamp(img, 0.0, 1.0)

    return render
