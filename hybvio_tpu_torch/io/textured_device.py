"""On-device renderer of the textured world (port of the reference's
``io/textured_jax.py make_textured_renderer``).

``io/textured.py`` renders the procedural world (cylinder wall, floor,
ceiling and spherical occluders under multi-octave value noise; exposure
jitter, pixel noise, a 2-tap motion blur) in numpy float64 on the host,
seconds a frame at 752x480. This module renders the same world in float32
tensor ops on the device, a chunk of frames at a time, so the long accuracy
protocol (``eval/long_probe.py``) feeds the step frames that never leave
the card. The reference has no Pallas kernel here, so neither has the port.

As in the reference, the world's geometry is ``io/textured.py``'s, the
lattice hash runs in wrapping uint32 arithmetic (here int64 masked to 32
bits: torch has only part of uint32's arithmetic), and the pixel noise is
``jax.random.normal`` on per-frame threefry keys (``random.normal``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import random as jr
from ..runtime import default_device, full_precision
from .textured import TexturedScene

_MASK = 0xFFFFFFFF


def _hash01(ix, iy, seed: int):
    """The uint32 lattice hash of integer lattice coordinates (int64 tensors)
    -> [0, 1) float32."""
    h = (((ix & _MASK) * 374761393) & _MASK) + (((iy & _MASK) * 668265263) & _MASK)
    h = (h + ((seed * 2654435761) & _MASK)) & _MASK
    h = ((h ^ (h >> 13)) * 1274126177) & _MASK
    h = h ^ (h >> 16)
    return (h & 0xFFFFFF).to(torch.float32) / float(0x1000000)


def _value_noise(x, y, octaves: int, base_scale: float, seed: int):
    """Multi-octave value noise at float coordinates (x, y); float32 in [0, 1]."""
    out = torch.zeros_like(x, dtype=torch.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        s = float(np.float32(base_scale * (2.0 ** o)))
        xs = x.to(torch.float32) * s
        ys = y.to(torch.float32) * s
        ix, iy = torch.floor(xs), torch.floor(ys)
        fx, fy = xs - ix, ys - iy
        wx = fx * fx * (3.0 - 2.0 * fx)
        wy = fy * fy * (3.0 - 2.0 * fy)
        ixi = ix.to(torch.int32).to(torch.int64)
        iyi = iy.to(torch.int32).to(torch.int64)
        n00 = _hash01(ixi, iyi, seed + o)
        n10 = _hash01(ixi + 1, iyi, seed + o)
        n01 = _hash01(ixi, iyi + 1, seed + o)
        n11 = _hash01(ixi + 1, iyi + 1, seed + o)
        val = (n00 * (1 - wx) * (1 - wy) + n10 * wx * (1 - wy)
               + n01 * (1 - wx) * wy + n11 * wx * wy)
        out = out + float(np.float32(amp)) * val
        total += amp
        amp *= 0.55
    return out / float(np.float32(total))


def _camera_rays(fx, fy, cx, cy, width, height, fisheye_coeffs=None):
    """Camera-frame ray directions of the pixel grid (H, W, 3), numpy
    float64 (the pinhole's, or the KB4 model's by Newton inversion)."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    u = (xx - cx) / fx
    v = (yy - cy) / fy
    if fisheye_coeffs is None:
        return np.stack([u, v, np.ones_like(u)], axis=-1)
    k1, k2, k3, k4 = fisheye_coeffs
    r = np.sqrt(u * u + v * v)
    theta = r.copy()
    for _ in range(8):
        t2 = theta * theta
        f = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - r
        fp = 1 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        theta = theta - f / np.maximum(fp, 1e-9)
    safe_r = np.where(r > 1e-12, r, 1.0)
    s_t = np.sin(theta)
    d = np.stack([s_t * u / safe_r, s_t * v / safe_r, np.cos(theta)], axis=-1)
    return np.where(r[..., None] > 1e-12, d, np.stack([0 * u, 0 * v, np.ones_like(u)], -1))


def _quat_to_rmat(q):
    """(F, 4) wxyz -> (F, 3, 3), the reference renderer's formula."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r = torch.stack([
        w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z,
    ], dim=-1)
    return r.reshape(-1, 3, 3)


def make_textured_renderer(scene: TexturedScene, imu_to_camera, fx: float, fy: float,
                           cx: float, cy: float, width: int, height: int,
                           fisheye_coeffs=None, exposure_jitter: float = 0.0,
                           pixel_noise: float = 0.0, motion_blur: bool = False, device=None):
    """``render_sequence(seq, frame_indices=None, chunk=32) -> (F, H, W)``
    float32 frames on ``device`` (the card unless told otherwise) of the
    textured world seen by the camera ``imu_to_camera``, ``chunk`` frames
    at a time. The per-frame exposure jitter follows the reference's
    RandomState(scene.seed + 4321) recipe and the noise its threefry key
    scene.seed * 1000 + frame index, so a scene seed gives one sequence."""
    device = torch.device(device) if device is not None else default_device()
    f32 = dict(dtype=torch.float32, device=device)
    i2c = np.asarray(imu_to_camera, np.float64)
    Rc = torch.as_tensor(np.asarray(i2c[:3, :3], np.float32), **f32)
    t_cam = torch.as_tensor(np.asarray(i2c[:3, 3], np.float32), **f32)
    d_cam = torch.as_tensor(np.asarray(_camera_rays(fx, fy, cx, cy, width, height,
                                                    fisheye_coeffs), np.float32), **f32)
    occ_centers = torch.as_tensor(np.asarray(scene.occ_centers, np.float32), **f32)
    occ_radii = np.asarray(scene.occ_radii)
    wall_r2 = float(np.float32(scene.wall_radius ** 2))
    two_pi = float(np.float32(2 * np.pi))

    def render_once(pos, quat):
        """(F, H, W) float32 shading of the frames' poses (F, 3), (F, 4)."""
        R = _quat_to_rmat(quat)
        o = pos - (R.transpose(1, 2) @ (Rc.T @ t_cam))  # (F, 3)
        w2c = Rc @ R  # (F, 3, 3)
        d = d_cam @ w2c[:, None]  # (F, H, W, 3) world-frame ray directions
        ox, oy, oz = (o[:, i, None, None] for i in range(3))
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        F = pos.shape[0]
        t_hit = torch.full((F, height, width), float("inf"), **f32)
        shade = torch.full((F, height, width), 0.45, **f32)

        # the cylinder wall (the camera inside it)
        a = dx ** 2 + dy ** 2
        b = 2 * (ox * dx + oy * dy)
        c = ox ** 2 + oy ** 2 - wall_r2
        disc = b * b - 4 * a * c
        safe_a = torch.where(a > 1e-12, a, torch.ones_like(a))
        t_wall = (-b + torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * safe_a)
        hit_w = (disc > 0) & (a > 1e-12) & (t_wall > 1e-6)
        px, py, pz = ox + t_wall * dx, oy + t_wall * dy, oz + t_wall * dz
        sel = hit_w & (pz > scene.floor_z) & (pz < scene.ceil_z)
        ang = torch.atan2(py, px) / two_pi + 0.5
        tex_w = _value_noise(ang * float(np.float32(scene.wall_radius * 2 * np.pi / 4.0)),
                             (pz - scene.floor_z) / 4.0, octaves=5,
                             base_scale=scene.tex_scale_wall, seed=scene.seed)
        t_hit = torch.where(sel, t_wall, t_hit)
        shade = torch.where(sel, 0.15 + scene.contrast * tex_w, shade)

        # the floor and the ceiling
        for z_plane, s_off in ((scene.floor_z, 100), (scene.ceil_z, 200)):
            ok_dz = torch.abs(dz) > 1e-9
            tp = (float(np.float32(z_plane)) - oz) / torch.where(ok_dz, dz, torch.ones_like(dz))
            tp = torch.where(ok_dz & (tp > 1e-6), tp, torch.full_like(tp, 1e6))
            pxp, pyp = ox + tp * dx, oy + tp * dy
            inside = pxp ** 2 + pyp ** 2 < scene.wall_radius ** 2
            selp = (tp > 1e-6) & (tp < t_hit) & inside
            tex_p = _value_noise(pxp / 5.0 + 7.7, pyp / 5.0 + 3.3, octaves=4,
                                 base_scale=scene.tex_scale_floor, seed=scene.seed + s_off)
            t_hit = torch.where(selp, tp, t_hit)
            shade = torch.where(selp, 0.1 + scene.contrast * 0.8 * tex_p, shade)

        # the spherical occluders
        a2 = torch.einsum("fhwi,fhwi->fhw", d, d)
        for i in range(scene.n_occluders):
            cen = occ_centers[i]
            r_i = np.float32(occ_radii[i])
            oc = o - cen  # (F, 3)
            b2 = 2 * torch.einsum("fhwi,fi->fhw", d, oc)
            c2 = (torch.sum(oc * oc, dim=1) - float(r_i * r_i))[:, None, None]
            disc2 = b2 * b2 - 4 * a2 * c2
            ts = (-b2 - torch.sqrt(torch.clamp(disc2, min=0.0))) / (
                2 * torch.where(a2 > 1e-12, a2, torch.ones_like(a2)))
            sel2 = (disc2 > 0) & (ts > 1e-6) & (ts < t_hit)
            hx = ox + ts * dx - cen[0]
            hy = oy + ts * dy - cen[1]
            hz = oz + ts * dz - cen[2]
            su = torch.atan2(hy, hx) / two_pi + 0.5
            sv = hz / float(np.float32(max(float(occ_radii[i]), 1e-6))) * 0.5 + 0.5
            tex_s = _value_noise(su * 4.0, sv * 2.0, octaves=3, base_scale=3.0,
                                 seed=scene.seed + 300 + i)
            t_hit = torch.where(sel2, ts, t_hit)
            shade = torch.where(sel2, 0.2 + scene.contrast * 0.9 * tex_s, shade)

        att = 1.0 / (1.0 + 0.02 * torch.where(torch.isfinite(t_hit), t_hit,
                                              torch.full_like(t_hit, 10.0)))
        return torch.clamp(shade * att, 0.0, 1.0)

    @torch.no_grad()
    def render_sequence(seq, frame_indices=None, chunk: int = 32):
        """(F, H, W) float32 frames of a SyntheticSequence on the device;
        ``frame_indices`` index ``seq.frame_sample_idx`` (default: all)."""
        if frame_indices is None:
            frame_indices = np.arange(len(seq.frame_sample_idx))
        frame_indices = np.asarray(frame_indices)
        rng = np.random.RandomState(scene.seed + 4321)
        F_all = len(seq.frame_sample_idx)
        gains_all = 1.0 + exposure_jitter * rng.randn(F_all)
        biases_all = 0.04 * exposure_jitter * rng.randn(F_all)
        k_idx = seq.frame_sample_idx[frame_indices]
        kb = np.where(k_idx > 0, np.maximum(k_idx - 2, 0), k_idx)  # ~half an IMU step
        per_frame = (seq.pos[k_idx], seq.quat[k_idx], seq.pos[kb], seq.quat[kb],
                     gains_all[frame_indices], biases_all[frame_indices])
        per_frame = [torch.as_tensor(np.asarray(a, np.float32), **f32) for a in per_frame]
        seeds = torch.as_tensor(scene.seed * 1000 + frame_indices.astype(np.int64),
                                dtype=torch.int64, device=device) & _MASK
        keys = jr.prng_key(seeds)
        out = []
        with full_precision():
            for s in range(0, len(frame_indices), chunk):
                pos, quat, bpos, bquat, gain, bias = (a[s:s + chunk] for a in per_frame)
                img = render_once(pos, quat)
                if motion_blur:
                    img = 0.5 * (img + render_once(bpos, bquat))
                img = img * gain[:, None, None] + bias[:, None, None]
                if pixel_noise > 0:
                    noise = jr.normal(keys[s:s + chunk], (height, width), torch.float32)
                    img = img + float(np.float32(pixel_noise)) * noise
                out.append(torch.clamp(img, 0.0, 1.0))
        return out[0] if len(out) == 1 else torch.cat(out)

    return render_sequence
