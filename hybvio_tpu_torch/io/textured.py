"""Textured synthetic scenes rendered on the host (the port's own numpy copy
of the reference's ``io/textured.py``; it imports nothing of the reference).

The Gaussian-blob world (``io/synthetic.py``) exercises the pipeline but
not the front-end's failure modes: LK on texture, corner selection among
clutter, occlusion, exposure change, motion blur. This procedural world is
the in-repo stand-in for real imagery, rendered by per-pixel ray casting:

  * a cylinder wall, a floor and a ceiling, each with multi-octave value
    noise (a deterministic integer-lattice hash, no stored assets);
  * spherical occluders between the trajectory and the wall (parallax and
    occlusion edges: tracks die and revive as in real scenes);
  * per-frame exposure gain and bias jitter, additive pixel noise;
  * an optional 2-tap motion blur (the average with a sub-frame pose).

Vectorized numpy over the pixel grid in float64; the same inputs give the
same bits as the reference's renderer. ``io/textured_device.py`` renders
the same world on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .synthetic import _np_quat_to_rmat


# ------------------------------------------------------------ value noise

def _hash01(ix: np.ndarray, iy: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic lattice hash -> [0,1) floats (vectorized)."""
    h = (ix.astype(np.int64) * 374761393 + iy.astype(np.int64) * 668265263
         + np.int64(seed) * 2147483647)
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return ((h & 0xFFFFFF).astype(np.float64)) / float(0x1000000)


def value_noise(u: np.ndarray, v: np.ndarray, octaves: int = 4,
                base_scale: float = 1.0, seed: int = 0) -> np.ndarray:
    """Multi-octave value noise sampled at float coords (u, v) in [0,1]."""
    out = np.zeros_like(u, dtype=np.float64)
    amp = 1.0
    total = 0.0
    for o in range(octaves):
        s = base_scale * (2.0 ** o)
        x = u * s
        y = v * s
        ix = np.floor(x)
        iy = np.floor(y)
        fx = x - ix
        fy = y - iy
        # smootherstep weights
        wx = fx * fx * (3.0 - 2.0 * fx)
        wy = fy * fy * (3.0 - 2.0 * fy)
        n00 = _hash01(ix, iy, seed + o)
        n10 = _hash01(ix + 1, iy, seed + o)
        n01 = _hash01(ix, iy + 1, seed + o)
        n11 = _hash01(ix + 1, iy + 1, seed + o)
        val = (n00 * (1 - wx) * (1 - wy) + n10 * wx * (1 - wy)
               + n01 * (1 - wx) * wy + n11 * wx * wy)
        out += amp * val
        total += amp
        amp *= 0.55
    return out / total


# ---------------------------------------------------------------- scene

@dataclasses.dataclass
class TexturedScene:
    """World: texture-mapped cylinder (axis = world z) + floor + ceiling +
    spherical occluders."""
    wall_radius: float = 6.0
    floor_z: float = -2.0
    ceil_z: float = 2.5
    tex_scale_wall: float = 5.0
    tex_scale_floor: float = 3.0
    contrast: float = 0.85
    seed: int = 0
    n_occluders: int = 6
    occluder_radius: Tuple[float, float] = (0.35, 0.8)
    occluder_ring: Tuple[float, float] = (3.2, 4.8)  # radial band

    def __post_init__(self):
        rng = np.random.RandomState(self.seed + 91)
        ang = rng.rand(self.n_occluders) * 2 * np.pi
        rad = rng.uniform(*self.occluder_ring, self.n_occluders)
        z = rng.uniform(self.floor_z + 0.8, self.ceil_z - 0.8, self.n_occluders)
        self.occ_centers = np.stack(
            [rad * np.cos(ang), rad * np.sin(ang), z], axis=1)
        self.occ_radii = rng.uniform(*self.occluder_radius, self.n_occluders)


def _camera_rays(quat, imu_to_camera, fx, fy, cx, cy, width, height,
                 fisheye_coeffs=None):
    """World-frame ray directions for every pixel (H, W, 3). With
    fisheye_coeffs (KB4 k1..k4) the pixel grid unprojects through the
    equidistant model r = theta + k1 th^3 + k2 th^5 + k3 th^7 + k4 th^9
    (same model geometry/cameras.py build_fisheye uses), so the render IS
    the distorted fisheye image."""
    yy, xx = np.mgrid[0:height, 0:width]
    u = (xx - cx) / fx
    v = (yy - cy) / fy
    if fisheye_coeffs is None:
        d = np.stack([u, v, np.ones_like(u, np.float64)], axis=-1)
    else:
        k1, k2, k3, k4 = fisheye_coeffs
        r = np.sqrt(u * u + v * v)
        theta = r.copy()  # Newton inversion of the odd polynomial
        for _ in range(8):
            t2 = theta * theta
            f = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - r
            fp = 1 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
            theta = theta - f / np.maximum(fp, 1e-9)
        safe_r = np.where(r > 1e-12, r, 1.0)
        s_t = np.sin(theta)
        d = np.stack([s_t * u / safe_r, s_t * v / safe_r, np.cos(theta)],
                     axis=-1)
        d = np.where(r[..., None] > 1e-12,
                     d, np.stack([0 * u, 0 * v, np.ones_like(u)], -1))
    R = _np_quat_to_rmat(np.asarray(quat))
    w2c = imu_to_camera[:3, :3] @ R  # world -> camera rotation
    return d @ w2c  # rows: d_world = w2c^T @ d_cam

def _render_once(scene: TexturedScene, pos, quat, imu_to_camera,
                 fx, fy, cx, cy, width, height,
                 fisheye_coeffs=None) -> np.ndarray:
    o = np.asarray(pos, np.float64)
    # camera center in world = imu position corrected by cam offset; the
    # synthetic rig has the camera at the imu origin (SYNTH_IMU_TO_CAMERA has
    # zero translation), so o is the camera center
    t_cam = imu_to_camera[:3, 3]
    if np.any(t_cam != 0):
        R = _np_quat_to_rmat(np.asarray(quat))
        o = o - R.T @ (imu_to_camera[:3, :3].T @ t_cam)
    d = _camera_rays(quat, imu_to_camera, fx, fy, cx, cy, width, height,
                     fisheye_coeffs=fisheye_coeffs)

    H, W = d.shape[:2]
    t_hit = np.full((H, W), np.inf)
    shade = np.full((H, W), 0.45)

    # --- cylinder wall: (ox+t dx)^2 + (oy+t dy)^2 = R^2, camera inside ---
    a = d[..., 0] ** 2 + d[..., 1] ** 2
    b = 2 * (o[0] * d[..., 0] + o[1] * d[..., 1])
    c = o[0] ** 2 + o[1] ** 2 - scene.wall_radius ** 2
    disc = b * b - 4 * a * c
    safe_a = np.where(a > 1e-12, a, 1.0)
    t_wall = (-b + np.sqrt(np.maximum(disc, 0.0))) / (2 * safe_a)
    hit_w = (disc > 0) & (a > 1e-12) & (t_wall > 1e-6)
    px = o[0] + t_wall * d[..., 0]
    py = o[1] + t_wall * d[..., 1]
    pz = o[2] + t_wall * d[..., 2]
    in_band = (pz > scene.floor_z) & (pz < scene.ceil_z)
    sel = hit_w & in_band
    ang = np.arctan2(py, px) / (2 * np.pi) + 0.5
    tex_w = value_noise(ang * scene.wall_radius * 2 * np.pi / 4.0,
                        (pz - scene.floor_z) / 4.0,
                        octaves=5, base_scale=scene.tex_scale_wall,
                        seed=scene.seed)
    t_hit = np.where(sel, t_wall, t_hit)
    shade = np.where(sel, 0.15 + scene.contrast * tex_w, shade)

    # --- floor and ceiling planes ---
    for z_plane, s_off in ((scene.floor_z, 100), (scene.ceil_z, 200)):
        dz = d[..., 2]
        ok_dz = np.abs(dz) > 1e-9
        tp = (z_plane - o[2]) / np.where(ok_dz, dz, 1.0)
        tp = np.where(ok_dz & (tp > 1e-6), tp, 1e6)  # finite sentinel: never selected
        pxp = o[0] + tp * d[..., 0]
        pyp = o[1] + tp * d[..., 1]
        inside = pxp ** 2 + pyp ** 2 < scene.wall_radius ** 2
        selp = (tp > 1e-6) & (tp < t_hit) & inside
        tex_p = value_noise(pxp / 5.0 + 7.7, pyp / 5.0 + 3.3, octaves=4,
                            base_scale=scene.tex_scale_floor,
                            seed=scene.seed + s_off)
        t_hit = np.where(selp, tp, t_hit)
        shade = np.where(selp, 0.1 + scene.contrast * 0.8 * tex_p, shade)

    # --- spherical occluders ---
    for i in range(scene.n_occluders):
        cen = scene.occ_centers[i]
        r = scene.occ_radii[i]
        oc = o - cen
        b2 = 2 * np.einsum("hwi,i->hw", d, oc)
        a2 = np.einsum("hwi,hwi->hw", d, d)
        c2 = oc @ oc - r * r
        disc2 = b2 * b2 - 4 * a2 * c2
        ts = (-b2 - np.sqrt(np.maximum(disc2, 0.0))) / (2 * np.where(a2 > 1e-12, a2, 1.0))
        sel2 = (disc2 > 0) & (ts > 1e-6) & (ts < t_hit)
        # texture on the sphere via hit-point angles
        hx = o[0] + ts * d[..., 0] - cen[0]
        hy = o[1] + ts * d[..., 1] - cen[1]
        hz = o[2] + ts * d[..., 2] - cen[2]
        su = np.arctan2(hy, hx) / (2 * np.pi) + 0.5
        sv = hz / max(r, 1e-6) * 0.5 + 0.5
        tex_s = value_noise(su * 4.0, sv * 2.0, octaves=3, base_scale=3.0,
                            seed=scene.seed + 300 + i)
        t_hit = np.where(sel2, ts, t_hit)
        shade = np.where(sel2, 0.2 + scene.contrast * 0.9 * tex_s, shade)

    # distance attenuation (mild) for depth cues
    att = 1.0 / (1.0 + 0.02 * np.where(np.isfinite(t_hit), t_hit, 10.0))
    return np.clip(shade * att, 0.0, 1.0).astype(np.float32)


def render_textured_view(scene: TexturedScene, pos, quat, imu_to_camera,
                         fx, fy, cx, cy, width, height,
                         exposure_gain: float = 1.0,
                         exposure_bias: float = 0.0,
                         pixel_noise: float = 0.0,
                         blur_pose: Optional[Tuple] = None,
                         noise_seed: int = 0,
                         fisheye_coeffs=None) -> np.ndarray:
    """Render one gray frame; blur_pose=(pos2, quat2) enables a 2-tap motion
    blur (average with the sub-frame pose)."""
    img = _render_once(scene, pos, quat, imu_to_camera, fx, fy, cx, cy,
                       width, height, fisheye_coeffs=fisheye_coeffs)
    if blur_pose is not None:
        img2 = _render_once(scene, blur_pose[0], blur_pose[1], imu_to_camera,
                            fx, fy, cx, cy, width, height,
                            fisheye_coeffs=fisheye_coeffs)
        img = 0.5 * (img + img2)
    img = img * exposure_gain + exposure_bias
    if pixel_noise > 0:
        rng = np.random.RandomState(noise_seed)
        img = img + pixel_noise * rng.randn(height, width).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def textured_frame_renderer(scene: TexturedScene, seq, imu_to_camera,
                            fx, fy, cx, cy, width, height,
                            exposure_jitter: float = 0.0,
                            pixel_noise: float = 0.0,
                            motion_blur: bool = False,
                            fisheye_coeffs=None):
    """render(fi) -> float32 (H, W) frame for sequence frame fi, with
    deterministic per-frame exposure jitter / noise / blur."""
    rng = np.random.RandomState(scene.seed + 4321)
    F = len(seq.frame_sample_idx)
    gains = 1.0 + exposure_jitter * rng.randn(F)
    biases = 0.04 * exposure_jitter * rng.randn(F)

    def render(fi: int) -> np.ndarray:
        k = int(seq.frame_sample_idx[fi])
        blur = None
        if motion_blur and k > 0:
            kb = max(k - 2, 0)  # ~half an IMU-step exposure window
            blur = (seq.pos[kb], seq.quat[kb])
        return render_textured_view(
            scene, seq.pos[k], seq.quat[k], imu_to_camera, fx, fy, cx, cy,
            width, height, exposure_gain=float(gains[fi]),
            exposure_bias=float(biases[fi]), pixel_noise=pixel_noise,
            blur_pose=blur, noise_seed=scene.seed * 1000 + fi,
            fisheye_coeffs=fisheye_coeffs)

    return render
