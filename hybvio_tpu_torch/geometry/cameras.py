"""Camera models (port of the reference's ``geometry/cameras.py``): the
pinhole with radial k1-k3 distortion and a rectification rotation, and the
Kannala-Brandt (KB4) fisheye.

Intrinsics, coefficients and the rotation are Python floats: arithmetic
with them keeps the dtype of the pixel tensors, and a camera needs no
device. A per-frame lens (``with_intrinsics``, a zooming or autofocus
camera) carries fx, fy, cx, cy and the coefficients as 0-d tensors on the
device instead, which arithmetic treats as it treats the floats: a new lens
rebuilds, recompiles and syncs nothing. Iterative inversions (the pinhole
undistortion, the fisheye theta solve) run a fixed number of Newton steps,
with no data-dependent exit.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

PINHOLE = "pinhole"
FISHEYE = "fisheye"


@dataclasses.dataclass(frozen=True)
class Camera:
    # floats, or 0-d tensors (coeffs a (4,) tensor) on the device for a
    # per-frame lens
    fx: float
    fy: float
    cx: float
    cy: float
    width: int = -1
    height: int = -1
    kind: str = PINHOLE
    coeffs: tuple = (0.0, 0.0, 0.0, 0.0)  # pinhole k1..k3 (last unused), fisheye k1..k4
    max_valid_theta: float = math.pi / 2  # fisheye field-of-view cutoff (radians from the axis)
    max_valid_r: float = math.inf  # the distorted radius at max_valid_theta
    has_distortion: bool = False
    # rectification rotation, row-major 3x3: pixel_to_ray applies it to the
    # ray, ray_to_pixel its transpose
    rot: tuple = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
    has_rotation: bool = False

    @property
    def focal_length(self) -> float:
        return 0.5 * (self.fx + self.fy)


_EYE3 = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))


def build_pinhole(fx, fy, cx, cy, coeffs=(), width=-1, height=-1,
                  rotation=None) -> Camera:
    """Pinhole with up to three radial coefficients and an optional
    rectification rotation (3x3, anything numpy reads)."""
    coeffs = tuple(float(c) for c in coeffs)
    has_dist = len(coeffs) > 1 or (len(coeffs) == 1 and coeffs[0] != 0.0)
    c = (coeffs + (0.0,) * 4)[:4] if has_dist else (0.0, 0.0, 0.0, 0.0)
    rot, has_rot = _EYE3, False
    if rotation is not None:
        r = np.asarray(rotation, dtype=np.float64).reshape(3, 3)
        rot = tuple(tuple(float(v) for v in row) for row in r)
        has_rot = bool(np.linalg.norm(r - np.eye(3)) > 1e-8)
    return Camera(float(fx), float(fy), float(cx), float(cy), int(width), int(height),
                  coeffs=c, has_distortion=has_dist, rot=rot, has_rotation=has_rot)


def _poly_theta(theta, k):
    """KB4 distortion r(theta) = theta (1 + k1 t^2 + k2 t^4 + k3 t^6 + k4 t^8)."""
    t2 = theta * theta
    return theta * (1 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))


def build_fisheye(fx, fy, cx, cy, coeffs=(), max_valid_fov_deg=180.0,
                  width=-1, height=-1) -> Camera:
    coeffs = tuple(float(c) for c in coeffs)
    has_dist = len(coeffs) > 1
    if has_dist and len(coeffs) != 4:
        raise ValueError("the KB4 fisheye needs 4 coefficients")
    c = coeffs if has_dist else (0.0, 0.0, 0.0, 0.0)
    max_theta = 0.5 * max_valid_fov_deg * math.pi / 180.0
    return Camera(float(fx), float(fy), float(cx), float(cy), int(width), int(height),
                  kind=FISHEYE, coeffs=c, max_valid_theta=max_theta,
                  max_valid_r=_poly_theta(max_theta, c) if has_dist else max_theta,
                  has_distortion=has_dist)


def with_intrinsics(cam: Camera, fx, fy=None, cx=None, cy=None, coeffs=None,
                    dtype=torch.float64, device=None) -> Camera:
    """The same camera model with this frame's intrinsics (port of the
    reference's ``with_intrinsics``; reference addFrameMonoVarying,
    src/api/internal.hpp:216-230): fx, fy, cx, cy become 0-d tensors and,
    where ``cam`` has distortion, the coefficients a (4,) tensor; the kind,
    the flags, the rotation and the size stay. ``fy`` defaults to ``fx``,
    ``cx`` / ``cy`` to ``cam``'s; coefficients are ignored on a camera built
    without distortion. A tensor argument stays on its device (cast to
    ``dtype``); a number is made a tensor on ``device``, by default that of
    the tensor arguments, else the card."""
    given = [v for v in (fx, fy, cx, cy, coeffs) if isinstance(v, torch.Tensor)]
    if device is None:
        device = given[0].device if given else None
    if device is None:
        from ..runtime import default_device

        device = default_device()

    def a(v):
        if isinstance(v, torch.Tensor):
            return v.to(dtype)
        return torch.as_tensor(v, dtype=dtype, device=device)

    new = dict(fx=a(fx), fy=a(fy if fy is not None else fx),
               cx=a(cx if cx is not None else cam.cx), cy=a(cy if cy is not None else cam.cy))
    if coeffs is not None and cam.has_distortion:
        if not isinstance(coeffs, torch.Tensor):
            coeffs = (tuple(float(c) for c in coeffs) + (0.0,) * 4)[:4]
        new["coeffs"] = a(coeffs)
    return dataclasses.replace(cam, **new)


def build_camera_from_params(pt, width: int, height: int,
                             second: bool = False) -> Camera:
    """From ParametersTracker with the reference's automatic fallbacks."""
    if not second:
        fx = pt.focalLengthX if pt.focalLengthX > 0 else pt.focalLength
        fy = pt.focalLengthY if pt.focalLengthY > 0 else pt.focalLength
        cx, cy = pt.principalPointX, pt.principalPointY
        coeffs = pt.distortionCoeffs
    else:
        fx = pt.secondFocalLengthX if pt.secondFocalLengthX > 0 else (
            pt.secondFocalLength if pt.secondFocalLength > 0 else (
                pt.focalLengthX if pt.focalLengthX > 0 else pt.focalLength))
        fy = pt.secondFocalLengthY if pt.secondFocalLengthY > 0 else (
            pt.secondFocalLength if pt.secondFocalLength > 0 else (
                pt.focalLengthY if pt.focalLengthY > 0 else pt.focalLength))
        cx = pt.secondPrincipalPointX if pt.secondPrincipalPointX > 0 else pt.principalPointX
        cy = pt.secondPrincipalPointY if pt.secondPrincipalPointY > 0 else pt.principalPointY
        coeffs = (pt.secondDistortionCoeffs if len(pt.secondDistortionCoeffs) > 1
                  else pt.distortionCoeffs)
    if cx < 0:
        cx = 0.5 * width
    if cy < 0:
        cy = 0.5 * height
    if len(coeffs) == 1 and coeffs[0] == 0.0:
        coeffs = ()
    if pt.fisheyeCamera:
        return build_fisheye(fx, fy, cx, cy, coeffs, pt.validCameraFov, width, height)
    return build_pinhole(fx, fy, cx, cy, coeffs, width, height)


def _pinhole_distort(cam: Camera, x, y):
    """OpenCV radial model with k1, k2, k3 of normalized coordinates."""
    k = cam.coeffs
    r2 = x * x + y * y
    theta = 1 + r2 * (k[0] + r2 * (k[1] + r2 * k[2]))
    return x * theta, y * theta


def _pinhole_undistort(cam: Camera, px, py, iters: int = 20):
    """Newton inversion of the radial distortion from the distorted point,
    with the analytic 2x2 Jacobian, a fixed ``iters`` steps."""
    k = cam.coeffs
    x, y = px, py
    for _ in range(iters):
        r2 = x * x + y * y
        theta = 1 + r2 * (k[0] + r2 * (k[1] + r2 * k[2]))
        dtheta = k[0] + r2 * (2 * k[1] + 3 * r2 * k[2])  # d theta / d r^2
        a = theta + 2 * x * x * dtheta
        b = 2 * x * y * dtheta
        c = 2 * y * x * dtheta
        d = theta + 2 * y * y * dtheta
        det = a * d - b * c
        rx = px - x * theta
        ry = py - y * theta
        x, y = x + (d * rx - b * ry) / det, y + (-c * rx + a * ry) / det
    return x, y


def _rotate(rot, ray, transpose: bool = False):
    """rot @ ray (or rot^T @ ray) of rays (..., 3), with the rotation's
    entries as Python floats."""
    comps = [ray[..., j] for j in range(3)]
    out = []
    for i in range(3):
        row = [rot[j][i] for j in range(3)] if transpose else rot[i]
        out.append(row[0] * comps[0] + row[1] * comps[1] + row[2] * comps[2])
    return torch.stack(out, dim=-1)


def _fisheye_undistort_theta(cam: Camera, r, iters: int = 12):
    """Newton solve of r = distort(theta) from min(r, 1.5 max_valid_theta),
    clamped at 0, a fixed number of steps."""
    k = cam.coeffs
    theta = torch.clamp(r, max=cam.max_valid_theta * 1.5)
    for _ in range(iters):
        t2 = theta * theta
        f = _poly_theta(theta, k) - r
        df = 1 + 3 * t2 * (k[0] + 5.0 / 3 * t2 * (k[1] + 7.0 / 5 * t2 * (k[2] + 9.0 / 7 * t2 * k[3])))
        theta = torch.clamp(theta - f / df, min=0.0)
    return theta


def pixel_to_ray(cam: Camera, pixel):
    """Unit ray for pixel (..., 2); returns (ray (..., 3), valid)."""
    x = (pixel[..., 0] - cam.cx) / cam.fx
    y = (pixel[..., 1] - cam.cy) / cam.fy
    if cam.kind == PINHOLE:
        if cam.has_distortion:
            x, y = _pinhole_undistort(cam, x, y)
        ray = torch.stack([x, y, torch.ones_like(x)], dim=-1)
        ray = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
        if cam.has_rotation:
            ray = _rotate(cam.rot, ray)
        return ray, torch.ones(pixel.shape[:-1], dtype=torch.bool, device=pixel.device)
    uv = torch.stack([x, y], dim=-1)
    r = torch.linalg.norm(uv, dim=-1)
    big = r > 1e-12
    dir_xy = uv / torch.where(big, r, torch.ones_like(r))[..., None]
    valid = r <= cam.max_valid_r
    rc = torch.clamp(r, max=cam.max_valid_r)
    theta = _fisheye_undistort_theta(cam, rc) if cam.has_distortion else rc
    theta = torch.where(big, theta, torch.zeros_like(theta))
    theta = torch.where(valid, theta, torch.full_like(theta, cam.max_valid_theta))
    ray = torch.cat([torch.sin(theta)[..., None] * dir_xy, torch.cos(theta)[..., None]], dim=-1)
    return ray, valid


def ray_to_pixel(cam: Camera, ray):
    """Project rays (..., 3); returns (pixel (..., 2), valid)."""
    if cam.kind == PINHOLE:
        if cam.has_rotation:
            ray = _rotate(cam.rot, ray, transpose=True)
        z = ray[..., 2]
        valid = z > 0
        iz = 1.0 / torch.where(valid, z, torch.ones_like(z))
        x, y = ray[..., 0] * iz, ray[..., 1] * iz
        if cam.has_distortion:
            x, y = _pinhole_distort(cam, x, y)
        return torch.stack([x * cam.fx + cam.cx, y * cam.fy + cam.cy], dim=-1), valid
    z = ray[..., 2]
    nrm = torch.linalg.norm(ray, dim=-1)
    cos_t = torch.clamp(z / torch.where(nrm > 0, nrm, torch.ones_like(nrm)), -1.0, 1.0)
    theta = torch.arccos(cos_t)
    valid = (z > 0) & (theta <= cam.max_valid_theta)
    r = _poly_theta(theta, cam.coeffs) if cam.has_distortion else theta
    rxy = torch.linalg.norm(ray[..., :2], dim=-1)
    uv = r[..., None] * (ray[..., :2] / torch.where(rxy > 1e-12, rxy, torch.ones_like(rxy))[..., None])
    px = uv[..., 0] * cam.fx + cam.cx
    py = uv[..., 1] * cam.fy + cam.cy
    return torch.stack([px, py], dim=-1), valid


def normalize_pixel(cam: Camera, pixel):
    """Pixel -> normalized coordinates ray.xy / ray.z; returns (norm, valid)."""
    ray, valid = pixel_to_ray(cam, pixel)
    z = ray[..., 2]
    ok = valid & (z > 0)
    zz = torch.where(ok, z, torch.ones_like(z))
    return ray[..., :2] / zz[..., None], ok


def ray_to_pixel_jacobian(cam: Camera, ray):
    """(pixel, valid, d pixel / d ray (..., 2, 3)) of rays (..., 3), the
    Jacobian by reverse mode (``torch.func.jacrev``), through the
    distortion and the rotation."""
    flat = ray.reshape(-1, 3)
    J = torch.func.vmap(torch.func.jacrev(lambda r: ray_to_pixel(cam, r)[0]))(flat)
    pix, valid = ray_to_pixel(cam, ray)
    return pix, valid, J.reshape(ray.shape[:-1] + (2, 3))


def is_valid_pixel(cam: Camera, pixel):
    if cam.kind == FISHEYE:
        return pixel_to_ray(cam, pixel)[1]
    if cam.width < 0:
        return torch.ones(pixel.shape[:-1], dtype=torch.bool, device=pixel.device)
    x = torch.round(pixel[..., 0])
    y = torch.round(pixel[..., 1])
    return (x >= 0) & (x < cam.width) & (y >= 0) & (y < cam.height)
