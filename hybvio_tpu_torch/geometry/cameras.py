"""Pinhole camera model (port of the reference's ``geometry/cameras.py``,
pinhole branch without distortion or rectification rotation).

Intrinsics are Python floats: arithmetic with them keeps the dtype of the
pixel tensors, and a camera needs no device. Other models raise
``NotImplementedError`` when built.
"""
from __future__ import annotations

import dataclasses

import torch

PINHOLE = "pinhole"


@dataclasses.dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int = -1
    height: int = -1
    kind: str = PINHOLE

    @property
    def focal_length(self) -> float:
        return 0.5 * (self.fx + self.fy)


def build_pinhole(fx, fy, cx, cy, coeffs=(), width=-1, height=-1,
                  rotation=None) -> Camera:
    coeffs = tuple(coeffs)
    if len(coeffs) > 1 or (len(coeffs) == 1 and coeffs[0] != 0.0):
        raise NotImplementedError("pinhole lens distortion")
    if rotation is not None:
        raise NotImplementedError("rectification rotation")
    return Camera(float(fx), float(fy), float(cx), float(cy),
                  int(width), int(height))


def build_camera_from_params(pt, width: int, height: int,
                             second: bool = False) -> Camera:
    """From ParametersTracker with the reference's automatic fallbacks."""
    if pt.fisheyeCamera:
        raise NotImplementedError("fisheye camera")
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
    return build_pinhole(fx, fy, cx, cy, coeffs, width, height)


def pixel_to_ray(cam: Camera, pixel):
    """Unit ray for pixel (..., 2); returns (ray (..., 3), valid)."""
    x = (pixel[..., 0] - cam.cx) / cam.fx
    y = (pixel[..., 1] - cam.cy) / cam.fy
    ray = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    ray = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
    return ray, torch.ones(pixel.shape[:-1], dtype=torch.bool, device=pixel.device)


def ray_to_pixel(cam: Camera, ray):
    """Project rays (..., 3); returns (pixel (..., 2), valid)."""
    z = ray[..., 2]
    valid = z > 0
    iz = 1.0 / torch.where(valid, z, torch.ones_like(z))
    px = ray[..., 0] * iz * cam.fx + cam.cx
    py = ray[..., 1] * iz * cam.fy + cam.cy
    return torch.stack([px, py], dim=-1), valid


def normalize_pixel(cam: Camera, pixel):
    """Pixel -> normalized coordinates ray.xy / ray.z; returns (norm, valid)."""
    ray, valid = pixel_to_ray(cam, pixel)
    z = ray[..., 2]
    ok = valid & (z > 0)
    zz = torch.where(ok, z, torch.ones_like(z))
    return ray[..., :2] / zz[..., None], ok


def is_valid_pixel(cam: Camera, pixel):
    if cam.width < 0:
        return torch.ones(pixel.shape[:-1], dtype=torch.bool, device=pixel.device)
    x = torch.round(pixel[..., 0])
    y = torch.round(pixel[..., 1])
    return (x >= 0) & (x < cam.width) & (y >= 0) & (y < cam.height)
