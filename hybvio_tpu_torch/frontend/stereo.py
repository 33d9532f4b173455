"""Stereo epipolar-curve check (port of the reference's
``frontend/stereo.py``): each left point's ray is projected into the right
camera at depths 0.5 * 2^j (j = 0..7) and the right match must lie within
``max_dist_px`` of that polyline."""
from __future__ import annotations

import torch

from ..geometry.cameras import pixel_to_ray, ray_to_pixel
from ..geometry.poses import transform_vec3
from ..runtime import constant

CURVE_POINTS = 8


def epipolar_curves(cam0, cam1, pts0, cam0_to_cam1):
    """(curves (..., 8, 2), curve_valid (..., 8)) of points (..., 2)."""
    ray0, ok0 = pixel_to_ray(cam0, pts0)
    scales = 0.5 * 2.0 ** torch.arange(CURVE_POINTS, dtype=pts0.dtype, device=pts0.device)
    r1 = transform_vec3(cam0_to_cam1, ray0[..., None, :] * scales[:, None])
    pix, ok = ray_to_pixel(cam1, r1)
    return pix, ok & ok0[..., None]


def within_curve_distance(point, curve, curve_valid, d2):
    """Distance of ``point`` (..., 2) to the polyline ``curve`` (..., 8, 2)
    below sqrt(d2): vertex distances and in-segment projections."""
    dv = torch.sum((curve - point[..., None, :]) ** 2, dim=-1)
    near_vertex = torch.any(curve_valid & (dv < d2), dim=-1)
    c0 = curve[..., :-1, :]
    seg = curve[..., 1:, :] - c0
    seg_ok = curve_valid[..., :-1] & curve_valid[..., 1:]
    s2 = torch.sum(seg * seg, dim=-1)
    t = torch.sum((point[..., None, :] - c0) * seg, dim=-1) / torch.clamp(s2, min=1e-12)
    proj = c0 + t[..., None] * seg
    dp = torch.sum((point[..., None, :] - proj) ** 2, dim=-1)
    near_seg = torch.any(seg_ok & (t > 0) & (t < 1) & (dp < d2), dim=-1)
    return near_vertex | near_seg


def epipolar_check(cam0, cam1, pts0, pts1, valid, cam0_to_cam1, max_dist_px):
    """(...,) bool: right points consistent with the left points' curves."""
    curves, curve_valid = epipolar_curves(cam0, cam1, pts0, cam0_to_cam1)
    dist = constant(max_dist_px, pts0.dtype, pts0.device)
    ok = within_curve_distance(pts1, curves, curve_valid, dist * dist)
    return valid & ok
