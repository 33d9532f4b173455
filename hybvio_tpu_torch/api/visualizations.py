"""Visualization adapters: video overlays, pose plot, covariance heatmap
(port of the reference package's ``api/visualizations.py``).

Port of the reference visualization surface (reference: src/api/
visualizations.cpp, src/views/api_visualization_helpers.cpp,
visualization_pose.cpp, visualization_internals.cpp) as dependency-free numpy
raster drawing: track trails/corners on video frames, a 2D trajectory plot
comparing methods, and covariance magnitude/correlation heatmaps straight
from the EKF covariance.

Images may be numpy arrays or tensors on any device. The three views that
compute rather than draw run the port's own modules on the image's device:
the corner measure the Shi-Tomasi response (``ops.gftt.corner_response``,
the CUDA kernel on the card), the disparity and depth views the SAD
disparity (``frontend/disparity.py``), the epipolar curves the cameras
(``geometry/cameras.py``, in float64 on the host). Every raster comes back
as float32 RGB numpy.
"""
from __future__ import annotations

from enum import IntEnum
from typing import Dict, Optional, Tuple

import numpy as np
import torch


class VisualizationMode(IntEnum):
    """Video visualization modes (reference: api::InternalAPI::
    VisualizationMode, src/api/internal.hpp:66-81 — same names and values;
    9 is unused there too). PROCESSED_VIDEO differs from PLAIN_VIDEO only in
    output timing (delayed until the odometry processed the frame), which in
    this API is the caller's choice of tap; the raster is the same."""
    NONE = 0
    PLAIN_VIDEO = 1
    TRACKER_ONLY = 2
    TRACKS = 3
    DEBUG_VISUALIZATION = 4
    PROCESSED_VIDEO = 5
    OPTICAL_FLOW = 6
    OPTICAL_FLOW_FAILURES = 7
    TRACKS_ALL = 8
    CORNER_MEASURE = 10
    STEREO_MATCHING = 11
    STEREO_EPIPOLAR = 12
    STEREO_DISPARITY = 13
    STEREO_DEPTH = 14

# simple color palette (RGB float)
COLORS = {
    "track": (0.1, 1.0, 0.2),
    "corner": (1.0, 0.9, 0.1),
    "outlier": (1.0, 0.2, 0.2),
    "slam": (0.3, 0.5, 1.0),
    "our": (0.1, 1.0, 0.2),
    "groundTruth": (1.0, 1.0, 1.0),
    "ARKit": (1.0, 0.5, 0.1),
    "gps": (0.9, 0.2, 0.9),
}


def _host(a) -> np.ndarray:
    """A numpy array of an array or of a tensor on any device."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _tensor(a, device=None) -> torch.Tensor:
    """A float32 tensor of an image (numpy or tensor), on ``device`` if given,
    else where it is (numpy: the CPU); rows contiguous."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.array(a, np.float32))
    t = t.to(torch.float32)
    return (t if device is None else t.to(device)).contiguous()


def to_rgb(gray) -> np.ndarray:
    g = np.clip(_host(gray).astype(np.float32), 0, 1)
    return np.repeat(g[..., None], 3, axis=-1)


def draw_circle(img: np.ndarray, x: float, y: float, r: int, color, filled=False):
    H, W = img.shape[:2]
    x0, x1 = int(max(x - r, 0)), int(min(x + r + 1, W))
    y0, y1 = int(max(y - r, 0)), int(min(y + r + 1, H))
    if x1 <= x0 or y1 <= y0:
        return
    ys, xs = np.mgrid[y0:y1, x0:x1]
    d2 = (xs - x) ** 2 + (ys - y) ** 2
    mask = d2 <= r * r if filled else (d2 <= r * r) & (d2 >= (r - 1.5) ** 2)
    img[y0:y1, x0:x1][mask] = color


def draw_line(img: np.ndarray, x0, y0, x1, y1, color):
    H, W = img.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) + 1
    xs = np.linspace(x0, x1, n).round().astype(int)
    ys = np.linspace(y0, y1, n).round().astype(int)
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    img[ys[ok], xs[ok]] = color


# per-status flow/corner colors (reference draws Feature::Status-dependent
# colors in api_visualization_helpers.cpp; codes = frontend.tracker.ST_*)
STATUS_COLORS = {
    0: (0.1, 1.0, 0.2),   # TRACKED — green
    1: (1.0, 0.9, 0.1),   # NEW — yellow
    2: (0.5, 0.5, 0.5),   # FAILED_FLOW — gray
    3: (1.0, 0.2, 0.2),   # RANSAC_OUTLIER — red
    4: (0.4, 0.4, 0.4),   # FLOW_OUT_OF_RANGE — dark gray
    5: (0.4, 0.4, 0.4),   # OUT_OF_RANGE
    6: (1.0, 0.2, 1.0),   # FAILED_EPIPOLAR_CHECK — magenta
    7: (1.0, 0.6, 0.1),   # CULLED — orange
    8: (0.7, 0.1, 0.1),   # BLACKLISTED — dark red
}


def render_video_overlay(gray, track_pixels, track_valid, track_trails=None,
                         outlier_mask=None, slam_points_px=None,
                         flow_prev=None, track_status=None,
                         stereo_pixels=None) -> np.ndarray:
    """VIDEO visualization: corners + track trails (+ SLAM reprojections)
    (reference: api_visualization_helpers.cpp). With flow_prev/track_status
    (the TaggedFrame flowCorners/flowStatus payload,
    odometry/tagged_frame.hpp:48-58) every slot draws its attempted flow
    vector colored by lifecycle status; stereo_pixels adds the left->right
    match segments (epipolar visualization stand-in)."""
    img = to_rgb(gray)
    px = np.asarray(track_pixels)
    valid = np.asarray(track_valid)
    out = np.asarray(outlier_mask) if outlier_mask is not None else np.zeros_like(valid)
    if track_trails is not None:
        for trail in track_trails:
            t = np.asarray(trail)
            for i in range(len(t) - 1):
                draw_line(img, t[i, 0], t[i, 1], t[i + 1, 0], t[i + 1, 1], COLORS["track"])
    status = None if track_status is None else np.asarray(track_status)
    if flow_prev is not None and status is not None:
        prev = np.asarray(flow_prev)
        for i in np.where(status >= 0)[0]:
            c = STATUS_COLORS.get(int(status[i]), COLORS["corner"])
            if status[i] != 1:  # NEW has no flow history
                draw_line(img, prev[i, 0], prev[i, 1], px[i, 0], px[i, 1], c)
    if stereo_pixels is not None and status is not None:
        sp = np.asarray(stereo_pixels)
        for i in np.where(status == 0)[0]:
            draw_line(img, px[i, 0], px[i, 1], sp[i, 0], sp[i, 1], COLORS["slam"])
    for i in np.where(valid)[0]:
        if status is not None:
            c = STATUS_COLORS.get(int(status[i]), COLORS["corner"])
        else:
            c = COLORS["outlier"] if out[i] else COLORS["corner"]
        draw_circle(img, px[i, 0], px[i, 1], 3, c)
    if slam_points_px is not None:
        for p in np.asarray(slam_points_px):
            if p[0] >= 0:
                draw_circle(img, p[0], p[1], 2, COLORS["slam"], filled=True)
    return img


def _heat_colormap(v: np.ndarray) -> np.ndarray:
    """Map values in [0,1] to a blue->green->red heat ramp (float RGB)."""
    v = np.clip(np.asarray(v, np.float32), 0.0, 1.0)
    r = np.clip(2.0 * v - 1.0, 0, 1)
    g = 1.0 - np.abs(2.0 * v - 1.0)
    b = np.clip(1.0 - 2.0 * v, 0, 1)
    return np.stack([r, g, b], axis=-1)


def render_corner_measure(gray, block_size: int = 3) -> np.ndarray:
    """CORNER_MEASURE visualization: per-pixel Shi-Tomasi min-eigenvalue
    response heatmap (reference: -displayCornerMeasure,
    cmd_parameter_definitions.json 'show tracker corner measure for each
    pixel'; drawn by api_visualization_helpers.cpp via the tracker's GFTT
    response). Uses the SAME response kernel the detector runs, on the
    image's device (the CUDA kernel for an image on the card)."""
    from ..ops.gftt import corner_response

    resp = _host(corner_response(_tensor(gray), block_size=block_size))
    hi = float(np.percentile(resp, 99.5))
    v = resp / max(hi, 1e-12)
    # blend heat over dim video so structure stays visible
    return 0.35 * to_rgb(gray) + 0.65 * _heat_colormap(v)


def render_stereo_disparity(left, right, max_disparity: Optional[int] = None,
                            Q: Optional[np.ndarray] = None,
                            depth: bool = False) -> np.ndarray:
    """STEREO_DISPARITY / STEREO_DEPTH visualization (reference:
    -displayStereoDisparity / -displayStereoDepth, computed with OpenCV
    there; here with the SAD block-matching path the pipeline's depth
    attach uses, frontend/disparity.py, on the left image's device).
    depth=True requires Q and renders inverse depth (near = hot)."""
    from ..frontend.disparity import (
        compute_disparity, default_max_disparity, disparity_to_depth)
    from ..runtime import full_precision

    left = _tensor(left)
    right = _tensor(right, left.device)
    md = max_disparity or default_max_disparity(left.shape[1])
    with full_precision():
        disp_t, valid_t = compute_disparity(left, right, md)
        if depth:
            if Q is None:
                raise ValueError("depth rendering needs the rectification Q matrix")
            z, zvalid = disparity_to_depth(disp_t, valid_t, _tensor(_host(Q), left.device))
    disp, valid = _host(disp_t), _host(valid_t)
    if depth:
        z = _host(z)
        valid = valid & _host(zvalid) & (z > 1e-3)
        v = np.where(valid, 1.0 / np.maximum(z, 1e-3), 0.0)
        v = v / max(float(np.percentile(v[valid], 99.0)) if valid.any() else 1.0, 1e-9)
    else:
        v = disp / max(md, 1)
    img = _heat_colormap(v)
    img[~valid] = 0.0
    return img


def render_stereo_matching(gray, px_left, px_right, track_status=None) -> np.ndarray:
    """STEREO_MATCHING visualization: left->right match segments with both
    endpoints (reference: -displayStereoMatching,
    api_visualization_helpers.cpp stereo overlay)."""
    img = to_rgb(gray)
    pl = np.asarray(px_left)
    pr = np.asarray(px_right)
    status = (np.asarray(track_status) if track_status is not None
              else np.zeros(len(pl), np.int32))
    for i in np.where(status == 0)[0]:
        draw_line(img, pl[i, 0], pl[i, 1], pr[i, 0], pr[i, 1], COLORS["slam"])
        draw_circle(img, pl[i, 0], pl[i, 1], 3, COLORS["track"])
        draw_circle(img, pr[i, 0], pr[i, 1], 2, COLORS["corner"])
    return img


def render_epipolar_curves(gray_second, cam_first, cam_second, T10: np.ndarray,
                           px_first, track_status=None, select: str = "TRACKED",
                           depths: Optional[np.ndarray] = None) -> np.ndarray:
    """STEREO_EPIPOLAR visualization: for each selected left-camera feature,
    the locus of its possible right-camera locations over depth — the
    epipolar CURVE through the distortion model, not a pinhole line
    (reference: -displayStereoEpipolarCurves options NONE/TRACKED/DETECTED/
    FAILED; 'feature location prediction based on epipolar geometry').

    T10: (4,4) cam0->cam1 transform. depths: sampled depths along the ray
    (default log-spaced 0.3..60 m). The rays in float64 on the host."""
    from ..geometry.cameras import pixel_to_ray, ray_to_pixel

    img = to_rgb(gray_second)
    px = _host(px_first).astype(np.float32)
    status = (np.asarray(track_status) if track_status is not None
              else np.zeros(len(px), np.int32))
    want = {"TRACKED": status == 0, "DETECTED": status == 1,
            "FAILED": (status >= 2) & (status <= 6)}.get(select, status == 0)
    sel = np.where(want)[0]
    if sel.size == 0:
        return img
    if depths is None:
        depths = np.geomspace(0.3, 60.0, 24).astype(np.float32)
    T10 = np.asarray(T10, np.float32)
    rays, rvalid = pixel_to_ray(cam_first, torch.as_tensor(px[sel], dtype=torch.float64))
    rays, rvalid = _host(rays), _host(rvalid)  # (S,3), (S,)
    # points along each ray at the sampled depths, moved into cam1
    P0 = rays[:, None, :] * depths[None, :, None]  # (S, D, 3)
    P1 = P0 @ T10[:3, :3].T + T10[:3, 3]
    pix, pvalid = ray_to_pixel(cam_second, torch.as_tensor(P1.reshape(-1, 3)))
    pts = _host(pix).reshape(len(sel), len(depths), 2)
    ok = (np.isfinite(pts).all(-1)
          & _host(pvalid).reshape(len(sel), len(depths))
          & rvalid[:, None])
    for s in range(len(sel)):
        c = STATUS_COLORS.get(int(status[sel[s]]), COLORS["corner"])
        for d in range(len(depths) - 1):
            if ok[s, d] and ok[s, d + 1]:
                draw_line(img, pts[s, d, 0], pts[s, d, 1],
                          pts[s, d + 1, 0], pts[s, d + 1, 1], c)
    return img


def render_video_visualization(
    mode: VisualizationMode,
    gray,
    second_gray=None,
    track_pixels=None,
    track_prev_pixels=None,
    track_status=None,
    track_valid=None,
    stereo_pixels=None,
    slam_points_px=None,
    cam_first=None,
    cam_second=None,
    T10=None,
    Q=None,
    epipolar_select: str = "TRACKED",
) -> Optional[np.ndarray]:
    """Single entry point over every reference VisualizationMode (reference:
    InternalAPI::setVisualization + api_visualization_helpers.cpp dispatch).
    Returns None for NONE. Track arrays are the tagged-frame payload
    (FrameOutput.track_*); stereo modes additionally need the second image
    and (for EPIPOLAR/DEPTH) cameras/extrinsics/Q."""
    M = VisualizationMode
    mode = M(mode)
    if mode == M.NONE:
        return None
    if mode in (M.PLAIN_VIDEO, M.PROCESSED_VIDEO):
        return to_rgb(gray)
    if mode == M.CORNER_MEASURE:
        return render_corner_measure(gray)
    if mode == M.STEREO_DISPARITY or mode == M.STEREO_DEPTH:
        if second_gray is None:
            return to_rgb(gray)
        return render_stereo_disparity(gray, second_gray, Q=Q,
                                       depth=(mode == M.STEREO_DEPTH
                                              and Q is not None))
    if mode == M.STEREO_MATCHING:
        if stereo_pixels is None:
            return to_rgb(gray)
        return render_stereo_matching(gray, track_pixels, stereo_pixels,
                                      track_status)
    if mode == M.STEREO_EPIPOLAR:
        if cam_first is None or cam_second is None or T10 is None:
            return to_rgb(gray)
        return render_epipolar_curves(
            second_gray if second_gray is not None else gray,
            cam_first, cam_second, T10, track_pixels, track_status,
            select=epipolar_select)
    status = None if track_status is None else np.asarray(track_status)
    if mode == M.OPTICAL_FLOW_FAILURES and status is not None:
        keep = (status >= 2) & (status <= 6)
        status = np.where(keep, status, -1)
    flow = track_prev_pixels if mode in (M.OPTICAL_FLOW, M.OPTICAL_FLOW_FAILURES,
                                         M.DEBUG_VISUALIZATION, M.TRACKS_ALL) else None
    valid = (np.asarray(track_valid) if track_valid is not None
             else (status is not None) & (status == 0))
    if mode == M.TRACKER_ONLY:
        # corners only, no odometry-side payload
        return render_video_overlay(gray, track_pixels, valid)
    return render_video_overlay(
        gray, track_pixels, valid,
        flow_prev=flow, track_status=status,
        stereo_pixels=stereo_pixels if mode == M.DEBUG_VISUALIZATION else None,
        slam_points_px=slam_points_px)


def render_pose_plot(histories: Dict[str, np.ndarray], size: int = 512,
                     axes: Tuple[int, int] = (0, 1),
                     point_cloud: Optional[np.ndarray] = None) -> np.ndarray:
    """POSE visualization: 2D trajectory comparison
    (reference: visualization_pose.cpp). histories: name -> (N, >=3) positions
    (or (N, >=4) with time in column 0, auto-detected). point_cloud (M, 3)
    world points scatter in dim blue (reference: -displayPointCloud draws
    the point-cloud history into the pose window)."""
    img = np.zeros((size, size, 3), np.float32) + 0.08
    allpts = []
    series = {}
    for name, h in histories.items():
        h = np.asarray(h)
        pts = h[:, 1:4] if h.shape[1] >= 4 else h[:, :3]
        series[name] = pts[:, list(axes)]
        allpts.append(series[name])
    if not allpts:
        return img
    cat = np.concatenate(allpts)
    lo = cat.min(axis=0)
    hi = cat.max(axis=0)
    if point_cloud is not None and len(point_cloud):
        # include the bulk of the cloud in the view (robust percentiles so
        # stray triangulations don't crush the trajectory to a dot)
        pcq = np.asarray(point_cloud)[:, list(axes)]
        lo = np.minimum(lo, np.percentile(pcq, 5, axis=0))
        hi = np.maximum(hi, np.percentile(pcq, 95, axis=0))
    span = np.maximum(hi - lo, 1e-6).max()
    margin = 20

    def to_px(p):
        q = (p - (lo + hi) / 2) / span * (size - 2 * margin)
        return q[0] + size / 2, size / 2 - q[1]

    if point_cloud is not None and len(point_cloud):
        pc = np.asarray(point_cloud)[:, list(axes)]
        # vectorized scatter (single-pixel marks; the trajectory draws on top)
        q = (pc - (lo + hi) / 2) / span * (size - 2 * margin)
        xs = np.round(q[:, 0] + size / 2).astype(int)
        ys = np.round(size / 2 - q[:, 1]).astype(int)
        ok = (xs >= 0) & (xs < size) & (ys >= 0) & (ys < size)
        img[ys[ok], xs[ok]] = (0.25, 0.4, 0.9)
    for name, pts in series.items():
        color = COLORS.get(name, (0.7, 0.7, 0.7))
        for i in range(len(pts) - 1):
            x0, y0 = to_px(pts[i])
            x1, y1 = to_px(pts[i + 1])
            draw_line(img, x0, y0, x1, y1, color)
    return img


def render_covariance_magnitudes(P: np.ndarray, size: Optional[int] = None) -> np.ndarray:
    """COVARIANCE_MAGNITUDES visualization: log-magnitude heatmap of the EKF
    covariance (reference: api.cpp:956-966, visualization_internals.cpp)."""
    P = np.asarray(P)
    mag = np.log10(np.abs(P) + 1e-12)
    mag = (mag - mag.min()) / max(mag.max() - mag.min(), 1e-9)
    img = np.stack([mag, 0.2 + 0.6 * mag, 1.0 - mag], axis=-1).astype(np.float32)
    return img


def render_correlation(P: np.ndarray) -> np.ndarray:
    """KF_CORRELATION visualization: correlation heatmap (cov2corr;
    reference: src/odometry/util.hpp cov2corr + visualization_internals)."""
    P = np.asarray(P)
    d = np.sqrt(np.clip(np.diag(P), 1e-30, None))
    C = P / d[:, None] / d[None, :]
    C = np.clip(C, -1, 1)
    img = np.zeros(C.shape + (3,), np.float32)
    img[..., 0] = np.clip(C, 0, 1)
    img[..., 2] = np.clip(-C, 0, 1)
    img[..., 1] = 0.15
    return img


def render_imu_plot(gyro_samples: np.ndarray, acc_samples: np.ndarray,
                    width: int = 512, height: int = 256) -> np.ndarray:
    """Scrolling gyro/acc sample plot (reference:
    src/commandline/imu_visualization.hpp): two stacked panels, one polyline
    per axis, latest samples on the right. Inputs: (N, 3) arrays of the most
    recent samples (any N; resampled to the panel width)."""
    img = np.zeros((height, width, 3), np.float32)
    half = height // 2
    panels = [(np.asarray(gyro_samples, float), 0),
              (np.asarray(acc_samples, float), half)]
    colors = [(1.0, 0.3, 0.3), (0.3, 1.0, 0.3), (0.4, 0.5, 1.0)]
    for samples, y0 in panels:
        if samples.size == 0:
            continue
        n = samples.shape[0]
        lo = samples.min()
        hi = samples.max()
        span = max(hi - lo, 1e-6)
        xs = np.linspace(0, width - 1, n).astype(int)
        for axis in range(min(3, samples.shape[1])):
            ys = y0 + ((hi - samples[:, axis]) / span * (half - 1)).astype(int)
            for i in range(n - 1):
                draw_line(img, xs[i], ys[i], xs[i + 1], ys[i + 1], colors[axis])
        img[y0, :, :] = 0.25
    return img


# ---- SLAM keyframe / ORB debug viewers (reference: cmd slam group
# -displayKeyframe / -visualizeOrbMatching / -visualizeLoopOrbMatching /
# -visualizeOrbPyramid / -visualizeOrbs / -visualizeMapPointSearch; drawn in
# Pangolin windows there, rasters here) ----

def render_orb_keypoints(thumb: np.ndarray, pix_pts, valid=None,
                         scale: float = 0.5) -> np.ndarray:
    """KEYFRAME / ORBS view: descriptor sample points on the keyframe thumb
    (pix_pts are full-resolution pixels; thumb is the stored half-res)."""
    img = to_rgb(thumb)
    pts = np.asarray(pix_pts) * scale
    ok = (np.asarray(valid) if valid is not None
          else np.ones(len(pts), bool))
    for i in np.where(ok)[0]:
        draw_circle(img, pts[i, 0], pts[i, 1], 3, COLORS["corner"])
    return img


def render_orb_pyramid(thumb: np.ndarray, levels: int = 3) -> np.ndarray:
    """ORB_PYRAMID view: the keyframe's downscale pyramid, levels stacked
    top-to-bottom in a right-hand column."""
    H, W = thumb.shape
    canvas = np.zeros((H, W + W // 2 + 8, 3), np.float32)
    canvas[:H, :W] = to_rgb(thumb)
    x = W + 4
    y = 0
    img = thumb
    for _ in range(1, levels):
        he, we = (img.shape[0] // 2) * 2, (img.shape[1] // 2) * 2  # even crop
        img = 0.25 * (img[0:he:2, 0:we:2] + img[1:he:2, 0:we:2]
                      + img[0:he:2, 1:we:2] + img[1:he:2, 1:we:2])
        h, w = img.shape
        if y + h > H:
            break
        canvas[y:y + h, x:x + w] = to_rgb(img)
        y += h + 2
    return canvas


def render_orb_matches(thumb_a: np.ndarray, pts_a, thumb_b: np.ndarray,
                       pts_b, matches, scale: float = 0.5,
                       color=None) -> np.ndarray:
    """ORB matching view: keyframes side by side with match lines
    (reference: visualizeOrbMatching / visualizeLoopOrbMatching windows)."""
    Ha, Wa = thumb_a.shape
    Hb, Wb = thumb_b.shape
    H = max(Ha, Hb)
    canvas = np.zeros((H, Wa + Wb, 3), np.float32)
    canvas[:Ha, :Wa] = to_rgb(thumb_a)
    canvas[:Hb, Wa:Wa + Wb] = to_rgb(thumb_b)
    pa = np.asarray(pts_a) * scale
    pb = np.asarray(pts_b) * scale
    c = color or COLORS["track"]
    for i, j in matches:
        if i >= len(pa) or j >= len(pb):
            continue
        x0, y0 = pa[i]
        x1, y1 = pb[j]
        draw_line(canvas, x0, y0, Wa + x1, y1, c)
        draw_circle(canvas, x0, y0, 2, COLORS["corner"])
        draw_circle(canvas, Wa + x1, y1, 2, COLORS["corner"])
    return canvas


def render_map_point_search(thumb: np.ndarray, proj_pts, obs_pts=None,
                            scale: float = 0.5) -> np.ndarray:
    """MAP_POINT_SEARCH view: map points projected into the keyframe
    (blue) vs its own observations (green)."""
    img = to_rgb(thumb)
    for p in np.asarray(proj_pts) * scale:
        if np.isfinite(p).all():
            draw_circle(img, p[0], p[1], 2, COLORS["slam"], filled=True)
    if obs_pts is not None:
        for p in np.asarray(obs_pts) * scale:
            draw_circle(img, p[0], p[1], 3, COLORS["track"])
    return img
