"""The port's visualizations (api/visualizations.py, VioApi's
render_visualization, the CLI's display flags and -visualizationPath) and
its video input (io/video.py VideoFileSource) against the reference's, on
the CPU:

- every VisualizationMode of one tagged payload at 64x48 (stereo pair,
  cameras, Q): exact where the view is numpy drawing; CORNER_MEASURE within
  CORNER_TOL (the port's plain corner response against XLA's); the
  disparity, depth and epipolar views exact;
- every other renderer (overlays, pose plot, heatmaps, IMU plot, the SLAM
  viewers' rasters), exact;
- VioApi.render_visualization over a port run of the mono blobs dataset:
  the reference's renderer on the same retired output and images;
- the CLI with every display flag and -visualizationPath over the stereo
  blobs dataset writes the reference's file names; save_visualization's
  PNG, or .npy where cv2 is missing;
- a 5-frame MJPG .avi and mp4v .mp4 written with cv2 decode to the
  reference's frames exactly."""
import contextlib
import io
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from hybvio_tpu.api import visualizations as r_vz
from hybvio_tpu.frontend.rectify import stereo_rectify as r_stereo_rectify
from hybvio_tpu.geometry.cameras import build_pinhole as r_pinhole
from hybvio_tpu.io import video as r_video
from hybvio_tpu_torch.api import visualizations as p_vz
from hybvio_tpu_torch.frontend.rectify import stereo_rectify as p_stereo_rectify
from hybvio_tpu_torch.geometry.cameras import build_pinhole as p_pinhole
from hybvio_tpu_torch.io import video as p_video

torch.set_num_threads(1)

H, W = 48, 64
CORNER_TOL = 1e-5  # the heatmap's RGB: the response's float32 rounding, scaled
M = p_vz.VisualizationMode


def _payload():
    """One frame's tagged payload at 64x48 for each package: gray images,
    the track arrays, each package's cameras, T10 and Q."""
    rng = np.random.RandomState(3)
    g = (rng.rand(H, W) * 0.5).astype(np.float32)
    g[10:20, 20:34] += 0.4
    g2 = np.roll(g, -4, axis=1)
    px = np.array([[20.0, 25.0], [50.0, 40.0], [10.0, 10.0], [33.0, 18.0], [-1.0, -1.0]])
    kw = dict(second_gray=g2, track_pixels=px, track_prev_pixels=px - np.array([6.0, 2.0]),
              track_status=np.array([0, 3, 1, 2, -1], np.int32),
              track_valid=np.array([True, False, False, True, False]),
              stereo_pixels=px + np.array([9.0, 0.0]))
    i2c0, i2c1 = np.eye(4), np.eye(4)
    i2c1[0, 3] = -0.1
    T10 = i2c1 @ np.linalg.inv(i2c0)
    rcam = r_pinhole(50.0, 50.0, W / 2, H / 2, width=W, height=H, dtype=jnp.float64)
    pcam = p_pinhole(50.0, 50.0, W / 2, H / 2, width=W, height=H)
    Q = np.asarray(r_stereo_rectify(rcam, rcam, i2c0, i2c1, W, H)[2])
    np.testing.assert_array_equal(p_stereo_rectify(pcam, pcam, i2c0, i2c1, W, H)[2], Q)
    return g, kw, dict(cam_first=rcam, cam_second=rcam, T10=T10, Q=Q), dict(
        cam_first=pcam, cam_second=pcam, T10=T10, Q=Q)


@pytest.mark.parametrize("mode", list(M), ids=[m.name for m in M])
def test_visualization_mode_equals_reference(mode):
    g, kw, rk, pk = _payload()
    want = r_vz.render_video_visualization(mode, g, **kw, **rk)
    got = p_vz.render_video_visualization(mode, torch.as_tensor(g), **kw, **pk)
    if mode == M.NONE:
        assert got is None and want is None
        return
    assert got.shape == want.shape == (H, W, 3) and got.dtype == np.float32
    if mode == M.CORNER_MEASURE:
        np.testing.assert_allclose(got, want, rtol=0, atol=CORNER_TOL)
    else:
        np.testing.assert_array_equal(got, np.asarray(want))
    assert np.isfinite(got).all()


def _renderer_cases():
    rng = np.random.RandomState(5)
    thumb = rng.rand(24, 32).astype(np.float32)
    pts = rng.rand(12, 2) * np.array([60.0, 44.0])
    t = np.linspace(0, 1, 30)
    hist = {"output": np.stack([t, np.cos(6 * t), np.sin(6 * t)], axis=1),
            "groundTruth": np.stack([t, t, np.cos(6 * t), 0 * t], axis=1)}
    A = rng.randn(20, 20)
    g = rng.rand(H, W).astype(np.float32)
    return {
        "overlay with trails and outliers": lambda vz: vz.render_video_overlay(
            g, pts, np.arange(12) % 3 > 0, [pts[:4], pts[4:9]], outlier_mask=np.arange(12) % 2 == 0,
            slam_points_px=pts[::3]),
        "stereo matching": lambda vz: vz.render_stereo_matching(
            g, pts, pts + 5.0, np.arange(12) % 2),
        "pose plot with a point cloud": lambda vz: vz.render_pose_plot(
            hist, size=96, point_cloud=rng.randn(200, 3)),
        "covariance magnitudes": lambda vz: vz.render_covariance_magnitudes(A @ A.T),
        "correlation": lambda vz: vz.render_correlation(A @ A.T),
        "IMU plot": lambda vz: vz.render_imu_plot(rng.randn(50, 3), rng.randn(40, 3), 96, 64),
        "ORB keypoints": lambda vz: vz.render_orb_keypoints(thumb, pts, np.arange(12) % 4 > 0),
        "ORB pyramid": lambda vz: vz.render_orb_pyramid(thumb),
        "ORB matches": lambda vz: vz.render_orb_matches(
            thumb, pts, thumb[::-1], pts[::-1], [(0, 1), (3, 5), (11, 2), (20, 0)],
            color=(1.0, 0.4, 0.1)),
        "map point search": lambda vz: vz.render_map_point_search(
            thumb, np.concatenate([pts, [[np.nan, 1.0]]]), pts[:5]),
    }


@pytest.mark.parametrize("name", list(_renderer_cases()))
def test_renderer_equals_reference(name):
    # one draw of the random inputs for each package: the same seed
    got, want = _renderer_cases()[name](p_vz), _renderer_cases()[name](r_vz)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got.max() > 0


@pytest.fixture(scope="module")
def mono_api(tmp_path_factory):
    """The port's VioApi over 5 frames of the mono blobs dataset (320x240)."""
    from hybvio_tpu_torch.api.vio import VioApi
    from hybvio_tpu_torch.config import Parameters
    from hybvio_tpu_torch.config import loader as p_loader
    from hybvio_tpu_torch.io import jsonl as p_jsonl

    ds = tp.make_api_dataset(str(tmp_path_factory.mktemp("vis_mono")), 0.6)
    api = VioApi(tp.api_params(Parameters, p_loader, p_jsonl, ds), tp.API_W, tp.API_H,
                 device="cpu")
    outs, _ = tp.drive_api(api, ds, 5)
    assert outs and api.last_frame_output is not None
    return api


@pytest.mark.parametrize("mode", [M.PLAIN_VIDEO, M.TRACKS, M.OPTICAL_FLOW_FAILURES,
                                  M.DEBUG_VISUALIZATION, M.CORNER_MEASURE],
                         ids=lambda m: m.name)
def test_api_render_visualization_equals_reference_renderer(mono_api, mode):
    """VioApi.render_visualization: the reference's renderer on the same
    retired output and frame (set_visualization picks the default mode)."""
    fo = mono_api.last_frame_output
    gray = mono_api._norm_gray(mono_api._last_images[0]).numpy()
    want = r_vz.render_video_visualization(
        mode, gray, track_pixels=fo.track_pixels[:, 0, :],
        track_prev_pixels=fo.track_prev_pixels[:, 0, :], track_status=fo.track_status,
        track_valid=fo.track_ids >= 0, stereo_pixels=None)
    mono_api.set_visualization(mode)
    got = mono_api.render_visualization()
    if mode == M.CORNER_MEASURE:
        np.testing.assert_allclose(got, want, rtol=0, atol=CORNER_TOL)
    else:
        np.testing.assert_array_equal(got, np.asarray(want))
    mono_api.set_visualization(M.NONE)
    assert mono_api.render_visualization() is None


DISPLAY_FLAGS = ("-displayVideo", "-displayPlainVideo", "-displayTracks", "-displayTracksAll",
                 "-displayOpticalFlow", "-displayCornerMeasure", "-displayStereoMatching",
                 "-displayStereoEpipolarCurves", "-displayStereoDisparity",
                 "-displayStereoDepth", "-displayPose", "-displayPointCloud",
                 "-displayCovarianceMagnitude", "-displayCorrelation", "-displayImuSamples")


def test_cli_display_flags_write_reference_file_names(tmp_path):
    """Both CLIs over 5 frames of the stereo blobs dataset with every display
    flag: the same files under -visualizationPath (PNG, cv2 is here), each
    view of each retired output."""
    from hybvio_tpu.cli.main import run as ref_run
    from hybvio_tpu_torch.cli.main import run

    ds = tp.make_api_dataset(str(tmp_path / "stereo"), 0.6, stereo=True)
    names = {}
    for who, fn in (("ref", ref_run), ("port", lambda a: run(a, device="cpu"))):
        err = io.StringIO()
        argv = [f"-i={ds}", f"-o={tmp_path / who}.jsonl", "-maxFrames=5", "-useStereo",
                f"-visualizationPath={tmp_path / who}", *tp.API_FLAGS, *DISPLAY_FLAGS]
        with contextlib.redirect_stderr(err):
            assert fn(argv) == 0
        assert "failed" not in err.getvalue(), err.getvalue()
        names[who] = sorted(os.listdir(tmp_path / who))
    assert names["port"] == names["ref"]
    views = {n.rsplit("_", 1)[0] for n in names["port"]}
    assert views == {"video", "plain", "tracks", "tracks_all", "flow", "corner", "stereo_match",
                     "epipolar", "disparity", "depth", "pose", "cov", "corr"}
    assert len(names["port"]) == 2 * len(views)  # 2 outputs of 5 frames


def test_save_visualization_png_or_npy(tmp_path, monkeypatch):
    """A PNG (8-bit BGR of the RGB raster) where cv2 imports, the raw .npy
    where it does not: the reference CLI's save_vis."""
    import cv2

    from hybvio_tpu_torch.cli.main import save_visualization

    img = np.random.RandomState(0).rand(6, 8, 3).astype(np.float32)
    path = save_visualization(str(tmp_path), "v", img)
    assert path.endswith("v.png")
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], (img * 255).astype(np.uint8))
    monkeypatch.setitem(sys.modules, "cv2", None)
    path = save_visualization(str(tmp_path), "w", img)
    assert path.endswith("w.npy")
    np.testing.assert_array_equal(np.load(path), img)


@pytest.mark.parametrize("ext, fourcc", [(".avi", "MJPG"), (".mp4", "mp4v")])
def test_video_decode_equals_reference(tmp_path, ext, fourcc):
    import cv2

    rng = np.random.RandomState(1)
    path = str(tmp_path / f"v{ext}")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 10, (W, H))
    for _ in range(5):
        writer.write((rng.rand(H, W, 3) * 255).astype(np.uint8))
    writer.release()
    got, want = p_video.open_frame_source(path), r_video.open_frame_source(path)
    assert isinstance(got, p_video.VideoFileSource) and got.shape == want.shape == (H, W)
    for n in range(5):
        a = got.frame(n)
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, want.frame(n))
    with pytest.raises(IndexError):
        got.frame(5)
    # where cv2 is missing: the reference's error
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "cv2", None)
        with pytest.raises(RuntimeError, match="requires cv2"):
            p_video.VideoFileSource(path)
