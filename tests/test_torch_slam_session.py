"""The port's SLAM session (slam/session.py Slam, on the CPU) against the
reference's over the scenarios of tests/test_slam.py and
tests/test_slam_global.py, frame by frame: keyframe ids, map-point ids,
their observations and track aliases, loop events and loop edges exactly;
keyframe poses and map-point positions to POSE_TOL; the end-of-run global
adjustment and the saved map too.

The reference is pinned to its JAX keypoint detector and the port to its
torch detector (each package's native C++ one is held by
test_session_native_orb_on_both_sides_equals_reference and
tests/test_torch_native.py). The scenarios' frames are test_slam.py's
flat 0.3 images with 5x5 boxes; there a descriptor bit is rounding noise
wherever a BRIEF pair's samples are equal up to rounding, and which way it
falls depends on each package's float32 reduction order
(test_torch_slam.py). So in those scenarios the port's session takes the
reference's descriptors and keypoints of the same frames (the analog of the
API tests stepping from the reference's state); everything downstream of
them is the port's own. On textured frames (render_view) the port's own
descriptors and keypoints equal the reference's: test_torch_slam_textured.py
runs the revisit scenario rendered that way with nothing taken from the
reference. The multi-scale keypoints are off here (their reference build is
the costliest compile of the module); test_torch_slam.py and
test_torch_slam_textured.py hold them."""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, os.path.dirname(__file__))

from hybvio_tpu.config import Parameters as RParams
from hybvio_tpu.io.synthetic import render_view
from hybvio_tpu.slam import keypoints as r_keypoints
from hybvio_tpu.slam import native_orb as r_native_orb
from hybvio_tpu.slam import orb as r_orb
from hybvio_tpu.slam.ba import ba_iterate as r_ba_iterate
from hybvio_tpu.slam.host import host_jit, np_rmat_to_quat
from hybvio_tpu.slam.session import Slam as RSlam
from hybvio_tpu_torch.config import Parameters
from hybvio_tpu_torch.slam import keypoints as p_keypoints
from hybvio_tpu_torch.slam import native_orb as p_native_orb
from hybvio_tpu_torch.slam import orb as p_orb
from hybvio_tpu_torch.slam.session import Slam
from test_slam import cam_pose_cw, project_to_norm

torch.set_num_threads(1)

POSE_TOL = 1e-8  # m (and quaternion components); float64 solves on both sides

_DETECTORS = {}
_make_ref_detector = r_keypoints.make_multiscale_orb


def _cached_ref_detector(H, W, **kw):
    """The reference's detector, compiled once per shape for the file."""
    key = (H, W, tuple(sorted(kw.items())))
    if key not in _DETECTORS:
        _DETECTORS[key] = _make_ref_detector(H, W, **kw)
    return _DETECTORS[key]


_REF_BA = host_jit(lambda prob: r_ba_iterate(prob, iterations=8))
# each package's own choice of detector, before the file's fixture pins them
_NATIVE_ORB = (r_native_orb.native_orb_available, p_native_orb.native_orb_available)


@pytest.fixture(autouse=True)
def reference_jax_detector(monkeypatch):
    """The reference on its JAX detector, the port on its torch detector;
    the reference's detector and its local BA (the same programs) compiled
    once per shape for the whole file."""
    monkeypatch.setattr(r_native_orb, "native_orb_available", lambda: False)
    monkeypatch.setattr(p_native_orb, "native_orb_available", lambda: False)
    monkeypatch.setattr(r_keypoints, "make_multiscale_orb", _cached_ref_detector)
    monkeypatch.setattr(RSlam, "_ba_fn", lambda self: _REF_BA)


def _lock_descriptors(monkeypatch):
    """The port's session computes the reference's descriptors and
    keypoints of its frames."""
    r_desc = jax.jit(r_orb.orb_descriptors)

    def orb_descriptors(image, pts, valid):
        d, ok = r_desc(image.numpy(), pts.numpy(), valid.numpy())
        return torch.as_tensor(np.array(d)), torch.as_tensor(np.array(ok))

    def make_multiscale_orb(H, W, **kw):
        det, n = _cached_ref_detector(H, W, **kw)
        return (lambda img: det(img.numpy())), n

    monkeypatch.setattr(p_orb, "orb_descriptors", orb_descriptors)
    monkeypatch.setattr(p_keypoints, "make_multiscale_orb", make_multiscale_orb)


def _same(port, ref, where):
    """Every integer field of the two sessions equal, floats to POSE_TOL."""
    assert port.kf_order == ref.kf_order, where
    assert (port.next_kf_id, port.next_point_id) == (ref.next_kf_id, ref.next_point_id), where
    assert sorted(port.points) == sorted(ref.points), where
    assert port.track_to_point == ref.track_to_point, where
    for pid, r in ref.points.items():
        p = port.points[pid]
        assert (p.track_id, p.track_ids, p.triangulated) == (r.track_id, r.track_ids,
                                                              r.triangulated), (where, pid)
        assert sorted(p.observations) == sorted(r.observations), (where, pid)
        np.testing.assert_allclose(p.position, r.position, rtol=0, atol=POSE_TOL,
                                   err_msg=f"{where} point {pid}")
        assert len(p.desc_bank) == len(r.desc_bank), (where, pid)
    for kid in ref.kf_order:
        p, r = port.keyframes[kid], ref.keyframes[kid]
        np.testing.assert_array_equal(p.track_ids, r.track_ids)
        np.testing.assert_allclose(p.pose, r.pose, rtol=0, atol=POSE_TOL,
                                   err_msg=f"{where} keyframe {kid}")
        if r.kp_track_row is not None:
            np.testing.assert_array_equal(p.kp_track_row, r.kp_track_row)
    events = lambda s: [(e.kf_id, e.matched_kf_id, e.n_matches, e.applied) for e in s.loop_events]
    assert events(port) == events(ref), where
    assert [(e.kf_a, e.kf_b) for e in port.loop_edges] == [(e.kf_a, e.kf_b)
                                                           for e in ref.loop_edges], where
    for pe, re in zip(port.loop_edges, ref.loop_edges):
        np.testing.assert_allclose(pe.rel, re.rel, rtol=0, atol=POSE_TOL)
    assert port._pending_loops == ref._pending_loops, where
    assert port._loop_seed == ref._loop_seed and port._clean_upto == ref._clean_upto, where


def _run(frames, setup, slam_kw, end=False, tmp_path=None):
    """Both sessions over ``frames`` ((image, T_cw, ids, norm_pts, t, k)),
    compared after every frame (and after end()); returns (port, ref)."""
    rp, pp = RParams(), Parameters()
    setup(rp)
    setup(pp)
    ref, port = RSlam(rp, **slam_kw), Slam(pp, device="cpu", **slam_kw)
    for img, T, ids, ip, t, k in frames:
        ref.add_frame(img, T, ids, ip, t=t, frame_num=k)
        port.add_frame(img, T, ids, ip, t=t, frame_num=k)
        _same(port, ref, f"frame {k}")
    if end:
        paths = [None, None] if tmp_path is None else [str(tmp_path / n)
                                                       for n in ("ref.jsonl", "port.jsonl")]
        assert ref.end(map_save_path=paths[0]) and port.end(map_save_path=paths[1])
        _same(port, ref, "end")
    return port, ref


def _decide_every_frame(p):
    p.slam.keyframeDecisionMinIntervalSeconds = 0.0
    p.slam.keyframeDecisionDistanceThreshold = 0.01


# ------------------------------------------------ tests/test_slam.py scenarios

def _straight(n, n_lm, seed, step, noise=0.0):
    rng = np.random.RandomState(seed)
    lm = np.stack([4.0 + rng.rand(n_lm) * 2, rng.randn(n_lm) * 2, rng.randn(n_lm)], axis=1)
    for k in range(n):
        T = cam_pose_cw(np.array([0.0, k * step, 0.0]), 0.0)
        ip, ok = project_to_norm(T, lm)
        T_odo = T.copy()
        if noise:
            T_odo[:3, 3] += rng.randn(3) * noise
            ip = ip + rng.randn(*ip.shape) * 5e-4
        ids = np.where(ok, np.arange(n_lm), -1).astype(np.int32)
        yield None, T_odo, ids[ok], ip[ok], float(k), k


def test_session_keyframes_and_map_equal_reference():
    port, _ = _run(_straight(6, 60, 0, 0.3), _decide_every_frame,
                   dict(max_ba_keyframes=8, compute_descriptors=False))
    assert len(port.kf_order) >= 4 and len(port._cloud()) > 20


def test_session_ba_on_noisy_odometry_equals_reference():
    port, _ = _run(_straight(8, 80, 1, 0.25, noise=0.01), _decide_every_frame,
                   dict(max_ba_keyframes=10, compute_descriptors=False))
    assert any(np.abs(port.keyframes[k].pose - port.keyframes[k].odo_pose).max() > 1e-4
               for k in port.kf_order)  # local BA moved the poses


def _box_frame(T, landmarks, f=260.0):
    """test_slam.py's frame: flat 0.3 with a 5x5 box at each visible
    landmark."""
    ip, ok = project_to_norm(T, landmarks)
    px = ip * f + np.array([160.0, 120.0])
    img = np.zeros((240, 320), np.float32) + 0.3
    for i in np.where(ok)[0]:
        u, v = px[i]
        if 8 <= u < 312 and 8 <= v < 232:
            iu, iv = int(u), int(v)
            img[max(iv - 2, 0):iv + 3, max(iu - 2, 0):iu + 3] += 0.5 if i % 2 == 0 else -0.2
    return ip, ok, np.clip(img, 0, 1)


def _revisit_frames(textured=False):
    """test_loop_closure_detection's trajectory: out 1.2 m and back, the
    tracks broken on the way back; box frames, or render_view frames of the
    same landmarks (sky background + blobs) when ``textured``."""
    rng = np.random.RandomState(2)
    landmarks = np.stack([5.0 + rng.rand(50), rng.randn(50) * 2, rng.randn(50)], axis=1)
    for k, y in enumerate((0.0, 0.4, 0.8, 1.2, 0.8, 0.4, 0.02)):
        T = cam_pose_cw(np.array([0.0, y, 0.0]), 0.0)
        ip, ok, img = _box_frame(T, landmarks)
        if textured:
            img = render_view(landmarks, T[:3, 3], np_rmat_to_quat(T[:3, :3].T), np.eye(4),
                              260.0, 260.0, 160.0, 120.0, 320, 240).astype(np.float32)
        ids = np.where(ok, np.arange(50) + (1000 * k if k >= 4 else 0), -1).astype(np.int32)
        yield img, T, ids[ok], ip[ok], float(k), k


def _loop_setup(p, keypoints=False):
    _decide_every_frame(p)
    p.slam.adjacentSpaceSize = 3
    p.slam.minLoopClosureFeatureMatches = 4
    p.slam.orbExtraKeyPoints = keypoints


def test_session_loop_closure_detection_equals_reference(monkeypatch):
    _lock_descriptors(monkeypatch)
    port, _ = _run(_revisit_frames(), _loop_setup, dict(max_ba_keyframes=8))
    assert port.loop_events and port.loop_events[-1].n_matches >= 4


def test_session_map_save_equals_reference(tmp_path):
    """end(map_save_path) (-slamMapPosesPath): the global adjustment, then
    one line per keyframe and map point; the two packages' files hold the
    same keys, times and ids, and poses and positions to POSE_TOL."""
    port, _ = _run(_straight(5, 60, 1, 0.3), _decide_every_frame,
                   dict(max_ba_keyframes=8, compute_descriptors=False), end=True,
                   tmp_path=tmp_path)
    lines = [[json.loads(l) for l in open(tmp_path / n)] for n in ("port.jsonl", "ref.jsonl")]
    assert len(lines[0]) == len(lines[1]) == len(port.kf_order) + len(port.points)
    for a, b in zip(*lines):
        assert a.keys() == b.keys()
        if "mapPoint" in b:
            assert (a["mapPoint"]["id"], a["mapPoint"]["trackId"]) == (b["mapPoint"]["id"],
                                                                       b["mapPoint"]["trackId"])
            np.testing.assert_allclose(a["mapPoint"]["position"], b["mapPoint"]["position"],
                                       rtol=0, atol=POSE_TOL)
        else:
            assert a["time"] == b["time"]
            for key in ("position", "orientation"):
                assert a[key].keys() == b[key].keys()
                np.testing.assert_allclose(list(a[key].values()), list(b[key].values()),
                                           rtol=0, atol=POSE_TOL)


# ----------------------------------------- tests/test_slam_global.py scenarios

def _global_revisit_frames(laps=2):
    """test_slam_global.py's _revisit_run: an out-and-back leg walked
    ``laps`` times with odometry drift growing 0.05 m a frame in x, tracks
    broken across laps."""
    rng = np.random.RandomState(11)
    landmarks = np.stack([6.0 + rng.rand(60), rng.randn(60) * 2.5, rng.randn(60)], axis=1)
    k = 0
    for lap in range(laps):
        for y in (0.0, 0.35, 0.7, 1.05, 1.4, 1.05, 0.7, 0.35):
            T = cam_pose_cw(np.array([0.0, y, 0.0]), 0.0)
            ip, ok, img = _box_frame(T, landmarks)
            T_drift = T.copy()
            T_drift[0, 3] += 0.05 * k
            ids = np.where(ok, np.arange(60) + 10000 * lap, -1).astype(np.int32)
            yield img, T_drift, ids[ok], ip[ok], float(k), k
            k += 1


def _global_setup(p):
    _decide_every_frame(p)
    p.slam.adjacentSpaceSize = 4
    p.slam.minLoopClosureFeatureMatches = 4
    p.slam.loopClosureRansacMinInliers = 4
    p.slam.applyLoopClosures = True
    p.slam.applyLocalBundleAdjustment = False
    p.slam.maximumDriftMetersPerSecond = 1.0
    p.slam.maximumDriftMetersPerTraveled = 1.0
    p.slam.keyframeCullEnabled = False
    p.slam.orbExtraKeyPoints = False


def test_session_loop_closure_with_pose_graph_equals_reference(monkeypatch):
    """Applied loop closures: 3D-3D RANSAC (the bit-exact draws), the drift
    gates, the fusion of matched points and the pose graph over all
    keyframes; then end()'s global adjustment."""
    _lock_descriptors(monkeypatch)
    port, _ = _run(_global_revisit_frames(), _global_setup, {}, end=True)
    assert any(e.applied for e in port.loop_events) and port.loop_edges


def test_session_native_orb_on_both_sides_equals_reference(monkeypatch):
    """Each package on its default, native C++ detector (the same source,
    so the same keypoints): the textured revisit of
    test_torch_slam_textured.py with the multi-scale keypoints on, frame by
    frame, the loop closed."""
    monkeypatch.setattr(r_native_orb, "native_orb_available", _NATIVE_ORB[0])
    monkeypatch.setattr(p_native_orb, "native_orb_available", _NATIVE_ORB[1])
    port, ref = _run(_revisit_frames(textured=True), lambda p: _loop_setup(p, keypoints=True),
                     dict(max_ba_keyframes=8))
    assert port.keypoint_detector == "native"
    assert ref._kp_detector.__qualname__.startswith("make_native_orb")
    assert port.loop_events and ref.keyframes[ref.kf_order[-1]].kp_valid.sum() > 50
    for k in ref.kf_order:
        np.testing.assert_array_equal(port.keyframes[k].kp_desc, ref.keyframes[k].kp_desc)


def test_session_keyframe_culling_equals_reference():
    def setup(p):
        _decide_every_frame(p)
        p.slam.adjacentSpaceSize = 3
        p.slam.keyframeCullEnabled = True
        p.slam.applyLocalBundleAdjustment = False

    def frames():
        rng = np.random.RandomState(2)
        lm = np.stack([5.0 + rng.rand(40), rng.randn(40) * 2, rng.randn(40)], axis=1)
        k = 0
        for _ in range(8):
            for y in (0.0, 0.3, 0.6, 0.3):
                T = cam_pose_cw(np.array([0.0, y, 0.0]), 0.0)
                ip, ok = project_to_norm(T, lm)
                ids = np.where(ok, np.arange(40), -1).astype(np.int32)
                yield None, T, ids[ok], ip[ok], float(k), k
                k += 1

    port, _ = _run(frames(), setup, dict(compute_descriptors=False))
    assert len(port.kf_order) < 32


def test_session_takes_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Slam(Parameters())
