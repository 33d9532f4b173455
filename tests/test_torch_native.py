"""The port's native host library (utils/native.py over its copies of
native/sample_sync.cpp, jsonl_reader.cpp and orb_detect.cpp) against the
reference's native library and its Python modules, on the CPU:

- the synchronizer on tests/test_native_sync.py's random stream against
  the reference's native and Python synchronizers, every field within
  1e-12, and a frame's payload through it;
- the JSONL reader event for event against the reference's native reader,
  echo events included, and read_jsonl_events' dispatch to it;
- the ORB detector against the reference's native detector at 120x160 and
  on a blank frame, exact (the same C++), and against the port's torch
  detector on texture (the reference's own bounds);
- the choices the reference makes: VioApi's synchronizer, the Slam's
  detector (and HYBVIO_NATIVE_ORB=0), and where the library does not build,
  the fallback with the reason logged."""
import json
import logging

import numpy as np
import pytest
import torch

from hybvio_tpu.config import Parameters as RParams
from hybvio_tpu.io import native_jsonl as r_native_jsonl
from hybvio_tpu.io import native_sync as r_native_sync
from hybvio_tpu.odometry.sample_sync import SampleSync as RSampleSync
from hybvio_tpu.slam import native_orb as r_native_orb
from hybvio_tpu.slam import orb as r_orb
from hybvio_tpu_torch.config import Parameters
from hybvio_tpu_torch.io import jsonl as p_jsonl
from hybvio_tpu_torch.io import native_jsonl as p_native_jsonl
from hybvio_tpu_torch.io import native_sync as p_native_sync
from hybvio_tpu_torch.slam import native_orb as p_native_orb
from hybvio_tpu_torch.slam import orb as p_orb
from hybvio_tpu_torch.utils import native

torch.set_num_threads(1)

SYNC_TOL = 1e-12  # s, and the samples' values


# ---------------------------------------------------------------- synchronizer

def _stream(syncs, seed=0):
    """tests/test_native_sync.py's random stream into every synchronizer;
    returns each one's polled samples, in order."""
    rng = np.random.RandomState(seed)
    out = [[] for _ in syncs]
    t, i = 5.0, 0
    while t < 8.0:
        tl, v = t + rng.randn() * 0.002, rng.randn(3)
        ta, a = t + 0.003 + rng.randn() * 0.002, rng.randn(3)
        for s in syncs:
            s.add_sample_leader(tl, tuple(v))
            s.add_sample_follower(ta, tuple(a))
            if i % 10 == 3:
                s.add_frame(t + 0.001)
        for k, s in enumerate(syncs):
            while True:
                got = s.poll_synced_sample()
                if got is None:
                    break
                out[k].append(got)
        t += 0.01
        i += 1
    return out


@pytest.mark.parametrize("reference", ["native", "python"])
def test_native_sync_equals_reference_on_random_stream(reference):
    pp, rp = Parameters(), RParams()
    pp.odometry.sampleSyncLag = rp.odometry.sampleSyncLag = 25
    ref = (r_native_sync.NativeSampleSync(rp.odometry) if reference == "native"
           else RSampleSync(rp.odometry))
    port, ref_out = _stream([p_native_sync.NativeSampleSync(pp.odometry), ref])
    assert len(port) == len(ref_out) > 100
    for p, r in zip(port, ref_out):
        assert abs(p.t - r.t) < SYNC_TOL and abs(p.tF - r.tF) < SYNC_TOL
        np.testing.assert_allclose(p.l, r.l, rtol=0, atol=SYNC_TOL)
        np.testing.assert_allclose(p.f, r.f, rtol=0, atol=SYNC_TOL)
        assert (p.frame is None) == (r.frame is None)
        if r.frame is not None:
            assert p.frame.num == r.frame.num and abs(p.frame.t - r.frame.t) < SYNC_TOL
    assert sum(p.frame is not None for p in port) > 20


def test_native_sync_frame_payload_round_trip():
    """A frame's images (a tensor here) ride the handle through the C ABI."""
    nat = p_native_sync.NativeSampleSync(Parameters().odometry)
    img = torch.full((4, 4), 0.5)
    for i in range(60):
        t = 1.0 + i * 0.01
        nat.add_sample_leader(t, (0, 0, 0))
        nat.add_sample_follower(t, (0, 0, 9.8))
    nat.add_frame(1.3, first_image=img, intrinsics=(1.0, 2.0, 3.0, 4.0, None))
    nat.add_frame(1.4)  # sampleSyncFrameCount = 2 frames before an output
    got = [s.frame for s in iter(nat.poll_synced_sample, None) if s.frame is not None]
    assert got and got[0].first_image is img and got[0].intrinsics[:4] == (1.0, 2.0, 3.0, 4.0)


# ------------------------------------------------------------------ JSONL

def _write_dataset(path):
    """tests/test_native_jsonl.py's dataset, with the calibration lines a
    recorded dataset starts with."""
    rng = np.random.RandomState(0)
    lines = [{"imuToCamera": [[0, 1, 0, 0.1], [-1, 0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
              "cameraInd": 0},
             {"model": "KANNALA_BRANDT4", "coeffs": [0.1, 0.2, 0.3, 0.4], "cameraInd": 1}]
    t = 0.0
    for i in range(200):
        t += 0.005
        lines.append({"time": t, "sensor": {"type": "gyroscope",
                                            "values": rng.randn(3).round(6).tolist()}})
        lines.append({"time": t + 0.001, "sensor": {"type": "accelerometer",
                                                    "values": rng.randn(3).round(6).tolist()}})
        if i % 10 == 0:
            lines.append({"time": t, "number": i // 10, "frames": [
                {"cameraInd": 1, "time": t, "cameraParameters": {
                    "focalLength": 400.0, "principalPointX": 160.0, "principalPointY": 120.0}},
                {"cameraInd": 0, "time": t, "cameraParameters": {
                    "focalLengthX": 401.0, "focalLengthY": 402.0}}]})
        if i % 25 == 0:
            lines.append({"time": t, "groundTruth": {"position": {"x": 1.0, "y": 2.0, "z": 3.0}}})
        if i == 100:
            lines.append({"time": t, "gps": {"latitude": 60.1, "longitude": 24.9,
                                             "altitude": 3.0}})
    lines += [{"time": t, "sensor": {"type": "magnetometer", "values": [1, 2, 3]}},
              {"time": t, "frames": []}, {"somethingElse": 42}]
    with open(path, "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
        f.write("\n")


def _astuple(e):
    return (e.kind, e.t, e.values, e.frames_index, e.raw,
            [(f.camera_ind, f.t, f.focal_length_x, f.focal_length_y, f.principal_point_x,
              f.principal_point_y, f.number) for f in e.frames or []])


def test_native_jsonl_equals_reference_native_event_for_event(tmp_path):
    path = str(tmp_path / "data.jsonl")
    _write_dataset(path)
    port = [_astuple(e) for e in p_native_jsonl.iter_events(path)]
    ref = [_astuple(e) for e in r_native_jsonl.iter_events(path)]
    assert port == ref
    kinds = [e[0] for e in port]
    assert (kinds.count("gyroscope"), kinds.count("frame")) == (200, 20)
    # the echo events: 8 ground truth lines, the GPS fix and the two
    # calibration lines (not the untimed unknown object)
    assert kinds.count("echo") == 11
    packed = p_native_jsonl.read_packed(path)
    np.testing.assert_array_equal(packed.kind, r_native_jsonl.read_packed(path).kind)


def test_read_jsonl_events_dispatches_to_native(tmp_path, monkeypatch):
    path = str(tmp_path / "data.jsonl")
    _write_dataset(path)
    events = p_jsonl.read_jsonl_events(path)
    assert events.reader == "native"
    assert [_astuple(e) for e in events] == [_astuple(e) for e in r_native_jsonl.iter_events(path)]
    # where the library is unavailable: the Python loop, its echo events the
    # pose and GPS lines only
    monkeypatch.setattr(native, "library", lambda: None)
    events = p_jsonl.read_jsonl_events(path)
    assert events.reader == "python"
    assert [e.kind for e in events].count("echo") == 9


# -------------------------------------------------------------------- ORB

def _texture(H, W, seed=0):
    """tests/test_native_orb.py's texture."""
    rng = np.random.RandomState(seed)
    base = rng.rand(H // 8 + 1, W // 8 + 1)
    img = np.kron(base, np.ones((8, 8)))[:H, :W].astype(np.float32)
    img += 0.15 * rng.rand(H, W).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


@pytest.mark.parametrize("frame", ["texture", "blank"])
def test_native_orb_equals_reference_native(frame):
    H, W = 120, 160
    img = _texture(H, W, seed=3) if frame == "texture" else np.zeros((H, W), np.float32)
    np.testing.assert_array_equal(p_orb._PAIRS_A, r_orb._PAIRS_A)
    np.testing.assert_array_equal(p_orb._PAIRS_B, r_orb._PAIRS_B)
    (det_p, cap_p), (det_r, cap_r) = (p_native_orb.make_native_orb(H, W),
                                      r_native_orb.make_native_orb(H, W))
    assert cap_p == cap_r
    got, want = det_p(torch.as_tensor(img)), det_r(img)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[3].sum() > 30 if frame == "texture" else not got[3].any()


def test_native_orb_agrees_with_torch_detector():
    """The reference's bounds between its native and its own detector
    (tests/test_native_orb.py), held by the port's two."""
    from hybvio_tpu_torch.slam.keypoints import make_multiscale_orb

    H, W = 240, 320
    img = _texture(H, W, seed=3)
    (det_n, cap_n), (det_t, cap_t) = p_native_orb.make_native_orb(H, W), make_multiscale_orb(H, W)
    assert cap_n == cap_t
    pn, ln, dn, vn = det_n(img)
    pt, lt, dt, vt = det_t(torch.as_tensor(img))
    np.testing.assert_array_equal(ln, lt)
    both = vn & vt
    assert vn.sum() > 30 and both.sum() >= 0.95 * max(vn.sum(), vt.sum())
    assert float(np.median(np.linalg.norm(pn[both] - pt[both], axis=1))) < 0.5
    assert float(np.median((dn[both] * dt[both] > 0).mean(axis=1))) > 0.95


# -------------------------------------------------------------- selection

def _keyframe(cls):
    """A keyframe with no tracker features."""
    pose = np.array([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0])
    return cls(kf_id=0, frame_num=0, t=0.0, pose=pose, odo_pose=pose,
               track_ids=np.zeros(0, np.int32), norm_pts=np.zeros((0, 2)))


@pytest.mark.parametrize("env, want", [("1", ("native", "make_native_orb")),
                                       ("0", ("torch", "make_multiscale_orb"))])
def test_slam_picks_the_reference_detector(monkeypatch, env, want):
    """The Slam builds the detector the reference builds: the native one
    unless HYBVIO_NATIVE_ORB=0, and names it in ``keypoint_detector``."""
    from hybvio_tpu.slam.session import KeyFrame as RKeyFrame
    from hybvio_tpu.slam.session import Slam as RSlam
    from hybvio_tpu_torch.slam.session import KeyFrame, Slam

    monkeypatch.setenv("HYBVIO_NATIVE_ORB", env)
    port, ref = Slam(Parameters(), device="cpu"), RSlam(RParams())
    img = _texture(96, 128, seed=1)
    port._add_keypoints(_keyframe(KeyFrame), img)
    assert port.keypoint_detector == want[0]
    assert port._kp_detector.__qualname__.startswith(want[1])
    if env == "1":  # the reference's JAX detector is not built here: its compile is the cost
        ref._add_keypoints(_keyframe(RKeyFrame), img)
        assert ref._kp_detector.__qualname__.startswith(want[1])
    else:
        assert not r_native_orb.native_orb_available()


def test_unbuilt_library_falls_back_and_logs(tmp_path, monkeypatch, caplog):
    """A library that does not build: its reason logged once, VioApi on the
    Python synchronizer, the Slam on the torch detector, the Python reader
    (the reference's fallbacks), and each choice visible."""
    from hybvio_tpu_torch.api.vio import VioApi
    from hybvio_tpu_torch.slam.session import KeyFrame, Slam

    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCES", (bad,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "lib.so")
    monkeypatch.setattr(native, "_state", {"lib": None, "error": None})
    with caplog.at_level(logging.WARNING, logger="hybvio_tpu_torch"):
        assert native.library() is None and native.library() is None
    assert "failed" in native.unavailable_reason()
    assert sum("native library" in r.getMessage() for r in caplog.records) == 1
    api = VioApi(Parameters(), 64, 48, recording_only=True, device="cpu")
    assert type(api.sample_sync).__name__ == "SampleSync"
    slam = Slam(Parameters(), device="cpu")
    slam._add_keypoints(_keyframe(KeyFrame), _texture(96, 128))
    assert slam.keypoint_detector == "torch"
    path = str(tmp_path / "data.jsonl")
    _write_dataset(path)
    assert p_jsonl.read_jsonl_events(path).reader == "python"
    with pytest.raises(RuntimeError, match="unavailable"):
        p_native_sync.NativeSampleSync(Parameters().odometry)
