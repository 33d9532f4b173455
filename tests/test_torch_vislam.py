"""Full VISLAM in the port (odometry/slam_coupling.py, VioApi and the CLI with
slam.useSlam) against the reference package, on the CPU.

- The coordinate transformer, the IMU-to-camera pose and the uint8
  quantization of a frame equal the reference's.
- The coupling's cadence (the interval gate, the delay contract, the
  synchronous mode and the dropped-candidate backlog) matches the
  reference's submission for submission, with a stand-in session.
- VioApi with useSlam (slamThread off, a SLAM candidate at every keyframe)
  over 8 frames of the blobs mono dataset at 320x240, each frame step from
  the reference's state (tests/test_torch_api.py): every retired output and
  VioOutput, SLAM-corrected pose, velocity and cloud with the merged map
  points included, equals the reference's (torch_parity.api_tol); the SLAM
  session's keyframe ids, map-point ids and loop events are exact and its
  poses and points agree to 1e-5 m (the front end's few-ulp pixel
  differences move the tracks' normalized points by ~1e-6). The reference
  is fed its frames on its device, which its coupling quantizes to uint8
  as the port's does.
- The map each saves (finish(slam_map_poses_path), the CLI's
  -slamMapPosesPath) holds the same lines; the port's CLI with -useSlam,
  -slamMapPosesPath and -timer writes it and the SLAM stage table.
The reference is pinned to its JAX keypoint detector (the native one is not
ported); here the keypoints are off (test_torch_slam.py and
test_torch_slam_textured.py hold them)."""
import contextlib
import functools
import io
import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parity as tp
from hybvio_tpu.api.vio import VioApi as RVioApi
from hybvio_tpu.config import Parameters as RParams
from hybvio_tpu.config import loader as r_loader
from hybvio_tpu.io import jsonl as r_jsonl
from hybvio_tpu.odometry import slam_coupling as r_sc
from hybvio_tpu.slam import native_orb as r_native_orb
from hybvio_tpu_torch.api.vio import VioApi
from hybvio_tpu_torch.config import Parameters
from hybvio_tpu_torch.config import loader as p_loader
from hybvio_tpu_torch.io import jsonl as p_jsonl
from hybvio_tpu_torch.odometry import slam_coupling as sc
from hybvio_tpu_torch.slam.host import np_pose_to_mat

torch.set_num_threads(1)

FRAMES = 8
SLAM_TOL = 1e-5  # m


@pytest.fixture(autouse=True)
def reference_jax_detector(monkeypatch):
    """The reference on its JAX keypoint detector (the native one is not
    ported)."""
    monkeypatch.setattr(r_native_orb, "native_orb_available", lambda: False)


def _random_pose(rng):
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    return rng.randn(3), q


def test_coordinate_transformer_equals_reference():
    rng = np.random.RandomState(0)
    for tilt in (True, False):
        t, rt = sc.SlamOdometryCoordinateTransformer(tilt), r_sc.SlamOdometryCoordinateTransformer(tilt)
        pos, q = _random_pose(rng)
        assert t.transform_position_orientation(pos, q) == (pos, q)  # not ready: identity
        for _ in range(3):
            p, q = _random_pose(rng)
            a = np_pose_to_mat(np.concatenate([p, q]))
            b = a.copy()
            b[:3, 3] += rng.randn(3) * 0.1
            t.set_coordinates(a, b)
            rt.set_coordinates(a, b)
            np.testing.assert_array_equal(t.T, rt.T)
            p, q = _random_pose(rng)
            for x, y in zip(t.transform_position_orientation(p, q),
                            rt.transform_position_orientation(p, q)):
                np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(t.transform_point(p), rt.transform_point(p))
            np.testing.assert_array_equal(t.transform_pose_cw(a), rt.transform_pose_cw(a))


def test_imu_pose_to_camera_equals_reference():
    rng = np.random.RandomState(1)
    c = sc.SlamCoupling(Parameters(), tp.SYNTH_IMU_TO_CAMERA, camera=None, device="cpu")
    rc = r_sc.SlamCoupling(RParams(), tp.SYNTH_IMU_TO_CAMERA, camera=None)
    for _ in range(3):
        pos, q = _random_pose(rng)
        np.testing.assert_array_equal(c.imu_pose_to_camera_cw(pos, q),
                                      rc.imu_pose_to_camera_cw(pos, q))


def _couplings(params_setup, use_thread=False):
    """The port's and the reference's SlamCoupling (mono blobs camera), each
    with its session replaced by a recording stand-in: [(frame_num, image
    dtype, image sum)] of every frame it was given."""
    from hybvio_tpu.geometry.cameras import build_pinhole as r_pinhole
    from hybvio_tpu_torch.geometry.cameras import build_pinhole

    out = []
    for port in (True, False):
        p = Parameters() if port else RParams()
        params_setup(p)
        cam = (build_pinhole(260.0, 260.0, 160.0, 120.0, width=320, height=240) if port else
               r_pinhole(260.0, 260.0, 160.0, 120.0, width=320, height=240, dtype=jnp.float32))
        c = (sc.SlamCoupling(p, tp.SYNTH_IMU_TO_CAMERA, use_thread=use_thread, camera=cam,
                             device="cpu") if port else
             r_sc.SlamCoupling(p, tp.SYNTH_IMU_TO_CAMERA, use_thread=use_thread, camera=cam))
        c.seen, c.gate = [], threading.Event()
        c.gate.set()

        def add_frame(img, odo_cw, ids, pts, t, fn, pix_pts=None, c=c):
            c.gate.wait(timeout=30)
            c.seen.append((fn, str(np.asarray(img).dtype), float(np.asarray(img).sum()),
                           None if pix_pts is None else np.asarray(pix_pts)))
            pose = odo_cw.copy()
            pose[:3, 3] += 0.01 * fn
            return type("R", (), {"pose_cw": pose, "point_cloud": [(fn, fn, pose[:3, 3])]})()

        c.slam.add_frame = add_frame
        c.slam.end = lambda map_save_path=None: True
        out.append(c)
    return out


def _submit_all(c, frames, port, image_of=None):
    rng = np.random.RandomState(5)
    got = []
    for k in range(frames):
        pos, q = rng.randn(3), np.array([1.0, 0.0, 0.0, 0.0])
        ids = np.arange(20) - 2
        pts = rng.rand(20, 2) * 0.4 - 0.2
        img = np.random.RandomState(k).rand(240, 320).astype(np.float32) * 1.2 - 0.1
        img = image_of(img) if image_of else (torch.as_tensor(img) if port else jnp.asarray(img))
        got.append((c.maybe_submit(img, pos, q, ids, pts, 0.1 * k, k), c.coord.ready,
                    c.coord.T.copy(), [p[0] for p in c.point_cloud], c.dropped))
    return got


@pytest.mark.parametrize("interval, delay", [(1, 1), (3, 1), (2, 0), (2, -1), (1, 3)])
def test_coupling_cadence_equals_reference(interval, delay):
    """The interval gate, the delay contract (delayIntervalMultiplier, -1 =
    synchronous) and what each submission hands the session: the frame
    quantized to uint8 (the reference's on-device quantizer), the features'
    true pixels through the camera, the odometry pose."""
    def setup(p):
        p.slam.keyframeCandidateInterval = interval
        p.slam.delayIntervalMultiplier = delay

    port, ref = _couplings(setup)
    a, b = _submit_all(port, 12, True), _submit_all(ref, 12, False)
    for (s, ready, T, cloud, drop), (rs, rready, rT, rcloud, rdrop) in zip(a, b):
        assert (s, ready, cloud, drop) == (rs, rready, rcloud, rdrop)
        np.testing.assert_allclose(T, rT, rtol=0, atol=1e-12)
    assert [x[:3] for x in port.seen] == [x[:3] for x in ref.seen]
    assert port.seen[0][1] == "float32" == ref.seen[0][1]  # the uint8 levels / 255
    for x, y in zip(port.seen, ref.seen):  # XLA fuses x * fx + cx into one rounding
        np.testing.assert_allclose(x[3], y[3], rtol=0, atol=3e-5)
    port.finish()
    ref.finish()
    np.testing.assert_allclose(port.coord.T, ref.coord.T, rtol=0, atol=1e-12)


def test_coupling_drops_candidates_past_its_backlog_as_reference():
    """With the worker thread stalled, candidates past delay + max_backlog
    are dropped and counted, then everything drains at finish."""
    def setup(p):
        p.slam.keyframeCandidateInterval = 1
        p.slam.delayIntervalMultiplier = 1

    for c, port in zip(_couplings(setup, use_thread=True), (True, False)):
        c.gate.clear()
        got = _submit_all(c, 8, port)
        assert [g[4] for g in got] == [0, 0, 0, 0, 1, 2, 3, 4]  # the 5th on is dropped
        assert [g[0] for g in got] == [True] * 4 + [False] * 4
        c.gate.set()
        c.finish()
        assert [x[0] for x in c.seen] == [0, 1, 2, 3] and c.coord.ready


def test_quantize_u8_equals_reference():
    img = np.random.RandomState(0).rand(48, 64).astype(np.float32) * 1.4 - 0.2
    ref = jax.jit(lambda x: (jnp.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8))
    np.testing.assert_array_equal(sc.quantize_u8(torch.as_tensor(img)).numpy(),
                                  np.asarray(ref(jnp.asarray(img))))


# --------------------------------------------------------------- VioApi

def _slam_params(port, dataset):
    p = (tp.api_params(Parameters, p_loader, p_jsonl, dataset) if port else
         tp.api_params(RParams, r_loader, r_jsonl, dataset))
    p.slam.useSlam = True
    p.slam.slamThread = False
    p.slam.keyframeCandidateInterval = 1
    p.slam.keyframeDecisionAlways = True
    # 8 frames move the camera ~0.3 m: triangulate from 0.5 degrees of parallax
    p.slam.minTriangulationAngleTwoObs = 0.5
    # the multi-scale keypoints are held in test_torch_slam.py and
    # test_torch_slam_textured.py (their reference build is the costliest
    # compile of the SLAM module)
    p.slam.orbExtraKeyPoints = False
    return p


@pytest.fixture(scope="module")
def vislam(tmp_path_factory):
    """Both APIs over the dataset, each finishing with its map saved
    (finish(slam_map_poses_path), as -slamMapPosesPath)."""
    d = tmp_path_factory.mktemp("vislam")
    ds = tp.make_api_dataset(str(d / "ds"), 1.0)
    tol = tp.api_tol(tp.mono_step_tol)
    diffs = []
    maps = {n: str(d / f"{n}_map.jsonl") for n in ("ref", "port")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(r_native_orb, "native_orb_available", lambda: False)
        states = tp.lockstep(mp, tol, diffs)
        ref = RVioApi(_slam_params(False, ds), tp.API_W, tp.API_H, native_sync=False)
        ref.finish = functools.partial(ref.finish, slam_map_poses_path=maps["ref"])
        r_outs, r_vos = tp.drive_api(ref, ds, FRAMES, frame=jnp.asarray)
        port = VioApi(_slam_params(True, ds), tp.API_W, tp.API_H, device="cpu")
        port.finish = functools.partial(port.finish, slam_map_poses_path=maps["port"])
        p_outs, p_vos = tp.drive_api(port, ds, FRAMES)
    return dict(ref=ref, port=port, r_outs=r_outs, r_vos=r_vos, p_outs=p_outs, p_vos=p_vos,
                diffs=diffs, tol=tol, steps=len(states), dataset=ds, maps=maps)


def test_vislam_api_equals_reference(vislam):
    from test_torch_api import _vio_output_mismatches

    run = vislam
    assert run["steps"] == len(run["p_outs"]) == len(run["r_outs"]) == FRAMES - 3
    assert not run["diffs"], run["diffs"]
    for i, (p, r) in enumerate(zip(run["p_outs"], run["r_outs"])):
        diff = tp.mismatches(p, r, run["tol"], f"output {i}")
        assert not diff, diff
    for i, (p, r) in enumerate(zip(run["p_vos"], run["r_vos"])):
        diff = _vio_output_mismatches(p, r, run["tol"], f"VioOutput {i}")
        assert not diff, diff
    ref, port = run["ref"], run["port"]
    assert port.slam.coord.ready and ref.slam.coord.ready
    assert not np.allclose(port.slam.coord.T, np.eye(4))  # the outputs were corrected
    assert (port.slam.frame_counter, port.slam.dropped) == (ref.slam.frame_counter, 0)
    # after finish, an output carries the SLAM map's points (negative ids),
    # as the reference's does
    vo, rvo = port._convert_output(port.last_frame_output), ref._convert_output(
        ref.last_frame_output)
    assert (vo.point_cloud[:, 0] < 0).any()
    diff = _vio_output_mismatches(vo, rvo, run["tol"], "VioOutput after finish")
    assert not diff, diff


def test_vislam_session_equals_reference(vislam):
    ref, port = vislam["ref"].slam.slam, vislam["port"].slam.slam
    assert len(port.kf_order) >= 3
    assert port.kf_order == ref.kf_order
    assert sorted(port.points) == sorted(ref.points)
    assert port.track_to_point == ref.track_to_point
    events = lambda s: [(e.kf_id, e.matched_kf_id, e.n_matches, e.applied) for e in s.loop_events]
    assert events(port) == events(ref)
    for k in ref.kf_order:
        np.testing.assert_allclose(port.keyframes[k].pose, ref.keyframes[k].pose, rtol=0,
                                   atol=SLAM_TOL)
        assert (port.keyframes[k].descriptors == ref.keyframes[k].descriptors).mean() > 0.99
    for pid, r in ref.points.items():
        assert port.points[pid].triangulated == r.triangulated
        np.testing.assert_allclose(port.points[pid].position, r.position, rtol=0, atol=SLAM_TOL)
    assert any(mp.triangulated for mp in port.points.values())


def test_vislam_map_file_carries_across(vislam):
    """The map each package saved (-slamMapPosesPath): the same lines, times
    and ids exactly, poses and points to SLAM_TOL, so a reader of either
    reads the other's."""
    maps = [[json.loads(l) for l in open(vislam["maps"][n])] for n in ("port", "ref")]
    assert len(maps[0]) == len(maps[1]) and sum("time" in d for d in maps[0]) >= 3
    for a, b in zip(*maps):
        assert a.keys() == b.keys()
        if "mapPoint" in b:
            assert (a["mapPoint"]["id"], a["mapPoint"]["trackId"]) == (b["mapPoint"]["id"],
                                                                       b["mapPoint"]["trackId"])
            np.testing.assert_allclose(a["mapPoint"]["position"], b["mapPoint"]["position"],
                                       rtol=0, atol=SLAM_TOL)
        else:
            assert a["time"] == b["time"]
            for key in ("position", "orientation"):
                assert a[key].keys() == b[key].keys()
                np.testing.assert_allclose(list(a[key].values()), list(b[key].values()),
                                           rtol=0, atol=SLAM_TOL)


def test_cli_use_slam_writes_the_map_and_the_slam_timer_table(vislam, tmp_path, monkeypatch):
    """-useSlam -slamMapPosesPath -timer through the port's CLI: an output
    for every step, a map line per keyframe, and the SLAM worker's
    per-keyframe table with the reference session's stage labels."""
    import re
    from pathlib import Path

    import hybvio_tpu.slam.session as r_session
    from hybvio_tpu_torch.cli.main import run
    from hybvio_tpu_torch.utils import timer

    monkeypatch.setattr(timer, "SLAM_TIME_STATS", timer.TimeStats(enabled=False))
    out, mp_path = tmp_path / "o.jsonl", tmp_path / "map.jsonl"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert run([f"-i={vislam['dataset']}", f"-o={out}", f"-slamMapPosesPath={mp_path}",
                    "-useSlam", "-slamThread=false", "-keyframeCandidateInterval=1",
                    "-keyframeDecisionAlways", "-orbExtraKeyPoints=false",
                    "-minTriangulationAngleTwoObs=0.5",
                    "-timer", f"-maxFrames={FRAMES}", *tp.API_FLAGS], device="cpu") == 0
    assert len(open(out).readlines()) == FRAMES - 3
    lines = [json.loads(l) for l in open(mp_path)]
    assert sum("time" in d for d in lines) >= 3 and any("mapPoint" in d for d in lines)
    table = err.getvalue().split("--- SLAM worker (per keyframe) ---")[1]
    labels = set(re.findall(r"ms  (.+?)  \(x\d+\)", table))
    ref_labels = set(re.findall(r'TS\.scope\("(.+?)"\)', Path(r_session.__file__).read_text()))
    assert labels == ref_labels - {"multi-scale keypoints"}
    assert set(timer.SLAM_STAGES) == ref_labels
