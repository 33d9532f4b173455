"""The port's VioApi (CPU, float64 filter) against the reference's
VioApi(native_sync=False) (x64) on blobs datasets at 320x240 with
tests/test_api_cli.py's reduced tracker sizes, mono over 8 frames and stereo
over 6.

Both APIs are fed the same events. Each frame step of the port starts from
the reference's state at the same point (the way torch_parity's whole-step
tests step both packages from one state): the port's own state before each
step, and every field of every retired output and VioOutput, must equal the
reference's, statuses, times and ids exactly, floats to
torch_parity.mono_step_tol (mono) / step_tol (stereo) with the pixel bounds
scaled to the frame (api_tol). Run on its own, the port follows the
reference with every integer field exact; its positions part by ~1e-4 m at
the first visual update, where the float32 front end's few-ulp pixel
differences meet a short-baseline triangulation.

Also: pipeline depth 0 equals depth 1, the worker thread equals the
inline run, uint8 frames equal their float32 / 255 frames, chunked 800 Hz
IMU leads equal one wide batch, outputCameraPose, the state surgery
of the API (reset keeping the pose or not, lock_biases,
condition_on_last_pose) equals the reference's, the bounded IMU scan equals
the full one, the eight status-machine rows of tests/test_status_machine.py,
and recordingOnly."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import torch_parity as tp
from hybvio_tpu.api.vio import VioApi as RVioApi
from hybvio_tpu.config import Parameters as RParams
from hybvio_tpu.config import loader as r_loader
from hybvio_tpu.io import jsonl as r_jsonl
from hybvio_tpu_torch import convert
from hybvio_tpu_torch.api.vio import VioApi
from hybvio_tpu_torch.config import Parameters
from hybvio_tpu_torch.config import loader as p_loader
from hybvio_tpu_torch.io import jsonl as p_jsonl

torch.set_num_threads(1)

MONO_FRAMES, STEREO_FRAMES = 8, 6


def _params(port, dataset, stereo=False):
    if port:
        return tp.api_params(Parameters, p_loader, p_jsonl, dataset, stereo)
    return tp.api_params(RParams, r_loader, r_jsonl, dataset, stereo)


def _lockstep(dataset, n_frames, stereo, base_tol):
    tol = tp.api_tol(base_tol)
    diffs = []
    with pytest.MonkeyPatch.context() as mp:
        states = tp.lockstep(mp, tol, diffs)
        ref = RVioApi(_params(False, dataset, stereo), tp.API_W, tp.API_H, native_sync=False)
        r_outs, r_vos = tp.drive_api(ref, dataset, n_frames, stereo)
        port = VioApi(_params(True, dataset, stereo), tp.API_W, tp.API_H, device="cpu")
        p_outs, p_vos = tp.drive_api(port, dataset, n_frames, stereo)
    return dict(ref=ref, port=port, r_outs=r_outs, r_vos=r_vos, p_outs=p_outs, p_vos=p_vos,
                diffs=diffs, tol=tol, steps=len(states))


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    ds = tp.make_api_dataset(str(tmp_path_factory.mktemp("api_mono")), 1.0)
    run = _lockstep(ds, MONO_FRAMES, False, tp.mono_step_tol)
    run["dataset"] = ds
    return run


@pytest.fixture(scope="module")
def stereo(tmp_path_factory):
    ds = tp.make_api_dataset(str(tmp_path_factory.mktemp("api_stereo")), 0.8, stereo=True)
    return _lockstep(ds, STEREO_FRAMES, True, tp.step_tol)


@pytest.fixture(scope="module")
def mono_alone(mono):
    """The port on its own over the mono dataset, depth 1, float32 frames."""
    api = VioApi(_params(True, mono["dataset"]), tp.API_W, tp.API_H, device="cpu")
    return tp.drive_api(api, mono["dataset"], MONO_FRAMES)


VIO_FIELD = {"position": "position", "orientation": "orientation", "velocity": "velocity",
             "position_covariance": "position_cov", "velocity_covariance": "velocity_cov",
             "bias_covariance_diagonal": "bias_cov_diag", "pose_trail": "pose_trail",
             "bias_gyro": "bias_gyro", "bias_acc": "bias_acc", "point_cloud": "point_cloud"}


def _vio_output_mismatches(p, r, tol, path):
    out = []
    for f in dataclasses.fields(r):
        a, b = getattr(p, f.name), getattr(r, f.name)
        if f.name in ("status", "t", "stationary_visual"):
            if a != b:
                out.append((f"{path}.{f.name}", f"{a} != {b}"))
        elif f.name == "point_cloud":
            if a.shape != b.shape or not np.array_equal(a[:, 0], b[:, 0]):
                out.append((f"{path}.point_cloud", "ids differ"))
            else:
                out += tp.mismatches(a[:, 1:], b[:, 1:], tol, f"{path}.point_cloud")
        else:
            out += tp.mismatches(a, b, tol, f"{path}.{VIO_FIELD[f.name]}")
    return out


@pytest.mark.parametrize("which", ["mono", "stereo"])
def test_api_equals_reference_frame_by_frame(which, request):
    run = request.getfixturevalue(which)
    n = MONO_FRAMES if which == "mono" else STEREO_FRAMES
    # the synchronizer holds the last two frames back, the first initializes
    assert run["steps"] == len(run["p_outs"]) == len(run["r_outs"]) == n - 3
    assert not run["diffs"], run["diffs"]
    tol = run["tol"]
    for i, (p, r) in enumerate(zip(run["p_outs"], run["r_outs"])):
        diff = tp.mismatches(p, r, tol, f"output {i}")
        assert not diff, diff
    assert len(run["p_vos"]) == len(run["r_vos"])
    for i, (p, r) in enumerate(zip(run["p_vos"], run["r_vos"])):
        diff = _vio_output_mismatches(p, r, tol, f"VioOutput {i}")
        assert not diff, diff
        assert json.loads(p.as_json(True)).keys() == json.loads(r.as_json(True)).keys()
    tracked = sum(int((o.track_ids >= 0).sum()) for o in run["p_outs"])
    assert tracked > 10 * len(run["p_outs"])


def test_api_alone_follows_reference(mono, mono_alone):
    """Without the reference's state: every integer field exact, positions
    within 1e-3 m (they part by ~1e-4 m at the first visual update)."""
    outs, _ = mono_alone
    assert len(outs) == len(mono["r_outs"])
    for i, (p, r) in enumerate(zip(outs, mono["r_outs"])):
        diff = tp.mismatches(p, r, lambda path: np.inf, f"output {i}")
        assert not diff, diff
        np.testing.assert_allclose(p.position, r.position, rtol=0, atol=1e-3)


def _equal_outputs(a, b):
    assert len(a) == len(b) > 0
    for i, (p, r) in enumerate(zip(a, b)):
        diff = tp.mismatches(p, r, 0.0, f"output {i}")
        assert not diff, diff


def test_pipeline_depth_0_equals_depth_1(mono, mono_alone, monkeypatch):
    monkeypatch.setenv("HYBVIO_PIPELINE_DEPTH", "0")
    api = VioApi(_params(True, mono["dataset"]), tp.API_W, tp.API_H, device="cpu")
    assert api._pipeline_depth == 0
    _equal_outputs(tp.drive_api(api, mono["dataset"], MONO_FRAMES)[0], mono_alone[0])


def test_uint8_frames_equal_float32_frames(mono, mono_alone):
    """The dataset's frames are uint8 levels / 255: fed as uint8 they give
    the same outputs (the step normalizes them on the device)."""
    api = VioApi(_params(True, mono["dataset"]), tp.API_W, tp.API_H, device="cpu")
    outs, _ = tp.drive_api(api, mono["dataset"], MONO_FRAMES, frame=tp.to_uint8)
    assert api._u8_pool.pool and api._gray_pool.pool == []
    _equal_outputs(outs, mono_alone[0])


def test_worker_thread_equals_inline(mono, mono_alone):
    """processingQueueSize > 0: the frames run on the odometry worker
    thread (reference: controlProcessingQueue) with the same outputs."""
    p = _params(True, mono["dataset"])
    p.odometry.processingQueueSize = 3
    api = VioApi(p, tp.API_W, tp.API_H, device="cpu")
    assert api._worker is not None
    outs, _ = tp.drive_api(api, mono["dataset"], 6)
    assert len(outs) == 3
    _equal_outputs(outs, mono_alone[0][:3])


def test_state_surgery_equals_reference(mono):
    """From one state (the reference's at the end of the run): lock_biases,
    condition_on_last_pose, reset keeping the pose and a fresh reset give
    the reference's filter state."""
    ref, port = mono["ref"], mono["port"]
    port._state = convert.from_jax(jax.tree.map(lambda a: np.asarray(a)[None], ref._state),
                                   device="cpu")
    ops = (("lock_biases", lambda api: api.lock_biases()),
           ("condition_on_last_pose", lambda api: api.condition_on_last_pose()),
           ("reset keeping the pose", lambda api: api.reset(keep_pose=True, t=11.0)),
           ("fresh reset", lambda api: api.reset(keep_pose=False, t=12.0)))
    for name, op in ops:
        op(ref)
        op(port)
        want = jax.tree.map(lambda a: np.asarray(a)[None], ref._state.backend)
        got = convert.to_numpy(port._state.backend)
        diff = tp.mismatches(got, want, lambda path: 1e-9, name)
        assert not diff, diff
        assert port._last_reset_time == ref._last_reset_time


def test_camera_pose_output_equals_reference(mono):
    """outputCameraPose: the first camera's pose in place of the IMU's, from
    one retired output."""
    from hybvio_tpu.config import DerivedParameters as RDerived
    from hybvio_tpu_torch.config import DerivedParameters

    out = mono["r_outs"][-1]
    got = []
    for api, D in ((mono["port"], DerivedParameters), (mono["ref"], RDerived)):
        api.params.odometry.outputCameraPose = True
        api.derived = D.from_parameters(api.params)
        got.append(api._convert_output(out))
    p, r = got
    assert not np.allclose(p.orientation, out.orientation)
    np.testing.assert_allclose(p.position, r.position, rtol=0, atol=1e-12)
    np.testing.assert_allclose(p.orientation, r.orientation, rtol=0, atol=1e-12)


# ------------------------------------------------------------- the IMU batch

def _imu_params(W=160, H=120):
    from hybvio_tpu_torch.io.synthetic import SYNTH_IMU_TO_CAMERA

    p = Parameters()
    p.odometry.cameraTrailLength = 6
    p.tracker.maxTracks = 24
    p.tracker.focalLength = 130.0
    p.tracker.principalPointX = W / 2
    p.tracker.principalPointY = H / 2
    p.tracker.pyrLKWindowSize = 11
    p.tracker.pyrLKMaxLevel = 1
    p.tracker.gfttMinDistance = 18.0
    p.odometry.imuToCameraMatrix = tuple(SYNTH_IMU_TO_CAMERA.T.flatten())
    p.odometry.visualR = 0.3
    return p


def test_800hz_imu_chunked_equals_wide():
    """tests/test_imu_chunking.py's scenario on the port: 800 Hz IMU at 10
    FPS is 80 samples a frame; with S = 64 the lead rides an IMU-only step,
    and the outputs equal those of one 96-wide batch a frame."""
    from hybvio_tpu_torch.io.synthetic import SYNTH_IMU_TO_CAMERA, generate_sequence, render_view

    W, H, n_frames = 160, 120, 6
    seq = generate_sequence(duration=2.0, imu_rate=800.0, frame_rate=10.0, n_landmarks=200,
                            seed=3)
    runs = []
    for S in (64, 96):
        api = VioApi(_imu_params(), W, H, max_imu_per_frame=S, device="cpu")
        chunks = [0]
        imu_only = api._vio.imu_only
        api._vio.imu_only = lambda *a: chunks.__setitem__(0, chunks[0] + 1) or imu_only(*a)
        outs = []
        api.on_output = outs.append
        frame_set = set(seq.frame_sample_idx[:n_frames].tolist())
        for k in range(seq.frame_sample_idx[n_frames - 1] + 1):
            api.add_gyro(seq.times[k], seq.gyro[k])
            api.add_acc(seq.times[k], seq.acc[k])
            if k in frame_set:
                api.add_frame_mono(seq.times[k], render_view(
                    seq.landmarks, seq.pos[k], seq.quat[k], SYNTH_IMU_TO_CAMERA, 130.0, 130.0,
                    W / 2, H / 2, W, H, blob_sigma=1.2))
        api.finish()
        runs.append((outs, chunks[0]))
    (chunked, n_chunked), (wide, n_wide) = runs
    assert n_chunked == 2 * n_wide > 0  # a lead chunk before every frame step
    assert len(chunked) == len(wide) > 0
    pos_c = np.stack([o.position for o in chunked])
    assert np.isfinite(pos_c).all()
    np.testing.assert_allclose(pos_c, np.stack([o.position for o in wide]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.stack([o.velocity for o in chunked]),
                               np.stack([o.velocity for o in wide]), rtol=0, atol=1e-12)


def test_bounded_imu_scan_equals_full():
    """Backend.imu_scan over the valid columns alone (n_valid) equals the
    scan over all S columns, whatever the invalid columns hold."""
    from hybvio_tpu_torch import random as jr
    from hybvio_tpu_torch.odometry.backend import ImuBatch

    api = VioApi(_imu_params(), 160, 120, device="cpu")
    backend = api._vio.backend
    rng = np.random.RandomState(0)
    state = backend.init_state(jr.prng_key(torch.arange(2)))
    S, n = 16, 9
    for first in (True, False):  # before and after the orientation is initialized
        t = torch.as_tensor(10.0 + 0.005 * np.arange(S))[None].repeat(2, 1)
        gyro = torch.as_tensor(0.1 * rng.randn(2, S, 3))
        acc = torch.as_tensor(rng.randn(2, S, 3) + [0.0, 0.0, 9.8])
        valid = torch.arange(S)[None].repeat(2, 1) < n
        batch = ImuBatch(t, gyro, acc, valid)
        full = backend.imu_scan(state, batch)
        bounded = backend.imu_scan(state, batch, n_valid=n)
        for name, a, b in zip(full._fields, full, bounded):
            for x, y in zip(jax.tree.leaves(convert.to_numpy(a)), jax.tree.leaves(convert.to_numpy(b))):
                np.testing.assert_array_equal(x, y, err_msg=name)
        assert bool(full.orientation_initialized.all())
        state = full


# ------------------------------------------------------- the status machine

@dataclasses.dataclass
class _Out:
    tracking_status: int
    t: float


RESET_T = 3.0  # default resetAfterTrackingFailsToInitialize

# tests/test_status_machine.py's rows: (odometry settings, (status, t) fed
# in order, resets expected, latched status at the end)
STATUS_ROWS = {
    "init_timer_expired_resets_fresh": (
        {"resetUntilInitSucceeds": True}, [(0, RESET_T + 1.0)], [(False, RESET_T + 1.0)], 0),
    "init_timer_not_expired_no_reset": (
        {"resetUntilInitSucceeds": True}, [(0, RESET_T - 1.0)], [], 0),
    "init_without_flag_no_reset": (
        {"resetUntilInitSucceeds": False}, [(0, RESET_T + 1.0)], [], 0),
    "lost_with_reset_on_failed_keeps_pose": (
        {"resetOnFailedTracking": True}, [(2, 1.0)], [(True, 1.0)], 2),
    "lost_without_flag_only_latches": (
        {"resetOnFailedTracking": False}, [(2, 1.0)], [], 2),
    "status_never_demotes_to_init": ({}, [(1, 1.0), (0, 2.0)], [], 1),
    "tracking_then_session_init_timer_expired_resets_keep_pose": (
        {}, [(1, 1.0), (0, RESET_T + 1.5)], [(True, RESET_T + 1.5)], 1),
    "lost_priority_over_timed_reinit": (
        {"resetOnFailedTracking": True}, [(2, RESET_T + 2.0)], [(True, RESET_T + 2.0)], 2),
}


@pytest.mark.parametrize("row", sorted(STATUS_ROWS))
def test_status_machine_row(row):
    odo, feed, resets, status = STATUS_ROWS[row]
    p = Parameters()
    for k, v in odo.items():
        setattr(p.odometry, k, v)
    api = VioApi(p, 64, 48, recording_only=True, device="cpu")
    calls = []
    api.reset = lambda keep_pose=False, t=None: calls.append((keep_pose, t))
    for s, t in feed:
        api._handle_status_and_reset(_Out(s, t))
    assert calls == resets
    assert api._status == status


def test_recording_only_records_without_running(tmp_path):
    p = Parameters()
    p.slam.useSlam = True  # never built when only recording
    api = VioApi(p, 64, 48, recording_only=True, device="cpu")
    assert api._vio is None
    api.recorder = p_jsonl.Recorder(str(tmp_path), save_frames=True)
    outputs = []
    api.on_output = outputs.append
    img = np.random.RandomState(0).rand(48, 64).astype(np.float32)
    for k in range(10):
        t = 0.01 * k
        api.add_gyro(t, [0.0, 0.0, 0.1])
        api.add_acc(t, [0.0, 0.0, 9.81])
        if k % 5 == 0:
            api.add_frame_mono(t, img)
    api.finish()
    assert outputs == [] and api._state is None
    assert api.sample_sync.poll_synced_sample() is None
    lines = open(tmp_path / "data.jsonl").read().splitlines()
    assert len(lines) == 22 and sum("sensor" in json.loads(l) for l in lines) == 20
    slam_api = VioApi(p, 64, 48, device="cpu")  # the SLAM session is ported
    assert slam_api.slam is not None and slam_api.slam.device.type == "cpu"
    slam_api.finish()
    # GPS echoes land in the pose history, metres east / north / up of the
    # first fix (utils/gps.py), as the reference's do
    ref_api = RVioApi(RParams(), 64, 48, recording_only=True, native_sync=False)
    for a in (api, ref_api):
        for t, lat, lon, alt in ((0.0, 60.0, 24.0, 10.0), (1.0, 60.001, 24.002, 12.5)):
            a.add_echo({"time": t, "gps": {"latitude": lat, "longitude": lon, "altitude": alt}})
    gps = np.asarray(api.pose_histories["gps"])
    np.testing.assert_array_equal(gps, np.asarray(ref_api.pose_histories["gps"]))
    assert np.allclose(gps[0, 1:], 0.0) and 100.0 < gps[1, 1] < 120.0 and gps[1, 3] == 2.5
    with pytest.raises(NotImplementedError, match="odometry/debug.py"):
        api.debug_api = object()
    with pytest.raises(NotImplementedError, match="visualizations"):
        api.set_visualization("TRACKS")
    with pytest.raises(NotImplementedError, match="native_sync"):
        VioApi(Parameters(), 64, 48, recording_only=True, native_sync=True, device="cpu")
