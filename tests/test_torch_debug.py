"""The port's debug publisher (odometry/debug.py, VioApi.debug_api) and the
exported helpers the slice adds, against the reference's, on the CPU:

- a RecordingPublisher through VioApi over the mono blobs dataset (320x240,
  8 frames), each frame step of the port from the reference's state
  (torch_parity.lockstep): the same frames, visual updates and successful
  updates (times and track ids), triangulations and point clouds within
  PUBLISH_TOL; a session with a publisher retires each frame in the call
  that steps it;
- ekf/update.py update_zrupt, update_position, update_zero_height and
  update_orientation (dense and square-root, two lanes), ekf/state.py
  trail_pose_slice and state_as_string, eval/ate.py rpe_rmse,
  geometry/poses.py to_odometry_pose and geometry/quaternion.py
  remove_z_tilt_rmat, each against the reference's function on the same
  float64 inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from hybvio_tpu.api.vio import VioApi as RVioApi
from hybvio_tpu.config import Parameters as RParams
from hybvio_tpu.config import loader as r_loader
from hybvio_tpu.ekf import state as r_state
from hybvio_tpu.ekf import update as r_update
from hybvio_tpu.eval import ate as r_ate
from hybvio_tpu.geometry import poses as r_poses
from hybvio_tpu.geometry import quaternion as r_quat
from hybvio_tpu.io import jsonl as r_jsonl
from hybvio_tpu.odometry import debug as r_debug
from hybvio_tpu_torch.api.vio import VioApi
from hybvio_tpu_torch.config import Parameters
from hybvio_tpu_torch.config import loader as p_loader
from hybvio_tpu_torch.ekf import EKFState
from hybvio_tpu_torch.ekf import state as p_state
from hybvio_tpu_torch.ekf import update as p_update
from hybvio_tpu_torch.eval import ate as p_ate
from hybvio_tpu_torch.geometry import poses as p_poses
from hybvio_tpu_torch.geometry import quaternion as p_quat
from hybvio_tpu_torch.io import jsonl as p_jsonl
from hybvio_tpu_torch.odometry import debug as p_debug

torch.set_num_threads(1)

FRAMES = 8
# m: the triangulated points and clouds, each step from one state. One
# camera's few-centimetre baselines magnify the float32 front end's few-ulp
# pixel differences (torch_parity.MONO_POINT_TOL; at most 2.8e-5 m here)
PUBLISH_TOL = tp.MONO_POINT_TOL
FN_TOL = 1e-12  # the helpers, float64 on both sides


# ------------------------------------------------------------ the publisher

@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """Both APIs over the dataset with a RecordingPublisher, the port
    stepped from the reference's state."""
    ds = tp.make_api_dataset(str(tmp_path_factory.mktemp("debug")), 1.0)
    tol = tp.api_tol(tp.mono_step_tol)
    diffs = []
    with pytest.MonkeyPatch.context() as mp:
        states = tp.lockstep(mp, tol, diffs)
        ref = RVioApi(tp.api_params(RParams, r_loader, r_jsonl, ds), tp.API_W, tp.API_H,
                      native_sync=False)
        ref.debug_api = r_debug.DebugAPI(r_debug.RecordingPublisher())
        r_outs, _ = tp.drive_api(ref, ds, FRAMES)
        port = VioApi(tp.api_params(Parameters, p_loader, p_jsonl, ds), tp.API_W, tp.API_H,
                      device="cpu")
        port.debug_api = p_debug.DebugAPI(p_debug.RecordingPublisher())
        in_flight = []
        process = port._process_frame

        def counted(synced):  # the frames still in flight after each frame's call
            process(synced)
            in_flight.append(len(port._inflight))

        port._process_frame = counted
        p_outs, _ = tp.drive_api(port, ds, FRAMES)
    return dict(ref=ref.debug_api.publisher, port=port.debug_api.publisher, r_outs=r_outs,
                p_outs=p_outs, diffs=diffs, steps=len(states), in_flight=in_flight)


def test_recording_publisher_equals_reference(published):
    ref, port = published["ref"], published["port"]
    assert published["steps"] == FRAMES - 3 and not published["diffs"]
    assert port.frames == ref.frames and len(port.frames) == len(published["p_outs"]) > 0
    assert port.visual_updates == ref.visual_updates and port.visual_updates
    assert port.successful_updates == ref.successful_updates
    assert len(port.triangulations) == len(ref.triangulations) > 0
    tri_p, tri_r = np.stack(port.triangulations), np.stack(ref.triangulations)
    np.testing.assert_allclose(tri_p, tri_r, rtol=0, atol=PUBLISH_TOL)
    assert [c.shape for c in port.point_clouds] == [c.shape for c in ref.point_clouds]
    for a, b in zip(port.point_clouds, ref.point_clouds):
        np.testing.assert_allclose(a, b, rtol=0, atol=PUBLISH_TOL)


def test_publisher_counts_follow_the_outputs(published):
    """Depth 0 with a publisher: no frame in flight after a step; one
    published frame per retired output, one visual update per cloud id."""
    port, outs = published["port"], published["p_outs"]
    assert published["in_flight"] and not any(published["in_flight"])
    assert port.frames == [float(o.t) for o in outs]
    assert len(port.visual_updates) == sum(int((o.point_cloud_ids >= 0).sum()) for o in outs)


def test_publisher_base_class_is_a_no_op():
    pub = p_debug.DebugPublisher()
    for call in (lambda: pub.start_frame(0.0, None),
                 lambda: pub.add_sample(0.0, (0,) * 3, (0,) * 3),
                 lambda: pub.start_visual_update(0.0, 1, None),
                 lambda: pub.push_triangulation_point(np.zeros(3)),
                 lambda: pub.finish_successful_visual_update(0.0, 1),
                 lambda: pub.add_point_cloud(np.zeros((0, 3)))):
        assert call() is None
    api = p_debug.DebugAPI(end_callback=print)
    assert api.publisher is None and api.end_debug_callback is print


# -------------------------------------------------------------- the helpers

def _states(sqrt_mode, seed=0, L=3):
    """Two lanes of a random filter state (port, batch-first) and each lane
    as the reference's EKFState."""
    rng = np.random.RandomState(seed)
    po = Parameters().odometry
    po.cameraTrailLength = L
    d = p_state.state_dim(L, 0)
    ms, Ps = [], []
    for _ in range(2):
        m = rng.randn(d)
        for o in [p_state.ORI] + [p_state.CAM + p_state.POSE_DIM * i + 3 for i in range(L)]:
            m[o:o + 4] /= np.linalg.norm(m[o:o + 4])
        A = rng.randn(d, d) * 0.1
        P = A @ A.T + 0.01 * np.eye(d)
        ms.append(m)
        Ps.append(np.linalg.cholesky(P) if sqrt_mode else P)
    port = p_state.init_state(po, 2, device="cpu", sqrt_mode=sqrt_mode)
    port = port._replace(m=torch.tensor(np.stack(ms)), P=torch.tensor(np.stack(Ps)),
                         time=torch.tensor([1.0, 0.1], dtype=torch.float64),
                         zrupt_time=torch.tensor([0.5, 0.0], dtype=torch.float64))
    refs = [r_state.init_state(po, dtype=jnp.float64, sqrt_mode=sqrt_mode)._replace(
        m=jnp.asarray(ms[b]), P=jnp.asarray(Ps[b]), time=jnp.asarray([1.0, 0.1][b]),
        zrupt_time=jnp.asarray([0.5, 0.0][b])) for b in range(2)]
    return port, refs, L


def _same_state(port: EKFState, refs, sqrt_mode):
    for b, r in enumerate(refs):
        for name in EKFState._fields:
            a, w = getattr(port, name)[b].numpy(), np.asarray(getattr(r, name))
            if name == "P" and sqrt_mode:  # the factor's column signs are free
                a, w = a @ a.T, w @ w.T
            np.testing.assert_allclose(a, w, rtol=0, atol=FN_TOL, err_msg=f"lane {b} {name}")


Q_MEAS = np.array([0.9, 0.1, -0.3, 0.2]) / np.linalg.norm([0.9, 0.1, -0.3, 0.2])
UPDATES = {  # name -> fn(module, state, sqrt_mode, L, array of the package)
    "zrupt": lambda m, s, sq, L, a: m.update_zrupt(s, a([0.01, -0.02, 0.03]), 1e-4, 2.0, sq),
    "position": lambda m, s, sq, L, a: m.update_position(s, a([0.5, -1.0, 2.0]), 1e-3, 2.0, sq),
    "zero_height": lambda m, s, sq, L, a: m.update_zero_height(s, 1e-3, 2.0, sq),
    "orientation": lambda m, s, sq, L, a: m.update_orientation(s, a(Q_MEAS), 1e-2, 2.0, L, sq),
}


@pytest.mark.parametrize("sqrt_mode", [False, True], ids=["dense", "sqrt"])
@pytest.mark.parametrize("name", list(UPDATES))
def test_measurement_update_equals_reference(name, sqrt_mode):
    port, refs, L = _states(sqrt_mode, seed=len(name))
    fn = UPDATES[name]
    got = fn(p_update, port, sqrt_mode, L, lambda v: torch.tensor(v, dtype=torch.float64))
    want = [fn(r_update, r, sqrt_mode, L, lambda v: jnp.asarray(v, jnp.float64)) for r in refs]
    if name == "zrupt":  # lane 1 is inside the 0.25 s rate limit: unchanged
        assert torch.equal(got.m[1], port.m[1]) and not torch.equal(got.m[0], port.m[0])
    _same_state(got, want, sqrt_mode)


def test_state_helpers_equal_reference():
    port, refs, L = _states(False)
    for i in range(L):
        assert p_state.trail_pose_slice(i) == r_state.trail_pose_slice(i)
    for b in range(2):
        assert p_state.state_as_string(port, b) == r_state.state_as_string(refs[b])
    assert p_state.STATE_PART_SIZES == r_state.STATE_PART_SIZES


def test_trajectory_and_pose_helpers_equal_reference():
    rng = np.random.RandomState(7)
    est, gt = rng.randn(40, 3).cumsum(0), rng.randn(40, 3).cumsum(0)
    for delta in (1, 5):
        assert p_ate.rpe_rmse(est, gt, delta) == r_ate.rpe_rmse(est, gt, delta)
    q = rng.randn(6, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    p = rng.randn(6, 3)
    i2c = np.eye(4)
    i2c[:3, :3] = np.asarray(r_quat.quat_to_rmat(jnp.asarray(q[0])))
    i2c[:3, 3] = [0.1, -0.05, 0.02]
    w2c = p_poses.to_world_to_camera(torch.tensor(p), torch.tensor(q), torch.tensor(i2c))
    pos, quat = p_poses.to_odometry_pose(w2c, torch.tensor(i2c))
    rpos, rquat = r_poses.to_odometry_pose(jnp.asarray(w2c.numpy()), jnp.asarray(i2c))
    np.testing.assert_allclose(pos.numpy(), np.asarray(rpos), rtol=0, atol=FN_TOL)
    np.testing.assert_allclose(quat.numpy(), np.asarray(rquat), rtol=0, atol=FN_TOL)
    np.testing.assert_allclose(pos.numpy(), p, rtol=0, atol=1e-9)  # the round trip
    R = p_quat.quat_to_rmat(torch.tensor(q))
    np.testing.assert_allclose(p_quat.remove_z_tilt_rmat(R).numpy(),
                               np.asarray(r_quat.remove_z_tilt_rmat(jnp.asarray(R.numpy()))),
                               rtol=0, atol=FN_TOL)
    assert jax.config.jax_enable_x64
