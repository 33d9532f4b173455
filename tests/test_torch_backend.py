"""The port's estimator against the reference, fed the same ground-truth
TrackerInput from io.synthetic's PerfectTracker (the backend's own test
pattern): imu_scan and process_frame frame by frame in float64, m and P to
1e-9, FrameOutput integer fields exactly. Plus the measurement model (the
autodiff H through GN triangulation) and the stereo idp covariance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybvio_tpu.config import DerivedParameters, Parameters
from hybvio_tpu.geometry.cameras import build_pinhole
from hybvio_tpu.io.synthetic import PerfectTracker, SYNTH_IMU_TO_CAMERA, generate_sequence
from hybvio_tpu.odometry import backend as rb
from hybvio_tpu.odometry.triangulation import triangulate_stereo_idp as r_tri_idp
from hybvio_tpu.odometry.visual_update import make_prepare_track_update as r_make_prepare
from hybvio_tpu_torch import convert
from hybvio_tpu_torch.config import DerivedParameters as PortDerived
from hybvio_tpu_torch.odometry.backend import Backend, ImuBatch, TrackerInput
from hybvio_tpu_torch.odometry.triangulation import triangulate_stereo_idp
from hybvio_tpu_torch.odometry.visual_update import make_prepare_track_update

from torch_parity import SECOND_IMU_TO_CAMERA, mismatches

torch.set_num_threads(1)

W, H, FX = 320, 240, 250.0
T = 24


def _params():
    p = Parameters()
    p.odometry.cameraTrailLength = 6
    p.tracker.maxTracks = T
    p.tracker.useStereo = True
    p.odometry.maxVisualUpdates = 8
    p.tracker.focalLength = FX
    p.tracker.principalPointX = W / 2
    p.tracker.principalPointY = H / 2
    p.odometry.imuToCameraMatrix = tuple(SYNTH_IMU_TO_CAMERA.T.flatten())
    p.odometry.secondImuToCameraMatrix = tuple(SECOND_IMU_TO_CAMERA.T.flatten())
    p.odometry.visualR = 0.3
    p.odometry.batchVisualUpdate = True
    return p


TOL = 1e-9  # float64 on both sides; m and P included


@pytest.mark.parametrize("B", [1, 2])
def test_imu_scan_and_process_frame(B):
    p = _params()
    derived = DerivedParameters.from_parameters(p)
    rcam = build_pinhole(FX, FX, W / 2, H / 2, width=W, height=H)
    seq = generate_sequence(duration=1.2, imu_rate=100.0, frame_rate=10.0,
                            gyro_noise=1e-3, acc_noise=1e-2, seed=3)
    tracker = PerfectTracker(seq, SYNTH_IMU_TO_CAMERA, rcam, W, H, max_tracks=T,
                             pixel_noise=0.3, seed=3, second_imu_to_camera=SECOND_IMU_TO_CAMERA)
    rinit, rstep = rb.make_backend(p, derived, (rcam, rcam), max_tracks=T)
    r_scan = jax.jit(jax.vmap(rstep.imu_scan))
    r_frame = jax.jit(jax.vmap(rstep.process_frame))
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B, dtype=jnp.uint32))
    rstate = jax.vmap(rinit)(keys)

    cam = convert.camera_from_jax(rcam)
    backend = Backend(p, PortDerived.from_parameters(p), (cam, cam), max_tracks=T)
    state = convert.from_jax(jax.tree.map(np.asarray, rstate), device="cpu")
    assert not mismatches(convert.to_numpy(backend.init_state(state.rng)),
                          jax.tree.map(np.asarray, rstate), 0.0)

    S = int(np.max(np.diff(np.concatenate([[0], seq.frame_sample_idx + 1]))))
    prev = 0
    n_updates = 0
    for fi in range(len(seq.frame_sample_idx)):
        k = seq.frame_sample_idx[fi] + 1
        n = k - prev
        t = np.pad(seq.times[prev:k], (0, S - n), constant_values=seq.times[k - 1])
        g = np.pad(seq.gyro[prev:k], ((0, S - n), (0, 0)))
        a = np.pad(seq.acc[prev:k], ((0, S - n), (0, 0)))
        prev = k
        rng = np.random.RandomState(fi)
        imu = (np.tile(t, (B, 1)), g[None] + 1e-4 * rng.randn(B, S, 3),
               a[None] + 1e-3 * rng.randn(B, S, 3), np.tile(np.arange(S) < n, (B, 1)))
        ids, pixels, keyframe = tracker.track(fi)
        tin = (np.tile(ids, (B, 1)), np.tile(pixels, (B, 1, 1, 1)), np.full(B, bool(keyframe)),
               np.full((B, T), -1.0))

        rstate = r_scan(rstate, rb.ImuBatch(*map(jnp.asarray, imu)))
        state = backend.imu_scan(state, ImuBatch(*map(torch.as_tensor, imu)))
        diff = mismatches(convert.to_numpy(state), jax.tree.map(np.asarray, rstate), TOL,
                          f"frame {fi} imu_scan state")
        assert not diff, diff

        rstate, rout = r_frame(rstate, rb.TrackerInput(*map(jnp.asarray, tin)))
        state, out = backend.process_frame(state, TrackerInput(*map(torch.as_tensor, tin)))
        diff = (mismatches(convert.to_numpy(state), jax.tree.map(np.asarray, rstate), TOL,
                           f"frame {fi} process_frame state")
                + mismatches(convert.to_numpy(out), jax.tree.map(np.asarray, rout), TOL,
                             f"frame {fi} FrameOutput"))
        assert not diff, diff
        n_updates += int((np.asarray(rout.point_cloud_status) == 1).sum())
        tracker.delete_tracks(np.asarray(rstate.blacklist_flags)[0],
                              np.asarray(rstate.blacklist_ids)[0])
    assert n_updates > 0  # the visual update really ran


def test_prepare_track_update_autodiff_h():
    """(H, f, y, statuses, pf) of the batched measurement model, jacfwd
    through the GN triangulation, against the reference's jax.jacfwd."""
    p = _params()
    po = p.odometry
    derived = DerivedParameters.from_parameters(p)
    d = 20 + 7 * po.cameraTrailLength
    K = po.cameraTrailLength + 1
    rprep = r_make_prepare(po, derived.imu_to_camera, derived.second_imu_to_camera, True, d)
    prep = make_prepare_track_update(
        po, torch.tensor(derived.imu_to_camera), torch.tensor(derived.second_imu_to_camera),
        True, d)
    rng = np.random.RandomState(0)
    NB = 5
    pose = np.zeros((NB, K, 7))
    pose[..., 0] = np.linspace(0, 0.6, K)[None] + 0.01 * rng.randn(NB, K)
    pose[..., 1] = 0.02 * rng.randn(NB, K)
    pose[..., 3] = 1.0
    pose[..., 4:] = 0.01 * rng.randn(NB, K, 3)
    pf = np.array([3.0, 0.3, 0.2]) + 0.2 * rng.randn(NB, 3)
    from hybvio_tpu.odometry.triangulation import camera_poses_from_states as r_cp
    ips = []
    for i2c in (derived.imu_to_camera, derived.second_imu_to_camera):
        cp = jax.vmap(lambda s: r_cp(s, jnp.asarray(i2c)))(jnp.asarray(pose))
        pc = np.einsum("bnij,bnj->bni", np.asarray(cp.R), pf[:, None] - np.asarray(cp.p))
        ips.append(pc[..., :2] / pc[..., 2:] + 1e-3 * rng.randn(NB, K, 2))
    ips = np.concatenate(ips, axis=1)
    vels = 0.01 * rng.randn(NB, 2 * K, 2)
    mask = np.ones((NB, K), bool)
    mask[1, 4:] = False
    mask[2, 2:] = False
    ref = jax.jit(jax.vmap(lambda ps, ip, v, m: rprep(ps, jnp.arange(K, dtype=jnp.int32), ip, v, m)))(
        jnp.asarray(pose), jnp.asarray(ips), jnp.asarray(vels), jnp.asarray(mask))
    out = prep(torch.as_tensor(pose), torch.as_tensor(ips), torch.as_tensor(vels),
               torch.as_tensor(mask))
    for name in ("H", "f", "y", "pf"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-8, atol=1e-9, err_msg=name)
    for name in ("row_mask", "tri_status", "prepare_status"):
        np.testing.assert_array_equal(getattr(out, name).numpy().astype(np.int64),
                                      np.asarray(getattr(ref, name)).astype(np.int64), name)
    assert (out.tri_status.numpy() == 0).sum() >= 3


def _ekf_pair(B=3, seed=0):
    """A random, well-conditioned filter state in both packages."""
    from hybvio_tpu.ekf import init_state as r_init_state

    po = _params().odometry
    rs = r_init_state(po, jnp.float64)
    rng = np.random.RandomState(seed)
    d = rs.m.shape[0]
    m = np.tile(np.asarray(rs.m), (B, 1)) + 0.1 * rng.randn(B, d)
    A = 0.05 * rng.randn(B, d, d)
    P = np.asarray(rs.P)[None] + A @ A.transpose(0, 2, 1)
    lanes = lambda a: np.tile(np.asarray(a)[None], (B,) + (1,) * np.asarray(a).ndim)
    rstate = rs._replace(m=jnp.asarray(m), P=jnp.asarray(P),
                         **{f: jnp.asarray(lanes(getattr(rs, f))) for f in rs._fields[2:]})
    rstate = rstate._replace(time=jnp.asarray([0.1, 0.5, 2.0][:B]),
                             zupt_time=jnp.asarray([-1.0, 0.4, 1.9][:B]))
    return po, rstate, convert.from_jax(jax.tree.map(np.asarray, rstate), device="cpu")


@pytest.mark.parametrize("update", ["zupt", "zupt_initialization", "pseudo_velocity", "predict"])
def test_ekf_updates_and_predict(update):
    from hybvio_tpu import ekf as rekf
    from hybvio_tpu_torch import ekf

    po, rstate, state = _ekf_pair()
    ns = po.noiseScale**2
    if update == "zupt":
        ref = jax.vmap(lambda s: rekf.update_zupt(s, po.visualZuptR, ns))(rstate)
        out = ekf.update_zupt(state, po.visualZuptR, ns)
    elif update == "zupt_initialization":
        ref = jax.vmap(lambda s: rekf.update_zupt_initialization(s, po.initZuptR, ns))(rstate)
        out = ekf.update_zupt_initialization(state, po.initZuptR, ns)
    elif update == "pseudo_velocity":
        ref = jax.vmap(lambda s: rekf.update_pseudo_velocity(s, 0.5, 0.1, ns))(rstate)
        out = ekf.update_pseudo_velocity(state, 0.5, 0.1, ns)
    else:
        t = jnp.asarray([0.0, 0.5, 2.01])  # lane 0: first sample, dt = 0
        g, a = jnp.asarray(0.3 * np.ones((3, 3))), jnp.asarray(np.tile([0.1, 0.2, 9.8], (3, 1)))
        rs = rstate._replace(got_first_sample=jnp.asarray([False, True, True]),
                             prev_sample_t=jnp.asarray([-1.0, 0.495, 2.0]))
        ref = jax.vmap(rekf.make_predict(po, jnp.float64))(rs, t, g, a)
        out = ekf.make_predict(po)(convert.from_jax(jax.tree.map(np.asarray, rs), device="cpu"),
                                   *(torch.as_tensor(np.asarray(x)) for x in (t, g, a)))
    diff = mismatches(convert.to_numpy(out), jax.tree.map(np.asarray, ref), TOL)
    assert not diff, diff


def test_augment_and_undo_per_lane_dropped_index():
    from hybvio_tpu import ekf as rekf
    from hybvio_tpu_torch import ekf

    po, rstate, state = _ekf_pair()
    dropped = np.array([0, 3, po.cameraTrailLength - 1])
    ref = jax.vmap(lambda s, k: rekf.augment_pose(s, k, po))(rstate, jnp.asarray(dropped))
    out = ekf.augment_pose(state, torch.as_tensor(dropped), po)
    assert not mismatches(convert.to_numpy(out), jax.tree.map(np.asarray, ref), TOL)
    ref = jax.vmap(lambda s: rekf.undo_augmentation(s, po.cameraTrailLength, 0))(rstate)
    out = ekf.undo_augmentation(state, po.cameraTrailLength)
    assert not mismatches(convert.to_numpy(out), jax.tree.map(np.asarray, ref), TOL)


def test_stereo_idp_with_covariance():
    rng = np.random.RandomState(1)
    s2f = np.linalg.inv(SECOND_IMU_TO_CAMERA @ np.linalg.inv(SYNTH_IMU_TO_CAMERA))
    ip0 = 0.3 * rng.randn(8, 2)
    ip1 = ip0 + np.stack([0.02 + 0.01 * rng.rand(8), 0.001 * rng.randn(8)], 1)
    ref = jax.vmap(lambda a, b: r_tri_idp(a, b, jnp.asarray(s2f)))(jnp.asarray(ip0), jnp.asarray(ip1))
    idp, cov, ok = triangulate_stereo_idp(torch.as_tensor(ip0), torch.as_tensor(ip1),
                                          torch.as_tensor(s2f))
    np.testing.assert_allclose(idp.numpy(), np.asarray(ref[0]), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(cov.numpy(), np.asarray(ref[1]), rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref[2]))
