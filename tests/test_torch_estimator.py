"""The port's estimator options against the reference (CPU, float64): the
sequential visual update (the reference default), the hybrid EKF-SLAM map in
both update forms, GAP / ALL / RANDOM track sampling, linear triangulation,
the every-N-frame and the disabled visual update.

Tolerances: the map-point insert and the trail functions bit for bit (RANDOM
draws its keys from ``random.py``, bit-exact with jax.random); the linear
triangulation to 1e-12; the measurement model's H, f, y to 1e-9 and its
statuses exactly; the per-lane gates and the Backend frame by frame (m and
P) to 1e-9, integer fields exactly. With a hybrid map the Backend's
covariances are held to MAP_COV_TOL (1e-5) and its means to MAP_TOL (1e-8)
instead: a map point's variance falls from 1e6 to a few hundred in its
first update, and that cancellation leaves the float64 rounding of
1e6-sized terms (up to 5.9e-7 in P and 4.4e-9 in m over these 8 frames,
where the cases without a map agree to 6e-11 and 3e-13). The
square-root filter's map cases compare its factor as W W^T and the mean
over the trail's used slots."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybvio_tpu import ekf as rekf
from hybvio_tpu.config import DerivedParameters, Parameters
from hybvio_tpu.geometry.cameras import build_pinhole
from hybvio_tpu.io.synthetic import PerfectTracker, SYNTH_IMU_TO_CAMERA, generate_sequence
from hybvio_tpu.odometry import backend as rb
from hybvio_tpu.odometry import trail as rtr
from hybvio_tpu.odometry.triangulation import (
    camera_poses_from_states as r_camera_poses, triangulate_linear as r_triangulate_linear,
)
from hybvio_tpu.odometry.visual_update import make_prepare_track_update as r_make_prepare
from hybvio_tpu_torch import convert, ekf
from hybvio_tpu_torch.ekf import CAM, POSE_DIM
from hybvio_tpu_torch import random as jr
from hybvio_tpu_torch.config import DerivedParameters as PortDerived
from hybvio_tpu_torch.odometry import trail as tr
from hybvio_tpu_torch.odometry.backend import Backend, ImuBatch, TrackerInput
from hybvio_tpu_torch.odometry.triangulation import CameraPoses, triangulate_linear
from hybvio_tpu_torch.odometry.visual_update import make_prepare_track_update

from torch_parity import SECOND_IMU_TO_CAMERA, mismatches

torch.set_num_threads(1)

TOL = 1e-9
W, H, FX = 320, 240, 250.0
T = 12


def _trail_pair(seed=0, B=2, K=6, Tt=10, C=2, M=4):
    """A random trail store of B lanes in both packages: tracks of random
    lengths (some slots empty, some with a stale id further back), random
    used flags, pixels and points; map slots half claimed."""
    rng = np.random.RandomState(seed)
    track_ids = np.where(rng.rand(B, Tt) < 0.8, 100 + np.arange(Tt)[None] + 10 * np.arange(B)[:, None],
                         -1).astype(np.int32)
    kf_track_id = np.full((B, K, Tt), -1, np.int32)
    for b in range(B):
        for t in range(Tt):
            n = rng.randint(0, K + 1)
            kf_track_id[b, :n, t] = track_ids[b, t]
            if n < K and rng.rand() < 0.3:
                kf_track_id[b, n:, t] = 999  # a stale id behind the track's end
    mp = np.full((B, M), -1, np.int32)
    mp[0, 1] = track_ids[0, 2]
    mp[1, :3] = 7
    f64 = lambda *s: rng.randn(*s)
    ref = rtr.TrailState(
        kf_track_id=kf_track_id, kf_norm=0.1 * f64(B, K, Tt, C, 2), kf_vel=0.01 * f64(B, K, Tt, C, 2),
        kf_pix=100 * rng.rand(B, K, Tt, 2), kf_stereo_idp=f64(B, K, Tt, 3),
        kf_stereo_cov=f64(B, K, Tt, 3, 3), kf_stereo_valid=rng.rand(B, K, Tt) < 0.5,
        kf_used=rng.rand(B, K, Tt) < 0.4, kf_frame_num=np.tile(np.arange(K, dtype=np.int32), (B, 1)),
        kf_time=np.tile(np.arange(K, dtype=np.float64), (B, 1)), frame_counter=np.zeros(B, np.int32),
        map_point_ids=mp)
    return ref, convert.from_jax(ref, device="cpu"), track_ids


def test_insert_map_point_per_lane_offsets():
    po = Parameters().odometry
    po.cameraTrailLength, po.hybridMapSize = 3, 4
    rs = rekf.init_state(po, jnp.float64)
    d = rs.m.shape[0]
    rng = np.random.RandomState(0)
    m = rng.randn(2, d)
    A = rng.randn(2, d, d)
    P = A @ A.transpose(0, 2, 1)
    offsets = np.array([d - 12, d - 3])
    pf = rng.randn(2, 3)
    ref = [rekf.insert_map_point(rs._replace(m=jnp.asarray(m[b]), P=jnp.asarray(P[b])),
                                 jnp.asarray(offsets[b]), jnp.asarray(pf[b])) for b in range(2)]
    state = convert.from_jax(jax.tree.map(lambda *x: np.stack(x), *[
        jax.tree.map(np.asarray, rs._replace(m=m[b], P=P[b])) for b in range(2)]), device="cpu")
    out = ekf.insert_map_point(state, torch.as_tensor(offsets), torch.as_tensor(pf))
    for b in range(2):
        np.testing.assert_array_equal(out.m[b].numpy(), np.asarray(ref[b].m))
        np.testing.assert_array_equal(out.P[b].numpy(), np.asarray(ref[b].P))


@pytest.mark.parametrize("sampling", ["GAP", "ALL", "RANDOM"])
def test_track_selection_scores_and_marking(sampling):
    """select_track_poses (RANDOM with per-track keys from split(sel_key,
    T)), track_scores and mark_track_used of every lane, bit for bit."""
    s = rtr.SAMPLING[sampling]
    ref, trail, ids = _trail_pair()
    B, K, Tt = ref.kf_track_id.shape
    seeds = np.array([3, 11])
    sel_keys = jax.vmap(lambda k: jax.random.split(k, Tt))(jax.vmap(jax.random.PRNGKey)(seeds))
    lane = lambda b: jax.tree.map(lambda a: jnp.asarray(a[b]), ref)
    want_sel, want_scores = [], []
    for b in range(B):
        sel, exists = jax.vmap(lambda slot, key: rtr.select_track_poses(
            lane(b), slot, jnp.asarray(ids[b]), s, key, 0.75))(jnp.arange(Tt), sel_keys[b])
        want_sel.append(np.asarray(sel))
        want_scores.append(np.asarray(rtr.track_scores(lane(b), jnp.asarray(ids[b]), s)))
    keys = jr.split(jr.prng_key(torch.as_tensor(seeds)), Tt)
    sel, exists = tr.select_track_poses(trail, torch.as_tensor(ids), s, keys, 0.75)
    np.testing.assert_array_equal(sel.numpy(), np.stack(want_sel))
    np.testing.assert_array_equal(tr.track_scores(trail, torch.as_tensor(ids), s).numpy(),
                                  np.stack(want_scores))
    if s == rtr.SAMPLING_RANDOM:  # the draw really thins some track
        assert (sel.numpy() != exists.numpy()).any()

    slots = np.array([2, 7])
    used = tr.mark_track_used(trail, torch.as_tensor(slots), sel[torch.arange(B), slots], s,
                              torch.as_tensor(ids)).kf_used
    for b in range(B):
        want = rtr.mark_track_used(lane(b), slots[b], jnp.asarray(want_sel[b][slots[b]]), s,
                                   jnp.asarray(ids[b])).kf_used
        np.testing.assert_array_equal(used[b].numpy(), np.asarray(want))


def test_offer_map_point():
    ref, trail, _ = _trail_pair(M=3)
    ref = ref._replace(map_point_ids=np.array([[-1, 5, -1], [4, 5, 6]], np.int32))
    trail = trail._replace(map_point_ids=torch.as_tensor(ref.map_point_ids))
    idx, out = tr.offer_map_point(trail, torch.as_tensor([41, 42], dtype=torch.int32))
    for b in range(2):
        r_idx, r_out = rtr.offer_map_point(jax.tree.map(lambda a: jnp.asarray(a[b]), ref), 41 + b)
        assert int(idx[b]) == int(r_idx)
        np.testing.assert_array_equal(out.map_point_ids[b].numpy(), np.asarray(r_out.map_point_ids))
    assert idx.tolist() == [0, -1]


def _poses_and_points(seed, NB, K, i2cs):
    """NB random trails of K poses along x and noisy projections of a point
    ~3 m ahead into every camera of ``i2cs`` (camera-major rows)."""
    rng = np.random.RandomState(seed)
    pose = np.zeros((NB, K, 7))
    pose[..., 0] = np.linspace(0, 0.6, K)[None] + 0.01 * rng.randn(NB, K)
    pose[..., 1] = 0.02 * rng.randn(NB, K)
    pose[..., 3] = 1.0
    pose[..., 4:] = 0.01 * rng.randn(NB, K, 3)
    pf = np.array([3.0, 0.3, 0.2]) + 0.2 * rng.randn(NB, 3)
    ips = []
    for i2c in i2cs:
        cp = jax.vmap(lambda s: r_camera_poses(s, jnp.asarray(i2c)))(jnp.asarray(pose))
        pc = np.einsum("bnij,bnj->bni", np.asarray(cp.R), pf[:, None] - np.asarray(cp.p))
        ips.append(pc[..., :2] / pc[..., 2:] + 1e-3 * rng.randn(NB, K, 2))
    return pose, pf, np.concatenate(ips, axis=1), rng


def test_triangulate_linear():
    K = 6
    pose, pf, ips, _ = _poses_and_points(4, 5, K, [SYNTH_IMU_TO_CAMERA])
    mask = np.ones((5, K), bool)
    mask[1, 3:] = False
    pose[4, :, 0] *= 0.01  # 6 mm of baseline: a poorly conditioned system
    i2c = jnp.asarray(SYNTH_IMU_TO_CAMERA)
    statuses = []
    for b in range(5):
        cp = r_camera_poses(jnp.asarray(pose[b]), i2c)
        want = r_triangulate_linear(cp, jnp.asarray(ips[b]), jnp.asarray(mask[b]))
        got_pf, got_status = triangulate_linear(
            CameraPoses(torch.tensor(np.asarray(cp.p)), torch.tensor(np.asarray(cp.R))),
            torch.as_tensor(ips[b]), torch.as_tensor(mask[b]))
        np.testing.assert_allclose(got_pf.numpy(), np.asarray(want.pf), rtol=0, atol=1e-12)
        assert int(got_status) == int(want.status)
        statuses.append(int(got_status))
    assert 0 in statuses


@pytest.mark.parametrize("form", ["hybrid", "linear"])
def test_prepare_hybrid_and_linear(form):
    """(H, f, y, statuses, pf) of the map-point form (some tracks' offsets
    in the map block, one dropped at d) and of the linear-triangulation
    form, against the reference's jax.jacfwd, stereo with the time shift."""
    p = Parameters()
    p.odometry.cameraTrailLength = 5
    p.odometry.hybridMapSize = 3
    p.odometry.useLinearTriangulation = form == "linear"
    p.odometry.imuToCameraMatrix = tuple(SYNTH_IMU_TO_CAMERA.T.flatten())
    p.odometry.secondImuToCameraMatrix = tuple(SECOND_IMU_TO_CAMERA.T.flatten())
    po = p.odometry
    derived = DerivedParameters.from_parameters(p)
    d = 20 + 7 * 5 + 3 * 3
    K = 6
    i2cs = (derived.imu_to_camera, derived.second_imu_to_camera)
    rprep = r_make_prepare(po, *i2cs, True, d)
    prep = make_prepare_track_update(po, *(torch.tensor(np.asarray(a)) for a in i2cs), True, d)
    NB = 4
    pose, pf, ips, rng = _poses_and_points(5, NB, K, i2cs)
    vels = 0.01 * rng.randn(NB, 2 * K, 2)
    mask = np.ones((NB, K), bool)
    mask[1, 4:] = False
    mask[2, 2:] = False
    trail_index = jnp.arange(K, dtype=jnp.int32)
    if form == "hybrid":
        point = pf + 0.05 * rng.randn(NB, 3)
        offset = np.array([d - 9, d - 3, d, d - 6])
        ref = jax.jit(jax.vmap(lambda ps, ip, v, m, x, o: rprep(
            ps, trail_index, ip, v, m, map_point=x, map_point_offset=o)))(
                *map(jnp.asarray, (pose, ips, vels, mask, point, offset)))
        out = prep(*map(torch.as_tensor, (pose, ips, vels, mask)), map_point=torch.as_tensor(point),
                   map_point_offset=torch.as_tensor(offset))
        assert np.abs(out.H[:, :, d - 9:].numpy()).sum(axis=(1, 2)).astype(bool).tolist() == \
            [True, True, False, True]  # map columns filled, none for the dropped offset
    else:
        ref = jax.jit(jax.vmap(lambda ps, ip, v, m: rprep(ps, trail_index, ip, v, m)))(
            *map(jnp.asarray, (pose, ips, vels, mask)))
        out = prep(*map(torch.as_tensor, (pose, ips, vels, mask)))
    for name in ("H", "f", "y", "pf"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=TOL, err_msg=name)
    for name in ("row_mask", "tri_status", "prepare_status"):
        np.testing.assert_array_equal(getattr(out, name).numpy().astype(np.int64),
                                      np.asarray(getattr(ref, name)).astype(np.int64), name)
    assert (out.tri_status.numpy() == (6 if form == "hybrid" else 0)).sum() >= 3


def test_visual_track_update_per_lane_thresholds():
    """Per-lane (B,) thresholds as the sequential update carries them: in
    lane 0 both gates are off (thresholds < 0), in lane 1 both on, on the
    same outlying track. Lane 0 updates, lane 1 rejects."""
    po = Parameters().odometry
    po.cameraTrailLength = 2
    rs = rekf.init_state(po, jnp.float64)
    d = rs.m.shape[0]
    rng = np.random.RandomState(2)
    m = np.tile(np.asarray(rs.m), (2, 1)) + 0.01 * rng.randn(2, d)
    A = 0.05 * rng.randn(d, d)
    P = np.tile(0.01 * np.eye(d) + A @ A.T, (2, 1, 1))
    n = 8
    Hm = np.tile(0.01 * rng.randn(n, d), (2, 1, 1))
    f = np.zeros((2, n))
    y = np.tile(0.5 * rng.randn(n), (2, 1))  # far outside visual_r: chi2 and rmse both reject
    mask = np.ones((2, n), bool)
    mask[:, -2:] = False
    chi_r, rmse = np.array([-1.0, 0.01]), np.array([-1.0, 0.02])
    ref = jax.vmap(lambda *a: rekf.visual_track_update(*a[:6], 0.01, 1.0, a[6], a[7]))(
        *map(jnp.asarray, (m, P, Hm, f, y, mask, chi_r, rmse)))
    out = ekf.visual_track_update(*map(torch.as_tensor, (m, P, Hm, f, y, mask)), 0.01, 1.0,
                                  torch.as_tensor(chi_r), torch.as_tensor(rmse),
                                  apply_update=torch.ones(2, dtype=torch.bool))
    for name in ("is_inlier", "rmse_ok", "chi2_ok"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)))
    for name in ("m", "P", "chi2_value"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=TOL, err_msg=name)
    assert out.is_inlier.tolist() == [True, False]
    assert out.rmse_ok.tolist() == [True, False] and out.chi2_ok.tolist() == [True, False]
    assert not np.array_equal(out.m[0].numpy(), m[0]) and np.array_equal(out.m[1].numpy(), m[1])


COV_FIELDS = ("P", "position_cov", "velocity_cov", "bias_cov_diag")
MAP_TOL, MAP_COV_TOL = 1e-8, 1e-5
BACKEND_CASES = {  # name -> the odometry parameters it sets on the stereo set-up
    "sequential": {},
    "sequential_map": {"hybridMapSize": 8},
    "batched_map": {"hybridMapSize": 8, "batchVisualUpdate": True},
    "random": {"trackSampling": "RANDOM"},
    "all": {"trackSampling": "ALL"},
    "linear": {"useLinearTriangulation": True},
    "every_2nd_frame": {"visualUpdateForEveryNFrame": 2},
    "update_disabled": {"visualUpdateEnabled": False},
    # the square-root filter's map inserts (insert_map_point, and the
    # batched update's one QR for every promoted slot)
    "sqrt_sequential_map": {"hybridMapSize": 8, "useSquareRootEkf": True},
    "sqrt_batched_map": {"hybridMapSize": 8, "batchVisualUpdate": True,
                         "useSquareRootEkf": True},
}


@pytest.mark.parametrize("case", list(BACKEND_CASES))
def test_backend_matches_reference(case):
    """imu_scan and process_frame frame by frame against make_backend, fed
    the same ground-truth TrackerInput (io.synthetic's PerfectTracker) at
    B = 2, float64: state and FrameOutput floats to 1e-9, integer fields
    (map_point_ids included) exactly. A map case must claim a map slot and
    update a map point, an updating case must update."""
    p = Parameters()
    p.odometry.cameraTrailLength = 5
    p.tracker.maxTracks = T
    p.tracker.useStereo = True
    p.odometry.maxVisualUpdates = 4
    p.tracker.focalLength = FX
    p.tracker.principalPointX = W / 2
    p.tracker.principalPointY = H / 2
    p.odometry.imuToCameraMatrix = tuple(SYNTH_IMU_TO_CAMERA.T.flatten())
    p.odometry.secondImuToCameraMatrix = tuple(SECOND_IMU_TO_CAMERA.T.flatten())
    p.odometry.visualR = 0.3
    for k, v in BACKEND_CASES[case].items():
        setattr(p.odometry, k, v)
    B = 2
    derived = DerivedParameters.from_parameters(p)
    rcam = build_pinhole(FX, FX, W / 2, H / 2, width=W, height=H)
    seq = generate_sequence(duration=0.8, imu_rate=100.0, frame_rate=10.0,
                            gyro_noise=1e-3, acc_noise=1e-2, seed=3)
    tracker = PerfectTracker(seq, SYNTH_IMU_TO_CAMERA, rcam, W, H, max_tracks=T,
                             pixel_noise=0.3, seed=3, second_imu_to_camera=SECOND_IMU_TO_CAMERA)
    rinit, rstep = rb.make_backend(p, derived, (rcam, rcam), max_tracks=T)
    r_scan = jax.jit(jax.vmap(rstep.imu_scan))
    r_frame = jax.jit(jax.vmap(rstep.process_frame))
    rstate = jax.vmap(rinit)(jax.vmap(jax.random.PRNGKey)(jnp.arange(B, dtype=jnp.uint32)))

    cam = convert.camera_from_jax(rcam)
    backend = Backend(p, PortDerived.from_parameters(p), (cam, cam), max_tracks=T)
    state = convert.from_jax(jax.tree.map(np.asarray, rstate), device="cpu")
    assert not mismatches(convert.to_numpy(backend.init_state(state.rng)),
                          jax.tree.map(np.asarray, rstate), 0.0)
    M = p.odometry.hybridMapSize
    sq = p.odometry.useSquareRootEkf

    def gram(st, out=None):
        """With the square-root filter: the factor as W W^T (its column
        signs are free) and the trail slots past augment_count zeroed in
        the mean and the output's pose trail (QR rounding noise of ~1e-80
        there, which the quaternion normalization makes an arbitrary unit
        vector in either package; nothing reads it)."""
        if not sq:
            return st if out is None else out
        L = p.odometry.cameraTrailLength
        unused = np.arange(L)[None, :] >= np.asarray(st.ekf.augment_count)[:, None]  # (B, L)
        if out is not None:
            return out._replace(pose_trail=np.where(unused[..., None], 0.0, out.pose_trail))
        m = st.ekf.m.copy()
        trail = m[:, CAM:CAM + POSE_DIM * L].reshape(-1, L, POSE_DIM)
        m[:, CAM:CAM + POSE_DIM * L] = np.where(unused[..., None], 0.0, trail).reshape(len(m), -1)
        return st._replace(ekf=st.ekf._replace(m=m, P=st.ekf.P @ np.swapaxes(st.ekf.P, 1, 2)))
    tol = lambda path: (MAP_COV_TOL if path.rsplit(".", 1)[-1] in COV_FIELDS else MAP_TOL) if M else TOL
    S = int(np.max(np.diff(np.concatenate([[0], seq.frame_sample_idx + 1]))))
    prev, statuses = 0, []
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
        rstate, rout = r_frame(rstate, rb.TrackerInput(*map(jnp.asarray, tin)))
        state, out = backend.process_frame(state, TrackerInput(*map(torch.as_tensor, tin)))
        diff = (mismatches(gram(convert.to_numpy(state)), gram(jax.tree.map(np.asarray, rstate)),
                           tol, f"frame {fi} state")
                + mismatches(gram(convert.to_numpy(state), convert.to_numpy(out)),
                             gram(jax.tree.map(np.asarray, rstate), jax.tree.map(np.asarray, rout)),
                             tol, f"frame {fi} FrameOutput"))
        assert not diff, diff
        statuses.append(np.asarray(rout.point_cloud_status))
        tracker.delete_tracks(np.asarray(rstate.blacklist_flags)[0],
                              np.asarray(rstate.blacklist_ids)[0])
    statuses = np.stack(statuses)
    if case == "update_disabled":
        assert (statuses == 0).all()
        return
    assert (statuses == 1).any()  # some track updated the filter
    if p.odometry.hybridMapSize:  # not vacuous: a slot was claimed and a map point updated
        assert (np.asarray(rstate.trail.map_point_ids) >= 0).any()
        assert (statuses == 2).any()


def test_unported_options_still_raise():
    """Every estimator option builds now: the square-root filter with its
    factor (the initial diagonal's square root; tests/test_torch_sqrt_ekf.py
    holds it to the reference) and independent stereo triangulation with the
    second-to-first camera transform its pre-triangulation uses. Around the
    estimator nothing raises any more: asked for, the native sample
    synchronizer (io/native_sync.py, which used to raise) runs under either
    option, as the reference's does."""
    from hybvio_tpu_torch.api.vio import VioApi
    from hybvio_tpu_torch.geometry.cameras import build_pinhole as port_pinhole

    cam = port_pinhole(FX, FX, W / 2, H / 2, width=W, height=H)

    def stereo_params(name):
        p = Parameters()
        p.tracker.useStereo = True
        p.odometry.secondImuToCameraMatrix = tuple(SECOND_IMU_TO_CAMERA.T.flatten())
        setattr(p.odometry, name, True)
        return p

    p = stereo_params("useSquareRootEkf")
    sq = Backend(p, PortDerived.from_parameters(p), (cam, cam), max_tracks=T)
    P = sq.init_state(jr.prng_key(torch.arange(1))).ekf.P[0]
    dense = Backend(Parameters(), PortDerived.from_parameters(Parameters()), (cam,),
                    max_tracks=T).init_state(jr.prng_key(torch.arange(1))).ekf.P[0]
    assert sq.sqrt_mode and torch.equal(P, torch.sqrt(dense[:P.shape[0], :P.shape[0]]))
    api = VioApi(p, W, H, recording_only=True, native_sync=True, device="cpu")
    assert type(api.sample_sync).__name__ == "NativeSampleSync"
    p = stereo_params("useIndependentStereoTriangulation")
    derived = PortDerived.from_parameters(p)
    backend = Backend(p, derived, (cam, cam), max_tracks=T)
    assert backend.indep_stereo
    want = (np.asarray(derived.imu_to_camera)
            @ np.linalg.inv(np.asarray(derived.second_imu_to_camera)))
    np.testing.assert_allclose(backend.second_to_first.numpy(), want, rtol=0, atol=1e-15)
