"""The port's front-end against the reference on identical inputs: LK,
detection + subpixel refinement, the epipolar check, RANSAC2/3 with the same
keys, and a whole stereo ``track_frame``.

Statuses, ids and masks must be equal. Positions are float32 on both sides
and agree to POS_TOL px: the two frameworks sum the 81..225-term window
reductions in different orders, a few f32 ulps at these pixel magnitudes,
which the LK and subpixel iterations carry along."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybvio_tpu.frontend import gftt as rgftt
from hybvio_tpu.frontend.lk import LKParams as RLKParams
from hybvio_tpu.frontend.lk import lk_track_pyramid as r_lk_track_pyramid
from hybvio_tpu.frontend.lk import precompute_prev
from hybvio_tpu.frontend.pyramid import build_pyramid as r_build_pyramid
from hybvio_tpu.frontend.ransac import ransac2 as r_ransac2
from hybvio_tpu.frontend.ransac import ransac3 as r_ransac3
from hybvio_tpu.frontend.stereo import epipolar_check as r_epipolar_check
from hybvio_tpu.frontend.tracker import make_tracker
from hybvio_tpu_torch import convert
from hybvio_tpu_torch.frontend.gftt import detect_corners, subpixel_refine
from hybvio_tpu_torch.frontend.lk import LKParams, lk_track_pyramid
from hybvio_tpu_torch.frontend.pyramid import build_pyramids_with_gradients
from hybvio_tpu_torch.frontend.ransac import ransac2, ransac3
from hybvio_tpu_torch.frontend.stereo import epipolar_check
from hybvio_tpu_torch.frontend.tracker import Tracker
from hybvio_tpu_torch.config import DerivedParameters as PortDerived

from torch_parity import mismatches, stereo_frame, tiny_sequence, tiny_stereo_setup

torch.set_num_threads(1)

POS_TOL = 2e-4  # px


@pytest.fixture(scope="module")
def scene():
    seq = tiny_sequence(4)
    return [stereo_frame(seq, fi) for fi in range(4)]


def _t(a):
    return torch.as_tensor(np.array(a))


def test_lk_track_pyramid(scene):
    prev, cur = scene[0][0], scene[2][0]
    rp = RLKParams(window_size=9, max_level=1, max_iter=8, epsilon=0.03, min_eig_threshold=1e-3)
    pyr, grads = precompute_prev(jnp.asarray(prev), rp)
    cur_pyr = r_build_pyramid(jnp.asarray(cur), 1)
    rng = np.random.RandomState(0)
    pts = np.stack([rng.uniform(4, 92, 24), rng.uniform(4, 60, 24)], 1).astype(np.float32)
    guess = (pts + rng.uniform(-1.5, 1.5, pts.shape)).astype(np.float32)
    ref_pts, ref_status, _ = jax.jit(
        lambda a, b, c, x, g: r_lk_track_pyramid(a, b, c, x, initial_pts=g, params=rp))(
        pyr, grads, cur_pyr, jnp.asarray(pts), jnp.asarray(guess))

    (tp,), tg = build_pyramids_with_gradients((_t(prev),), 1)
    tg = [tuple(g[None] for g in pair) for pair in tg]
    (tc,), _ = build_pyramids_with_gradients((_t(cur),), 1)
    out_pts, status, _ = lk_track_pyramid(
        [p[None] for p in tp], tg, [p[None] for p in tc],
        _t(pts)[None], initial_pts=_t(guess)[None], params=LKParams(*rp))
    np.testing.assert_array_equal(status[0].numpy(), np.asarray(ref_status))
    assert (np.asarray(ref_status) == 0).sum() >= 6
    np.testing.assert_allclose(out_pts[0].numpy(), np.asarray(ref_pts), rtol=0, atol=POS_TOL)


def test_detect_corners_and_subpixel(scene):
    img = scene[1][0]
    rng = np.random.RandomState(1)
    B, T = 2, 12
    existing = rng.uniform(0, 90, (B, T, 2)).astype(np.float32)
    ex_valid = rng.rand(B, T) > 0.5
    mask_r = np.array([6.0, 3.0], np.float32)
    kw = dict(min_distance=13.33, block_size=3, min_response=1e-3, n_candidates=128,
              quality_level=0.01)

    def ref_one(e, v, r):
        xy, sc, ok = rgftt.detect_corners(jnp.asarray(img), T, e, v, mask_radius=r, **kw)
        return rgftt.subpixel_refine(jnp.asarray(img), xy, window=7, iters=5, epsilon=0.03), sc, ok

    rxy, rsc, rok = jax.jit(jax.vmap(ref_one))(jnp.asarray(existing), jnp.asarray(ex_valid),
                                      jnp.asarray(mask_r))
    xy, sc, ok = detect_corners(_t(img), T, _t(existing), _t(ex_valid), mask_radius=_t(mask_r), **kw)
    xy = subpixel_refine(_t(img), xy, window=7, iters=5, epsilon=0.03)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    assert ok.sum() >= 4
    # responses are f32 eigenvalue differences with cancellation; XLA's
    # fused (jitted) form itself moves them by ~3e-6
    np.testing.assert_allclose(sc.numpy(), np.asarray(rsc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(xy.numpy(), np.asarray(rxy), rtol=0, atol=POS_TOL)


def _cams():
    p, derived, cam = tiny_stereo_setup()
    c0c1 = derived.second_imu_to_camera @ np.linalg.inv(derived.imu_to_camera)
    return cam, convert.camera_from_jax(cam), c0c1.astype(np.float32)


def test_epipolar_check():
    rcam, cam, c0c1 = _cams()
    rng = np.random.RandomState(2)
    pts0 = np.stack([rng.uniform(0, 96, 40), rng.uniform(0, 64, 40)], 1).astype(np.float32)
    pts1 = (pts0 + np.stack([rng.uniform(-12, 2, 40), rng.uniform(-4, 4, 40)], 1)).astype(np.float32)
    valid = rng.rand(40) > 0.1
    ref = r_epipolar_check(rcam, rcam, jnp.asarray(pts0), jnp.asarray(pts1), jnp.asarray(valid),
                           jnp.asarray(c0c1), 6.6667)
    out = epipolar_check(cam, cam, _t(pts0)[None], _t(pts1)[None], _t(valid)[None],
                         _t(c0c1), 6.6667)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref))
    assert 0 < int(out.sum()) < 40


def test_ransac2_same_keys():
    rcam, cam, _ = _cams()
    rng = np.random.RandomState(3)
    B, T = 3, 12
    pts1 = np.stack([rng.uniform(5, 90, (B, T)), rng.uniform(5, 60, (B, T))], -1).astype(np.float32)
    pts2 = (pts1 + [1.5, -0.5] + 0.05 * rng.randn(B, T, 2)).astype(np.float32)
    pts2[:, :3] += rng.uniform(-9, 9, (B, 3, 2)).astype(np.float32)  # outliers
    valid = rng.rand(B, T) > 0.15
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B, dtype=jnp.uint32) + 11)
    ref = jax.jit(jax.vmap(lambda a, b, v, k: r_ransac2(rcam, rcam, a, b, v, k, 2.0)))(
        jnp.asarray(pts1), jnp.asarray(pts2), jnp.asarray(valid), keys)
    out = ransac2(cam, cam, _t(pts1), _t(pts2), _t(valid),
                  convert.from_jax(np.asarray(keys), device="cpu"), 2.0, int_bits=64)
    np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_array_equal(out.inlier_count.numpy(), np.asarray(ref.inlier_count))
    np.testing.assert_allclose(out.score.numpy(), np.asarray(ref.score), rtol=1e-6)
    np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), rtol=0, atol=1e-5)


def test_ransac3_same_keys():
    rng = np.random.RandomState(4)
    B, T = 2, 16
    prev = np.stack([rng.uniform(-1, 1, (B, T)), rng.uniform(-1, 1, (B, T)),
                     rng.uniform(3, 6, (B, T))], -1).astype(np.float32)
    ang = 0.05
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    cur = (prev @ R.T + [0.05, 0.0, -0.1]).astype(np.float32)
    cur_norm = (cur[..., :2] / cur[..., 2:] + 0.001 * rng.randn(B, T, 2)).astype(np.float32)
    cur_norm[:, :2] += 0.2
    valid = rng.rand(B, T) > 0.1
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B, dtype=jnp.uint32) + 5)
    ref = jax.jit(jax.vmap(lambda a, b, c, v, k: r_ransac3(a, b, c, v, k, max_iters=64)))(
        jnp.asarray(prev), jnp.asarray(cur), jnp.asarray(cur_norm), jnp.asarray(valid), keys)
    out = ransac3(_t(prev), _t(cur), _t(cur_norm), _t(valid),
                  convert.from_jax(np.asarray(keys), device="cpu"), max_iters=64, int_bits=64)
    np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_array_equal(out.ok.numpy(), np.asarray(ref.ok))
    np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), rtol=0, atol=1e-5)


def test_track_frame_tiny_stereo(scene):
    p, derived, rcam = tiny_stereo_setup()
    rinit, rtrack = make_tracker(p, (rcam, rcam), max_tracks=12, dtype=jnp.float32,
                                 derived=derived)
    cam = convert.camera_from_jax(rcam)
    tracker = Tracker(p, (cam, cam), PortDerived.from_parameters(p), max_tracks=12, int_bits=64)
    (l0, r0), (l1, r1) = scene[0], scene[1]
    rs = jax.jit(rinit)(jnp.asarray(l0), 10.0, second_image=jnp.asarray(r0))
    ts = tracker.init_state(_t(l0), torch.tensor([10.0], dtype=torch.float64), _t(r0))
    init_diff = mismatches(convert.to_numpy(ts), jax.tree.map(lambda a: np.asarray(a)[None], rs),
                           POS_TOL)
    assert not init_diff, init_diff

    key = jax.random.PRNGKey(7)
    rng = np.random.RandomState(5)
    guess = (np.asarray(rs.px[:, 0]) + rng.uniform(-1, 1, (12, 2))).astype(np.float32)
    sguess = (np.asarray(rs.px[:, 1]) + rng.uniform(-1, 1, (12, 2))).astype(np.float32)
    bl = np.zeros(12, bool)
    bl[3] = True
    bl_ids = np.asarray(rs.track_ids)
    rs2, rout = jax.jit(rtrack)(rs, jnp.asarray(l1), key, 10.05, flow_guess=jnp.asarray(guess),
                       blacklist_flags=jnp.asarray(bl), blacklist_ids=jnp.asarray(bl_ids),
                       second_image=jnp.asarray(r1), stereo_guess=jnp.asarray(sguess))
    ts2, tout = tracker.track_frame(
        ts, _t(l1), convert.from_jax(np.asarray(key), device="cpu")[None], torch.tensor([10.05]),
        flow_guess=_t(guess)[None], blacklist_flags=_t(bl)[None], blacklist_ids=_t(bl_ids)[None],
        second_image=_t(r1), stereo_guess=_t(sguess)[None])
    lift = lambda tree: jax.tree.map(lambda a: np.asarray(a)[None], tree)
    diff = (mismatches(convert.to_numpy(ts2), lift(rs2), POS_TOL, "state")
            + mismatches(convert.to_numpy(tout), lift(rout), POS_TOL, "out"))
    assert not diff, diff
    assert int((np.asarray(rout.track_ids) >= 0).sum()) >= 4
