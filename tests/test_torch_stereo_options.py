"""The stereo options' modules of the port against the reference, module by
module on identical numpy inputs from a seed: the distorted and rotated
pinhole, stereo rectification and the remap, SAD disparity and depth,
upright-2P, the stereo triangulations (idp with its covariance, and the
information-weighted fusion inside the visual update's prepare), FAST.

Tolerances: camera maps in float64 to 1e-12 (pixels) / 1e-14 (rays), the
undistortion round trip to 1e-9 px at EuRoC's k1 = -0.283 out to the image
corners (r ~ 0.97), the projection Jacobian to 1e-9; the rectified cameras'
rotations and Q to float32 rounding (4e-7, the reference builds them in
float32), the float32 remap to 5e-5 px (XLA contracts the rotation's
products into FMAs, a few ulp of ~100 px) and the resampled image to 5e-5;
disparity equal on every pixel whose reference cost beats its runner-up by
more than rounding (relative margin 1e-4; at most DISP_EXCLUDED_MAX of the
pixels excluded, 5 of the 19,200 on this pair, and the port's disparity
equals the reference's on those too) and depth to 1e-5 relative there;
upright-2P's inliers exactly and its pose to 1e-9; the stereo covariance,
fused point and the prepare's H / f / y to 1e-9 (relative for the
covariance, whose entries reach 1e3); FAST's corners exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybvio_tpu.config import DerivedParameters, Parameters
from hybvio_tpu.frontend import disparity as rd
from hybvio_tpu.frontend import fast as rf
from hybvio_tpu.frontend import ransac as rr
from hybvio_tpu.frontend import rectify as rrect
from hybvio_tpu.geometry import cameras as rc
from hybvio_tpu.io.synthetic import SYNTH_IMU_TO_CAMERA, generate_sequence, render_view
from hybvio_tpu.odometry import triangulation as rt
from hybvio_tpu.odometry.visual_update import make_prepare_track_update as r_make_prepare
from hybvio_tpu_torch import convert
from hybvio_tpu_torch import random as jr
from hybvio_tpu_torch.config import Parameters as PortParameters
from hybvio_tpu_torch.frontend import disparity as pd
from hybvio_tpu_torch.frontend import fast as pf
from hybvio_tpu_torch.frontend import ransac as pr
from hybvio_tpu_torch.frontend import rectify as prect
from hybvio_tpu_torch.geometry import cameras as pc
from hybvio_tpu_torch.odometry import triangulation as pt
from hybvio_tpu_torch.odometry.visual_update import make_prepare_track_update

from test_torch_estimator import _poses_and_points
from torch_parity import SECOND_IMU_TO_CAMERA

torch.set_num_threads(1)

EUROC = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375, w=752, h=480)
EUROC_K = (-0.28340811, 0.07395907, 0.0)
DISP_EXCLUDED_MAX = 0.002  # share of pixels whose argmin or uniqueness test is a rounding tie


def _rotation(seed, angle=0.05):
    rng = np.random.RandomState(seed)
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _grid(w, h, step):
    """Pixels on a grid that includes the four corners."""
    xs = np.unique(np.r_[np.arange(0, w, step), w - 1])
    ys = np.unique(np.r_[np.arange(0, h, step), h - 1])
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx, gy], -1).astype(np.float64)


@pytest.mark.parametrize("rotated", [False, True])
def test_distorted_pinhole_matches_reference_to_the_corners(rotated):
    e = EUROC
    rot = _rotation(1) if rotated else None
    rcam = rc.build_pinhole(e["fx"], e["fy"], e["cx"], e["cy"], EUROC_K, e["w"], e["h"],
                            rotation=rot)
    cam = pc.build_pinhole(e["fx"], e["fy"], e["cx"], e["cy"], EUROC_K, e["w"], e["h"],
                           rotation=rot)
    assert cam.has_distortion and cam.has_rotation == rotated
    assert convert.camera_from_jax(rcam) == cam
    pix = _grid(e["w"], e["h"], 47)
    r_ray, _ = rc.pixel_to_ray(rcam, jnp.asarray(pix))
    ray, ok = pc.pixel_to_ray(cam, torch.as_tensor(pix))
    assert ok.all()
    np.testing.assert_allclose(ray.numpy(), np.asarray(r_ray), rtol=0, atol=1e-14)
    # the corner is at r ~ 0.97, where the distortion factor is ~0.80
    corner = ray[0, 0].numpy() if not rotated else (rot.T @ ray[0, 0].numpy())
    assert np.hypot(*(corner[:2] / corner[2])) > 0.95 * 1.0 - 0.1
    back, okb = pc.ray_to_pixel(cam, ray)
    assert okb.all()
    np.testing.assert_allclose(back.numpy(), pix, rtol=0, atol=1e-9)
    r_back, _ = rc.ray_to_pixel(rcam, r_ray)
    np.testing.assert_allclose(back.numpy(), np.asarray(r_back), rtol=0, atol=1e-12)
    r_pix, _, r_J = rc.ray_to_pixel_jacobian(rcam, r_ray[::3, ::3])
    got_pix, _, J = pc.ray_to_pixel_jacobian(cam, ray[::3, ::3])
    np.testing.assert_allclose(got_pix.numpy(), np.asarray(r_pix), rtol=0, atol=1e-12)
    np.testing.assert_allclose(J.numpy(), np.asarray(r_J), rtol=0, atol=1e-9)


def test_camera_from_params_takes_the_second_cameras_coefficients():
    second = (-0.28368365, 0.07451284, 0.0)
    for P, build in ((Parameters, rc.build_camera_from_params),
                     (PortParameters, pc.build_camera_from_params)):
        p = P()
        p.tracker.focalLength = 458.0
        p.tracker.distortionCoeffs = EUROC_K
        p.tracker.secondDistortionCoeffs = second
        cams = [build(p.tracker, 752, 480, second=s) for s in (False, True)]
        if P is Parameters:
            ref = [convert.camera_from_jax(c) for c in cams]
        else:
            port = cams
    assert port == ref
    assert port[0].coeffs[:3] == EUROC_K and port[1].coeffs[:3] == second


def _stereo_pair(seed):
    """cam0 / cam1 extrinsics with a 0.11 m baseline and a small relative
    rotation, and EuRoC-like distorted cameras on a 160x120 frame."""
    e1 = SYNTH_IMU_TO_CAMERA.copy()
    e2 = SECOND_IMU_TO_CAMERA.copy()
    e2[:3, :3] = _rotation(seed, 0.02) @ e2[:3, :3]
    return e1, e2


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_stereo_rectify_and_remap_match_reference(dtype):
    W, H = 160, 120
    e1, e2 = _stereo_pair(3)
    rcam = rc.build_pinhole(96.0, 95.5, 81.2, 59.4, EUROC_K, W, H, dtype=dtype)
    cam = convert.camera_from_jax(rcam)
    a = rrect.stereo_rectify(rcam, rcam, e1, e2, W, H, zoom=1.1)
    b = prect.stereo_rectify(cam, cam, e1, e2, W, H, zoom=1.1)
    for ra, pa in zip(a[:2], b[:2]):
        port = convert.camera_from_jax(ra)
        assert (port.fx, port.cx, port.cy, port.width) == (pa.fx, pa.cx, pa.cy, pa.width)
        np.testing.assert_allclose(np.asarray(pa.rot), np.asarray(ra.rot), rtol=0, atol=4e-7)
    np.testing.assert_allclose(b[2], np.asarray(a[2]), rtol=4e-7, atol=0)
    for ra, pa in zip(a[3:], b[3:]):
        np.testing.assert_allclose(pa, ra, rtol=0, atol=1e-14)
    tdt = torch.float32 if dtype == jnp.float32 else torch.float64
    r_map = rrect.build_remap(rcam, a[0], W, H)
    p_map = prect.build_remap(cam, b[0], W, H, tdt, device="cpu")
    assert p_map.dtype == tdt
    np.testing.assert_allclose(p_map.numpy(), np.asarray(r_map), rtol=0,
                               atol=5e-5 if dtype == jnp.float32 else 1e-9)
    img = np.random.RandomState(4).rand(2, H, W).astype(np.float32)
    r_img = rrect.remap(jnp.asarray(img[0]), r_map)
    p_img = prect.remap(torch.as_tensor(img), p_map)  # two lanes, one map
    np.testing.assert_allclose(p_img[0].numpy(), np.asarray(r_img), rtol=0, atol=5e-5)
    np.testing.assert_array_equal(p_img[1].numpy(), prect.remap(torch.as_tensor(img[1]),
                                                                p_map).numpy())
    target, m = prect.build_mono_undistort(cam, W, H, device="cpu")
    r_target, r_m = rrect.build_mono_undistort(rcam, W, H)
    assert convert.camera_from_jax(r_target) == target
    np.testing.assert_allclose(m.numpy(), np.asarray(r_m), rtol=0, atol=5e-5)


def _rendered_pair(W=160, H=120, f=100.0):
    seq = generate_sequence(duration=0.2, imu_rate=100.0, frame_rate=10.0, n_landmarks=400,
                            landmark_radius=4.0, seed=5)
    k = seq.frame_sample_idx[1]
    return tuple(render_view(seq.landmarks, seq.pos[k], seq.quat[k], ext, f, f, W / 2, H / 2,
                             W, H, blob_sigma=1.6) for ext in (SYNTH_IMU_TO_CAMERA,
                                                              SECOND_IMU_TO_CAMERA))


def test_disparity_and_depth_match_reference():
    left, right = _rendered_pair()
    D = 32
    r_disp, r_valid = rd.compute_disparity(jnp.asarray(left), jnp.asarray(right), D)
    disp, valid = pd.compute_disparity(torch.as_tensor(left), torch.as_tensor(right), D)
    r_disp, r_valid = np.asarray(r_disp), np.asarray(r_valid)
    # the reference's own margin between its best and runner-up costs
    costs = np.stack([np.asarray(c) for c in _ref_costs(left, right, D)])
    best = costs.argmin(0)
    cmin = costs.min(0)
    near = np.abs(np.arange(D)[:, None, None] - best[None]) <= 1
    c2 = np.where(near, np.inf, costs).min(0)
    clear = (np.abs(cmin - 0.97 * c2) > 1e-4 * np.maximum(cmin, 1.0)) & (
        np.sort(costs, 0)[1] - cmin > 1e-4 * np.maximum(cmin, 1.0))
    assert 1.0 - clear.mean() <= DISP_EXCLUDED_MAX
    np.testing.assert_array_equal(valid.numpy()[clear], r_valid[clear])
    np.testing.assert_allclose(disp.numpy()[clear], r_disp[clear], rtol=0, atol=1e-5)
    assert r_valid.mean() > 0.05  # not vacuous
    # a batch of two equals two single calls
    d2, v2 = pd.compute_disparity(torch.as_tensor(np.stack([left, right])),
                                  torch.as_tensor(np.stack([right, left])), D)
    assert torch.equal(d2[0], disp) and torch.equal(v2[0], valid)

    e1, e2 = SYNTH_IMU_TO_CAMERA, SECOND_IMU_TO_CAMERA
    rcam = rc.build_pinhole(100.0, 100.0, 80.0, 60.0, width=160, height=120, dtype=jnp.float32)
    Q = np.asarray(rrect.stereo_rectify(rcam, rcam, e1, e2, 160, 120)[2])
    r_depth, r_ok = rd.disparity_to_depth(jnp.asarray(r_disp), jnp.asarray(r_valid), jnp.asarray(Q))
    depth, ok = pd.disparity_to_depth(torch.as_tensor(r_disp), torch.as_tensor(r_valid),
                                      torch.as_tensor(Q))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(r_ok))
    np.testing.assert_allclose(depth.numpy(), np.asarray(r_depth), rtol=1e-5, atol=0)
    r_pts, r_pok = rd.point_cloud(jnp.asarray(r_disp), jnp.asarray(r_valid), jnp.asarray(Q), 5)
    pts, pok = pd.point_cloud(torch.as_tensor(r_disp), torch.as_tensor(r_valid),
                              torch.as_tensor(Q), 5)
    np.testing.assert_array_equal(pok.numpy(), np.asarray(r_pok))
    m = np.asarray(r_pok)
    np.testing.assert_allclose(pts.numpy()[m], np.asarray(r_pts)[m], rtol=1e-5, atol=1e-6)
    xy = np.random.RandomState(6).rand(2, 40, 2) * [159, 119]
    r_s = rd.sample_depth(r_depth, r_ok, jnp.asarray(xy))
    s = pd.sample_depth(depth, ok, torch.as_tensor(xy))
    np.testing.assert_allclose(s.numpy(), np.asarray(r_s), rtol=1e-5, atol=0)
    sb = pd.sample_depth(depth.expand(2, 120, 160), ok.expand(2, 120, 160), torch.as_tensor(xy))
    assert torch.equal(sb, s)
    assert pd.default_max_disparity(752) == rd.default_max_disparity(752) == 64


def _ref_costs(left, right, D):
    """The reference's (D, H, W) SAD volume, as compute_disparity builds it."""
    from hybvio_tpu.frontend.pyramid import box_filter

    out = []
    W = left.shape[1]
    for d in range(D):
        diff = jnp.abs(jnp.asarray(left) - jnp.roll(jnp.asarray(right), d, axis=1))
        diff = jnp.where((jnp.arange(W) < d)[None, :], 1e3, diff)
        out.append(box_filter(diff, 15))
    return out


def _upright_scene(seed, T=40, outliers=8):
    """Gravity-aligned world points and their bearings from a camera moved by
    a yaw and a translation, some rows outliers, some invalid."""
    rng = np.random.RandomState(seed)
    p = rng.randn(T, 3) * [1.0, 1.0, 0.5] + [0.0, 0.0, 4.0]
    yaw = 0.1 + 0.05 * seed
    Rz = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
    q = p @ Rz.T + [0.05, -0.02, 0.1]
    rays = q / np.linalg.norm(q, axis=1, keepdims=True)
    rays[:outliers] += 0.05 * rng.randn(outliers, 3)
    valid = rng.rand(T) < 0.9
    return p, rays, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_upright_2p_matches_reference(seed):
    p, rays, valid = _upright_scene(seed)
    key = jax.random.PRNGKey(seed + 11)
    ref = rr.stereo_upright_2p(jnp.asarray(p), jnp.asarray(rays), jnp.asarray(valid), key,
                               error_thresh=1e-4, max_iters=64)
    pkey = jr.prng_key(torch.tensor([seed + 11]))
    got = pr.stereo_upright_2p(torch.as_tensor(p)[None], torch.as_tensor(rays)[None],
                               torch.as_tensor(valid)[None], pkey, error_thresh=1e-4,
                               max_iters=64, int_bits=64)
    np.testing.assert_array_equal(got.inliers[0].numpy(), np.asarray(ref.inliers))
    assert int(got.inlier_count[0]) == int(ref.inlier_count) >= 25
    assert bool(got.ok[0]) == bool(ref.ok)
    np.testing.assert_allclose(got.yaw[0].numpy(), np.asarray(ref.yaw), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.t[0].numpy(), np.asarray(ref.t), rtol=0, atol=1e-9)
    # the closed-form solve of every drawn pair, both roots
    i, j = np.arange(0, 30), np.arange(5, 35)
    r_yaw, r_t, r_ok = jax.vmap(lambda a, b, c, d: rr._solve_upright_2p(a, b, c, d, jnp.float64))(
        *map(jnp.asarray, (p[i], p[j], rays[i], rays[j])))
    yaw, t, ok = pr._solve_upright_2p(*map(torch.as_tensor, (p[i], p[j], rays[i], rays[j])))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(r_ok))
    m = np.asarray(r_ok)
    np.testing.assert_allclose(yaw.numpy()[m], np.asarray(r_yaw)[m], rtol=0, atol=1e-9)
    np.testing.assert_allclose(t.numpy()[m], np.asarray(r_t)[m], rtol=0, atol=1e-9)


def _s2f():
    return SYNTH_IMU_TO_CAMERA @ np.linalg.inv(SECOND_IMU_TO_CAMERA)


def test_stereo_idp_with_covariance_matches_reference():
    rng = np.random.RandomState(8)
    left = 0.4 * rng.randn(50, 2)
    depth = rng.uniform(0.8, 20.0, 50)
    right = left + np.array([0.11, 0.0]) / depth[:, None] + 1e-4 * rng.randn(50, 2)
    s2f = _s2f()
    r_idp, r_cov, r_ok = jax.vmap(lambda a, b: rt.triangulate_stereo_idp(a, b, jnp.asarray(s2f)))(
        jnp.asarray(left), jnp.asarray(right))
    idp, cov, ok = pt.triangulate_stereo_idp(torch.as_tensor(left), torch.as_tensor(right),
                                             torch.as_tensor(s2f))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(r_ok))
    np.testing.assert_allclose(idp.numpy(), np.asarray(r_idp), rtol=1e-12, atol=0)
    np.testing.assert_allclose(cov.numpy(), np.asarray(r_cov), rtol=1e-9, atol=1e-12)
    assert np.abs(np.asarray(r_cov)).max() > 10.0


@pytest.mark.parametrize("est_sft", [False, True])
def test_prepare_with_fused_stereo_triangulation_matches_reference(est_sft):
    """(H, f, y, statuses, pf) of the independent-stereo form: every pose's
    stereo triangulation fused in the anchor camera, against the
    reference's jax.jacfwd; one track with too few usable rows."""
    p = Parameters()
    p.odometry.cameraTrailLength = 5
    p.odometry.useIndependentStereoTriangulation = True
    p.odometry.estimateImuCameraTimeShift = est_sft
    p.odometry.imuToCameraMatrix = tuple(SYNTH_IMU_TO_CAMERA.T.flatten())
    p.odometry.secondImuToCameraMatrix = tuple(SECOND_IMU_TO_CAMERA.T.flatten())
    po = p.odometry
    derived = DerivedParameters.from_parameters(p)
    d = 20 + 7 * 5
    K = 6
    i2cs = (derived.imu_to_camera, derived.second_imu_to_camera)
    rprep = r_make_prepare(po, *i2cs, True, d)
    prep = make_prepare_track_update(po, *(torch.tensor(np.asarray(a)) for a in i2cs), True, d)
    NB = 4
    pose, _, ips, rng = _poses_and_points(9, NB, K, i2cs)
    vels = 0.01 * rng.randn(NB, 2 * K, 2)
    mask = np.ones((NB, K), bool)
    mask[1, 4:] = False
    s2f = jnp.asarray(np.asarray(derived.imu_to_camera)
                      @ np.linalg.inv(np.asarray(derived.second_imu_to_camera)))
    sidp, scov, sok = jax.vmap(jax.vmap(lambda a, b: rt.triangulate_stereo_idp(a, b, s2f)))(
        jnp.asarray(ips[:, :K]), jnp.asarray(ips[:, K:]))
    svalid = np.asarray(sok) & (rng.rand(NB, K) < 0.8)
    svalid[3] = False
    svalid[3, 2] = True
    svalid[2] = False  # no usable row: TRI_BAD_COND
    args = [np.asarray(a) for a in (sidp, scov)] + [svalid]
    trail_index = jnp.arange(K, dtype=jnp.int32)
    ref = jax.jit(jax.vmap(lambda ps, ip, v, m, a, c, s: rprep(
        ps, trail_index, ip, v, m, stereo_idp=a, stereo_cov=c, stereo_valid=s)))(
            *map(jnp.asarray, (pose, ips, vels, mask, *args)))
    out = prep(*map(torch.as_tensor, (pose, ips, vels, mask)), stereo_idp=torch.as_tensor(args[0]),
               stereo_cov=torch.as_tensor(args[1]), stereo_valid=torch.as_tensor(args[2]))
    for name in ("H", "f", "y", "pf"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-9, err_msg=name)
    for name in ("row_mask", "tri_status", "prepare_status"):
        np.testing.assert_array_equal(getattr(out, name).numpy().astype(np.int64),
                                      np.asarray(getattr(ref, name)).astype(np.int64), name)
    assert out.tri_status.numpy().tolist().count(0) == 3 and int(out.tri_status[2]) == 2
    assert np.abs(out.H.numpy()).max() > 0.1


@pytest.mark.parametrize("lanes", [0, 2])
def test_detect_fast_matches_reference(lanes):
    img = _rendered_pair(W=192, H=128)[0].astype(np.float32)
    rng = np.random.RandomState(10)
    existing = rng.rand(12, 2) * [192, 128]
    ev = rng.rand(12) < 0.5
    ref = rf.detect_fast(jnp.asarray(img), 32, jnp.asarray(existing, jnp.float32),
                         jnp.asarray(ev), mask_radius=9.0, min_distance=6.0)
    B = max(lanes, 1)
    frame = torch.as_tensor(img)
    if lanes:
        frame = frame.expand(B, *img.shape).clone()
    got = pf.detect_fast(frame, 32, torch.as_tensor(existing, dtype=torch.float32).expand(B, 12, 2),
                         torch.as_tensor(ev).expand(B, 12), torch.full((B,), 9.0), 6.0)
    for b in range(B):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(r))
    assert int(got[2][0].sum()) >= 10
    r_score = np.asarray(rf.fast_score(jnp.asarray(img), 20.0 / 255.0))
    np.testing.assert_array_equal(pf.fast_score(torch.as_tensor(img), 20.0 / 255.0).numpy(),
                                  r_score)
