"""The whole batched step with the reference's default estimator (the
sequential visual update) and the hybrid map (hybridMapSize = 4), through
the port and the reference's make_batched_vio, 5 frames at B = 2: stereo
with shared frames, and mono with per-lane frames of two worlds. And the
reference's own float32 sensitivity with the map, which sets the filter
dtype of chip_smoke.py's map path.

Tolerances: every integer and boolean field exactly (map_point_ids
included); floats as ``torch_parity.step_tol`` (stereo) and
``mono_step_tol`` (mono): the float32 front-end's few-ulp pixel
differences, carried on by the filter. In mono a map point's mean is a
triangulated point, held like the point cloud to MONO_POINT_TOL (1.5e-4 m
measured on a 2.6 m coordinate); its covariance rows and columns start at
the map prior's variance 1e6 and are held to MAP_COV_TOL, 1e-4 of it
(8.4 measured on an entry of 1.1e5, 8e-5 relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from hybvio_tpu.config import DerivedParameters, Parameters
from hybvio_tpu.geometry.cameras import build_pinhole
from hybvio_tpu.io.synthetic import (
    PerfectTracker, SYNTH_IMU_TO_CAMERA, generate_sequence, render_view,
)
from hybvio_tpu.odometry import backend as rb

from torch_parity import (
    FX, H, MONO_POINT_TOL, SECOND_IMU_TO_CAMERA, W, batched_step_parity, mono_step_tol,
    stereo_frame, tiny_mono_setup, tiny_sequence, tiny_stereo_setup,
)
from test_torch_per_lane import _per_lane_imu, _worlds

torch.set_num_threads(1)

B, FRAMES, M = 2, 5, 4
MAP_COV_TOL = 1e2


def _sequential_hybrid(p):
    p.odometry.batchVisualUpdate = False
    p.odometry.hybridMapSize = M
    return p


def _mono_map_tol(d):
    """mono_step_tol, with the map block of the mean at MONO_POINT_TOL and
    the map rows and columns of the covariance at MAP_COV_TOL."""
    k = d - 3 * M

    def tol(path):
        base = mono_step_tol(path)
        if path.endswith("ekf.m"):
            t = np.full(d, base)
            t[k:] = MONO_POINT_TOL
            return t
        if path.endswith("ekf.P"):
            t = np.full((d, d), base)
            t[k:, :] = t[:, k:] = MAP_COV_TOL
            return t
        return base
    return tol


class _MapSeen:
    """after_step hook: whether some lane claimed a map slot."""

    def __init__(self):
        self.claimed = False

    def __call__(self, state, out):
        self.claimed |= bool((state.backend.trail.map_point_ids >= 0).any())


def test_sequential_hybrid_stereo_step_matches_reference():
    p, _, rcam = tiny_stereo_setup()
    seq = tiny_sequence(FRAMES)
    seen = _MapSeen()
    tracked = batched_step_parity(_sequential_hybrid(p), (rcam, rcam),
                                  [stereo_frame(seq, fi) for fi in range(FRAMES + 1)], seq, B,
                                  after_step=seen)
    assert tracked > 0 and seen.claimed


def test_sequential_hybrid_mono_per_lane_step_matches_reference():
    """Two lanes with different rendered frames (two worlds), one image
    each per step (``shared_frames=False``)."""
    p, _, rcam = tiny_mono_setup()
    seqs = _worlds(FRAMES)

    def frame(fi):
        k = seqs[0].frame_sample_idx[fi]
        return np.stack([render_view(s.landmarks, s.pos[k], s.quat[k], SYNTH_IMU_TO_CAMERA, FX, FX,
                                     48.0, 32.0, W, H, blob_sigma=1.4) for s in seqs])

    p = _sequential_hybrid(p)
    seen = _MapSeen()
    tracked = batched_step_parity(p, (rcam,), [frame(fi) for fi in range(FRAMES + 1)], seqs[0], B,
                                  tol=_mono_map_tol(20 + 7 * p.odometry.cameraTrailLength + 3 * M),
                                  shared_frames=False, imus=_per_lane_imu(seqs, FRAMES),
                                  after_step=seen)
    assert tracked > 0 and seen.claimed


def _reference_moves(p, dtype, acc_eps, n_frames=20, B=2, T=12):
    """How far (max abs, m) the reference's own estimator (make_backend) in
    ``dtype`` moves its positions over ``n_frames`` when ``acc_eps`` of
    seeded noise is added to the accelerometer: fed io.synthetic's
    PerfectTracker (stereo, 320x240) with and without it."""
    w, h, fx = 320, 240, 250.0
    rcam = build_pinhole(fx, fx, w / 2, h / 2, width=w, height=h)
    seq = generate_sequence(duration=n_frames / 10.0, imu_rate=100.0, frame_rate=10.0,
                            gyro_noise=1e-3, acc_noise=1e-2, seed=3)
    rinit, rstep = rb.make_backend(p, DerivedParameters.from_parameters(p), (rcam, rcam),
                                   max_tracks=T, dtype=dtype)
    scan, frame = jax.jit(jax.vmap(rstep.imu_scan)), jax.jit(jax.vmap(rstep.process_frame))
    S = int(np.max(np.diff(np.concatenate([[0], seq.frame_sample_idx + 1]))))
    lanes = lambda a: np.tile(a, (B,) + (1,) * a.ndim)
    runs = []
    for eps in (0.0, acc_eps):
        tracker = PerfectTracker(seq, SYNTH_IMU_TO_CAMERA, rcam, w, h, max_tracks=T,
                                 pixel_noise=0.3, seed=3, second_imu_to_camera=SECOND_IMU_TO_CAMERA)
        state = jax.vmap(rinit)(jax.vmap(jax.random.PRNGKey)(jnp.arange(B, dtype=jnp.uint32)))
        prev, positions = 0, []
        for fi in range(len(seq.frame_sample_idx)):
            k = seq.frame_sample_idx[fi] + 1
            n = k - prev
            t = np.pad(seq.times[prev:k], (0, S - n), constant_values=seq.times[k - 1])
            g = np.pad(seq.gyro[prev:k], ((0, S - n), (0, 0)))
            a = np.pad(seq.acc[prev:k], ((0, S - n), (0, 0)))
            prev = k
            a = lanes(a) + eps * np.random.RandomState(fi).randn(B, S, 3)
            state = scan(state, rb.ImuBatch(
                jnp.asarray(lanes(t), dtype), jnp.asarray(lanes(g), dtype), jnp.asarray(a, dtype),
                jnp.asarray(lanes(np.arange(S) < n))))
            ids, pixels, keyframe = tracker.track(fi)
            state, out = frame(state, rb.TrackerInput(
                jnp.asarray(lanes(ids)), jnp.asarray(lanes(pixels), dtype),
                jnp.asarray(np.full(B, keyframe)), jnp.full((B, T), -1.0, dtype)))
            positions.append(np.asarray(out.position))
            tracker.delete_tracks(np.asarray(state.blacklist_flags)[0],
                                  np.asarray(state.blacklist_ids)[0])
        runs.append(np.stack(positions))
    return float(np.abs(runs[0] - runs[1]).max())


def test_float32_map_is_chaotic_in_the_reference():
    """Why chip_smoke.py runs the hybrid map in a float64 filter: a map point
    enters with variance 1e6, and the reference's own float32 estimator with
    the map moves its positions by more than 0.1 m (1.76 m measured) within
    20 frames when the accelerometer input moves by 1e-6 m/s^2, where its
    float64 estimator moves by less than 1e-6 m (4.9e-8 measured)."""
    p = Parameters()
    p.odometry.cameraTrailLength = 5
    p.tracker.maxTracks = 12
    p.tracker.useStereo = True
    p.odometry.maxVisualUpdates = 4
    p.tracker.focalLength = 250.0
    p.tracker.principalPointX, p.tracker.principalPointY = 160.0, 120.0
    p.odometry.imuToCameraMatrix = tuple(SYNTH_IMU_TO_CAMERA.T.flatten())
    p.odometry.secondImuToCameraMatrix = tuple(SECOND_IMU_TO_CAMERA.T.flatten())
    p.odometry.visualR = 0.3
    p.odometry.hybridMapSize = 8
    moved = {dt.__name__: _reference_moves(p, dt, 1e-6) for dt in (jnp.float32, jnp.float64)}
    assert moved["float32"] > 0.1 and moved["float64"] < 1e-6, moved
