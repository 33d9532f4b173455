"""Shared set-up for the parity tests of the PyTorch port against the JAX
reference: tiny stereo, mono and fisheye configurations, a rendered
synthetic sequence, a field-by-field comparison that names the first field
that parts, and the whole batched step run through both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from hybvio_tpu.config import DerivedParameters, Parameters
from hybvio_tpu.geometry.cameras import build_fisheye, build_pinhole
from hybvio_tpu.io.synthetic import (
    SYNTH_IMU_TO_CAMERA, generate_sequence, render_view, render_view_fisheye,
)
from hybvio_tpu.odometry.backend import ImuBatch as RImuBatch
from hybvio_tpu.parallel.batched import make_batched_vio as r_make_batched_vio
from hybvio_tpu_torch import convert
from hybvio_tpu_torch.config import DerivedParameters as PortDerived
from hybvio_tpu_torch.odometry.backend import ImuBatch
from hybvio_tpu_torch.parallel.batched import make_batched_vio

W, H, FX = 96, 64, 80.0
SECOND_IMU_TO_CAMERA = SYNTH_IMU_TO_CAMERA.copy()
SECOND_IMU_TO_CAMERA[0, 3] = -0.11
# the fisheye preset's lens (KB4, 150 degrees) on a 96x96 frame
FISHEYE_WH, FISHEYE_FX = 96, 36.0
KB4 = (0.0035, 0.0007, -0.002, 0.0002)
FISHEYE_FOV = 150.0


def _tiny_params():
    """tests/test_parallel.py's tiny set-up with the batched visual update."""
    p = Parameters()
    p.odometry.cameraTrailLength = 4
    p.tracker.maxTracks = 12
    p.odometry.maxVisualUpdates = 4
    p.tracker.focalLength = FX
    p.tracker.principalPointX = 48.0
    p.tracker.principalPointY = 32.0
    p.tracker.pyrLKWindowSize = 9
    p.tracker.pyrLKMaxLevel = 1
    p.tracker.gfttMinDistance = 20.0
    p.odometry.imuToCameraMatrix = tuple(SYNTH_IMU_TO_CAMERA.T.flatten())
    p.odometry.batchVisualUpdate = True
    return p


def tiny_stereo_setup():
    """tests/test_parallel.py's tiny set-up, stereo, batched visual update."""
    p = _tiny_params()
    p.tracker.useStereo = True
    p.odometry.secondImuToCameraMatrix = tuple(SECOND_IMU_TO_CAMERA.T.flatten())
    derived = DerivedParameters.from_parameters(p)
    cam = build_pinhole(FX, FX, 48.0, 32.0, width=W, height=H, dtype=jnp.float32)
    return p, derived, cam


def tiny_mono_setup():
    """tests/test_parallel.py's tiny set-up, mono, batched visual update."""
    p = _tiny_params()
    derived = DerivedParameters.from_parameters(p)
    cam = build_pinhole(FX, FX, 48.0, 32.0, width=W, height=H, dtype=jnp.float32)
    return p, derived, cam


def tiny_fisheye_setup():
    """The tiny mono set-up with the fisheye preset's KB4 lens and field of
    view on a 96x96 frame (the preset's 190 px focal length scaled to it)."""
    p = _tiny_params()
    c = FISHEYE_WH / 2
    p.tracker.fisheyeCamera = True
    p.tracker.validCameraFov = FISHEYE_FOV
    p.tracker.focalLength = FISHEYE_FX
    p.tracker.principalPointX = c
    p.tracker.principalPointY = c
    p.tracker.distortionCoeffs = KB4
    p.odometry.visualR = 0.4
    derived = DerivedParameters.from_parameters(p)
    cam = build_fisheye(FISHEYE_FX, FISHEYE_FX, c, c, coeffs=KB4, max_valid_fov_deg=FISHEYE_FOV,
                        width=FISHEYE_WH, height=FISHEYE_WH, dtype=jnp.float32)
    return p, derived, cam


def tiny_sequence(n_frames, landmark_radius=6.0):
    return generate_sequence(duration=(n_frames + 2) / 20.0, imu_rate=200.0, frame_rate=20.0,
                             n_landmarks=300, landmark_radius=landmark_radius,
                             gyro_noise=5e-4, acc_noise=5e-3, seed=0)


def stereo_frame(seq, fi):
    k = seq.frame_sample_idx[fi]
    return tuple(render_view(seq.landmarks, seq.pos[k], seq.quat[k], ext, FX, FX, 48.0, 32.0,
                             W, H, blob_sigma=1.4)
                 for ext in (SYNTH_IMU_TO_CAMERA, SECOND_IMU_TO_CAMERA))


def mono_frame(seq, fi):
    k = seq.frame_sample_idx[fi]
    return render_view(seq.landmarks, seq.pos[k], seq.quat[k], SYNTH_IMU_TO_CAMERA, FX, FX,
                       48.0, 32.0, W, H, blob_sigma=1.4)


def fisheye_frame(seq, fi):
    k = seq.frame_sample_idx[fi]
    c = FISHEYE_WH / 2
    return render_view_fisheye(seq.landmarks, seq.pos[k], seq.quat[k], SYNTH_IMU_TO_CAMERA,
                               FISHEYE_FX, FISHEYE_FX, c, c, FISHEYE_WH, FISHEYE_WH, KB4,
                               max_fov_deg=FISHEYE_FOV, blob_sigma=1.4)


def imu_batches(seq, n_frames, B, S=10):
    """Per-frame (t, gyro, acc, valid) numpy arrays with per-lane jitter."""
    out = []
    prev = seq.frame_sample_idx[0] + 1
    for fi in range(1, n_frames + 1):
        k = seq.frame_sample_idx[fi] + 1
        n = k - prev
        t = np.pad(seq.times[prev:k], (0, S - n), constant_values=seq.times[k - 1])
        g = np.pad(seq.gyro[prev:k], ((0, S - n), (0, 0)))
        a = np.pad(seq.acc[prev:k], ((0, S - n), (0, 0)))
        rng = np.random.RandomState(fi)
        gB = np.stack([g + 1e-4 * rng.randn(*g.shape) for _ in range(B)])
        aB = np.stack([a + 1e-3 * rng.randn(*a.shape) for _ in range(B)])
        out.append((np.tile(t, (B, 1)), gB, aB, np.tile(np.arange(S) < n, (B, 1))))
        prev = k
    return out


def mismatches(port, ref, float_tol, path="", out=None):
    """[(field path, description)] where ``port`` and ``ref`` (NamedTuple
    trees of numpy arrays) differ: integers and bools exactly, floats by
    ``float_tol`` (a number, or a callable path -> number or an array of
    per-element tolerances that broadcasts against the field)."""
    out = [] if out is None else out
    if port is None and ref is None:
        return out
    if isinstance(ref, tuple) and hasattr(ref, "_fields"):
        for f in ref._fields:
            mismatches(getattr(port, f), getattr(ref, f), float_tol, f"{path}.{f}", out)
        return out
    if isinstance(ref, (tuple, list)):
        for i, (a, b) in enumerate(zip(port, ref)):
            mismatches(a, b, float_tol, f"{path}[{i}]", out)
        return out
    a, b = np.asarray(port), np.asarray(ref)
    if a.shape != b.shape:
        out.append((path, f"shape {a.shape} vs {b.shape}"))
    elif b.dtype == bool or np.issubdtype(b.dtype, np.integer):
        if not np.array_equal(a.astype(np.int64), b.astype(np.int64)):
            out.append((path, f"{int((a.astype(np.int64) != b.astype(np.int64)).sum())} entries differ"))
    else:
        tol = float_tol(path) if callable(float_tol) else float_tol
        if not np.array_equal(np.isfinite(a), np.isfinite(b)):
            out.append((path, "finite masks differ"))
        elif np.ndim(tol):
            fin = np.isfinite(b)
            over = (np.abs(a - b) > np.broadcast_to(tol, b.shape)) & fin
            if over.any():
                out.append((path, f"{int(over.sum())} entries over their tolerance, max abs diff "
                                  f"{float(np.max(np.abs(a - b)[over])):.3g}"))
        else:
            fin = np.isfinite(b)
            d = float(np.max(np.abs(a[fin] - b[fin]))) if fin.any() else 0.0
            if d > tol:
                out.append((path, f"max abs diff {d:.3g} > {tol:.3g}"))
    return out


PIXEL_FIELDS = ("px", "kf_pix", "pixels", "prev_pixels", "track_prev_pixels", "last_kf_px")
# visualization payload: also where LK landed for FAILED tracks, whose
# unconverged iterations carry the rounding further
VIZ_FIELDS = ("viz_pixels", "track_pixels")


def _field(path):
    return path.rsplit(".", 1)[-1].split("[")[0]


def step_tol(path):
    """Float tolerance of a field of the batched step's state or output."""
    field = _field(path)
    if field == "position":
        return 1e-6  # m
    if field in PIXEL_FIELDS:
        return 2e-4  # px, f32 front-end
    if field in VIZ_FIELDS:
        return 1e-2  # px
    if field in ("P", "position_cov", "velocity_cov", "bias_cov_diag"):
        return 1e-3  # covariance entries up to ~1e4
    return 1e-5


MONO_COV_TOL, MONO_POINT_TOL = 1e-2, 1e-3


def mono_step_tol(path):
    """step_tol, but covariances to MONO_COV_TOL and triangulated points to
    MONO_POINT_TOL m. One camera triangulates over the few-centimetre
    baselines of a 5-frame trail, which magnifies the front-end's few-ulp
    pixel differences (4.6e-5 px at 83 px) more than a stereo pair does:
    0.0043 on covariance entries of ~100 (4e-5 relative) and 1.9e-4 m on
    points ~3 m away after 5 mono frames; positions still agree to 1e-6 m."""
    field = _field(path)
    if field in ("P", "position_cov", "velocity_cov", "bias_cov_diag"):
        return MONO_COV_TOL
    if field == "point_cloud":
        return MONO_POINT_TOL
    return step_tol(path)


def long_trail_tol(path):
    """step_tol over a 10-slot trail and 12 steps, but positions to 1e-5 m,
    other filter floats to 1e-4, pixels to 2e-3 px and covariances to 1e-2.
    The longer tracks carry the float32 front-end's few-ulp differences
    further: the reference's own step, fed its frames plus 1e-6 noise,
    moves by 1.1e-3 px, 9.3e-5 in the mean and 6e-6 m in position over the
    same 13 frames, more than the port moves from it (5.1e-4 px, 2.2e-5,
    3.4e-6 m)."""
    field = _field(path)
    if field == "position":
        return 1e-5
    if field in PIXEL_FIELDS:
        return 2e-3
    if field in ("P", "position_cov", "velocity_cov", "bias_cov_diag"):
        return 1e-2
    return max(step_tol(path), 1e-4)


def _tensors(frame, make):
    return tuple(make(f) for f in frame) if isinstance(frame, tuple) else make(frame)


def batched_step_parity(p, rcams, frames, seq, B, max_tracks=12, tol=step_tol,
                        shared_frames=True, on_step=None, imus=None, after_step=None):
    """Run the reference's make_batched_vio and the port's (CPU, float64
    filter) over ``frames`` (each an (H, W) array or a stereo pair of them,
    or with ``shared_frames=False`` (B, H, W) arrays, one image per lane):
    the port's own initial state must equal the reference's, then both step
    from one state (through convert); floats agree to ``tol`` (path ->
    tolerance), integers and bools exactly. ``imus`` (per frame, (t, gyro,
    acc, valid) arrays) defaults to ``imu_batches(seq, ...)``;
    ``on_step(vio, state, imu)``, when given, sees the port's state and IMU
    batch before each step, ``after_step(state, out)`` the port's state and
    output after it. Returns the number of tracked slots over all frames;
    raises on the first field that parts."""
    derived = DerivedParameters.from_parameters(p)
    n = len(frames) - 1
    rinit, rstep = r_make_batched_vio(p, derived, rcams, batch_size=B, max_tracks=max_tracks,
                                      dtype=jnp.float64, shared_frames=shared_frames)
    t0 = np.full(B, seq.frame_times[0])
    rstate = rinit(_tensors(frames[0], jnp.asarray), t0, np.arange(B))
    cams = tuple(convert.camera_from_jax(c) for c in rcams)
    tinit, tstep, vio = make_batched_vio(p, PortDerived.from_parameters(p), cams, batch_size=B,
                                         max_tracks=max_tracks, dtype=torch.float64,
                                         shared_frames=shared_frames, device="cpu")
    own = tinit(_tensors(frames[0], torch.as_tensor), t0, np.arange(B))
    diff = mismatches(convert.to_numpy(own), jax.tree.map(np.asarray, rstate), tol, "init")
    assert not diff, diff
    state = convert.from_jax(jax.tree.map(np.asarray, rstate), device="cpu")
    tracked = 0
    imus = imu_batches(seq, n, B) if imus is None else imus
    for fi, imu in enumerate(imus[:n], start=1):
        if on_step is not None:
            on_step(vio, state, ImuBatch(*map(torch.as_tensor, imu)))
        rstate, rout = rstep(rstate, RImuBatch(*map(jnp.asarray, imu)),
                             _tensors(frames[fi], jnp.asarray))
        state, out = tstep(state, ImuBatch(*map(torch.as_tensor, imu)),
                           _tensors(frames[fi], torch.as_tensor))
        diff = (mismatches(convert.to_numpy(state), jax.tree.map(np.asarray, rstate), tol,
                           f"frame {fi} state")
                + mismatches(convert.to_numpy(out), jax.tree.map(np.asarray, rout), tol,
                             f"frame {fi} output"))
        assert not diff, f"first parting: {diff[0]} (all: {diff})"
        if after_step is not None:
            after_step(state, out)
        tracked += int((np.asarray(rout.track_ids) >= 0).sum())
        assert np.isfinite(out.position.numpy()).all()
    return tracked
