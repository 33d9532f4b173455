"""Shared set-up for the parity tests of the PyTorch port against the JAX
reference: a tiny stereo configuration, a rendered synthetic sequence, and
a field-by-field comparison that names the first field that parts."""
import jax.numpy as jnp
import numpy as np

from hybvio_tpu.config import DerivedParameters, Parameters
from hybvio_tpu.geometry.cameras import build_pinhole
from hybvio_tpu.io.synthetic import SYNTH_IMU_TO_CAMERA, generate_sequence, render_view

W, H, FX = 96, 64, 80.0
SECOND_IMU_TO_CAMERA = SYNTH_IMU_TO_CAMERA.copy()
SECOND_IMU_TO_CAMERA[0, 3] = -0.11


def tiny_stereo_setup():
    """tests/test_parallel.py's tiny set-up, stereo, batched visual update."""
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
    p.tracker.useStereo = True
    p.odometry.secondImuToCameraMatrix = tuple(SECOND_IMU_TO_CAMERA.T.flatten())
    derived = DerivedParameters.from_parameters(p)
    cam = build_pinhole(FX, FX, 48.0, 32.0, width=W, height=H, dtype=jnp.float32)
    return p, derived, cam


def tiny_sequence(n_frames):
    return generate_sequence(duration=(n_frames + 2) / 20.0, imu_rate=200.0, frame_rate=20.0,
                             n_landmarks=300, gyro_noise=5e-4, acc_noise=5e-3, seed=0)


def stereo_frame(seq, fi):
    k = seq.frame_sample_idx[fi]
    return tuple(render_view(seq.landmarks, seq.pos[k], seq.quat[k], ext, FX, FX, 48.0, 32.0,
                             W, H, blob_sigma=1.4)
                 for ext in (SYNTH_IMU_TO_CAMERA, SECOND_IMU_TO_CAMERA))


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
    ``float_tol`` (a number, or a callable path -> number)."""
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
        else:
            fin = np.isfinite(b)
            d = float(np.max(np.abs(a[fin] - b[fin]))) if fin.any() else 0.0
            if d > tol:
                out.append((path, f"max abs diff {d:.3g} > {tol:.3g}"))
    return out
