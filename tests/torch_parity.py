"""Shared set-up for the parity tests of the PyTorch port against the JAX
reference: tiny stereo, mono and fisheye configurations, a rendered
synthetic sequence, a field-by-field comparison that names the first field
that parts, the whole batched step run through both packages, and the
datasets and lockstep harness of the host API and CLI tests."""
import os

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


def _mask_stereo_rows(trail):
    """The trail with the stereo covariances of rows whose stereo
    triangulation is not valid zeroed: the visual update never reads them
    (their information weight is zero), and for a track's near-parallel
    rays (an empty slot's, say) the covariance is cancellation noise that
    forward and reverse mode round apart."""
    valid = np.asarray(trail.kf_stereo_valid)[..., None, None]
    return trail._replace(kf_stereo_cov=np.where(valid, trail.kf_stereo_cov, 0.0))


def _comparable(state):
    return state._replace(backend=state.backend._replace(
        trail=_mask_stereo_rows(state.backend.trail)))


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
    output after it. Stereo covariances are compared where the trail's
    stereo row is valid (``_mask_stereo_rows``). Returns the number of tracked slots over all frames;
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
        diff = (mismatches(_comparable(convert.to_numpy(state)),
                           _comparable(jax.tree.map(np.asarray, rstate)), tol, f"frame {fi} state")
                + mismatches(convert.to_numpy(out), jax.tree.map(np.asarray, rout), tol,
                             f"frame {fi} output"))
        assert not diff, f"first parting: {diff[0]} (all: {diff})"
        if after_step is not None:
            after_step(state, out)
        tracked += int((np.asarray(rout.track_ids) >= 0).sum())
        assert np.isfinite(out.position.numpy()).all()
    return tracked


# ------------------------------------------------- the host API and the CLI

API_W, API_H, API_FX = 320, 240, 260.0
# tests/test_api_cli.py's reduced tracker sizes at 320x240, as CLI flags
API_FLAGS = ("-focalLength=260", "-principalPointX=160", "-principalPointY=120",
             "-maxTracks=32", "-cameraTrailLength=6", "-pyrLKWindowSize=13",
             "-pyrLKMaxLevel=2", "-gfttMinDistance=30")
# float32 rounding of a pixel coordinate scales with its magnitude: the
# pixel fields of a 320x240 frame are held to step_tol's bounds (set on the
# 96x64 frames) times the ratio of the frame sizes, the same few ulp
API_PIXEL_SCALE = API_W / W


def api_tol(base):
    """``base`` (step_tol or mono_step_tol) with the pixel fields' bounds
    scaled by API_PIXEL_SCALE."""
    def tol(path):
        t = base(path)
        return t * API_PIXEL_SCALE if _field(path) in PIXEL_FIELDS + VIZ_FIELDS else t
    return tol


def quantize_frames(dataset):
    """Re-save every frame_*.npy of ``dataset`` as uint8 levels / 255 in
    float32 (the step's own normalization of a uint8 frame), so a uint8 run
    of the same frames must give the same outputs."""
    for name in sorted(os.listdir(dataset)):
        if name.startswith("frame_") and name.endswith(".npy"):
            path = os.path.join(dataset, name)
            np.save(path, to_uint8(np.load(path)).astype(np.float32) * np.float32(1.0 / 255.0))


def to_uint8(frame):
    return np.clip(np.round(np.asarray(frame) * 255.0), 0, 255).astype(np.uint8)


def make_api_dataset(out_dir, duration, stereo=False):
    """A blobs dataset at 320x240 for the API and CLI tests: mono is
    tools/make_synthetic_dataset.make_dataset(world="blobs"); stereo the same
    sequence, recorder and parameters.txt with a second camera 0.11 m along
    -x (frame_*_cam1.npy and its imuToCamera line). Frames quantized
    (quantize_frames)."""
    import json
    import sys

    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    from make_synthetic_dataset import make_dataset

    if not stereo:
        make_dataset(out_dir, duration=duration, world="blobs")
        quantize_frames(out_dir)
        return out_dir
    from hybvio_tpu.io.jsonl import Recorder

    seq = generate_sequence(duration=duration, imu_rate=100.0, frame_rate=10.0, n_landmarks=300,
                            gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    rec = Recorder(out_dir)
    for ci, ext in enumerate((SYNTH_IMU_TO_CAMERA, SECOND_IMU_TO_CAMERA)):
        rec.f.write(json.dumps({"imuToCamera": [list(r) for r in np.asarray(ext)],
                                "cameraInd": ci}) + "\n")
    with open(os.path.join(out_dir, "parameters.txt"), "w") as pf:
        pf.write("ransac2Threshold 8.0;\nransac5Threshold 4.0;\nvisualR 0.5;\n")
    cx, cy = API_W / 2, API_H / 2
    frame_set = set(seq.frame_sample_idx.tolist())
    for k in range(len(seq.times)):
        t = float(seq.times[k])
        rec.gyro(t, seq.gyro[k])
        rec.acc(t, seq.acc[k])
        if k in frame_set:
            imgs = [render_view(seq.landmarks, seq.pos[k], seq.quat[k], ext, API_FX, API_FX, cx,
                                cy, API_W, API_H, blob_sigma=1.2)
                    for ext in (SYNTH_IMU_TO_CAMERA, SECOND_IMU_TO_CAMERA)]
            cp = {"focalLengthX": API_FX, "focalLengthY": API_FX, "principalPointX": cx,
                  "principalPointY": cy}
            rec.frame(t, imgs, [cp, cp])
            rec.ground_truth(t, seq.pos[k], seq.quat[k])
    rec.close()
    quantize_frames(out_dir)
    return out_dir


def api_params(P, loader, jsonl, dataset, stereo=False):
    """Parameters of one package (its ``Parameters`` class, ``config.loader``
    and ``io.jsonl`` modules) as its CLI loads them from ``dataset`` with
    API_FLAGS (and -useStereo)."""
    p = P()
    jsonl.set_parameters_from_data(p, os.path.join(dataset, "data.jsonl"))
    loader.apply_parameters_text(p, open(os.path.join(dataset, "parameters.txt")).read())
    rest = loader.apply_argv(p, list(API_FLAGS) + (["-useStereo"] if stereo else []))
    assert not rest, rest
    return p


def drive_api(api, dataset, n_frames, stereo=False, frame=None):
    """Feed ``dataset``'s events to a VioApi (either package) up to
    ``n_frames`` frames, as the CLI does, then finish(); ``frame(img)``
    maps each frame first. Returns (retired FrameOutputs, VioOutputs)."""
    from hybvio_tpu.io import jsonl as rj
    from hybvio_tpu_torch.io.video import open_frame_source

    outs, vos = [], []
    retire = api._retire

    def _retire(out, aux):
        outs.append(type(out)(*(np.asarray(x) for x in out)))
        retire(out, aux)

    api._retire = _retire
    api.on_output = vos.append
    frames = open_frame_source(dataset)
    frame = frame or (lambda img: img)
    n = 0
    for ev in rj.read_jsonl_events(os.path.join(dataset, "data.jsonl")):
        if ev.kind == rj.GYROSCOPE:
            api.add_gyro(ev.t, ev.values)
        elif ev.kind == rj.ACCELEROMETER:
            api.add_acc(ev.t, ev.values)
        elif ev.kind == rj.FRAME:
            if stereo:
                api.add_frame_stereo(ev.t, frame(frames.frame(n, 0)), frame(frames.frame(n, 1)))
            else:
                api.add_frame_mono(ev.t, frame(frames.frame(n, 0)))
            n += 1
            if n >= n_frames:
                break
    api.finish()
    return outs, vos


def lockstep(mp, tol, diffs):
    """Patch (through the MonkeyPatch ``mp``) the reference's VioApi to
    record its state (numpy, with a lane axis) before each of its frame
    steps, and the port's to compare its own state before each frame step
    with the reference's at the same point (mismatches appended to
    ``diffs``) and continue from the reference's: every step of the port
    then starts where the reference's did. Run the reference first; each
    new port VioApi replays the recorded states from the first. Returns the
    recorded states."""
    from hybvio_tpu.api.vio import VioApi as RVioApi
    from hybvio_tpu_torch.api.vio import VioApi

    states = []
    process, step = RVioApi._process_frame, VioApi._step_frame

    def _process(self, synced):
        if self._state is not None:
            states.append(jax.tree.map(lambda a: np.asarray(a)[None], self._state))
        process(self, synced)

    def _step(self, *args):
        k = getattr(self, "_lockstep_k", 0)
        diffs.extend(mismatches(convert.to_numpy(self._state), states[k], tol, f"step {k} state"))
        self._state = convert.from_jax(states[k], device="cpu")
        self._lockstep_k = k + 1
        step(self, *args)

    mp.setattr(RVioApi, "_process_frame", _process)
    mp.setattr(VioApi, "_step_frame", _step)
    return states
