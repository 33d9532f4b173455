"""The textured-world accuracy probe (port of the reference's
``eval/textured_probe.py``).

The blob world (``io/synthetic.py``) proves the plumbing; this probe runs
the whole VIO step on the ray-cast textured world (``io/textured.py``):
dense texture, occlusion, exposure jitter, pixel noise and motion blur, the
failure regimes of real imagery. Its ATE is the accuracy evidence on
realistic images. Frames render on the host, bit-equal with the
reference's renderer; the step runs at one lane on ``device`` (the card
unless told otherwise) at "highest" matmul precision with TF32 off, as
every step of the port does (the reference's ``precision`` sweep has no
counterpart).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import DerivedParameters, Parameters
from ..eval.ate import ate_rmse
from ..geometry.cameras import build_fisheye, build_pinhole
from ..io.synthetic import SYNTH_IMU_TO_CAMERA, generate_sequence
from ..io.textured import TexturedScene, textured_frame_renderer
from ..odometry.backend import ImuBatch
from ..parallel.batched import make_batched_vio
from ..runtime import default_device

KB4_PROBE = (0.0035, 0.0007, -0.002, 0.0002)  # the fisheye preset's lens


def textured_accuracy_params(width: int = 320, height: int = 240, fx: float = 260.0):
    """The textured run's parameters (the per-dataset tuning the reference
    ships as parameters.txt): visualR and the RANSAC gates matched to this
    world's LK noise, as motion smear on the renders puts genuine tracks'
    epipolar error beyond the sharp-image 2 px defaults."""
    p = Parameters()
    p.odometry.cameraTrailLength = 8
    p.tracker.maxTracks = 64
    p.tracker.focalLength = fx
    p.tracker.principalPointX = width / 2
    p.tracker.principalPointY = height / 2
    p.tracker.pyrLKWindowSize = 15
    p.tracker.pyrLKMaxLevel = 2
    p.tracker.gfttMinDistance = 20.0
    p.odometry.imuToCameraMatrix = tuple(SYNTH_IMU_TO_CAMERA.T.flatten())
    p.odometry.visualR = 0.5  # textured LK is noisier than blob LK
    p.tracker.ransac2Threshold = 8.0
    p.tracker.ransac5Threshold = 4.0
    return p


def stereo_second_extrinsic(baseline_m: float = 0.11) -> np.ndarray:
    """The second camera's imu_to_camera, an EuRoC-like horizontal baseline."""
    second = np.asarray(SYNTH_IMU_TO_CAMERA).copy()
    second[0, 3] = -baseline_m
    return second


def imu_batches(seq, frames, S: int, dtype, device):
    """Per frame 1..frames-1: (ImuBatch of one lane padded to S columns,
    valid count), the samples since the previous frame."""
    prev = seq.frame_sample_idx[0] + 1
    for fi in range(1, frames):
        k = seq.frame_sample_idx[fi] + 1
        n = k - prev
        pad = S - n
        t = np.pad(seq.times[prev:k], (0, pad), constant_values=seq.times[k - 1])
        g = np.pad(seq.gyro[prev:k], ((0, pad), (0, 0)))
        a = np.pad(seq.acc[prev:k], ((0, pad), (0, 0)))
        prev = k
        lane = lambda x: torch.as_tensor(np.asarray(x)[None], dtype=dtype, device=device)
        yield ImuBatch(lane(t), lane(g), lane(a),
                       torch.as_tensor((np.arange(S) < n)[None], device=device)), n


def run_textured_probe(duration: float = 6.0, seed: int = 8, width: int = 320,
                       height: int = 240, fx: float = 260.0, dtype=None,
                       stereo: bool = False, fisheye: bool = False,
                       overrides: dict | None = None, device=None) -> dict:
    """Run mono, stereo or fisheye VIO (one lane) end to end on the
    textured world: {"ate_rmse_m", "frames", "finite"}, deterministic for a
    seed. ``dtype`` is the filter's (float32 unless given); fisheye renders
    through the KB4 model at 320x320 with a 120 px focal length."""
    device = torch.device(device) if device is not None else default_device()
    dtype = torch.float32 if dtype is None else dtype
    if fisheye:
        width = height = 320
        fx = 120.0  # a wide field of view over the same sensor
    p = textured_accuracy_params(width, height, fx)
    for k, v in (overrides or {}).items():
        g, n = k.split(".")
        p.set_parameter(g, n, v)
    if stereo:
        p.tracker.useStereo = True
        p.odometry.secondImuToCameraMatrix = tuple(stereo_second_extrinsic().T.flatten())
    coeffs = None
    if fisheye:
        coeffs = KB4_PROBE
        p.tracker.fisheyeCamera = True
        p.tracker.validCameraFov = 150.0
        p.tracker.distortionCoeffs = coeffs
        cam = build_fisheye(fx, fx, width / 2, height / 2, coeffs=coeffs,
                            max_valid_fov_deg=150.0, width=width, height=height)
    else:
        cam = build_pinhole(fx, fx, width / 2, height / 2, width=width, height=height)
    cams = (cam, cam) if stereo else (cam,)

    seq = generate_sequence(duration=duration, imu_rate=100.0, frame_rate=10.0,
                            gyro_noise=5e-4, acc_noise=5e-3, seed=seed, radius=2.0)
    scene = TexturedScene(seed=seed, wall_radius=6.0)
    kw = dict(exposure_jitter=0.05, pixel_noise=0.01, motion_blur=True, fisheye_coeffs=coeffs)
    renders = [textured_frame_renderer(scene, seq, SYNTH_IMU_TO_CAMERA, fx, fx, width / 2,
                                       height / 2, width, height, **kw)]
    if stereo:
        renders.append(textured_frame_renderer(scene, seq, stereo_second_extrinsic(), fx, fx,
                                               width / 2, height / 2, width, height, **kw))

    def frame(fi):
        return tuple(torch.as_tensor(r(fi)[None], device=device) for r in renders)

    init, step, _ = make_batched_vio(p, DerivedParameters.from_parameters(p), cams,
                                     batch_size=1, max_tracks=p.tracker.maxTracks,
                                     dtype=dtype, device=device)
    F = len(seq.frame_sample_idx)
    state = init(frame(0) if stereo else frame(0)[0], np.full(1, seq.frame_times[0]),
                 np.arange(1))
    S_max = int(np.max(np.diff(np.concatenate([[0], seq.frame_sample_idx + 1]))))
    est = []
    for fi, (batch, _) in enumerate(imu_batches(seq, F, S_max, dtype, device), start=1):
        state, out = step(state, batch, frame(fi) if stereo else frame(fi)[0])
        est.append(out.position[0])
    est = torch.stack(est).double().cpu().numpy()
    finite = bool(np.isfinite(est).all())
    gt = seq.pos[seq.frame_sample_idx[1:F]] - seq.pos[0]
    ate = float(ate_rmse(est, gt)) if finite else float("nan")
    return {"ate_rmse_m": round(ate, 4) if finite else None, "frames": F - 1, "finite": finite}
