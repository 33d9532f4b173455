"""The long textured-world accuracy protocol (port of the reference's
``eval/long_probe.py``).

``eval/textured_probe.py`` proves the front-end survives realistic images
over 6 s at 320x240; this protocol runs the whole VIO over long textured
sequences (60 s, 600 frames, by default) at the benchmark resolutions
(752x480 pinhole mono and stereo, 512x512 KB4 fisheye) on a trajectory that
laps the textured cylinder ~3.7 times, so the same scenery is seen again
every ~16 s with broken tracks between: long duration, revisits,
occlusion, exposure jitter, pixel noise and motion blur, the shape of the
reference's real-dataset protocol (full EuRoC / TUM-VI sequences).

Frames render on the device (``io/textured_device.py``) a chunk at a time
and never leave it. The mono, stereo and fisheye families run ``Vio.step``
at one lane (on the card its CUDA graph, replayed each frame); stereo_api (the same stereo run through ``VioApi`` and its
sample synchronizer) and vislam (``VioApi`` with the SLAM worker) run the
host entry point. The reference's compilation-cache lines and its
``HYBVIO_LONG_SCAN`` chunked-scan driver have no counterpart here.

    python -m hybvio_tpu_torch.eval.long_probe --family stereo --duration 60 [--sqrt]

prints one JSON line with the run's result.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from ..config import DerivedParameters
from ..eval.ate import ate_rmse
from ..geometry.cameras import build_camera_from_params
from ..io.synthetic import SYNTH_IMU_TO_CAMERA, generate_sequence
from ..io.textured import TexturedScene
from ..io.textured_device import make_textured_renderer
from ..models import synthetic_bench_params
from ..parallel.batched import make_batched_vio
from ..runtime import default_device
from .textured_probe import imu_batches

KB4_LONG = (0.0035, 0.0007, -0.002, 0.0002)  # the fisheye preset's lens
FAMILIES = ("mono", "stereo", "fisheye", "stereo_api", "vislam")


def long_probe_params(family: str = "stereo", overrides: Optional[dict] = None):
    """(Parameters, width, height, fx, fisheye coefficients or None) of a
    family: the benchmark preset (``models.synthetic_bench_params``) with
    the textured world's measurement noise (as ``textured_accuracy_params``:
    LK on motion-blurred texture is noisier than on blobs)."""
    base = "stereo" if family in ("vislam", "stereo_api") else family
    p = synthetic_bench_params(base)
    if family == "vislam":
        p.slam.useSlam = True
        p.slam.applyLoopClosures = True
        p.slam.keyframeCandidateInterval = 4
    p.odometry.visualR = 0.5
    if family == "fisheye":
        W = H = 512
        fx, coeffs = 190.0, KB4_LONG
    else:
        W, H = 752, 480
        fx, coeffs = 458.0, None
    for k, v in (overrides or {}).items():
        g, n = k.split(".")
        p.set_parameter(g, n, v)
    return p, W, H, fx, coeffs


class _FrameCache:
    """Renders frames a chunk at a time on first access and holds only the
    current chunk of each camera on the device (a 600-frame 752x480 stereo
    run never holds more than two chunks)."""

    def __init__(self, seq, renderers, chunk: int = 32):
        self.seq = seq
        self.renderers = renderers  # render_sequence functions, one per camera
        self.chunk = chunk
        self._cur = (-1, None)  # (chunk index, one (chunk, H, W) tensor per camera)

    def get(self, fi: int):
        """Frame ``fi`` of every camera, (H, W) device tensors."""
        c = fi // self.chunk
        if self._cur[0] != c:
            lo = c * self.chunk
            idx = np.arange(lo, min(lo + self.chunk, len(self.seq.frame_sample_idx)))
            self._cur = (c, tuple(r(self.seq, idx, chunk=self.chunk) for r in self.renderers))
        return tuple(imgs[fi - c * self.chunk] for imgs in self._cur[1])


def _build_world(family: str, seq, W: int, H: int, fx: float, coeffs, seed: int,
                 scene_kwargs: Optional[dict] = None, device=None):
    """(renderers, the second camera's imu_to_camera or None) of a family."""
    scene = TexturedScene(seed=seed, wall_radius=6.0, **(scene_kwargs or {}))
    kw = dict(exposure_jitter=0.05, pixel_noise=0.01, motion_blur=True,
              fisheye_coeffs=coeffs, device=device)
    rl = make_textured_renderer(scene, SYNTH_IMU_TO_CAMERA, fx, fx, W / 2, H / 2, W, H, **kw)
    if family in ("stereo", "vislam", "stereo_api"):
        second = np.asarray(SYNTH_IMU_TO_CAMERA).copy()
        second[0, 3] = -0.11  # the preset's EuRoC-like baseline
        rr = make_textured_renderer(scene, second, fx, fx, W / 2, H / 2, W, H, **kw)
        return (rl, rr), second
    return (rl,), None


def _make_sequence(duration: float, seed: int, frame_rate: float, imu_rate: float):
    return generate_sequence(duration=duration, imu_rate=imu_rate, frame_rate=frame_rate,
                             gyro_noise=5e-4, acc_noise=5e-3, seed=seed, radius=2.0)


def _geometry(family, overrides, width, height, fx):
    p, W, H, FX, coeffs = long_probe_params(family, overrides)
    if width is not None:  # a reduced shape (the CPU tests): intrinsics rescaled with it
        scale = width / W
        W, H = width, (height or int(round(H * width / 752)))
        FX = fx if fx is not None else FX * scale
        p.tracker.focalLength = FX
        p.tracker.principalPointX = W / 2
        p.tracker.principalPointY = H / 2
        p.tracker.gfttMinDistance = max(p.tracker.gfttMinDistance * scale, 8.0)
    return p, W, H, FX, coeffs


def run_long_probe(family: str = "stereo", duration: float = 60.0, seed: int = 8,
                   frame_rate: float = 10.0, imu_rate: float = 100.0, chunk: int = 32,
                   overrides: Optional[dict] = None, width: Optional[int] = None,
                   height: Optional[int] = None, fx: Optional[float] = None,
                   scene_kwargs: Optional[dict] = None, dtype=None, device=None) -> dict:
    """Run one family of the long textured protocol end to end on ``device``
    (the card unless told otherwise), the filter in ``dtype`` (float32
    unless given): {"ate_rmse_m", "frames", "duration_s", "finite",
    "resolution", "wall_s"}; the API families add fps_steady, teardown_s
    and native_sync (whether the native synchronizer ran), vislam its SLAM
    counts. ``width`` (and ``height``) run a
    reduced shape with the intrinsics rescaled."""
    device = torch.device(device) if device is not None else default_device()
    dtype = torch.float32 if dtype is None else dtype
    if family not in FAMILIES:
        raise ValueError(f"family {family!r} not in {FAMILIES}")
    if family in ("vislam", "stereo_api"):
        return _run_api(family, duration, seed, frame_rate, imu_rate, chunk, overrides,
                        width, height, fx, scene_kwargs, dtype, device)
    return _run_step(family, duration, seed, frame_rate, imu_rate, chunk, overrides,
                     width, height, fx, scene_kwargs, dtype, device)


def _run_step(family, duration, seed, frame_rate, imu_rate, chunk, overrides, width, height,
              fx, scene_kwargs, dtype, device) -> dict:
    """The one-lane ``Vio.step`` loop over the device-rendered frames (the
    reference's ``_run_jitted``): on the card the compiled step of
    ``make_batched_vio``, a CUDA graph replayed each frame, as the reference
    jits its step; positions stay on the device until the end (no host read
    per frame)."""
    p, W, H, FX, coeffs = _geometry(family, overrides, width, height, fx)
    cams = [build_camera_from_params(p.tracker, W, H)]
    if p.tracker.useStereo:
        cams.append(build_camera_from_params(p.tracker, W, H, second=True))
    seq = _make_sequence(duration, seed, frame_rate, imu_rate)
    renderers, _ = _build_world(family, seq, W, H, FX, coeffs, seed, scene_kwargs, device)
    frames = _FrameCache(seq, renderers, chunk=chunk)
    init, step, _ = make_batched_vio(p, DerivedParameters.from_parameters(p), tuple(cams),
                                     batch_size=1, max_tracks=p.tracker.maxTracks,
                                     dtype=dtype, device=device)
    stereo = bool(p.tracker.useStereo)

    def frame(fi):
        imgs = tuple(im[None] for im in frames.get(fi))
        return imgs if stereo else imgs[0]

    F = len(seq.frame_sample_idx)
    state = init(frame(0), np.full(1, seq.frame_times[0]), np.arange(1))
    S_max = int(np.max(np.diff(np.concatenate([[0], seq.frame_sample_idx + 1]))))
    t_start = time.perf_counter()
    est = []
    for fi, (batch, _) in enumerate(imu_batches(seq, F, S_max, dtype, device), start=1):
        state, out = step(state, batch, frame(fi))
        est.append(out.position[0])
    est = torch.stack(est).double().cpu().numpy()
    wall = time.perf_counter() - t_start
    finite = bool(np.isfinite(est).all())
    gt = seq.pos[seq.frame_sample_idx[1:F]] - seq.pos[0]
    ate = float(ate_rmse(est, gt)) if finite else float("nan")
    return {"ate_rmse_m": round(ate, 4) if finite else None, "frames": F - 1,
            "duration_s": round(duration, 1), "finite": finite, "resolution": f"{W}x{H}",
            "wall_s": round(wall, 1)}


def _run_api(family, duration, seed, frame_rate, imu_rate, chunk, overrides, width, height,
             fx, scene_kwargs, dtype, device) -> dict:
    """The whole host entry point: ``VioApi`` with its sample synchronizer,
    the stereo step and for vislam the SLAM worker. frames/s counts the
    steady state, after 3 warm-up frames and before ``finish()``'s
    teardown, which is reported on its own."""
    from ..api.vio import VioApi
    from ..utils.timer import SLAM_TIME_STATS

    p, W, H, FX, coeffs = _geometry(family, overrides, width, height, fx)
    seq = _make_sequence(duration, seed, frame_rate, imu_rate)
    renderers, _ = _build_world(family, seq, W, H, FX, coeffs, seed, scene_kwargs, device)
    frames = _FrameCache(seq, renderers, chunk=chunk)
    if family == "vislam":  # the SLAM worker's stage split per keyframe
        SLAM_TIME_STATS.reset()
        SLAM_TIME_STATS.enabled = True

    api = VioApi(p, W, H, dtype=dtype, device=device)
    outputs = []
    api.on_output = outputs.append
    F = len(seq.frame_sample_idx)
    frame_at = {int(k): fi for fi, k in enumerate(seq.frame_sample_idx)}
    warmup_frames, t0, n_fed = 3, None, 0
    for k in range(int(seq.frame_sample_idx[F - 1]) + 1):
        api.add_gyro(seq.times[k], seq.gyro[k])
        api.add_acc(seq.times[k], seq.acc[k])
        fi = frame_at.get(k)
        if fi is not None:
            fr = frames.get(fi)
            api.add_frame_stereo(seq.times[k], fr[0], fr[1])
            n_fed += 1
            if n_fed == warmup_frames:
                t0 = time.perf_counter()
    t_end = time.perf_counter()
    api.finish()
    teardown_s = time.perf_counter() - t_end
    fps = max(n_fed - warmup_frames, 1) / max(t_end - (t0 or t_end), 1e-9)

    est = np.stack([np.asarray(o.position) for o in outputs])
    est_t = np.array([o.t for o in outputs])
    finite = bool(np.isfinite(est).all())
    gt = np.stack([np.interp(est_t, seq.times, seq.pos[:, i] - seq.pos[0, i])
                   for i in range(3)], axis=1)
    ate = float(ate_rmse(est, gt)) if finite else float("nan")
    out = {"ate_rmse_m": round(ate, 4) if finite else None, "frames": n_fed,
           "duration_s": round(duration, 1), "finite": finite, "resolution": f"{W}x{H}",
           "fps_steady": round(fps, 2), "teardown_s": round(teardown_s, 2),
           "native_sync": type(api.sample_sync).__name__ == "NativeSampleSync"}
    if family == "vislam":
        slam = api.slam.slam if api.slam else None
        out.update({"keyframes": len(slam.kf_order) if slam else 0,
                    "loop_events": len(slam.loop_events) if slam else 0,
                    "map_points": len(slam.points) if slam else 0,
                    "dropped_candidates": api.slam.dropped if api.slam else 0,
                    "slam_ms_per_kf": {k: round(v, 1) for k, v in
                                       SLAM_TIME_STATS.per_frame_timings().items()}})
        SLAM_TIME_STATS.enabled = False
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The long textured-world accuracy protocol: "
                                             "one run, one JSON line.")
    ap.add_argument("--family", choices=FAMILIES, default="stereo")
    ap.add_argument("--duration", type=float, default=60.0, help="seconds of sequence")
    ap.add_argument("--sqrt", action="store_true", help="the square-root filter "
                    "(odometry.useSquareRootEkf)")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32",
                    help="the filter's dtype")
    ap.add_argument("--device", default=None, help="the card unless given (e.g. cpu)")
    args = ap.parse_args(argv)
    overrides = {"odometry.useSquareRootEkf": True} if args.sqrt else None
    res = run_long_probe(args.family, duration=args.duration, overrides=overrides,
                         dtype=getattr(torch, args.dtype), device=args.device)
    dev = torch.device(args.device) if args.device else default_device()
    res.update(family=args.family, sqrt=args.sqrt, dtype=args.dtype,
               device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
