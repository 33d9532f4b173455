"""Attribute the batched VIO step's time to its stages, at the step's own
shapes (``tools/worlds.py build_config``'s world, B lanes):

  full        the batched step (``make_batched_vio``)
  be-*        the step under a backend ablation (PROF_BE_ABLATE)
  frontend    the tracker's ``track_frame`` (pyramids, LK, stereo LK,
              RANSAC, detection)
  fe-*        the tracker under a front-end ablation (PROF_ABLATE)
  pyramids    the pyramids and gradients of the frame's image(s)
  lk+pyr      temporal LK of the left camera, with its pyramids
  stereo_lk+pyr  the guided left -> right match (stereo configs)
  detect      corner detection
  ransac2     the rotation RANSAC
  backend~    full - frontend (they share the pyramid work: attribution,
              not an exact decomposition)

Each program is a ``graphs.CapturedStep`` over the B lanes (on the card a
CUDA graph captured at its first call), timed over PROF_REPS replays
between CUDA events (the host clock on the CPU); each is released before
the next is captured, so the ablations do not pile up in the steps' graph
pool, whose size is reported at the end.

    PROF_CONFIG=stereo|mono|fisheye PROF_BATCH=16 PROF_REPS=20 \\
        python -m hybvio_tpu_torch.tools.profile_step [--device cpu]

PROF_ABLATE=0 / PROF_BE_ABLATE=0 skip the ablations, PROF_BE_ONLY=1 stops
after the backend ones. Prints the stage table, then one JSON line.
"""
from __future__ import annotations

import copy
import json
import os
import sys
import time

import numpy as np
import torch

from .. import random as jr
from ..config import DerivedParameters
from ..frontend.gftt import detect_corners
from ..frontend.lk import lk_track_pyramid
from ..frontend.pyramid import build_pyramids_with_gradients
from ..frontend.ransac import ransac2
from ..frontend.tracker import Tracker
from ..graphs import CapturedStep, _flatten, graph_pool_bytes
from ..io.synthetic import generate_sequence
from ..odometry.backend import ImuBatch
from ..parallel.batched import make_batched_vio
from . import resolve_device, split_device
from .worlds import build_config


def _finish(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, args, reps: int, device):
    """(ms a call, the last call's result): one call first (on the card the
    capture of a new signature), then ``reps`` calls between CUDA events on
    the card, or on the host clock on the CPU."""
    out = fn(*args)
    _finish(device)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    return 1000.0 * (time.perf_counter() - t0) / reps, out


def leaves_differ(a, b) -> int:
    """The tensor leaves of two results that are not bit-equal (NaN equal
    to NaN)."""
    la, lb = [], []
    if _flatten(a, la) != _flatten(b, lb):
        return max(len(la), len(lb))
    n = 0
    for x, y in zip(la, lb):
        same = (x == y) | (torch.isnan(x) & torch.isnan(y)) if x.is_floating_point() else x == y
        n += not bool(torch.all(same))
    return n


def _with(p, overrides):
    """A copy of ``p`` with {"group__name": value} set."""
    p2 = copy.deepcopy(p)
    for k, v in overrides.items():
        g, n = k.split("__")
        setattr(getattr(p2, g), n, v)
    return p2


def profile(config=None, batch=None, reps=None, device=None, check_eager: bool = False) -> dict:
    """Time every stage (the module docstring); PROF_* environment
    variables give what is not passed. Returns {"config", "batch", "reps",
    "device", "stages": {name: ms}, "pool_mib"} and, with ``check_eager``,
    "eager_leaves_differ": {name: leaves of the last captured call not
    bit-equal with the eager program on the same inputs}."""
    config = config or os.environ.get("PROF_CONFIG", "stereo")
    B = int(batch or os.environ.get("PROF_BATCH", "16"))
    reps = int(reps or os.environ.get("PROF_REPS", "20"))
    device = resolve_device(device)
    dtype = torch.float32

    p, cams, render, seq_kwargs = build_config(config, device)
    derived = DerivedParameters.from_parameters(p)
    use_stereo = bool(p.tracker.useStereo)
    seq = generate_sequence(duration=5.0, imu_rate=200.0, frame_rate=20.0, **seq_kwargs)

    def tile(frame):
        if isinstance(frame, tuple):
            return tuple(f.expand((B,) + f.shape) for f in frame)
        return frame.expand((B,) + frame.shape)

    frames = [tile(render(seq, fi)) for fi in range(3)]
    S = seq.frame_sample_idx[1] + 1
    imu = ImuBatch(
        torch.as_tensor(np.tile(seq.times[:S], (B, 1)), dtype=dtype, device=device),
        torch.as_tensor(np.tile(seq.gyro[:S], (B, 1, 1)), dtype=dtype, device=device),
        torch.as_tensor(np.tile(seq.acc[:S], (B, 1, 1)), dtype=dtype, device=device),
        torch.ones((B, S), dtype=torch.bool, device=device))
    results, differ = {}, {}

    def measure(name, program, args, eager=None):
        ms, out = timeit(program, args, reps, device)
        results[name] = ms
        if check_eager:
            differ[name] = leaves_differ(out, (eager or program.eager)(*args))
        return ms

    def full_with(**overrides):
        """The batched step of the preset under ``overrides``, timed on
        frame 2 after frames 0-1; released on return."""
        p2 = _with(p, overrides)
        init, step, _ = make_batched_vio(p2, DerivedParameters.from_parameters(p2), cams,
                                         batch_size=B, max_tracks=p2.tracker.maxTracks,
                                         dtype=dtype, device=device)
        st = init(frames[0], np.full(B, float(seq.frame_times[0])), np.arange(B))
        st, _ = step(st, imu, frames[1])  # get past frame 1
        return step, (st, imu, frames[2])

    def report():
        print(f"\n== stage times ({config} B={B}), ms/step ==")
        for k, v in results.items():
            print(f"  {k:14s} {v:8.2f}")

    def done():
        return {"config": config, "batch": B, "reps": reps, "device": str(device),
                "stages": results, "pool_mib": graph_pool_bytes(device) / 2**20
                if device.type == "cuda" else 0.0,
                **({"eager_leaves_differ": differ} if check_eager else {})}

    step, args = full_with()
    measure("full", step, args, eager=step.eager)
    del step, args

    if os.environ.get("PROF_BE_ABLATE", "1") == "1":
        for name, overrides in (("be-NV8", {"odometry__maxVisualUpdates": 8}),
                                ("be-gn3", {"odometry__triangulationGaussNewtonIterations": 3}),
                                ("be-seqVU", {"odometry__batchVisualUpdate": False}),
                                ("be-trail8", {"odometry__cameraTrailLength": 8})):
            step, args = full_with(**overrides)
            measure(name, step, args, eager=step.eager)
            del step, args
        if os.environ.get("PROF_BE_ONLY", "0") == "1":
            report()
            return done()

    # ---- the tracker alone
    def first_img(f):
        return f[0] if isinstance(f, tuple) else f

    def second_img(f):
        return f[1] if isinstance(f, tuple) else None

    T = p.tracker.maxTracks
    keys = jr.prng_key(torch.arange(B, device=device))
    t_now = torch.full((B,), 0.05, dtype=dtype, device=device)
    no_black = (torch.zeros((B, T), dtype=torch.bool, device=device),
                torch.full((B, T), -1, dtype=torch.int32, device=device))

    def tracker_program(params):
        tracker = Tracker(params, cams, derived, max_tracks=params.tracker.maxTracks).to(device)
        return CapturedStep(lambda ts, im, sim, k: tracker.track_frame(
            ts, im, k, t_now, None, *no_black, second_image=sim), "profile frontend"), tracker

    track, tracker = tracker_program(p)
    ts0 = tracker.init_state(first_img(frames[0]), torch.zeros((B,), dtype=dtype, device=device),
                             second_img(frames[0]))
    targs = (ts0, first_img(frames[1]), second_img(frames[1]), keys)
    measure("frontend", track, targs)
    del track, tracker

    if os.environ.get("PROF_ABLATE", "1") == "1":
        ablations = []
        if use_stereo:
            ablations += [("fe-no_epipolar", {"tracker__maxStereoEpipolarDistance": 0.0}),
                          ("fe-hybridR2R5", {"tracker__useRansac3": False,
                                             "tracker__useStereoUpright2p": False})]
        ablations.append(("fe-no_subpix", {"tracker__subPixMaxIter": 0}))
        for name, overrides in ablations:
            track, _ = tracker_program(_with(p, overrides))
            measure(name, track, targs)
            del track

    # ---- pyramids and gradients
    L = p.tracker.pyrLKMaxLevel
    pyramids = CapturedStep(lambda f: build_pyramids_with_gradients(
        f if use_stereo else (f,), L), "profile pyramids")
    measure("pyramids", pyramids, (frames[1],))
    del pyramids

    # ---- temporal LK with its pyramids
    lkp = Tracker(p, cams, derived, max_tracks=T).lk._replace(max_level=L)
    H, W = cams[0].height, cams[0].width
    rng = np.random.RandomState(0)
    pts = torch.as_tensor(rng.rand(B, T, 2) * np.array([W - 60, H - 60]) + 30, dtype=dtype,
                          device=device)

    def lk_one(prev_im, cur_im, pp, params):
        (pyr_p, pyr_c), grads = build_pyramids_with_gradients((prev_im, cur_im),
                                                              params.max_level)
        return lk_track_pyramid(pyr_p, grads, pyr_c, pp, initial_pts=pp, params=params)

    lk = CapturedStep(lambda a, b, pp: lk_one(a, b, pp, lkp), "profile lk+pyr")
    measure("lk+pyr", lk, (first_img(frames[0]), first_img(frames[1]), pts))
    del lk

    if use_stereo:
        smp = lkp._replace(max_level=1)
        sm = CapturedStep(lambda a, b, pp: lk_one(a, b, pp, smp), "profile stereo_lk+pyr")
        measure("stereo_lk+pyr", sm, (first_img(frames[1]), second_img(frames[1]), pts))
        del sm

    # ---- detection
    existing_valid = torch.ones((B, T), dtype=torch.bool, device=device)
    radius = torch.full((B,), 30.0, dtype=dtype, device=device)
    detect = CapturedStep(lambda img, ex: detect_corners(
        img, T, ex, existing_valid, radius, p.tracker.gfttMinDistance,
        block_size=p.tracker.gfttBlockSize, min_response=p.tracker.gfttMinResponse),
        "profile detect")
    measure("detect", detect, (first_img(frames[1]), pts))
    del detect

    # ---- the rotation RANSAC
    su = min(H, W) / 720.0
    valid = torch.ones((B, T), dtype=torch.bool, device=device)
    r2 = CapturedStep(lambda a, b, k: ransac2(cams[0], cams[0], a, b, valid, k,
                                              p.tracker.ransac2Threshold * su), "profile ransac2")
    measure("ransac2", r2, (pts, pts + 1.0, keys))
    del r2

    report()
    print(f"  {'backend~':14s} {results['full'] - results['frontend']:8.2f}  (full - frontend)")
    return done()


def main(argv=None) -> int:
    device, _ = split_device(sys.argv[1:] if argv is None else argv)
    print(json.dumps(profile(device=device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
