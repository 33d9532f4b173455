"""The SLAM session's cost a keyframe as its map grows: a synthetic session
of ``n_kf`` keyframes (landmarks on a surrounding wall, revisit laps, so
that loop closures and the map-point search stay active) through the port's
``slam.session.Slam``, with the ``add_frame`` latency by keyframe-count
bucket. Bounded growth means the last bucket is not much slower than the
steady state: local BA is windowed (localBAProblemSize), the pose graph
re-solves only on new or still significant loops, and loop edges are
deduplicated per keyframe pair.

    python -m hybvio_tpu_torch.tools.slam_cost_curve [n_keyframes] [--descriptors] [--device cpu]

The session runs on the card (its programs CUDA graphs) unless
``--device cpu`` or HYBVIO_PLATFORM=cpu. Prints one JSON line {buckets,
ms_per_kf, ..., signatures}: ``signatures`` maps each of the session's
captured programs to the input signatures it captured (a program raises
beyond ``graphs.MAX_KEYS``).
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

from ..config import Parameters
from ..slam.session import Slam
from . import resolve_device, split_device


def run(n_kf: int = 200, descriptors: bool = False, kf_per_lap: int = 25,
        n_landmarks: int = 120, seed: int = 4, device=None) -> dict:
    p = Parameters()
    p.slam.keyframeDecisionAlways = True
    p.slam.applyLoopClosures = True
    p.slam.applyLocalBundleAdjustment = True
    p.slam.adjacentSpaceSize = 8
    p.slam.minLoopClosureFeatureMatches = 4
    p.slam.loopClosureRansacMinInliers = 4
    slam = Slam(p, compute_descriptors=descriptors, device=resolve_device(device))

    rng = np.random.RandomState(seed)
    ang_l = rng.rand(n_landmarks) * 2 * np.pi
    z_l = rng.rand(n_landmarks) * 2 - 1
    landmarks = np.stack([5.5 * np.cos(ang_l), 5.5 * np.sin(ang_l), z_l], axis=1)

    # each landmark's appearance: a fixed 31x31 patch a landmark index (the
    # same on every lap), the size of the ORB sampling window (slam/orb.py
    # _PATCH_R = 15), so that descriptors tell landmarks apart and the ratio
    # test lets loop-closure matches through
    patch_rng = np.random.RandomState(seed + 1)
    PR = 15
    patches = patch_rng.rand(n_landmarks, 2 * PR + 1, 2 * PR + 1).astype(np.float32) - 0.5

    def blob_image(ip, vis):
        img = np.full((240, 320), 0.3, np.float32)
        px = ip * 260.0 + np.array([160.0, 120.0])
        for i in np.where(vis)[0]:
            u, v = px[i]
            if PR + 1 <= u < 320 - PR - 1 and PR + 1 <= v < 240 - PR - 1:
                iu, iv = int(u), int(v)
                img[iv - PR:iv + PR + 1, iu - PR:iu + PR + 1] += 0.6 * patches[i]
        return np.clip(img, 0, 1)

    lat_ms = []
    for k in range(n_kf):
        lap, i = divmod(k, kf_per_lap)
        th = 2 * np.pi * i / kf_per_lap
        pos = np.array([2.0 * np.cos(th), 2.0 * np.sin(th), 0.0])
        # the camera looks outward (+z radial) in a right-handed frame
        c, s = np.cos(th), np.sin(th)
        T = np.eye(4)
        T[:3, 0] = [s, -c, 0]
        T[:3, 1] = [0, 0, -1]
        T[:3, 2] = [c, s, 0]
        T[:3, 3] = pos
        rel = landmarks - pos
        Xc = rel @ T[:3, :3]
        vis = Xc[:, 2] > 0.5
        ip = Xc[:, :2] / np.where(vis, Xc[:, 2], 1.0)[:, None]
        vis &= (np.abs(ip) < 0.6).all(axis=1)
        ids = np.where(vis, lap * 10000 + np.arange(n_landmarks), -1)
        img = blob_image(ip, vis) if descriptors else None
        t0 = time.perf_counter()
        slam.add_frame(img, T, ids[vis].astype(np.int32), ip[vis], t=float(k) * 0.5,
                       frame_num=k)
        lat_ms.append(1000.0 * (time.perf_counter() - t0))

    lat = np.asarray(lat_ms)
    warm = 5  # the first calls of the programs: captures (the reference: jit compiles)
    lat_w = lat.copy()
    lat_w[:warm] = np.median(lat)
    q = max(n_kf // 4, 1)
    buckets = [f"kf {i * q}-{(i + 1) * q - 1}" for i in range(4)]
    per_bucket = [round(float(np.mean(lat_w[i * q:(i + 1) * q])), 2) for i in range(4)]
    return {
        "n_keyframes": n_kf,
        "descriptors": descriptors,
        "buckets": buckets,
        "ms_per_kf": per_bucket,
        "p95_ms": round(float(np.percentile(lat, 95)), 2),
        "max_ms": round(float(lat.max()), 2),
        "kept_keyframes": len(slam.kf_order),
        "map_points": len(slam.points),
        "loop_edges": len(slam.loop_edges),
        "loops_applied": sum(1 for e in slam.loop_events if e.applied),
        "growth_ratio_last_vs_second_bucket": round(
            float(per_bucket[3] / max(per_bucket[1], 1e-9)), 2),
        "signatures": {prog.name: prog.keys for prog in slam.graph_pools.programs},
    }


def main(argv=None) -> int:
    device, argv = split_device(sys.argv[1:] if argv is None else argv)
    positional = [a for a in argv if not a.startswith("-")]
    n = int(positional[0]) if positional else 200
    print(json.dumps(run(n, descriptors="--descriptors" in argv, device=device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
