"""The bundle adjustment's cost over the problem size, and the sharded BA
against the unsharded one.

  ba-sweep    ``ba_iterate`` (8 Gauss-Newton iterations, float64) over NK
              keyframes x MP map points: NK 20 at MP 1024 / 8192 / 32768 /
              65536, NK 40 and NK 80 at MP 1024 / 8192 / 32768; each NK one
              ``graphs.CapturedStep`` (a CUDA graph a signature on the
              card), timed after two warm-ups in growing batches until
              0.5 s have passed; then the point side's marginal cost a
              1,000 points at each NK (a least-squares slope), the fixed
              cost, and the map size past which two devices would win
              against an assumed 1 ms for summing the pose side.
  mesh-check  ``make_sharded_ba`` over meshes of 1 / 2 / 4 / 8 shards on
              one device (``parallel.batched.Mesh``) against
              ``ba_iterate`` at NK 20 / MP 1024: poses within 1e-5, points
              within 1e-4. One device's shards show the split and the
              equality, not a speed-up.

    python -m hybvio_tpu_torch.tools.scaling_bench ba-sweep|mesh-check [--device cpu]

Runs on the card unless ``--device cpu`` or HYBVIO_PLATFORM=cpu. Prints one
JSON line per mode; mesh-check exits 1 if a mesh is not ``ok``.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..graphs import CapturedStep, GraphPools, capturing_into
from ..parallel.batched import Mesh
from ..slam.ba import BAProblem, ba_iterate, make_sharded_ba
from . import resolve_device, split_device

GRID = ((20, (1024, 8192, 32768, 65536)), (40, (1024, 8192, 32768)), (80, (1024, 8192, 32768)))
ITERATIONS = 8
PSUM_MS = 1.0  # the assumed cost of summing the pose side across two devices


def _make_problem(NK=20, MP=128, seed=0, device="cpu") -> BAProblem:
    """A well-posed synthetic BA problem of the given size (cameras on a
    line looking at a point cloud, 0.002 observation noise, the points off
    by 1%), float64 on ``device``."""
    rng = np.random.RandomState(seed)
    poses = np.zeros((NK, 7))
    poses[:, 3] = 1.0
    poses[:, 0] = np.linspace(0, 2.0, NK)
    pts = rng.randn(MP, 3) * 2.0 + np.array([1.0, 0.0, 6.0])
    obs_ip = np.zeros((NK, MP, 2))
    obs_mask = np.zeros((NK, MP), bool)
    for i in range(NK):
        rel = pts - poses[i, :3]
        obs_ip[i] = rel[:, :2] / rel[:, 2:3]
        obs_mask[i] = rel[:, 2] > 1.0
    obs_ip += 0.002 * rng.randn(*obs_ip.shape)
    rel7 = np.zeros((NK - 1, 7))
    rel7[:, 3] = 1.0
    rel7[:, 0] = poses[1, 0] - poses[0, 0]

    def t(a):
        return torch.as_tensor(np.asarray(a)).to(device)

    return BAProblem(
        poses=t(poses), points=t(pts * (1 + 0.01 * rng.randn(MP, 3))), obs_ip=t(obs_ip),
        obs_mask=t(obs_mask), pose_valid=t(np.ones(NK, bool)), point_valid=t(np.ones(MP, bool)),
        prior_rel=t(rel7), prior_mask=t(np.ones(NK - 1, bool)), prior_w_pos=t(5.0),
        prior_w_rot=t(50.0))


def _time_ms(fn, arg, device, min_total_s=0.5, min_reps=3) -> float:
    """ms a call: two warm-ups (on the card the first call of a signature
    also captures it), then batches of calls, each ended by waiting for the
    device, growing until ``min_total_s`` have passed."""
    def wait():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn(arg)
    wait()
    fn(arg)
    wait()
    reps_done, elapsed, reps = 0, 0.0, min_reps
    while elapsed < min_total_s:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(arg)
        wait()
        elapsed += time.perf_counter() - t0
        reps_done += reps
        reps = max(reps, int(reps_done * 1.5))
        if reps_done > 100000:
            break
    return 1000.0 * elapsed / reps_done


def ba_program(pools: GraphPools) -> CapturedStep:
    """``ba_iterate`` at ITERATIONS, captured into ``pools``."""
    with capturing_into(pools):
        return CapturedStep(lambda prob: ba_iterate(prob, iterations=ITERATIONS),
                            "scaling_bench ba_iterate")


def sweep_row(fn, NK: int, MP: int, device) -> dict:
    """{"NK", "MP", "ms"} of ``fn`` (a ``ba_program``) on the problem of
    that size."""
    return {"NK": NK, "MP": MP, "ms": round(_time_ms(fn, _make_problem(NK, MP, device=device),
                                                     device), 3)}


def analyze(rows) -> list:
    """A least-squares line through each NK's rows: the fixed cost, the
    cost a 1,000 points, and the map size past which two devices win."""
    analysis = []
    for NK in sorted({r["NK"] for r in rows}):
        sub = [r for r in rows if r["NK"] == NK]
        xs = np.array([r["MP"] for r in sub], float)
        ys = np.array([r["ms"] for r in sub], float)
        slope = float(np.polyfit(xs, ys, 1)[0])  # ms a point
        fixed = float(max(ys[0] - slope * xs[0], 0.0))
        analysis.append({
            "NK": NK,
            "ms_fixed_overhead": round(fixed, 3),
            "ms_per_1k_points": round(slope * 1000, 4),
            "crossover_points_2chips": int(2 * PSUM_MS / slope) if slope > 1e-9 else None,
        })
    return analysis


def ba_sweep(device=None, grid=GRID) -> dict:
    device = resolve_device(device)
    pools = GraphPools("scaling_bench")
    rows = []
    for NK, mps in grid:
        fn = ba_program(pools)
        rows.extend(sweep_row(fn, NK, MP, device) for MP in mps)
        del fn  # its graphs go back to the pool before the next NK's
    return {"mode": "ba-sweep", "backend": device.type, "rows": rows,
            "assumed_psum_ms": PSUM_MS, "analysis": analyze(rows)}


def mesh_check(device=None, shards=(1, 2, 4, 8), NK=20, MP=1024) -> dict:
    """The sharded BA over ``n`` shards of one device, for each n, against
    ``ba_iterate``."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    prob = _make_problem(NK, MP, device=device)
    ref_poses, ref_pts, _ = ba_iterate(prob, iterations=ITERATIONS)
    out = []
    for n in shards:
        sharded = make_sharded_ba(Mesh((device,) * n), iterations=ITERATIONS)
        sp, spts, _ = sharded(prob)
        ok = bool(torch.allclose(ref_poses, sp, rtol=1e-5, atol=1e-5)
                  and torch.allclose(ref_pts, spts, rtol=1e-5, atol=1e-4))
        out.append({"devices": n, "ok": ok, "points_per_device": MP // n,
                    "NK_replicated": NK})
    return {"mode": "mesh-check", "results": out}


def main(argv=None) -> int:
    device, argv = split_device(sys.argv[1:] if argv is None else argv)
    mode = argv[0] if argv else "ba-sweep"
    if mode == "ba-sweep":
        print(json.dumps(ba_sweep(device)))
        return 0
    if mode == "mesh-check":
        res = mesh_check(device)
        print(json.dumps(res))
        return 0 if all(r["ok"] for r in res["results"]) else 1
    raise SystemExit(f"unknown mode {mode}")


if __name__ == "__main__":
    raise SystemExit(main())
