#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hybvio_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every CUDA kernel from csrc/ with nvcc (sm_90a);
  3. each kernel against its plain PyTorch version on the card at the
     stereo main-path shapes (exact for gather / greedy, <= 1e-6 max abs for
     the stencils), with CUDA-event timings of both (median of 25);
  4. the main path: the stereo preset at 752x480, B=16 lanes sharing each
     frame, float32, over a 60-frame synthetic sequence (io.synthetic, the
     benchmark's world); median step time, aggregate frames/s, finite lanes,
     ATE median against ground truth, and every kernel's launch count in
     that run. Fails on a kernel never launched, a non-finite lane or an
     ATE median over 0.05 m.
The second-to-last line is the kernel JSON, the last line the device JSON.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

B = 16
FRAMES = 60
ATE_LIMIT_M = 0.05
REPEATS = 25
STENCIL_TOL = 1e-6

KERNELS = {  # name -> (source, Pallas kernel it replaces)
    "patch_gather": ("hybvio_tpu_torch/csrc/patch_gather.cu",
                     "hybvio_tpu/ops/patch_gather_pallas.py:105"),
    "pyr_down": ("hybvio_tpu_torch/csrc/pyramid.cu",
                 "hybvio_tpu/ops/pyramid_pallas.py:83"),
    "scharr": ("hybvio_tpu_torch/csrc/pyramid.cu",
               "hybvio_tpu/ops/pyramid_pallas.py:118"),
    "corner_response": ("hybvio_tpu_torch/csrc/corner_response.cu",
                        "hybvio_tpu/ops/gftt_pallas.py:79"),
    "greedy_nms": ("hybvio_tpu_torch/csrc/greedy_nms.cu",
                   "hybvio_tpu/ops/nms_pallas.py:42"),
}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def cuda_ms(fn, repeats=REPEATS):
    """Median milliseconds of fn() by CUDA events, after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check_kernels(dev):
    """Phase 3: every kernel against its plain version at main-path shapes."""
    import torch

    from hybvio_tpu_torch import ops

    g = torch.Generator(device="cpu").manual_seed(0)
    img = torch.rand((480, 752), generator=g).to(dev)
    half = torch.rand((240, 376), generator=g).to(dev)
    results = {}

    def record(name, err, tol, kernel, plain):
        if not err <= tol:
            raise AssertionError(f"{name}: max abs error {err} > {tol}")
        results[name] = {"max_abs_err": float(err), "ms": cuda_ms(kernel),
                         "plain_ms": cuda_ms(plain)}
        print(f"kernel {name}: max_abs_err {err:.3g} (tol {tol}) "
              f"kernel {results[name]['ms']:.4f} ms, plain {results[name]['plain_ms']:.4f} ms",
              flush=True)

    # patch gather: LK / subpixel windows out of the shared frame (stride 0)
    shared = img.expand(B, 480, 752)
    errs = []
    for ps in (18, 50, 34, 33):
        y0 = torch.randint(-3, 480 - ps + 4, (B, 96), generator=g, dtype=torch.int32).to(dev)
        x0 = torch.randint(-3, 752 - ps + 4, (B, 96), generator=g, dtype=torch.int32).to(dev)
        out = ops.gather_patches(shared, y0, x0, ps)
        ref = ops.gather_patches_plain(shared, y0, x0, ps)
        errs.append(float((out - ref).abs().max()))
    y0 = torch.randint(0, 480 - 34 + 1, (B, 96), generator=g, dtype=torch.int32).to(dev)
    x0 = torch.randint(0, 752 - 34 + 1, (B, 96), generator=g, dtype=torch.int32).to(dev)
    record("patch_gather", max(errs), 0.0,
           lambda: ops.gather_patches(shared, y0, x0, 34),
           lambda: ops.gather_patches_plain(shared, y0, x0, 34))

    errs = [float((ops.pyr_down(im) - ops.pyr_down_plain(im)).abs().max()) for im in (img, half)]
    record("pyr_down", max(errs), STENCIL_TOL,
           lambda: ops.pyr_down(img), lambda: ops.pyr_down_plain(img))

    gx, gy = ops.scharr(img)
    rx, ry = ops.scharr_plain(img)
    record("scharr", max(float((gx - rx).abs().max()), float((gy - ry).abs().max())),
           STENCIL_TOL, lambda: ops.scharr(img), lambda: ops.scharr_plain(img))

    errs = [float((ops.corner_response(img, bs) - ops.corner_response_plain(img, bs)).abs().max())
            for bs in (3, 5)]
    record("corner_response", max(errs), STENCIL_TOL,
           lambda: ops.corner_response(img, 3), lambda: ops.corner_response_plain(img, 3))

    K = 192
    xy = torch.rand((B, K, 2), generator=g).to(dev) * torch.tensor([752.0, 480.0], device=dev)
    d2 = torch.sum((xy[:, :, None] - xy[:, None]) ** 2, dim=-1).contiguous()
    ok = (torch.rand((B, K), generator=g) > 0.2).to(dev)
    min_d2 = (35.0 * 480 / 720) ** 2
    taken = ops.greedy_min_distance(d2, ok, min_d2)
    ref = ops.greedy_min_distance_plain(d2, ok, min_d2)
    record("greedy_nms", float((taken != ref).sum()), 0.0,
           lambda: ops.greedy_min_distance(d2, ok, min_d2),
           lambda: ops.greedy_min_distance_plain(d2, ok, min_d2))
    return results


def run_slice(dev):
    """Phase 4: the batched stereo step at full width on the card."""
    import torch

    from hybvio_tpu.eval.ate import ate_rmse
    from hybvio_tpu.io.synthetic import SYNTH_IMU_TO_CAMERA, generate_sequence, render_view
    from hybvio_tpu_torch import ops, runtime
    from hybvio_tpu_torch.models import _finalize, synthetic_bench_params
    from hybvio_tpu_torch.odometry.backend import ImuBatch
    from hybvio_tpu_torch.parallel.batched import make_batched_vio

    params, derived, cams = _finalize(synthetic_bench_params("stereo"), 752, 480)
    seq = generate_sequence(duration=FRAMES / 20.0, imu_rate=200.0, frame_rate=20.0,
                            n_landmarks=500, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    F = len(seq.frame_times)
    second = np.asarray(SYNTH_IMU_TO_CAMERA).copy()
    second[0, 3] = -0.11
    t0 = time.perf_counter()
    frames = []
    for fi in range(F):
        k = seq.frame_sample_idx[fi]
        pair = [render_view(seq.landmarks, seq.pos[k], seq.quat[k], ext, 458.0, 458.0,
                            376.0, 240.0, 752, 480, blob_sigma=1.4)
                for ext in (SYNTH_IMU_TO_CAMERA, second)]
        frames.append(tuple(torch.as_tensor(f).to(dev) for f in pair))
    print(f"slice: rendered {F} stereo frames in {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.RandomState(1)
    S = int(np.max(np.diff(np.concatenate([[0], seq.frame_sample_idx + 1]))))
    batches, prev = [], seq.frame_sample_idx[0] + 1
    for fi in range(1, F):
        k = seq.frame_sample_idx[fi] + 1
        n, pad = k - prev, S - (k - prev)
        t = np.pad(seq.times[prev:k], (0, pad), constant_values=seq.times[k - 1])
        g = np.pad(seq.gyro[prev:k], ((0, pad), (0, 0)))
        a = np.pad(seq.acc[prev:k], ((0, pad), (0, 0)))
        gB = np.stack([g + 1e-4 * rng.randn(*g.shape) for _ in range(B)])
        aB = np.stack([a + 1e-3 * rng.randn(*a.shape) for _ in range(B)])
        fl = lambda x: torch.as_tensor(x, dtype=runtime.filter_dtype(dev), device=dev)
        batches.append(ImuBatch(fl(np.tile(t, (B, 1))), fl(gB), fl(aB),
                                torch.as_tensor(np.tile(np.arange(S) < n, (B, 1)), device=dev)))
        prev = k

    binit, bstep, _ = make_batched_vio(params, derived, cams, batch_size=B,
                                       dtype=runtime.filter_dtype(dev), device=dev)
    ops.reset_launch_counts()
    states = binit(frames[0], np.full(B, float(seq.frame_times[0])), np.arange(B))
    positions, step_ms = [], []
    for fi in range(1, F):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        states, out = bstep(states, batches[fi - 1], frames[fi])
        torch.cuda.synchronize()
        step_ms.append(1000.0 * (time.perf_counter() - ts))
        positions.append(out.position)
    launches = dict(ops.LAUNCHES)

    est = torch.stack(positions).cpu().numpy()  # (F-1, B, 3)
    if est.shape != (F - 1, B, 3):
        raise AssertionError(f"positions of shape {est.shape}")
    gt = seq.pos[seq.frame_sample_idx[1:F]] - seq.pos[0]
    finite = [b for b in range(B) if np.isfinite(est[:, b]).all()]
    ates = [float(ate_rmse(est[:, b], gt)) for b in finite]
    timed = step_ms[1:]  # the first step is the warm-up
    med = statistics.median(timed)
    fps = B * len(timed) / (sum(timed) / 1000.0)
    ate_med = float(np.median(ates)) if ates else float("nan")
    print(f"slice: B={B} 752x480 stereo f32, {F - 1} steps (1 warm-up): "
          f"median step {med:.2f} ms, aggregate {fps:.1f} frames/s, "
          f"warm-up step {step_ms[0]:.1f} ms", flush=True)
    print(f"slice: finite lanes {len(finite)}/{B}, ATE median {ate_med:.4f} m "
          f"(max {max(ates) if ates else float('nan'):.4f} m)", flush=True)
    print(f"slice: kernel launches {json.dumps(launches)}", flush=True)
    if len(finite) != B:
        raise AssertionError(f"only {len(finite)}/{B} lanes finite")
    if not ate_med <= ATE_LIMIT_M:
        raise AssertionError(f"ATE median {ate_med} m > {ATE_LIMIT_M} m")
    never = [k for k, v in launches.items() if v == 0]
    if never:
        raise AssertionError(f"kernels never launched on the main path: {never}")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError as e:
        return fail(f"torch not importable: {e}")
    if not torch.cuda.is_available():
        return fail("no CUDA device (torch.cuda.is_available() is False)")
    try:
        from hybvio_tpu_torch import ops, runtime
    except ImportError as e:
        return fail(f"the port is not importable here: {e}")
    if "jax" in sys.modules:
        return fail("jax was imported")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        return fail(f"nvidia-smi gave no card name and power limit: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}", flush=True)
    runtime.configure_precision()
    dev = runtime.default_device()
    try:
        secs = ops.build(force=True)
        print(f"build: nvcc sm_90a, {len(list(ops._lib.CSRC.glob('*.cu')))} sources, "
              f"{secs:.1f} s", flush=True)
        ops._lib.library()
        kern = check_kernels(dev)
        launches = run_slice(dev)
        torch.cuda.synchronize()
    except (AssertionError, RuntimeError, ValueError, TypeError) as e:
        return fail(f"{type(e).__name__}: {e}")
    if "jax" in sys.modules:
        return fail("jax was imported")
    rows = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[name], **kern[name]}
            for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
