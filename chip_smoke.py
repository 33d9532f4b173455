#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hybvio_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every CUDA kernel from csrc/ with nvcc (sm_90a);
  3. each kernel against its plain PyTorch version on the card at the
     stereo main-path shapes (exact for gather / greedy, <= 1e-6 max abs for
     the stencils), plus edge cases of the greedy walk and the corner
     response; each kernel's device time (CUDA events around 100
     back-to-back calls, median of 5 runs) beside its bound (bytes over
     3.35 TB/s or float32 operations over 67 TFLOP/s, whichever is larger),
     its plain version's time and, where one PyTorch call computes the same
     function, that call's time;
  4. the main path: the stereo preset at 752x480, B=16 lanes sharing each
     frame, float32, over a 60-frame synthetic sequence (io.synthetic, the
     benchmark's world); median step time, aggregate frames/s, finite lanes,
     ATE median against ground truth, and every kernel's launch count in
     that run. Fails on a kernel never launched, a non-finite lane or an
     ATE median over 0.05 m;
  5. the kernels ranked by the time the main path loses in them.
Before the last line come the kernel JSON and the card's name and power
limit; the last line is the device JSON."""
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
STENCIL_TOL = 1e-6
R = 100  # back-to-back calls in one timed run
RUNS = 5  # timed runs; their median is kept
SLEEP_CYCLES_PER_S = 2e9  # the H100's top SM clock, rounded up
MAX_SLEEP_S = 0.25
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, same source

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


def device_ms(fn):
    """(ms, ahead): the card's time per call of fn, the median over RUNS runs
    of R back-to-back calls between two CUDA events (inputs made before).
    Before each run the stream sleeps long enough for the host to enqueue
    all R calls, so the card runs them back to back and never waits on the
    Python wrapper. ``ahead`` is False if the card caught up with the host in
    some run anyway (a composition of many launches can fill the queue);
    that time then includes host dispatch."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(R):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(min(3.0 * enqueue_s, MAX_SLEEP_S) * SLEEP_CYCLES_PER_S)
    times, ahead = [], True
    for _ in range(RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(R):
            fn()
        b.record()
        ahead = ahead and not a.query()
        b.synchronize()
        times.append(a.elapsed_time(b) / R)
    return statistics.median(times), ahead


def bound(nbytes, nops):
    """(ms, "bytes" | "operations"): the least time an H100 SXM could take to
    move nbytes and do nops float32 operations."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def greedy_inputs(g, b, k, shared, ties, dev):
    """(d2 (b, k, k), ok (b, k), min_d2) for the greedy walk: candidates on
    an integer grid when ``ties`` (so d2 == min_d2 happens), else uniform in
    the frame; d2 shared by every lane (batch stride 0) when ``shared``;
    lane 0 has no eligible candidate and, with b > 1, the last lane only
    eligible ones."""
    import torch

    n = 1 if shared else b
    if ties:
        xy = torch.randint(0, 40, (n, k, 2), generator=g).float()
        min_d2 = 100.0
    else:
        xy = torch.rand((n, k, 2), generator=g) * torch.tensor([752.0, 480.0])
        min_d2 = (35.0 * 480 / 720) ** 2
    d2 = torch.sum((xy[:, :, None] - xy[:, None]) ** 2, dim=-1).to(dev)
    if shared:
        d2 = d2[0].expand(b, k, k)
    ok = torch.rand((b, k), generator=g) > 0.2
    ok[0] = False
    if b > 1:
        ok[-1] = True
    return d2, ok.to(dev), min_d2


def check_edge_cases(dev, g):
    """The kernels against their plain versions where chunks, words, tiles
    and halos end: the gather of 1 to 3 images at odd and even window sizes,
    on widths whose rows are and are not 16-byte aligned, shared and
    per-lane images, B = 1 and 16, origins past the edges; greedy at K up
    to 1024, shared and per-lane d2, exact ties, B = 1 and 16; the corner
    response at blocks 3 and 5 on the frame and on two odd level sizes.
    Returns the number of cases."""
    import torch

    from hybvio_tpu_torch import ops

    cases = 0
    for h, w in ((480, 752), (239, 377), (60, 94)):  # 377, 94: rows not 16-byte aligned
        base = torch.rand((h, w), generator=g).to(dev)
        for b in (1, B):
            lanes = torch.rand((b, h, w), generator=g).to(dev)
            for ps in (18, 33, 34, 50):
                y0 = torch.randint(-3, h - ps + 4, (b, 96), generator=g, dtype=torch.int32).to(dev)
                x0 = torch.randint(-3, w - ps + 4, (b, 96), generator=g, dtype=torch.int32).to(dev)
                for images in ((base.expand(b, h, w),), (lanes, base.expand(b, h, w)),
                               (lanes, lanes * 2, base.expand(b, h, w))):
                    outs = ops.gather_patches(images, y0, x0, ps)
                    for out, im in zip(outs, images):
                        if not torch.equal(out, ops.gather_patches_plain(im, y0, x0, ps)):
                            raise AssertionError(f"patch_gather {h}x{w} B={b} ps={ps} "
                                                 f"{len(images)} images: windows differ")
                    cases += 1
    for k in (128, 192, 200, 1024):
        for b in (1, B):
            for shared in (True, False):
                for ties in (False, True):
                    d2, ok, min_d2 = greedy_inputs(g, b, k, shared, ties, dev)
                    bad = int((ops.greedy_min_distance(d2, ok, min_d2)
                               != ops.greedy_min_distance_plain(d2, ok, min_d2)).sum())
                    if bad:
                        raise AssertionError(f"greedy_nms K={k} B={b} shared={shared} "
                                             f"ties={ties}: {bad} decisions differ")
                    cases += 1
    for h, w in ((480, 752), (239, 377), (121, 189)):
        im = torch.rand((h, w), generator=g).to(dev)
        for bs in (3, 5):
            err = float((ops.corner_response(im, bs) - ops.corner_response_plain(im, bs))
                        .abs().max())
            if not err <= STENCIL_TOL:
                raise AssertionError(f"corner_response {h}x{w} block {bs}: "
                                     f"max abs error {err} > {STENCIL_TOL}")
            cases += 1
    return cases


def check_kernels(dev):
    """Phase 3: every kernel against its plain version at main-path shapes,
    timed on the card beside its bound, its plain version and, where one
    PyTorch call computes the same function, that call (never used by the
    port)."""
    import torch
    import torch.nn.functional as F

    from hybvio_tpu_torch import ops
    from hybvio_tpu_torch.ops.pyramid import PYR_K, SCHARR_D, SCHARR_S

    g = torch.Generator(device="cpu").manual_seed(0)
    H, W = 480, 752
    img = torch.rand((H, W), generator=g).to(dev)
    half = torch.rand((H // 2, W // 2), generator=g).to(dev)
    px = H * W
    results = {}

    def record(name, err, tol, kernel, plain, library, nbytes, nops):
        if not err <= tol:
            raise AssertionError(f"{name}: max abs error {err} > {tol}")
        ms, ahead = device_ms(kernel)
        plain_ms, plain_ahead = device_ms(plain)
        library_ms = device_ms(library)[0] if library is not None else None
        bound_ms, bound_by = bound(nbytes, nops)
        results[name] = {"max_abs_err": float(err), "ms": ms, "device_ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": library_ms}
        lib = f"{library_ms:.5f} ms" if library_ms is not None else "none"
        print(f"kernel {name}: max_abs_err {err:.3g} (tol {tol}); device {ms:.5f} ms"
              f"{'' if ahead else ' (card caught up with the host)'}, bound {bound_ms:.5f} ms "
              f"({bound_by}, {100 * bound_ms / ms:.1f}% of it), library {lib}, plain "
              f"{plain_ms:.5f} ms{'' if plain_ahead else ' (host-bound)'}", flush=True)

    # patch gather: LK search windows out of the shared frame (stride 0), one
    # image per launch; then the LK template's three images in one launch
    shared = img.expand(B, H, W)
    gx, gy = ops.scharr(img)
    errs = []
    for ps in (18, 50, 34, 33):
        y0 = torch.randint(-3, H - ps + 4, (B, 96), generator=g, dtype=torch.int32).to(dev)
        x0 = torch.randint(-3, W - ps + 4, (B, 96), generator=g, dtype=torch.int32).to(dev)
        (out,) = ops.gather_patches((shared,), y0, x0, ps)
        errs.append(float((out - ops.gather_patches_plain(shared, y0, x0, ps)).abs().max()))
    ps, n = 34, 96
    y0 = torch.randint(0, H - ps + 1, (B, n), generator=g, dtype=torch.int32).to(dev)
    x0 = torch.randint(0, W - ps + 1, (B, n), generator=g, dtype=torch.int32).to(dev)
    r = torch.arange(ps, device=dev)
    idx = (((y0.long()[..., None] + r) * W)[..., :, None]
           + (x0.long()[..., None] + r)[..., None, :]).reshape(B, -1)
    flat = img.reshape(1, -1).expand(B, -1)
    if not torch.equal(torch.gather(flat, 1, idx).reshape(B, n, ps, ps),
                       ops.gather_patches((shared,), y0, x0, ps)[0]):
        raise AssertionError("patch_gather: the torch.gather yardstick disagrees")
    record("patch_gather", max(errs), 0.0,
           lambda: ops.gather_patches((shared,), y0, x0, ps),
           lambda: ops.gather_patches_plain(shared, y0, x0, ps),
           lambda: torch.gather(flat, 1, idx),
           4 * (B * n * ps * ps + px + 2 * B * n), 0)
    three = (shared, gx.expand(B, H, W), gy.expand(B, H, W))
    pt = 18
    y0t = torch.randint(0, H - pt + 1, (B, n), generator=g, dtype=torch.int32).to(dev)
    x0t = torch.randint(0, W - pt + 1, (B, n), generator=g, dtype=torch.int32).to(dev)
    fused, _ = device_ms(lambda: ops.gather_patches(three, y0t, x0t, pt))
    single, _ = device_ms(lambda: [ops.gather_patches((im,), y0t, x0t, pt) for im in three])
    fbytes = 4 * (3 * B * n * pt * pt + 3 * px + 2 * B * n)
    results["patch_gather"].update(template_3img_ms=fused, template_3launches_ms=single,
                                   template_3img_bound_ms=bound(fbytes, 0)[0])
    print(f"kernel patch_gather, LK template (3 images of 16x96 windows of 18x18): one "
          f"launch {fused:.5f} ms, three launches {single:.5f} ms, bound "
          f"{bound(fbytes, 0)[0]:.5f} ms", flush=True)

    # pyr_down: the 5x5 outer-product kernel at stride 2 on the padded frame
    k5 = torch.tensor(np.outer(PYR_K, PYR_K), dtype=torch.float32, device=dev)[None, None]
    pad2 = F.pad(img[None, None], (2, 2, 2, 2), mode="replicate")
    lib_err = float((F.conv2d(pad2, k5, stride=2)[0, 0] - ops.pyr_down(img)).abs().max())
    errs = [float((ops.pyr_down(im) - ops.pyr_down_plain(im)).abs().max()) for im in (img, half)]
    ho, wo = (H + 1) // 2, (W + 1) // 2
    record("pyr_down", max(errs), STENCIL_TOL,
           lambda: ops.pyr_down(img), lambda: ops.pyr_down_plain(img),
           lambda: F.conv2d(pad2, k5, stride=2),
           4 * (px + ho * wo), 9 * H * wo + 9 * ho * wo)

    # Scharr: one 2-channel 3x3 convolution of the padded frame
    k3 = torch.tensor(np.stack([np.outer(SCHARR_S, SCHARR_D), np.outer(SCHARR_D, SCHARR_S)]),
                      dtype=torch.float32, device=dev)[:, None]
    pad1 = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")
    lib_err = max(lib_err, float((F.conv2d(pad1, k3)[0] - torch.stack([gx, gy])).abs().max()))
    rx, ry = ops.scharr_plain(img)
    record("scharr", max(float((gx - rx).abs().max()), float((gy - ry).abs().max())),
           STENCIL_TOL, lambda: ops.scharr(img), lambda: ops.scharr_plain(img),
           lambda: F.conv2d(pad1, k3), 4 * 3 * px, 2 * 10 * px)
    if not lib_err <= 1e-5:
        raise AssertionError(f"the conv2d yardsticks disagree with the stencils by {lib_err}")

    errs = [float((ops.corner_response(img, bs) - ops.corner_response_plain(img, bs)).abs().max())
            for bs in (3, 5)]
    record("corner_response", max(errs), STENCIL_TOL,
           lambda: ops.corner_response(img, 3), lambda: ops.corner_response_plain(img, 3),
           None, 4 * 2 * px, 46 * px)

    # greedy: the main path's layout, one d2 shared by the lanes (stride 0)
    K = 192
    d2, ok, min_d2 = greedy_inputs(g, B, K, True, False, dev)
    taken = ops.greedy_min_distance(d2, ok, min_d2)
    ref = ops.greedy_min_distance_plain(d2, ok, min_d2)
    record("greedy_nms", float((taken != ref).sum()), 0.0,
           lambda: ops.greedy_min_distance(d2, ok, min_d2),
           lambda: ops.greedy_min_distance_plain(d2, ok, min_d2),
           None, 4 * K * K + 2 * B * K, B * K * (K - 1) // 2)
    # and with a distinct d2 per lane
    d2l, okl, _ = greedy_inputs(g, B, K, False, False, dev)
    ms, _ = device_ms(lambda: ops.greedy_min_distance(d2l, okl, min_d2))
    bms, _ = bound(4 * B * K * K + 2 * B * K, B * K * (K - 1) // 2)
    results["greedy_nms"].update(per_lane_d2_ms=ms, per_lane_d2_bound_ms=bms)
    print(f"kernel greedy_nms, per-lane d2: device {ms:.5f} ms, bound {bms:.5f} ms", flush=True)

    print(f"edge cases: {check_edge_cases(dev, g)} gather / greedy / corner-response cases "
          f"equal their plain versions", flush=True)
    return results


def rank(rows):
    """The order in which the kernels lose the main path the most time:
    first any kernel slower than its library call, then the rest by
    launches x (device time - bound); a kernel at >= 50% of its bound and
    no slower than its library call is left alone."""
    def slower(r):
        return r["library_ms"] is not None and r["ms"] > r["library_ms"]

    for r in rows:
        r["loss_ms"] = r["launches"] * (r["ms"] - r["bound_ms"])
    order = sorted(rows, key=lambda r: (not slower(r), -r["loss_ms"]))
    return [(r["name"], r["loss_ms"], slower(r),
             r["bound_ms"] / r["ms"] >= 0.5 and not slower(r)) for r in order]


def run_slice(dev):
    """Phase 4: the batched stereo step at full width on the card."""
    import torch

    from hybvio_tpu_torch import ops, runtime
    from hybvio_tpu_torch.eval.ate import ate_rmse
    from hybvio_tpu_torch.io.synthetic import SYNTH_IMU_TO_CAMERA, generate_sequence, render_view
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

    binit, bstep, _ = make_batched_vio(params, derived, cams, batch_size=B, device=dev)
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
    print("ranking (launches x (device - bound) per 60-frame run): " + "; ".join(
        f"{name} {loss:.3f} ms{' SLOWER THAN ITS LIBRARY CALL' if slower else ''}"
        f"{' (>= 50% of its bound: left alone)' if alone else ''}"
        for name, loss, slower, alone in rank(rows)), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
