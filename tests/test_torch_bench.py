"""The port's benchmark program (``hybvio_tpu_torch/bench.py``) on the CPU:
its budget and output machinery (one line, printed once from a snapshot;
the watchdog's stub and partial lines and their exit codes; a stage's
error and a budget skip), the live-ingest and scan stages against the
prestaged loop, the mono seeds, the absence of a CPU fallback, and (slow:
the reference's bench compiles its step for ~35 s a run) its batched and
single runs against the JAX package's ``bench.py``, trajectory by
trajectory.

    python -m pytest tests/test_torch_bench.py -q            # ~40 s
    python -m pytest tests/test_torch_bench.py -q -m slow    # ~2.5 min
"""
import functools
import inspect
import json
import os
import subprocess
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from hybvio_tpu_torch import bench
from torch_parity import mono_step_tol, step_tol

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

# the reference's headline extra keys without a stage, and with seed diverse
HEADLINE_KEYS = {"batch", "frames_per_seq", "step_latency_ms", "finite_lanes",
                 "ate_rmse_m_median", "backend", "core_wall_s"}
LIVE_KEYS = {"fps_prestaged", "fps_live_serial", "fps_live_prefetch", "h2d_ms_per_frame",
             "step_ms_prestaged", "serial_ms_per_frame", "overlapped_ms_per_frame",
             "hidden_frac", "frames", "fps_live_serial_u8", "fps_live_prefetch_u8",
             "h2d_u8_ms_per_frame"}
SCAN_KEYS = {"fps_scan", "fps_eager_loop", "scan_step_ms", "finite_lanes", "ate_rmse_m_median"}


@pytest.fixture
def fresh(monkeypatch):
    """The module's line state emptied, and an unbounded budget."""
    monkeypatch.setattr(bench, "RESULT", {})
    monkeypatch.setattr(bench, "CORE_T", {})
    monkeypatch.setattr(bench, "_EMITTED", threading.Event())
    monkeypatch.setattr(bench, "remaining", lambda: 1e9)
    return bench


def json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_stage_gate_records_a_skip(fresh, monkeypatch):
    monkeypatch.setattr(bench, "remaining", lambda: 50.0)
    assert bench.stage_gate("cheap", 40.0) is True
    assert bench.stage_gate("expensive", 200.0) is False
    assert bench.RESULT["extra"]["skipped_budget"] == [
        {"stage": "expensive", "est_s": 200.0, "remaining_s": 50.0}]


def test_emit_prints_exactly_once(fresh, capsys):
    assert bench.emit() is False  # nothing published: nothing printed
    bench.publish({"metric": "m", "value": 1})
    assert bench.emit(tag="first") is True
    assert bench.emit(tag="second") is False
    (line,) = json_lines(capsys.readouterr().out)
    assert line["value"] == 1 and line["extra"]["emitted_by"] == "first"
    assert "bench_wall_s" in line["extra"]


def test_emit_prints_a_snapshot_while_other_threads_write_extra(fresh, capsys):
    """Every line parses and holds whole legs while four threads keep
    adding legs to extra (the legs cleared every 64 writes), with the
    interpreter switching threads every microsecond."""
    bench.publish({"metric": "m", "value": 1, "extra": {}})
    stop = threading.Event()

    def writer(w):
        i = 0
        while not stop.is_set():
            if i % 64 == 0:
                bench.record("textured_long", value={})
            leg = {"i": i, "ates": list(range(i % 40))}
            bench.record("textured_long", f"leg{w}_{i}", value=leg)
            i += 1

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for _ in range(200):
            bench._EMITTED.clear()
            assert bench.emit(tag="snapshot")
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    lines = json_lines(capsys.readouterr().out)
    assert len(lines) == 200
    for line in lines:
        legs = line["extra"]["textured_long"]
        assert all(v["i"] == int(k.split("_")[1]) and v["ates"] == list(range(v["i"] % 40))
                   for k, v in legs.items())
    assert sum(len(line["extra"]["textured_long"]) for line in lines) > 0


WATCHDOG_RUN = """
import os, time
os.environ["BENCH_BUDGET_S"] = "1"
os.environ["BENCH_WATCHDOG_GRACE_S"] = "1"
from hybvio_tpu_torch import bench
if {partial}:
    bench.publish({{"metric": "partial", "value": 7, "extra": {{"batch": 2}}}})
bench.start_watchdog()
time.sleep(30)  # a stage that hangs
print("UNREACHABLE")
"""


@pytest.mark.parametrize("partial", [False, True], ids=["stub", "partial"])
def test_watchdog_prints_one_line_and_exits_nonzero(partial):
    """At budget + grace the watchdog prints the line as it stands (a stub
    with the mode's metric and value null when nothing was published) and
    exits with CUT_RC, within a few seconds."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    r = subprocess.run([sys.executable, "-c", WATCHDOG_RUN.format(partial=partial)], cwd=REPO,
                       capture_output=True, text=True, timeout=60, env=env)
    assert r.returncode == bench.CUT_RC, r.stdout + r.stderr
    assert "UNREACHABLE" not in r.stdout
    (line,) = json_lines(r.stdout)
    assert line["extra"]["emitted_by"] == "watchdog" and "watchdog fired" in line["extra"]["error"]
    if partial:
        assert (line["metric"], line["value"], line["extra"]["batch"]) == ("partial", 7, 2)
    else:
        assert line["metric"] == "synthetic_stereo_vio_batched_fps_per_chip"
        assert line["value"] is None


@pytest.fixture
def light_main(fresh, monkeypatch):
    """main() in this process with the world, the headline and the
    watchdog replaced: the scan stage is the only one on."""
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)
    for k, v in (("BENCH_PLATFORM", "cpu"), ("BENCH_SCAN", "1"), ("BENCH_LONG", "0"),
                 ("BENCH_TEXTURED", "0"), ("BENCH_H2D", "0"), ("BENCH_SEED_DIVERSE", "0")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(bench, "start_watchdog", lambda: None)
    monkeypatch.setattr(bench, "setup", lambda config, n, B, device: types.SimpleNamespace(
        config=config, B=B, device=device))
    monkeypatch.setattr(bench, "stage_batched", lambda b, shared: types.SimpleNamespace(bench=b))
    monkeypatch.setattr(bench, "run_headline", lambda run: (
        {"metric": "m", "value": 10.0, "unit": "u", "vs_baseline": 0.05,
         "extra": {"batch": run.bench.B}}, None))
    return bench


def test_a_stage_that_raises_is_printed_and_exits_1(light_main, monkeypatch, capsys):
    def broken(run):
        raise ValueError("the scan broke")

    monkeypatch.setattr(bench, "scan_throughput", broken)
    assert bench.run_main() == 1
    (line,) = json_lines(capsys.readouterr().out)
    extra = line["extra"]
    assert line["value"] == 10.0 and extra["emitted_by"] == "complete"
    assert "the scan broke" in extra["stage_errors"]["scan_throughput"]
    assert "scan_throughput" in extra["stage_wall_s"]
    assert (extra["device"], extra["implementation"]) == ("cpu", "hybvio_tpu_torch")


def test_a_budget_skip_exits_0(light_main, monkeypatch, capsys):
    ran = []
    monkeypatch.setattr(bench, "scan_throughput", lambda run: ran.append(run))
    monkeypatch.setitem(bench.EST_S, "scan_throughput", 1e12)
    assert bench.run_main() == 0
    (line,) = json_lines(capsys.readouterr().out)
    assert not ran and "stage_errors" not in line["extra"]
    assert [s["stage"] for s in line["extra"]["skipped_budget"]] == ["scan_throughput"]


def test_importing_the_module_starts_no_thread_and_touches_no_card():
    code = ("import threading, torch\n"
            "n = threading.active_count()\n"
            "import hybvio_tpu_torch.bench\n"
            "print(n, threading.active_count(), torch.cuda.is_initialized())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    n0, n1, touched = r.stdout.split()
    assert n0 == n1 and touched == "False"


def test_without_a_card_or_a_cpu_request_it_fails():
    """No probe and no fallback: with no card (torch.cuda.is_available
    False) and neither BENCH_PLATFORM nor HYBVIO_PLATFORM, the run exits
    non-zero and prints no numeric value."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_") and k != "HYBVIO_PLATFORM"}
    code = ("import runpy, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "runpy.run_module('hybvio_tpu_torch.bench', run_name='__main__')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120, env=env)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert all(line.get("value") is None for line in json_lines(r.stdout)), r.stdout


def test_the_platform_variables_choose_the_cpu(monkeypatch):
    monkeypatch.delenv("BENCH_PLATFORM", raising=False)
    monkeypatch.setenv("HYBVIO_PLATFORM", "cpu")
    assert bench.bench_device() == torch.device("cpu")
    monkeypatch.delenv("HYBVIO_PLATFORM")
    monkeypatch.setenv("BENCH_PLATFORM", "cpu")
    assert bench.bench_device() == torch.device("cpu")
    monkeypatch.setenv("BENCH_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="BENCH_PLATFORM"):
        bench.bench_device()


def test_mono_seeds_run_each_seed_once(fresh, monkeypatch):
    """With BENCH_MONO_SEEDS=8,9,9 the base mono leg (run_long_probe's
    default seed, 8) and seed 9 each run once, and the median is over the
    two; the legs run in the reference's order."""
    from hybvio_tpu_torch.eval import long_probe

    real = long_probe.run_long_probe
    default_seed = inspect.signature(real).parameters["seed"].default
    calls = []

    @functools.wraps(real)
    def fake(family, **kwargs):
        seed = kwargs.get("seed", default_seed)
        calls.append((family, seed))
        return {"ate_rmse_m": 0.01 * seed, "finite": True}

    monkeypatch.setattr(long_probe, "run_long_probe", fake)
    monkeypatch.setenv("BENCH_MONO_SEEDS", "8,9,9")
    monkeypatch.setenv("BENCH_LONG_DURATION", "1")
    bench.publish({"metric": "m", "value": 1.0})
    bench.record("textured_long", value={})
    for phase in (1, 2, 3):
        bench.textured_long_staged("cpu", phase)
    assert default_seed == 8
    assert [f for f, _ in calls] == ["stereo", "vislam", "mono", "fisheye", "stereo_api", "mono"]
    assert sorted(s for f, s in calls if f == "mono") == [8, 9]
    multi = bench.RESULT["extra"]["textured_long"]["mono_multiseed"]
    assert multi["seeds"] == [8, 9] and multi["median"] == round(float(np.median([0.08, 0.09])), 4)


def test_live_ingest_and_scan_equal_the_prestaged_loop(fresh, monkeypatch):
    """Stereo at one lane over 4 frames on the CPU: the serial and the
    prefetching live runs (float32 frames from the host) and the scan give
    the prestaged loop's positions bit for bit; the uint8 runs are finite;
    the stages report the reference's keys."""
    monkeypatch.setenv("BENCH_OVERRIDES", "tracker.maxTracks=48")
    world = bench.setup("stereo", 4, 1, torch.device("cpu"))
    run = bench.stage_batched(world, shared=True)
    headline, est = bench.run_headline(run)
    assert set(headline["extra"]) == HEADLINE_KEYS and est.shape == (3, 1, 3)
    res, pos = bench.live_ingest(run, 4)
    assert set(res) == LIVE_KEYS and res["frames"] == 3
    for name in ("serial", "prefetch"):
        np.testing.assert_array_equal(pos[name], est, err_msg=name)
    assert all(np.isfinite(pos[k]).all() for k in ("serial_u8", "prefetch_u8"))
    scan, scan_est = bench.scan_throughput(run)
    assert set(scan) == SCAN_KEYS and scan["finite_lanes"] == 1
    np.testing.assert_array_equal(scan_est, est)


# ---------------------------------------------------------------------------
# The two benches, each run whole in a subprocess: every trajectory handed
# to its package's ate_rmse is recorded, in order.
# ---------------------------------------------------------------------------
RUNNER = r"""
import importlib, os, runpy, sys
import numpy as np
which, out = sys.argv[1], sys.argv[2]
pkg = "hybvio_tpu" if which == "reference" else "hybvio_tpu_torch"
ate = importlib.import_module(pkg + ".eval.ate")
calls, ate_rmse = [], ate.ate_rmse

def recording(est, gt, *args, **kwargs):
    calls.append(np.array(est, np.float64))
    return ate_rmse(est, gt, *args, **kwargs)

ate.ate_rmse = recording
if os.environ.get("RUN_ACC_ULP"):  # the reference's accelerometer input one ulp up
    import jax.numpy as jnp
    import hybvio_tpu.parallel.batched as batched
    make = batched.make_batched_vio

    def nudged(*args, **kwargs):
        init, step = make(*args, **kwargs)
        up = jnp.float32(1.0000001)
        return init, lambda s, imu, f: step(s, imu._replace(acc=imu.acc * up), f)
    batched.make_batched_vio = nudged
rc = 0
try:
    if which == "reference":
        runpy.run_path("bench.py", run_name="__main__")
    else:
        from hybvio_tpu_torch import bench
        if os.environ.get("RUN_REFERENCE_FRAMES"):  # the reference's renderer
            import jax, torch
            from hybvio_tpu.io.synthetic_jax import make_blob_renderer as reference_renderer

            def renderer(*args, device=None, **kwargs):
                render = jax.vmap(reference_renderer(*args, **kwargs))

                def frames(*world):
                    world = [np.asarray(torch.as_tensor(a).cpu(), np.float32) for a in world]
                    return torch.as_tensor(np.asarray(render(*world))).to(device)
                return frames
            bench.make_blob_renderer = renderer
        rc = bench.run_main()
finally:
    np.savez(out, *calls)
sys.exit(rc)
"""


def start_bench(which, out, env, tmp_path, **extra):
    env = {**{k: v for k, v in os.environ.items() if not k.startswith("BENCH_")},
           "BENCH_PLATFORM": "cpu", "JAX_PLATFORMS": "cpu",
           "JAX_COMPILATION_CACHE_DIR": str(tmp_path / "jax_cache"), **env, **extra}
    return subprocess.Popen([sys.executable, "-c", RUNNER, which, str(out)], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finished(proc, timeout=600):
    """(the line, the trajectories) of a runner process; fails on rc != 0."""
    stdout, stderr = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, stdout[-2000:] + stderr[-4000:]
    (line,) = json_lines(stdout)
    with np.load(proc.args[-1]) as z:
        return line, [z[f"arr_{i}"] for i in range(len(z.files))]


BATCHED = {"BENCH_CONFIG": "stereo", "BENCH_FRAMES": "6", "BENCH_BATCH": "2",
           "BENCH_OVERRIDES": "tracker.maxTracks=48", "BENCH_H2D": "0", "BENCH_LONG": "0",
           "BENCH_TEXTURED": "0", "BENCH_SEED_DIVERSE_FRAMES": "4"}


@pytest.mark.slow
def test_batched_run_equals_the_reference_bench(tmp_path):
    """Stereo, B=2, 6 frames and seed diverse over 4, both benches fed the
    reference renderer's frames: the same line (metric, unit, counts, extra
    keys plus device and implementation) and each lane's trajectory to
    step_tol's position tolerance. The float32 filter's first visual update
    (frame 5) answers a one-ulp move of the reference's own accelerometer
    input by ~2.4e-6 m: from there each position is held to twice the
    reference's own move, and never looser than step_tol."""
    ref = start_bench("reference", tmp_path / "ref.npz", BATCHED, tmp_path)
    nudged = start_bench("reference", tmp_path / "ulp.npz", BATCHED, tmp_path,
                         BENCH_SEED_DIVERSE="0", RUN_ACC_ULP="1")
    port = start_bench("port", tmp_path / "port.npz", BATCHED, tmp_path,
                       RUN_REFERENCE_FRAMES="1")
    port_line, port_traj = finished(port)
    ref_line, ref_traj = finished(ref)
    _, ulp_traj = finished(nudged)
    for k in ("metric", "unit"):
        assert port_line[k] == ref_line[k], k
    for k in ("frames_per_seq", "batch", "finite_lanes"):
        assert port_line["extra"][k] == ref_line["extra"][k], k
    assert port_line["extra"]["seed_diverse"]["finite_lanes"] == 2
    assert set(port_line["extra"]) == set(ref_line["extra"]) | {"device", "implementation"}
    assert set(port_line["extra"]["seed_diverse"]) == set(ref_line["extra"]["seed_diverse"])
    assert len(port_traj) == len(ref_traj) == 4  # 2 headline lanes, 2 seed-diverse lanes
    tol = step_tol("position")
    for lane, (mine, theirs) in enumerate(zip(port_traj, ref_traj)):
        assert mine.shape == theirs.shape
        own = (np.abs(ulp_traj[lane] - theirs).max(axis=1) if lane < 2
               else np.zeros(len(theirs)))
        bound = np.maximum(tol, 2.0 * own)[:, None]
        assert np.all(np.abs(mine - theirs) <= bound), (lane, np.abs(mine - theirs), bound)


@pytest.mark.slow
def test_single_run_equals_the_reference_bench(tmp_path):
    """BENCH_MODE=single, mono, 6 frames, each bench on its own renderer:
    the line's metric, unit and extra keys, and the trajectory to
    mono_step_tol's position tolerance."""
    env = {"BENCH_MODE": "single", "BENCH_CONFIG": "mono", "BENCH_FRAMES": "6",
           "BENCH_OVERRIDES": "tracker.maxTracks=48"}
    ref = start_bench("reference", tmp_path / "ref.npz", env, tmp_path)
    port = start_bench("port", tmp_path / "port.npz", env, tmp_path)
    port_line, (mine,) = finished(port)
    ref_line, (theirs,) = finished(ref)
    for k in ("metric", "unit"):
        assert port_line[k] == ref_line[k], k
    assert port_line["extra"]["frames"] == ref_line["extra"]["frames"] == 5
    assert set(port_line["extra"]) == set(ref_line["extra"]) | {"device", "implementation"}
    assert mine.shape == theirs.shape == (5, 3)
    np.testing.assert_allclose(mine, theirs, rtol=0, atol=mono_step_tol("position"))
