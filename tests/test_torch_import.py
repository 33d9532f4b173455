"""The port imports neither jax nor anything of the reference package, its
parameter surface and preset equal the reference's field by field, and
state round-trips through convert."""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybvio_tpu.config import DerivedParameters, Parameters, parameter_names
from hybvio_tpu.models import _finalize as ref_finalize
from hybvio_tpu.models import synthetic_bench_params as ref_params
from hybvio_tpu_torch import config as port_config
from hybvio_tpu_torch import convert
from hybvio_tpu_torch.models import _finalize, synthetic_bench_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "hybvio_tpu_torch").rglob("*.py"))
PORT_MODULES = [".".join(f.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
                for f in PORT_FILES]


def _is_reference(name):
    return name is not None and any(name == top or name.startswith(top + ".")
                                    for top in ("hybvio_tpu", "jax"))


def test_port_imports_no_jax():
    """Importing every module of the port loads neither jax nor any module
    of hybvio_tpu."""
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'hybvio_tpu')\n"
            "             or m.startswith(('jax.', 'hybvio_tpu.')))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_port_and_smoke_run_never_import_the_reference():
    """No import statement of the port, of chip_smoke.py or of the mav0
    writer it shares with the tests names jax or hybvio_tpu, not even
    inside a function."""
    found = []
    for path in PORT_FILES + [REPO / "chip_smoke.py", REPO / "tests" / "euroc_fixture.py"]:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                      for n in names if _is_reference(n)]
    assert len(PORT_FILES) > 40
    assert not found, found


def _fields(group):
    return {f.name: getattr(group, f.name) for f in dataclasses.fields(group)}


@pytest.mark.parametrize("group", ["odometry", "tracker", "slam"])
def test_port_parameters_equal_reference_defaults(group):
    assert (_fields(getattr(port_config.Parameters(), group))
            == _fields(getattr(Parameters(), group)))


def test_port_parameter_names_equal_reference():
    assert port_config.parameter_names() == parameter_names()


def test_preset_matches_reference_field_by_field():
    p, r = synthetic_bench_params("stereo"), ref_params("stereo")
    for group in ("odometry", "tracker", "slam"):
        assert _fields(getattr(p, group)) == _fields(getattr(r, group)), group


def test_derived_and_cameras_match_reference():
    p = synthetic_bench_params("stereo")
    d = port_config.DerivedParameters.from_parameters(p)
    dr = DerivedParameters.from_parameters(p)
    for name in ("imu_to_camera", "second_imu_to_camera", "imu_to_output"):
        np.testing.assert_array_equal(getattr(d, name), getattr(dr, name))
    _, _, cams = _finalize(p, 752, 480)
    _, _, rcams = ref_finalize(ref_params("stereo"), 752, 480, dtype=jnp.float64)
    for c, rc in zip(cams, rcams):
        assert c == convert.camera_from_jax(rc)


def test_convert_round_trips_vio_state():
    from hybvio_tpu.parallel.batched import make_batched_vio
    from torch_parity import tiny_stereo_setup

    p, derived, cam = tiny_stereo_setup()
    binit, _ = make_batched_vio(p, derived, (cam, cam), batch_size=2, max_tracks=12,
                                dtype=jnp.float64, shared_frames=True)
    rng = np.random.RandomState(0)
    imgs = tuple(jnp.asarray(rng.rand(64, 96), jnp.float32) for _ in range(2))
    st = jax.tree.map(np.asarray, binit(imgs, np.full(2, 10.0), np.arange(2)))
    back = convert.to_numpy(convert.from_jax(st, device="cpu"))
    flat_a, flat_b = jax.tree.leaves(st), jax.tree.leaves(tuple(back))
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a).astype(b.dtype), b)


def test_host_entry_points_take_the_card(tmp_path, monkeypatch):
    """VioApi, build_vio and the CLI run on the card unless asked for the
    CPU (device="cpu" or HYBVIO_PLATFORM=cpu): without one they raise."""
    from hybvio_tpu_torch.api.vio import VioApi, build_vio
    from hybvio_tpu_torch.cli import main as cli
    from hybvio_tpu_torch.io.jsonl import Recorder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("HYBVIO_PLATFORM", raising=False)
    p = port_config.Parameters()
    for make in (lambda: VioApi(p, 64, 48), lambda: VioApi(p, 64, 48, recording_only=True),
                 lambda: build_vio(width=64, height=48)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert VioApi(p, 64, 48, recording_only=True, device="cpu").device.type == "cpu"
    rec = Recorder(str(tmp_path))
    rec.frame(0.0, [np.zeros((48, 64), np.float32)])
    rec.close()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run([f"-i={tmp_path}", "-focalLength=50"])
    assert cli._platform_device(None) is None
    monkeypatch.setenv("HYBVIO_PLATFORM", "cpu")
    assert cli._platform_device(None) == "cpu"
    assert cli._platform_device("cuda") == "cuda"


def test_slam_modules_are_scanned():
    """The SLAM slice's modules are among those imported and scanned above."""
    for m in ("slam.host", "slam.orb", "slam.keypoints", "slam.vocabulary", "slam.ba",
              "slam.posegraph", "slam.loopclosure", "slam.session", "frontend.fast",
              "odometry.slam_coupling"):
        assert f"hybvio_tpu_torch.{m}" in PORT_MODULES, m


def test_slam_entry_points_take_the_card(monkeypatch):
    """VioApi with slam.useSlam, the SLAM coupling and the session run on the
    card unless asked for the CPU: without one they raise."""
    from hybvio_tpu_torch.api.vio import VioApi
    from hybvio_tpu_torch.odometry.slam_coupling import SlamCoupling
    from hybvio_tpu_torch.slam.session import Slam

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = port_config.Parameters()
    p.slam.useSlam = True
    for make in (lambda: VioApi(p, 64, 48), lambda: Slam(p),
                 lambda: SlamCoupling(p, np.eye(4))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    api = VioApi(p, 64, 48, device="cpu")
    assert api.slam.device.type == api.slam.slam.device.type == "cpu"
    api.finish()


def test_precision_policy_holds_in_the_slam_worker_while_the_step_runs():
    """The policy is process-global. A VioApi with SLAM holds it from its
    construction to its finish(): the SLAM worker thread reads "highest"
    with cuDNN TF32 off all the while the main thread enters and leaves the
    step's full_precision scope, and finish() restores the caller's
    setting."""
    import threading

    from hybvio_tpu_torch import runtime
    from hybvio_tpu_torch.api.vio import VioApi

    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("medium")
    torch.backends.cudnn.allow_tf32 = True
    try:
        p = port_config.Parameters()
        p.slam.useSlam = True
        p.slam.slamThread = True
        api = VioApi(p, 64, 48, device="cpu")
        assert api.slam.pool is not None
        started, stop, seen = threading.Event(), threading.Event(), set()

        def worker():
            started.set()
            while not stop.is_set():
                seen.add((torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32))

        fut = api.slam.pool.submit(worker)
        started.wait(timeout=10)
        for _ in range(2000):  # the step's scope, as Vio.step enters it
            with runtime.full_precision():
                pass
        stop.set()
        fut.result(timeout=10)
        assert seen == {("highest", False)}
        api.finish()
        assert (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32) == (
            "medium", True)
        # without a hold the step's scope restores the caller's setting
        with runtime.full_precision():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def test_scan_covers_the_recorded_input_and_stereo_option_modules():
    """The AST scan and the import check above include the modules of the
    recorded input and the stereo options, and the decoder's binding."""
    for name in ("frontend.rectify", "frontend.disparity", "frontend.fast", "io.euroc",
                 "io.native_image", "io.video", "utils.gps"):
        assert f"hybvio_tpu_torch.{name}" in PORT_MODULES, name
    source = (REPO / "hybvio_tpu_torch" / "native" / "image_decode.cpp").read_text()
    assert "jax" not in source and "hybvio_tpu/" not in source


@pytest.mark.parametrize("fn", ["ransac_pnp_np", "ransac_similarity_np"])
def test_loop_closure_helpers_take_the_card(fn, monkeypatch):
    """Without a device given, the loop-closure helpers resolve it through
    runtime.default_device(): the card, or a raise without one (no CPU
    fallback)."""
    from hybvio_tpu_torch import runtime
    from hybvio_tpu_torch.slam import loopclosure

    rng = np.random.RandomState(0)
    pts = rng.randn(12, 3) + [0, 0, 5]
    args = (pts, pts[:, :2] / pts[:, 2:]) if fn == "ransac_pnp_np" else (pts, pts + 0.1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(loopclosure, fn)(*args, n_hyp=8)
    asked = []
    monkeypatch.setattr(loopclosure, "default_device",
                        lambda: asked.append(True) or torch.device("cpu"))
    got = getattr(loopclosure, fn)(*args, n_hyp=8)
    want = getattr(loopclosure, fn)(*args, n_hyp=8, device="cpu")
    assert asked == [True]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert runtime.default_device is not loopclosure.default_device


@pytest.mark.parametrize("fn", ["build_remap", "build_mono_undistort"])
def test_rectification_maps_take_the_card(fn, monkeypatch):
    """Without a device given, the rectification and undistortion maps are
    built on runtime.default_device(): the card, or a raise without one (no
    CPU fallback)."""
    from hybvio_tpu_torch.frontend import rectify
    from hybvio_tpu_torch.geometry.cameras import build_pinhole

    lens = build_pinhole(90.0, 90.0, 40.0, 30.0, coeffs=(-0.28, 0.07, 0.0), width=80,
                         height=60)
    args = (lens, build_pinhole(90.0, 90.0, 40.0, 30.0, width=80, height=60), 80, 60)
    if fn == "build_mono_undistort":
        args = (lens, 80, 60)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(rectify, fn)(*args)
    asked = []
    monkeypatch.setattr(rectify, "default_device",
                        lambda: asked.append(True) or torch.device("cpu"))
    got = getattr(rectify, fn)(*args)
    want = getattr(rectify, fn)(*args, device="cpu")
    assert asked == [True]
    got_map, want_map = (got, want) if fn == "build_remap" else (got[1], want[1])
    assert got_map.device.type == "cpu"
    torch.testing.assert_close(got_map, want_map, rtol=0, atol=0)
