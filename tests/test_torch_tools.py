"""The port's tools (``hybvio_tpu_torch/tools/``) against the JAX package's
``tools/`` and ``bench.py`` on the CPU, at small sizes: the benchmark
worlds, the datasets (byte for byte), the runner's ground truth and ATE,
the long probe's arguments, the SLAM cost curve, the BA problems and the
mesh check, and the profiler's stage table.

    python -m pytest tests/test_torch_tools.py -q
"""
import ast
import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hybvio_tpu_torch.tools import make_synthetic_dataset as port_ds
from hybvio_tpu_torch.tools import profile_step as port_profile
from hybvio_tpu_torch.tools import resolve_device
from hybvio_tpu_torch.tools import run_benchmark as port_rb
from hybvio_tpu_torch.tools import run_long_probe as port_lp
from hybvio_tpu_torch.tools import scaling_bench as port_sb
from hybvio_tpu_torch.tools import slam_cost_curve as port_scc
from hybvio_tpu_torch.tools import worlds

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TOOL_FILES = sorted((REPO / "hybvio_tpu_torch" / "tools").glob("*.py"))
REFERENCE_TOOLS = {p.stem for p in (REPO / "tools").glob("*.py")}


def reference(name):
    """A module of the JAX package's tools/ (or bench.py), loaded from its
    file under a name of its own."""
    path = REPO / ("bench.py" if name == "bench" else f"tools/{name}.py")
    key = f"reference_tool_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[key] = module
    return sys.modules[key]


def files_of(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


def test_tools_import_neither_bench_nor_the_reference_tools_nor_touch_sys_path():
    """No tool of the port imports the root bench.py or a module of tools/,
    and none edits sys.path (the reference tools insert the repository
    root)."""
    found = []
    for path in TOOL_FILES:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                names = []
            found += [f"{path.name}:{node.lineno} imports {n}" for n in names
                      if n.split(".")[0] in {"bench", "tools"} | REFERENCE_TOOLS]
            if isinstance(node, ast.Attribute) and node.attr == "path" and \
                    isinstance(node.value, ast.Name) and node.value.id == "sys":
                found.append(f"{path.name}:{node.lineno} sys.path")
    assert {p.stem for p in TOOL_FILES} >= {"worlds", "make_synthetic_dataset", "run_benchmark",
                                           "run_long_probe", "profile_step", "slam_cost_curve",
                                           "scaling_bench"}
    assert not found, found


def test_tools_take_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.delenv("HYBVIO_PLATFORM", raising=False)
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
    monkeypatch.setenv("HYBVIO_PLATFORM", "cpu")
    assert resolve_device() == torch.device("cpu")


@pytest.mark.parametrize("config", ["stereo", "mono", "fisheye"])
def test_worlds_equal_bench_build_config(config, monkeypatch):
    """worlds.build_config against bench.build_config: every parameter
    field, the cameras' intrinsics and lens, and frame 0 byte for byte,
    under a BENCH_OVERRIDES entry."""
    import jax.numpy as jnp

    from hybvio_tpu.io.synthetic import generate_sequence as ref_sequence
    from hybvio_tpu_torch.io.synthetic import generate_sequence

    monkeypatch.setenv("BENCH_OVERRIDES", "odometry.maxVisualUpdates=8")
    monkeypatch.setenv("BENCH_LK_ITERS", "6")
    rp, rcams, rrender, rkw = reference("bench").build_config(config, jnp)
    p, cams, render, kw = worlds.build_config(config)
    assert kw == rkw
    for group in ("tracker", "odometry", "slam"):
        mine = dataclasses.asdict(getattr(p, group))
        assert mine == dataclasses.asdict(getattr(rp, group)), group
    assert p.odometry.maxVisualUpdates == 8 and p.tracker.pyrLKMaxIter == 6
    assert len(cams) == len(rcams)
    for c, r in zip(cams, rcams):
        assert (c.width, c.height) == (int(r.width), int(r.height))
        np.testing.assert_array_equal([c.fx, c.fy, c.cx, c.cy],
                                      np.asarray([r.fx, r.fy, r.cx, r.cy], np.float64))
        np.testing.assert_allclose(c.coeffs, np.asarray(r.coeffs, np.float64), rtol=1e-7)
    short = dict(kw, duration=0.2)
    ref_img, img = rrender(ref_sequence(**short), 0), render(generate_sequence(**short), 0)
    ref_img = ref_img if isinstance(ref_img, tuple) else (ref_img,)
    img = img if isinstance(img, tuple) else (img,)
    assert [np.asarray(r).tobytes() for r in ref_img] == [i.numpy().tobytes() for i in img]


@pytest.mark.parametrize("kind", ["textured", "blobs_zoom", "euroc_stereo"])
def test_datasets_byte_equal_reference(kind, tmp_path):
    """Every file the port's tool writes equals the reference tool's, at
    0.5 s and 96x72."""
    ref = reference("make_synthetic_dataset")
    size = dict(width=96, height=72)
    for mod, out in ((ref, tmp_path / "ref"), (port_ds, tmp_path / "port")):
        if kind == "euroc_stereo":
            res = mod.make_euroc_dataset(str(out / "mav0"), 0.5, stereo=True, **size)
        elif kind == "blobs_zoom":
            res = mod.make_dataset(str(out), 0.5, world="blobs", zoom=0.3, **size)
        else:
            res = mod.make_dataset(str(out), 0.5, **size)
        assert res[1] == 5
    names = files_of(tmp_path / "ref")
    assert names == files_of(tmp_path / "port") and len(names) >= 7
    for name in names:
        assert ((tmp_path / "ref" / name).read_bytes()
                == (tmp_path / "port" / name).read_bytes()), name


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """A 1 s JSONL dataset of blobs and a stereo mav0 tree, both 96x72."""
    root = tmp_path_factory.mktemp("tool_datasets")
    port_ds.make_dataset(str(root / "jsonl"), 1.0, width=96, height=72, world="blobs")
    port_ds.make_euroc_dataset(str(root / "euroc" / "mav0"), 1.0, width=96, height=72,
                               stereo=True)
    return {"jsonl": str(root / "jsonl"), "mav0": str(root / "euroc")}


@pytest.mark.parametrize("layout", ["jsonl", "mav0"])
def test_gt_from_dataset_equals_reference(layout, datasets):
    ref = reference("run_benchmark").gt_from_dataset(datasets[layout])
    mine = port_rb.gt_from_dataset(datasets[layout])
    assert mine.shape == ref.shape and mine.shape[1] == 4 and len(mine) >= 10
    np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("layout", ["jsonl", "mav0"])
def test_run_sequence_equals_reference(layout, datasets, monkeypatch):
    """run_sequence's result (frames, ATE) equals the reference's, the CLI
    patched in both packages to write one fixed output file: the ground
    truth bent off by a few centimetres."""
    import hybvio_tpu.cli.main as ref_cli

    gt = port_rb.gt_from_dataset(datasets[layout])
    rng = np.random.RandomState(3)
    lines = [json.dumps({"time": float(t), "position": dict(zip("xyz", map(float, p + d))),
                         "orientation": {"w": 1.0, "x": 0.0, "y": 0.0, "z": 0.0},
                         "velocity": {"x": 0.0, "y": 0.0, "z": 0.0}})
             for t, p, d in zip(gt[2:, 0], gt[2:, 1:] - gt[0, 1:],
                                0.03 * rng.randn(len(gt) - 2, 3))]
    calls = []

    def fake_cli(args, device=None):
        calls.append(args)
        out = next(a for a in args if a.startswith("-o="))[3:]
        with open(out, "w") as f:
            f.write("\n".join(lines) + "\n")
        return 0

    monkeypatch.setattr(ref_cli, "run", fake_cli)
    monkeypatch.setattr(port_rb, "cli_run", fake_cli)
    extra = ["-tracker.maxTracks=48"]
    ref = reference("run_benchmark").run_sequence(datasets[layout], extra, 6)
    mine = port_rb.run_sequence(datasets[layout], extra, 6)
    assert [c[2:] for c in calls] == [extra + ["-maxFrames=6"]] * 2
    assert {k: v for k, v in mine.items() if k != "fps"} == \
        {k: v for k, v in ref.items() if k != "fps"}
    assert mine["frames"] == len(lines) and mine["ate_rmse_m"] > 0.01


def test_run_benchmark_main_on_the_cpu(tmp_path, capsys, monkeypatch):
    """One real run of the runner over a 9-frame 160x120 dataset on the
    CPU (the first frame initializes, the synchronizer holds the last two
    back, and ATE needs more than 5 outputs): the summary line in the
    reference's shape, and the sequence's VioApi (on the card, its step
    graphs) freed before the runner returns."""
    import weakref

    from hybvio_tpu_torch.api import vio

    apis, init = [], vio.VioApi.__init__

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        apis.append(weakref.ref(self))

    monkeypatch.setattr(vio.VioApi, "__init__", recording_init)
    d = str(tmp_path / "seq")
    port_ds.make_dataset(d, 0.9, width=160, height=120, fx=130.0, world="blobs")
    rc = port_rb.main([d, "-odometry.visualR=0.3", "-tracker.maxTracks=48",
                       "-odometry.cameraTrailLength=8", "-tracker.gfttMinDistance=25",
                       "-tracker.pyrLKMaxLevel=2"], device="cpu")
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(summary) == ["ate_rmse_m_mean", "ate_rmse_m_median", "completed",
                               "sequences", "total"]
    assert summary["completed"] == summary["total"] == 1
    (seq,) = summary["sequences"]
    assert seq["frames"] == 6 and seq["ate_rmse_m"] is not None and seq["ate_rmse_m"] < 0.1
    assert len(apis) == 1 and apis[0]() is None


def test_long_probe_arguments_equal_reference(monkeypatch, capsys):
    """For one argv the port's tool calls run_long_probe with the keyword
    arguments the reference tool passes, and prints the same keys."""
    import hybvio_tpu.eval.long_probe as ref_lp
    from hybvio_tpu_torch.eval import long_probe as lp

    argv = ["mono", "stereo", "--duration", "2", "--seed", "3", "--frame-rate", "15",
            "--width", "160", "--override", "odometry.visualR=0.4",
            "--override", "tracker.maxTracks=40"]
    calls = {"ref": [], "port": []}

    def fake(which):
        def run_long_probe(family, **kwargs):
            calls[which].append((family, kwargs))
            return {"finite": True}
        return run_long_probe

    monkeypatch.delenv("HYBVIO_PLATFORM", raising=False)
    monkeypatch.setattr(ref_lp, "run_long_probe", fake("ref"))
    monkeypatch.setattr(lp, "run_long_probe", fake("port"))
    monkeypatch.setattr(sys, "argv", ["run_long_probe.py"] + argv)
    reference("run_long_probe").main()
    ref_out = capsys.readouterr().out.splitlines()
    assert port_lp.main(argv) == 0
    port_out = capsys.readouterr().out.splitlines()
    assert calls["port"] == calls["ref"] and len(calls["ref"]) == 2
    assert calls["ref"][0][1]["overrides"] == {"odometry.visualR": "0.4",
                                               "tracker.maxTracks": "40"}
    assert [sorted(json.loads(ln)) for ln in port_out] == [sorted(json.loads(ln))
                                                           for ln in ref_out]


@pytest.mark.slow
def test_slam_cost_curve_equals_reference():
    """The SLAM cost curve just past one lap (25 keyframes a lap), where
    each package applies its first loop closure: the same keyframes, map
    points, loop edges and loops applied."""
    ref = reference("slam_cost_curve").run(27, descriptors=True)
    mine = port_scc.run(27, descriptors=True, device="cpu")
    keys = ("kept_keyframes", "map_points", "loop_edges", "loops_applied")
    assert {k: mine[k] for k in keys} == {k: ref[k] for k in keys}
    assert mine["loops_applied"] >= 1
    assert set(mine) == set(ref) | {"signatures"}


@pytest.mark.parametrize("size", [(20, 128, 0), (5, 40, 7)])
def test_make_problem_equals_reference(size):
    import jax.numpy as jnp

    NK, MP, seed = size
    ref = reference("scaling_bench")._make_problem(jnp, NK, MP, seed)
    mine = port_sb._make_problem(NK, MP, seed)
    for name, r in zip(ref._fields, ref):
        m = getattr(mine, name)
        assert np.asarray(r).dtype == m.numpy().dtype, name
        np.testing.assert_array_equal(m.numpy(), np.asarray(r), err_msg=name)


def test_mesh_check_on_cpu_meshes():
    res = port_sb.mesh_check(device="cpu", shards=(1, 2, 4))
    assert res["mode"] == "mesh-check"
    assert [(r["devices"], r["ok"], r["points_per_device"]) for r in res["results"]] == \
        [(1, True, 1024), (2, True, 512), (4, True, 256)]


def test_ba_sweep_rows_and_analysis_on_cpu():
    res = port_sb.ba_sweep(device="cpu", grid=((4, (32, 64)),))
    assert [(r["NK"], r["MP"]) for r in res["rows"]] == [(4, 32), (4, 64)]
    assert all(r["ms"] > 0 for r in res["rows"])
    assert sorted(res) == ["analysis", "assumed_psum_ms", "backend", "mode", "rows"]
    assert [a["NK"] for a in res["analysis"]] == [4]


def test_profile_step_prints_every_reference_stage(monkeypatch, capsys):
    """Stereo at B=2, one replay a stage, both ablation sets off: the
    reference's stage keys, each finite."""
    for k, v in (("PROF_CONFIG", "stereo"), ("PROF_BATCH", "2"), ("PROF_REPS", "1"),
                 ("PROF_ABLATE", "0"), ("PROF_BE_ABLATE", "0")):
        monkeypatch.setenv(k, v)
    assert port_profile.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    table = {ln.split()[0]: float(ln.split()[1]) for ln in out
             if ln.startswith("  ") and len(ln.split()) >= 2}
    assert list(table) == ["full", "frontend", "pyramids", "lk+pyr", "stereo_lk+pyr", "detect",
                           "ransac2", "backend~"]
    assert all(np.isfinite(v) for v in table.values())
    res = json.loads(out[-1])
    assert (res["config"], res["batch"], res["reps"]) == ("stereo", 2, 1)
    assert list(res["stages"]) == list(table)[:-1]
