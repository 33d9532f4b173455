"""The port's offline CLI ``run()`` against the reference's ``run()``,
in-process, on the blobs mono dataset of tests/test_torch_api.py at 320x240
(-maxFrames=7, -outputJsonExtras, tests/test_api_cli.py's reduced tracker
sizes).

The reference runs once with -timer (its staged path). The port runs twice,
as it runs by default and with -timer, each frame step starting from the
reference's state at the same point (as in tests/test_torch_api.py): every
field of every output line equals the reference's, status, time and focal
length exactly, floats to torch_parity.mono_step_tol; the -timer report has
the reference's labels. Unported inputs (a video, with or without the
legacy CSV beside it) and flags raise NotImplementedError."""
import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

import torch_parity as tp
from hybvio_tpu.cli.main import run as ref_run
from hybvio_tpu_torch.cli.main import run

torch.set_num_threads(1)

MAX_FRAMES = 7
LINE_FIELD = {"position": "position", "orientation": "orientation", "velocity": "velocity",
              "positionCovariance": "position_cov", "velocityCovariance": "velocity_cov",
              "biasMean": "bias_gyro", "biasCovarianceDiagonal": "bias_cov_diag"}


def _argv(dataset, out, *extra):
    return [f"-i={dataset}", f"-o={out}", f"-maxFrames={MAX_FRAMES}", "-outputJsonExtras",
            *tp.API_FLAGS, *extra]


def _timer_labels(stderr):
    """The labels of a -timer report."""
    report = stderr[stderr.index("--- per-frame timings"):]
    return {m.group(1) for m in re.finditer(r"^\s*[\d.]+ ms  (.+?)  (?:\(x\d+\)|\[attributed\])$",
                                            report, re.M)}


def _run(fn, argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert fn(argv) == 0
    return err.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    ds = tp.make_api_dataset(str(d / "mono"), 1.0)
    diffs = []
    tol = tp.api_tol(tp.mono_step_tol)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYBVIO_NATIVE_SYNC", "0")  # the reference's pure-Python synchronizer
        states = tp.lockstep(mp, tol, diffs)
        ref_err = _run(ref_run, _argv(ds, d / "ref.jsonl", "-timer"))
        for name, extra in (("port", ()), ("port_timer", ("-timer",))):
            _run(lambda argv: run(argv, device="cpu"), _argv(ds, d / f"{name}.jsonl", *extra))
    lines = {name: [json.loads(l) for l in open(d / f"{name}.jsonl")]
             for name in ("ref", "port", "port_timer")}
    return dict(lines=lines, diffs=diffs, steps=len(states), ref_err=ref_err, tol=tol,
                dataset=ds)


def _values(v):
    """A JSON value (a number, a list or a dict of them) as a flat float64
    array, dict values in their order."""
    if isinstance(v, dict):
        return np.concatenate([_values(x) for x in v.values()])
    return np.asarray(v, np.float64).reshape(-1)


def _line_mismatches(p, r, tol, path):
    if p.keys() != r.keys():
        return [(path, f"keys {sorted(p)} vs {sorted(r)}")]
    out = []
    for key in r:
        if key in LINE_FIELD:
            out += tp.mismatches(_values(p[key]), _values(r[key]), tol, f"{path}.{LINE_FIELD[key]}")
        elif p[key] != r[key]:
            out.append((f"{path}.{key}", f"{p[key]} != {r[key]}"))
    return out


@pytest.mark.parametrize("which", ["port", "port_timer"])
def test_cli_equals_reference_line_by_line(runs, which):
    ref, port = runs["lines"]["ref"], runs["lines"][which]
    assert runs["steps"] == MAX_FRAMES - 3 and len(ref) == MAX_FRAMES - 3
    assert not runs["diffs"], runs["diffs"]
    assert len(port) == len(ref)
    assert {"status", "biasMean", "positionCovariance", "focalLength"} <= set(ref[0])
    for i, (p, r) in enumerate(zip(port, ref)):
        diff = _line_mismatches(p, r, runs["tol"], f"line {i}")
        assert not diff, diff


def test_cli_timer_labels_equal_reference(runs, tmp_path):
    err = _run(lambda a: run(a, device="cpu"),
               _argv(runs["dataset"], tmp_path / "t.jsonl", "-timer", "-maxFrames=4"))
    labels = _timer_labels(err)
    assert labels == _timer_labels(runs["ref_err"])
    assert {"KF predict (IMU scan)", "tracker (flow+LK+detect+RANSAC)",
            "visual update + augmentation", "ransac5 (essential)"} <= labels


def test_cli_honours_hybvio_platform(runs, tmp_path, monkeypatch):
    monkeypatch.setenv("HYBVIO_PLATFORM", "cpu")
    out = tmp_path / "o.jsonl"
    _run(run, [f"-i={runs['dataset']}", f"-o={out}", "-maxFrames=4", *tp.API_FLAGS])
    assert len(open(out).readlines()) == 1
    monkeypatch.setenv("HYBVIO_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="HYBVIO_PLATFORM"):
        run([f"-i={runs['dataset']}"])


@pytest.mark.parametrize("flags, match", [
    (["-useSlam", "-displayKeyframe"], "visualizations"),
    (["-displayVideo"], "visualizations"),
    (["-c"], "visualizations"),
    (["-p"], "visualizations"),
    (["-visualizationPath=/nonexistent"], "visualizations"),
    (["-useSlam", "-visualizeOrbMatching"], "visualizations"),
    (["-useSquareRootEkf"], "useSquareRootEkf"),
])
def test_cli_unported_flags_raise(runs, tmp_path, flags, match):
    with pytest.raises(NotImplementedError, match=match):
        run([f"-i={runs['dataset']}", f"-o={tmp_path / 'x.jsonl'}", *tp.API_FLAGS, *flags],
            device="cpu")


@pytest.mark.parametrize("layout, match", [
    ("mp4_csv", "VideoFileSource"), ("mov_csv", "VideoFileSource"), ("video", "io/video.py"),
    ("varying", "add_frame_mono_varying")])
def test_cli_unported_inputs_raise(runs, tmp_path, layout, match):
    ds = tmp_path / layout
    if layout.endswith("_csv"):  # a video with the legacy CSV beside it
        ds.mkdir()
        video = ds / f"data.{layout[:3]}"
        video.write_bytes(b"")
        (ds / "data.csv").write_text("0.0,4,0,0,0\n")
        with pytest.raises(NotImplementedError, match=match):
            run([f"-i={video}"], device="cpu")
        return
    else:
        ds.mkdir()
        lines = open(os.path.join(runs["dataset"], "data.jsonl")).read().splitlines()
        if layout == "video":
            (ds / "data.mp4").write_bytes(b"")
        else:  # the focal length changes from the second frame on
            for name in os.listdir(runs["dataset"]):
                if name.endswith(".npy"):
                    os.symlink(os.path.join(runs["dataset"], name), ds / name)
            n = 0
            for i, line in enumerate(lines):
                j = json.loads(line)
                if "frames" in j:
                    n += 1
                    if n > 1:
                        j["frames"][0]["cameraParameters"]["focalLengthX"] = 270.0
                        lines[i] = json.dumps(j)
            (ds / "parameters.txt").write_text(
                open(os.path.join(runs["dataset"], "parameters.txt")).read())
        (ds / "data.jsonl").write_text("\n".join(lines) + "\n")
    with pytest.raises(NotImplementedError, match=match):
        run([f"-i={ds}", f"-o={tmp_path / 'x.jsonl'}", "-maxTracks=32", "-pyrLKMaxLevel=2",
             "-pyrLKWindowSize=13", "-cameraTrailLength=6"], device="cpu")
