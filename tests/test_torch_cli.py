"""The port's offline CLI ``run()`` against the reference's ``run()``,
in-process, on the blobs mono dataset of tests/test_torch_api.py at 320x240
(-maxFrames=7, -outputJsonExtras, tests/test_api_cli.py's reduced tracker
sizes).

The reference runs once with -timer (its staged path). The port runs twice,
as it runs by default and with -timer, each frame step starting from the
reference's state at the same point (as in tests/test_torch_api.py): every
field of every output line equals the reference's, status, time and focal
length exactly, floats to torch_parity.mono_step_tol; the -timer report has
the reference's labels. The display flags and the SLAM viewers write their
views; a video, with the legacy CSV beside it or in a dataset folder,
runs through VideoFileSource."""
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


# the SLAM flags that make a keyframe of every frame in a few frames
# (tests/test_torch_vislam.py's CLI run)
SLAM_FLAGS = ("-slamThread=false", "-keyframeCandidateInterval=1", "-keyframeDecisionAlways",
              "-orbExtraKeyPoints=false", "-minTriangulationAngleTwoObs=0.5")
VIS_FRAMES = 5  # frames of each display run: 2 outputs


# each case's views: a file-name pattern per flag (api/visualizations.py
# renders them; -c = -displayVideo, -p = -displayPose)
FLAG_VIEWS = {"-displayKeyframe": r"keyframe_\d{5}\.png", "-displayVideo": r"video_\d{6}\.png",
              "-c": r"video_\d{6}\.png", "-p": r"pose_\d{6}\.png",
              "-visualizeOrbMatching": r"orb_match_\d{5}\.png",
              "-displayCovarianceMagnitude": r"cov_\d{6}\.png"}


@pytest.mark.parametrize("flags, match", [
    (["-useSlam", "-displayKeyframe"], "visualizations"),
    (["-displayVideo"], "visualizations"),
    (["-c"], "visualizations"),
    (["-p"], "visualizations"),
    (["-visualizationPath=/nonexistent"], "visualizations"),
    (["-useSlam", "-visualizeOrbMatching"], "visualizations"),
    (["-displayCovarianceMagnitude"], "visualizations"),
])
def test_cli_unported_flags_raise(runs, tmp_path, flags, match):
    """Each display flag and SLAM viewer, which raised before the
    visualizations (``match``) were ported, writes its views under
    -visualizationPath with the reference's names (one a retired output for
    the video views, one a new keyframe or match for the viewers), and the
    outputs are those of the run without it. -visualizationPath with no
    display flag writes nothing and makes no directory. (The file names
    against the reference's own run: tests/test_torch_visualizations.py.)"""
    vis = tmp_path / "vis"
    views = [FLAG_VIEWS[f] for f in flags if f in FLAG_VIEWS]
    extra = list(flags) + (list(SLAM_FLAGS) if "-useSlam" in flags else [])
    if views:
        extra.append(f"-visualizationPath={vis}")
    out = tmp_path / "x.jsonl"
    err = _run(lambda a: run(a, device="cpu"),
               [f"-i={runs['dataset']}", f"-o={out}", f"-maxFrames={VIS_FRAMES}", *tp.API_FLAGS,
                *extra])
    lines = [json.loads(l) for l in open(out)]
    assert [l["time"] for l in lines] == [l["time"] for l in runs["lines"]["port"][:len(lines)]]
    assert len(lines) == VIS_FRAMES - 3 and "failed" not in err, err
    if not views:
        assert not os.path.exists("/nonexistent")
        return
    names = sorted(os.listdir(vis))
    assert names and all(re.fullmatch(views[0], n) for n in names), names
    if "-useSlam" not in flags:
        assert len(names) == len(lines)


def _write_video(dataset, path, fourcc):
    """The dataset's first-camera frames as a colour video, the gray value in
    every channel."""
    import cv2

    n = 0
    while os.path.exists(os.path.join(dataset, f"frame_{n:06d}_cam0.npy")):
        n += 1
    H, W = np.load(os.path.join(dataset, "frame_000000_cam0.npy")).shape
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 10, (W, H))
    for k in range(n):
        g = tp.to_uint8(np.load(os.path.join(dataset, f"frame_{k:06d}_cam0.npy")))
        writer.write(np.repeat(g[..., None], 3, axis=-1))
    writer.release()


def _write_csv(dataset, path):
    """The dataset's samples and frames as the legacy CSV (io/jsonl.py
    read_csv_events: t, 4 gyroscope / 3 accelerometer, x, y, z; t, 1, frame)."""
    rows = []
    for line in open(os.path.join(dataset, "data.jsonl")):
        j = json.loads(line)
        if "sensor" in j:
            code = 4 if j["sensor"]["type"] == "gyroscope" else 3
            rows.append(",".join(map(repr, [j["time"], code, *j["sensor"]["values"]])))
        elif "frames" in j:
            rows.append(f"{j['time']!r},1,{j['number']}")
    open(path, "w").write("\n".join(rows) + "\n")


@pytest.mark.parametrize("layout, match", [
    ("mp4_csv", "VideoFileSource"), ("mov_csv", "VideoFileSource"), ("video", "io/video.py"),
    ("video_mov", "io/video.py")])
def test_cli_unported_inputs_raise(runs, tmp_path, layout, match):
    """Video input, which raised before io/video.py VideoFileSource (``match``)
    was ported: a .mp4 or .mov of the dataset's frames (mp4v), with the
    legacy CSV beside it (-i=<video>) or in a dataset folder beside
    data.jsonl (data.mp4 / data.mov). The outputs come at the times of the
    run over the .npy frames, finite, as many."""
    ds = tmp_path / layout
    ds.mkdir()
    video = ds / ("data.mov" if layout in ("mov_csv", "video_mov") else "data.mp4")
    _write_video(runs["dataset"], video, "mp4v")
    if layout.endswith("_csv"):
        _write_csv(runs["dataset"], ds / "data.csv")
        source = video
    else:
        (ds / "data.jsonl").write_text(open(os.path.join(runs["dataset"], "data.jsonl")).read())
        (ds / "parameters.txt").write_text(
            open(os.path.join(runs["dataset"], "parameters.txt")).read())
        source = ds
    out = tmp_path / "x.jsonl"
    _run(lambda a: run(a, device="cpu"),
         [f"-i={source}", f"-o={out}", f"-maxFrames={VIS_FRAMES}", *tp.API_FLAGS])
    lines = [json.loads(l) for l in open(out)]
    assert len(lines) == VIS_FRAMES - 3
    assert [l["time"] for l in lines] == [l["time"] for l in runs["lines"]["port"][:len(lines)]]
    assert np.isfinite(np.concatenate([_values(l["position"]) for l in lines])).all()
