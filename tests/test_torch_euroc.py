"""Recorded input through the port against the reference: the EuRoC ASL
(mav0) reader and calibration, the legacy CSV reader, the GPS converter,
the native image decoder and ``load_image_file``, the CLI over a tiny
stereo mav0 tree with EuRoC's radial distortion and rectification (in
process, the port stepping from the reference's state at each frame, as
tests/test_torch_cli.py), the stereo point cloud through ``VioApi`` and the
TUM-VI fisheye preset.

Tolerances: events, calibrations, decoded images, GPS metres and the
preset's fields exactly; every output line of the CLI as
``torch_parity.api_tol(step_tol)`` (the float32 front-end's few ulp, scaled
to 320x240), its status and time exactly; the dense point cloud's rows as
its disparity (one disparity ulp moves a point by a few mm at these
depths): the same number of points, positions to 1e-3 m."""
import contextlib
import dataclasses
import io
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import torch_parity as tp
from hybvio_tpu.api.vio import VioApi as RVioApi
from hybvio_tpu.cli.main import run as ref_run
from hybvio_tpu.config import Parameters as RParams
from hybvio_tpu.io import euroc as r_euroc
from hybvio_tpu.io import jsonl as r_jsonl
from hybvio_tpu.io import native_image as r_native
from hybvio_tpu.io.video import load_image_file as r_load_image_file
from hybvio_tpu.models import tumvi_fisheye as r_tumvi
from hybvio_tpu.utils.gps import GpsToLocalConverter as RGps
from hybvio_tpu_torch import convert
from hybvio_tpu_torch.api.vio import VioApi
from hybvio_tpu_torch.cli.main import run
from hybvio_tpu_torch.config import Parameters
from hybvio_tpu_torch.config import loader as p_loader
from hybvio_tpu_torch.io import euroc, jsonl, native_image, video
from hybvio_tpu_torch.io.synthetic import SYNTH_IMU_TO_CAMERA, generate_sequence
from hybvio_tpu_torch.models import tumvi_fisheye
from hybvio_tpu_torch.utils.gps import GpsToLocalConverter

from euroc_fixture import encode_pgm, encode_png_gray, write_euroc_sequence
from test_euroc_io import mav_dir  # noqa: F401  (the reference's fixture)

torch.set_num_threads(1)

EUROC_K = (-0.28340811, 0.07395907)
W, H = 320, 240
FLAGS = ("-maxTracks=32", "-cameraTrailLength=6", "-pyrLKWindowSize=13", "-pyrLKMaxLevel=2",
         "-gfttMinDistance=30", "-useStereo", "-useRectification")


def _events(events):
    """Events (either package's dataclasses) as plain dicts."""
    return [dataclasses.asdict(e) for e in events]


def test_euroc_reader_and_calibration_equal_reference(mav_dir):  # noqa: F811
    got = _events(euroc.read_euroc_events(mav_dir))
    assert got == _events(r_euroc.read_euroc_events(mav_dir)) and len(got) == 28
    assert euroc.read_euroc_calibration(mav_dir) == r_euroc.read_euroc_calibration(mav_dir)
    cam, rcam = (m.read_camera_calib(os.path.join(mav_dir, "cam1")) for m in (euroc, r_euroc))
    np.testing.assert_array_equal(cam.imu_to_camera, rcam.imu_to_camera)
    assert cam.distortion == rcam.distortion and cam.model == rcam.model == "pinhole"
    # the calibration through each package's loader gives the same tracker
    cams = json.dumps({"cameras": euroc.read_euroc_calibration(mav_dir)})
    p = Parameters()
    p_loader.apply_calibration_json(p, cams)
    assert p.tracker.distortionCoeffs == tuple(EUROC_K) + (0.0,) or \
        list(p.tracker.distortionCoeffs) == list(EUROC_K) + [0.0]


def test_csv_reader_and_gps_equal_reference(tmp_path):
    rows = ["# t, code, ...", "0.00,4,0.01,0.02,0.03", "0.00,3,0.1,0.2,9.8",
            "0.05,1,0", "0.10,1,1,300.0,301.0,160.0,120.0,1", "0.15,2,60.17,24.94,5.0,12.0",
            "0.16,2,60.171,24.941,4.0", "0.20,7,2,0.1,0.2,0.3,0,0,0,290.0,292.0", ""]
    path = tmp_path / "data.csv"
    path.write_text("\n".join(rows))
    got = _events(jsonl.read_csv_events(str(path)))
    assert got == _events(r_jsonl.read_csv_events(str(path)))
    kinds = [e["kind"] for e in got]
    assert kinds.count(jsonl.ECHO) == 3 and kinds.count(jsonl.FRAME) == 3
    g, r = GpsToLocalConverter(), RGps()
    for lat, lon, alt in ((60.17, 24.94, 12.0), (60.171, 24.941, 4.0), (60.1695, 24.95, 0.0)):
        assert g.convert(lat, lon, alt) == r.convert(lat, lon, alt)
    assert abs(g.convert(60.171, 24.94, 12.0)[1] - 111.4) < 1.0  # 0.001 deg north


def _images(tmp_path):
    rng = np.random.RandomState(3)
    u8 = (rng.rand(37, 53) * 255).astype(np.uint8)
    rgb = (rng.rand(21, 30, 3) * 255).astype(np.uint8)
    u16 = (rng.rand(17, 19) * 65535).astype(np.uint16)
    files = {}
    files["gray.png"] = (tmp_path / "gray.png")
    files["gray.png"].write_bytes(encode_png_gray(u8))
    files["gray.pgm"] = tmp_path / "gray.pgm"
    files["gray.pgm"].write_bytes(encode_pgm(u8))
    files["rgb.png"] = tmp_path / "rgb.png"
    Image.fromarray(rgb).save(files["rgb.png"])
    files["gray16.png"] = tmp_path / "gray16.png"
    Image.fromarray(u16).save(files["gray16.png"])
    files["pil_gray.png"] = tmp_path / "pil_gray.png"
    Image.fromarray(u8).save(files["pil_gray.png"])
    files["gray.jpg"] = tmp_path / "gray.jpg"
    Image.fromarray(u8).save(files["gray.jpg"])
    return u8, files


def test_decoder_equals_reference_load_image_file(tmp_path, monkeypatch):
    u8, files = _images(tmp_path)
    assert native_image.unavailable_reason() is None and native_image.png_supported()
    for name, path in files.items():
        got, want = video.load_image_file(str(path)), r_load_image_file(str(path))
        assert got.dtype == np.uint8, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("gray.png", "gray.pgm", "pil_gray.png"):
        np.testing.assert_array_equal(native_image.decode_gray_u8_native(str(files[name])), u8)
    for name in ("gray.png", "gray.pgm", "rgb.png", "gray16.png", "pil_gray.png"):
        np.testing.assert_array_equal(native_image.decode_gray_u8_native(str(files[name])),
                                      r_native.decode_gray_u8_native(str(files[name])),
                                      err_msg=name)
    assert native_image.decode_gray_u8_native(str(files["gray.jpg"])) is None
    # neither decoder: the error names both, and no frame comes back
    monkeypatch.setitem(native_image._state, "lib", None)
    monkeypatch.setitem(native_image._state, "error", "g++ not found")
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(RuntimeError, match="native decoder.*g\\+\\+ not found.*PIL"):
        video.load_image_file(str(files["gray.png"]))


def _tree(root, n_frames=7):
    seq = generate_sequence(duration=(n_frames + 1) / 10.0, imu_rate=100.0, frame_rate=10.0,
                            n_landmarks=300, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    second = np.asarray(SYNTH_IMU_TO_CAMERA).copy()
    second[0, 3] = -0.11
    return write_euroc_sequence(os.path.join(root, "mav0"), seq, (SYNTH_IMU_TO_CAMERA, second),
                                260.0, 259.0, 161.3, 119.2, W, H, EUROC_K, n_frames=n_frames,
                                blob_sigma=1.2)


@pytest.fixture(scope="module")
def mav_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("euroc_cli")
    n = _tree(str(d / "ds"))
    diffs = []
    tol = tp.api_tol(tp.step_tol)

    def cli(fn, name):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert fn([f"-i={d / 'ds'}", f"-o={d / name}.jsonl", "-outputJsonExtras", *FLAGS]) == 0
        return [json.loads(line) for line in open(d / f"{name}.jsonl")]

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYBVIO_NATIVE_SYNC", "0")
        states = tp.lockstep(mp, tol, diffs)
        ref = cli(ref_run, "ref")
        port = cli(lambda a: run(a, device="cpu"), "port")
    return dict(ref=ref, port=port, diffs=diffs, steps=len(states), frames=n, tol=tol,
                dataset=str(d / "ds"))


def test_cli_on_mav0_tree_equals_reference_line_by_line(mav_runs):
    from test_torch_cli import _line_mismatches

    ref, port = mav_runs["ref"], mav_runs["port"]
    assert mav_runs["frames"] == 7 and len(ref) == mav_runs["steps"] >= 7 - 3
    assert not mav_runs["diffs"], mav_runs["diffs"]
    assert len(port) == len(ref)
    for i, (p, r) in enumerate(zip(port, ref)):
        diff = _line_mismatches(p, r, mav_runs["tol"], f"line {i}")
        assert not diff, diff
    assert np.linalg.norm(list(ref[-1]["position"].values())) > 0.05  # it moved


def test_stereo_point_cloud_through_vioapi(mav_runs):
    """computeStereoPointCloud (and dense track depth) through each
    package's VioApi over the mav0 tree's frames, the port stepping from
    the reference's states: the outputs' clouds agree."""
    ds = mav_runs["dataset"]
    calib = json.dumps({"cameras": euroc.read_euroc_calibration(os.path.join(ds, "mav0"))})

    def params(P, loader):
        p = P()
        loader.apply_calibration_json(p, calib)
        assert not loader.apply_argv(p, list(FLAGS) + ["-computeStereoPointCloud",
                                                       "-computeDenseStereoDepth"])
        return p

    from hybvio_tpu.config import loader as r_loader

    events = list(euroc.read_euroc_events(os.path.join(ds, "mav0")))
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        diffs = []
        tp.lockstep(mp, mav_runs["tol"], diffs)
        for name, api in (("ref", RVioApi(params(RParams, r_loader), W, H, native_sync=False)),
                          ("port", VioApi(params(Parameters, p_loader), W, H, device="cpu"))):
            got = outs.setdefault(name, [])
            api.on_output = got.append
            for ev in events:
                if ev.kind == jsonl.GYROSCOPE:
                    api.add_gyro(ev.t, ev.values)
                elif ev.kind == jsonl.ACCELEROMETER:
                    api.add_acc(ev.t, ev.values)
                elif ev.kind == jsonl.FRAME:
                    a, b = (video.load_image_file(p) for p in ev.raw["paths"])
                    api.add_frame_stereo(ev.t, a, b)
            api.finish()
    assert not diffs, diffs
    assert len(outs["port"]) == len(outs["ref"]) >= 3
    for p, r in zip(outs["port"], outs["ref"]):
        dense_p, dense_r = p.point_cloud[:, 0] == -2, r.point_cloud[:, 0] == -2
        assert dense_r.sum() > 100
        assert dense_p.sum() == dense_r.sum()
        np.testing.assert_allclose(p.point_cloud[dense_p], r.point_cloud[dense_r], rtol=0,
                                   atol=1e-3)
        tracks_p, tracks_r = p.point_cloud[~dense_p], r.point_cloud[~dense_r]
        assert tracks_p.shape == tracks_r.shape
        np.testing.assert_array_equal(tracks_p[:, 0], tracks_r[:, 0])
        np.testing.assert_allclose(tracks_p, tracks_r, rtol=0, atol=1e-3)


def test_tumvi_fisheye_preset_equals_reference():
    p, derived, cams = tumvi_fisheye()
    rp, rderived, rcams = r_tumvi()
    for group in ("odometry", "tracker", "slam"):
        assert vars(getattr(p, group)) == vars(getattr(rp, group)), group
    for f in vars(rderived):
        np.testing.assert_array_equal(np.asarray(getattr(derived, f)),
                                      np.asarray(getattr(rderived, f)))
    # the reference's camera arrays are float32 when its session ran without
    # x64 (its CLI sets that from its parameters): equal to their rounding
    (ref,) = (convert.camera_from_jax(jax.tree.map(np.asarray, c)) for c in rcams)
    for f in dataclasses.fields(ref):
        a, b = getattr(cams[0], f.name), getattr(ref, f.name)
        if isinstance(b, float) or (isinstance(b, tuple) and isinstance(b[0], float)):
            np.testing.assert_allclose(a, b, rtol=1e-7, atol=0, err_msg=f.name)
        else:
            assert a == b, f.name
    assert cams[0].kind == "fisheye" and cams[0].width == 512 and cams[0].has_distortion


def test_cli_on_csv_folder_equals_reference(tmp_path):
    """A folder with the legacy data.csv (tests/test_torch_cli.py's mono blobs
    dataset, its events rewritten as CSV rows with the frames' intrinsics)
    through both CLIs, the port stepping from the reference's states: every
    output line within api_tol(mono_step_tol)."""
    from test_torch_cli import _line_mismatches

    ds = tp.make_api_dataset(str(tmp_path / "csv"), 0.8)
    rows = []
    for ev in r_jsonl.read_jsonl_events(os.path.join(ds, "data.jsonl")):
        if ev.kind == r_jsonl.GYROSCOPE:
            rows.append(f"{ev.t!r},4,{','.join(map(repr, ev.values))}")
        elif ev.kind == r_jsonl.ACCELEROMETER:
            rows.append(f"{ev.t!r},3,{','.join(map(repr, ev.values))}")
        elif ev.kind == r_jsonl.FRAME:
            fr = ev.frames[0]
            rows.append(f"{ev.t!r},1,{ev.frames_index},{fr.focal_length_x!r},"
                        f"{fr.focal_length_y!r},{fr.principal_point_x!r},{fr.principal_point_y!r}")
    os.remove(os.path.join(ds, "data.jsonl"))
    with open(os.path.join(ds, "data.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    flags = [a for a in tp.API_FLAGS if not a.startswith(("-focalLength", "-principalPoint"))]
    diffs, tol = [], tp.api_tol(tp.mono_step_tol)
    lines = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYBVIO_NATIVE_SYNC", "0")
        states = tp.lockstep(mp, tol, diffs)
        for name, fn in (("ref", ref_run), ("port", lambda a: run(a, device="cpu"))):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                assert fn([f"-i={ds}", f"-o={tmp_path / name}.jsonl", "-maxFrames=6",
                           "-outputJsonExtras", *flags]) == 0, err.getvalue()
            lines[name] = [json.loads(line) for line in open(tmp_path / f"{name}.jsonl")]
    assert not diffs, diffs
    assert len(lines["port"]) == len(lines["ref"]) == len(states) >= 3
    assert lines["ref"][0]["focalLength"] == tp.API_FX  # from the CSV's frame rows
    for i, (p, r) in enumerate(zip(lines["port"], lines["ref"])):
        diff = _line_mismatches(p, r, tol, f"line {i}")
        assert not diff, diff
