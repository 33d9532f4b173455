"""Per-frame camera intrinsics in the port (a zooming or autofocus lens,
mono) against the reference's, on the CPU.

``with_intrinsics`` equals the reference's field for field; a per-frame
lens (0-d tensors) computes what a camera built with the same numbers
does, bit for bit, and a step with one makes none of the calls that sync
on the card. The one-lane mono step with a per-frame camera against the
reference's ``vio_step(camera0=...)``, each step from the reference's
state: integer fields exactly, floats to ``torch_parity.mono_step_tol``.
``VioApi.add_frame_mono_varying`` and the CLI over per-frame JSONL
cameraParameters (tools/make_synthetic_dataset.py, blobs, a 25% zoom), each
step from the reference's state (``torch_parity.lockstep``): every output
as in tests/test_torch_api.py / test_torch_cli.py."""
import contextlib
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from hybvio_tpu.api.vio import VioApi as RVioApi
from hybvio_tpu.cli.main import run as ref_run
from hybvio_tpu.config import Parameters as RParams
from hybvio_tpu.config import loader as r_loader
from hybvio_tpu.geometry import cameras as rcams
from hybvio_tpu.io import jsonl as r_jsonl
from hybvio_tpu.io.synthetic import SYNTH_IMU_TO_CAMERA, render_view
from hybvio_tpu.odometry.backend import ImuBatch as RImuBatch
from hybvio_tpu.odometry.vio import make_vio
from hybvio_tpu_torch import convert
from hybvio_tpu_torch.api.vio import VioApi
from hybvio_tpu_torch.cli.main import run
from hybvio_tpu_torch.config import DerivedParameters as PortDerived
from hybvio_tpu_torch.config import Parameters
from hybvio_tpu_torch.config import loader as p_loader
from hybvio_tpu_torch.geometry import cameras as pcams
from hybvio_tpu_torch.io import jsonl as p_jsonl
from hybvio_tpu_torch.odometry.backend import ImuBatch
from hybvio_tpu_torch.parallel.batched import make_batched_vio

from test_torch_step_policy import _SyncLint

torch.set_num_threads(1)

LENSES = {  # name -> (reference builder, port builder, constructor arguments)
    "pinhole_distorted": (rcams.build_pinhole, pcams.build_pinhole,
                          dict(fx=300.0, fy=300.0, cx=160.0, cy=120.0, coeffs=(0.01, -0.002),
                               width=320, height=240)),
    "pinhole": (rcams.build_pinhole, pcams.build_pinhole,
                dict(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320, height=240)),
    "fisheye": (rcams.build_fisheye, pcams.build_fisheye,
                dict(fx=190.0, fy=190.0, cx=256.0, cy=256.0,
                     coeffs=(0.0035, 0.0007, -0.002, 0.0002), max_valid_fov_deg=150.0,
                     width=512, height=512)),
}


@pytest.mark.parametrize("lens", list(LENSES))
def test_with_intrinsics_matches_reference(lens):
    """Field for field (coefficients replaced only on a distorted camera),
    kind, flags and size kept; the per-frame camera's rays equal a static
    camera's with the same numbers, bit for bit; the reference's dynamic
    camera converts to the port's."""
    rbuild, pbuild, kw = LENSES[lens]
    rcam, pcam = rbuild(**kw), pbuild(**kw)
    args = (330.0, 331.0, 161.0, 119.0)
    coeffs = (0.02, -0.001, 0.0005, 0.0001)
    ref = rcams.with_intrinsics(rcam, *args, coeffs=coeffs)
    got = pcams.with_intrinsics(pcam, *args, coeffs=coeffs, device="cpu")
    for name in ("fx", "fy", "cx", "cy", "coeffs"):
        value = getattr(got, name)
        assert np.array_equal(np.asarray(value, np.float64), np.asarray(getattr(ref, name))), name
        assert not isinstance(value, torch.Tensor) or value.dtype == torch.float64
    for name in ("kind", "has_distortion", "has_rotation", "width", "height", "max_valid_r"):
        assert getattr(got, name) == getattr(pcam, name), name
    assert isinstance(got.fx, torch.Tensor) and got.fx.dim() == 0
    static = pbuild(**{**kw, "fx": args[0], "fy": args[1], "cx": args[2], "cy": args[3],
                       **({"coeffs": coeffs if lens == "fisheye" else coeffs[:3]}
                          if pcam.has_distortion else {})})
    px = torch.as_tensor(np.random.default_rng(0).uniform(20, 200, (50, 2)))
    for a, b in zip(pcams.pixel_to_ray(got, px), pcams.pixel_to_ray(static, px)):
        assert torch.equal(a, b)
    back = convert.to_numpy(convert.from_jax(jax.tree.map(np.asarray, ref), device="cpu",
                                             dynamic_camera=True))
    for name in ("fx", "fy", "cx", "cy", "coeffs"):
        assert np.array_equal(np.asarray(getattr(back, name)), np.asarray(getattr(ref, name)))


def _zoom_frames(n, zoom=0.05):
    """A tiny mono sequence whose focal length grows by ``zoom`` of FX a
    frame: (params, reference camera, frames, focal lengths, sequence)."""
    p, derived, rcam = tp.tiny_mono_setup()
    seq = tp.tiny_sequence(n)
    fxs = [tp.FX * (1.0 + zoom * fi) for fi in range(n + 1)]
    frames = []
    for fi, f in enumerate(fxs):
        k = seq.frame_sample_idx[fi]
        frames.append(render_view(seq.landmarks, seq.pos[k], seq.quat[k], SYNTH_IMU_TO_CAMERA,
                                  f, f, 48.0, 32.0, tp.W, tp.H, blob_sigma=1.4))
    return p, derived, rcam, frames, fxs, seq


def test_mono_step_with_per_frame_camera_matches_reference():
    """Vio.step(camera0=...) at one lane against the reference's
    vio_step(camera0=...) over 4 zooming frames, each step from the
    reference's state; the step with a per-frame camera makes none of the
    calls that sync on the card."""
    n = 4
    p, derived, rcam, frames, fxs, seq = _zoom_frames(n)
    rinit, rstep = make_vio(p, derived, (rcam,), max_tracks=12, dtype=jnp.float64)
    rstep = jax.jit(rstep)
    rstate = rinit(jnp.asarray(frames[0]), t0=float(seq.frame_times[0]))
    cam = convert.camera_from_jax(rcam)
    _, _, vio = make_batched_vio(p, PortDerived.from_parameters(p), (cam,), batch_size=1,
                                 max_tracks=12, dtype=torch.float64, device="cpu")
    tol = tp.mono_step_tol
    lanes = lambda tree: jax.tree.map(lambda a: np.asarray(a)[None], tree)
    tracked = 0
    for fi, imu in enumerate(tp.imu_batches(seq, n, 1), start=1):
        rcam0 = rcams.with_intrinsics(rcam, fxs[fi], fxs[fi])
        state = convert.from_jax(lanes(rstate), device="cpu")
        intr = torch.tensor([fxs[fi], fxs[fi], 48.0, 32.0], dtype=torch.float32)
        cam0 = pcams.with_intrinsics(cam, *intr, dtype=torch.float32)
        rstate, rout = rstep(rstate, RImuBatch(*(jnp.asarray(a[0]) for a in imu)),
                             jnp.asarray(frames[fi]), camera0=rcam0)
        batch = ImuBatch(*map(torch.as_tensor, imu))
        image = torch.as_tensor(frames[fi])[None]
        if fi == 2:
            lint = _SyncLint()
            with lint:
                vio.step(state, batch, image, camera0=cam0)
            assert not lint.hits, dict(lint.hits)
        state, out = vio.step(state, batch, image, camera0=cam0)
        diff = (tp.mismatches(tp._comparable(convert.to_numpy(state)),
                              tp._comparable(lanes(rstate)), tol, f"frame {fi} state")
                + tp.mismatches(convert.to_numpy(out), lanes(rout), tol, f"frame {fi} output"))
        assert not diff, diff
        tracked += int((np.asarray(rout.track_ids) >= 0).sum())
    assert tracked > 0
    with pytest.raises(ValueError, match="mono only"):  # the reference asserts the same
        p2, d2, c2 = tp.tiny_stereo_setup()
        _, _, svio = make_batched_vio(p2, PortDerived.from_parameters(p2),
                                      (convert.camera_from_jax(c2),) * 2, batch_size=1,
                                      max_tracks=12, dtype=torch.float64, device="cpu")
        svio.track_stage(None, None, None, None, camera0=cam0)


@pytest.fixture(scope="module")
def zoom_dataset(tmp_path_factory):
    """A blobs dataset whose lens zooms by 25% over 1 s (10 frames)."""
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    from make_synthetic_dataset import make_dataset

    out = str(tmp_path_factory.mktemp("zoom"))
    make_dataset(out, duration=1.0, world="blobs", zoom=0.25)
    return out


def _drive_varying(api, dataset, n_frames):
    """Feed the dataset's events to a VioApi (either package), each frame
    with its own cameraParameters through add_frame_mono_varying; returns
    the VioOutputs."""
    from hybvio_tpu_torch.io.video import open_frame_source

    outs = []
    api.on_output = outs.append
    frames = open_frame_source(dataset)
    n = 0
    for ev in r_jsonl.read_jsonl_events(os.path.join(dataset, "data.jsonl")):
        if ev.kind == r_jsonl.GYROSCOPE:
            api.add_gyro(ev.t, ev.values)
        elif ev.kind == r_jsonl.ACCELEROMETER:
            api.add_acc(ev.t, ev.values)
        elif ev.kind == r_jsonl.FRAME:
            fr = ev.frames[0]
            api.add_frame_mono_varying(ev.t, frames.frame(n, 0), {
                "focalLengthX": fr.focal_length_x, "focalLengthY": fr.focal_length_y,
                "principalPointX": fr.principal_point_x,
                "principalPointY": fr.principal_point_y})
            n += 1
            if n >= n_frames:
                break
    api.finish()
    return outs


def test_api_varying_intrinsics_matches_reference(zoom_dataset):
    """add_frame_mono_varying over the zoom, 8 frames: every VioOutput as
    the reference's, each step from the reference's state."""
    tol = tp.api_tol(tp.mono_step_tol)
    diffs = []
    with pytest.MonkeyPatch.context() as mp:
        states = tp.lockstep(mp, tol, diffs)
        rp = tp.api_params(RParams, r_loader, r_jsonl, zoom_dataset)
        ref = _drive_varying(RVioApi(rp, tp.API_W, tp.API_H, native_sync=False), zoom_dataset, 8)
        pp = tp.api_params(Parameters, p_loader, p_jsonl, zoom_dataset)
        got = _drive_varying(VioApi(pp, tp.API_W, tp.API_H, device="cpu"), zoom_dataset, 8)
    assert len(states) == 5 and len(got) == len(ref) == 5
    assert not diffs, diffs
    for i, (p, r) in enumerate(zip(got, ref)):
        assert p.status == r.status and p.t == r.t
        for name, field in (("position", "position"), ("orientation", "orientation"),
                            ("velocity", "velocity"), ("position_covariance", "position_cov")):
            diff = tp.mismatches(np.asarray(getattr(p, name)), np.asarray(getattr(r, name)),
                                 tol, f"output {i}.{field}")
            assert not diff, diff
    with pytest.raises(ValueError, match="mono only"):
        stereo = Parameters()
        stereo.tracker.useStereo = True
        VioApi(stereo, 64, 48, recording_only=True, device="cpu").add_frame_mono_varying(
            0.0, np.zeros((48, 64), np.float32), (100.0, 100.0))


def test_cli_per_frame_intrinsics_matches_reference(zoom_dataset, tmp_path):
    """The CLI over the zoom dataset's per-frame JSONL cameraParameters,
    7 frames: it latches onto add_frame_mono_varying at the first changed
    lens, and every output line equals the reference's (each step from the
    reference's state)."""
    from test_torch_cli import _line_mismatches

    calls = []
    real = VioApi.add_frame_mono_varying
    tol = tp.api_tol(tp.mono_step_tol)
    diffs = []
    argv = lambda out: [f"-i={zoom_dataset}", f"-o={out}", "-maxFrames=7", "-outputJsonExtras",
                        *tp.API_FLAGS]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYBVIO_NATIVE_SYNC", "0")
        mp.setattr(VioApi, "add_frame_mono_varying",
                   lambda self, t, img, intr: calls.append(intr) or real(self, t, img, intr))
        tp.lockstep(mp, tol, diffs)
        with contextlib.redirect_stderr(io.StringIO()):
            assert ref_run(argv(tmp_path / "ref.jsonl")) == 0
            assert run(argv(tmp_path / "port.jsonl"), device="cpu") == 0
    ref = [json.loads(l) for l in open(tmp_path / "ref.jsonl")]
    got = [json.loads(l) for l in open(tmp_path / "port.jsonl")]
    assert not diffs, diffs
    assert len(got) == len(ref) == 4
    assert len(calls) == 6 and calls[-1][0] > calls[0][0] > tp.API_FX  # from frame 2 on
    for i, (p, r) in enumerate(zip(got, ref)):
        diff = _line_mismatches(p, r, tol, f"line {i}")
        assert not diff, diff
