"""The stereo step under each stereo option, through the port against the
reference's ``make_batched_vio``: B = 2 lanes with per-lane frames of two
worlds (``test_torch_per_lane``'s), 4 steps, the batched visual update.

Options, one case each (and each step checked, on the CPU, for the calls
that make a host sync on the card, as tests/test_torch_step_policy.py):
EuRoC cam0's radial distortion (k1, k2) on both cameras with rectification (the frames rendered pinhole and warped through
the distorted lens by the port's ``build_remap`` / ``remap``); dense depth
with the independent stereo triangulation; the independent stereo
triangulation alone; upright-2P (no RANSAC3); stereo without RANSAC3 (the
hybrid RANSAC2/RANSAC5); the FAST detector; ``predictOpticalFlow = false``.

Tolerances: every integer and boolean field exactly; floats as
``torch_parity.step_tol`` (the float32 front-end's sums run in another
order than XLA's fused ones: a few ulp of the pixels), and the trail's
stereo covariances (entries up to ~1e3, in normalized image units) to
1e-3, as step_tol holds the filter's covariance. The reference's
cameras are float64 here, as its API builds them, so both packages evaluate
the remap fields in float64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybvio_tpu.geometry.cameras import build_pinhole as r_build_pinhole
from hybvio_tpu.io.synthetic import SYNTH_IMU_TO_CAMERA, render_view
from hybvio_tpu_torch.frontend.rectify import build_remap, remap
from hybvio_tpu_torch.geometry.cameras import build_pinhole

from hybvio_tpu_torch.config import DerivedParameters as PortDerived
from hybvio_tpu_torch.odometry.backend import ImuBatch
from hybvio_tpu_torch.parallel.batched import make_batched_vio

from test_torch_per_lane import _per_lane_imu, _worlds
from test_torch_step_policy import _SyncLint
from torch_parity import (
    FX, H, SECOND_IMU_TO_CAMERA, W, batched_step_parity, step_tol, tiny_stereo_setup,
)

torch.set_num_threads(1)

B, FRAMES = 2, 4
EUROC_K = (-0.28340811, 0.07395907)  # EuRoC cam0, as io/euroc.py keeps them (p1, p2 dropped)

OPTIONS = {
    "rectify_distorted": {"tracker.useRectification": True},
    "dense_depth": {"tracker.computeDenseStereoDepth": True,
                    "odometry.useIndependentStereoTriangulation": True},
    "independent_triangulation": {"odometry.useIndependentStereoTriangulation": True},
    "upright_2p": {"tracker.useRansac3": False, "tracker.useStereoUpright2p": True},
    "no_ransac3": {"tracker.useRansac3": False},
    "fast": {"tracker.featureDetector": "FAST"},
    "no_flow_prediction": {"tracker.predictOpticalFlow": False},
}


def stereo_tol(path):
    return 1e-3 if path.endswith(".kf_stereo_cov") else step_tol(path)


def _frames(distort):
    seqs = _worlds(FRAMES)
    warp = None
    if distort:
        pin = build_pinhole(FX, FX, 48.0, 32.0, width=W, height=H)
        lens = build_pinhole(FX, FX, 48.0, 32.0, coeffs=EUROC_K + (0.0,), width=W, height=H)
        warp = build_remap(pin, lens, W, H, torch.float64, device="cpu")

    def frame(fi):
        k = seqs[0].frame_sample_idx[fi]
        out = []
        for ext in (SYNTH_IMU_TO_CAMERA, SECOND_IMU_TO_CAMERA):
            imgs = np.stack([render_view(s.landmarks, s.pos[k], s.quat[k], ext, FX, FX, 48.0,
                                         32.0, W, H, blob_sigma=1.4) for s in seqs])
            if warp is not None:
                imgs = remap(torch.as_tensor(imgs), warp).numpy()
            out.append(imgs)
        return tuple(out)

    return seqs, [frame(fi) for fi in range(FRAMES + 1)]


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_stereo_option_step_matches_reference(option):
    p, _, _ = tiny_stereo_setup()
    for key, value in OPTIONS[option].items():
        group, name = key.split(".")
        p.set_parameter(group, name, value)
    distort = option == "rectify_distorted"
    coeffs = EUROC_K + (0.0,) if distort else ()
    if distort:
        p.tracker.distortionCoeffs = coeffs
    rcam = r_build_pinhole(FX, FX, 48.0, 32.0, coeffs, width=W, height=H, dtype=jnp.float64)
    seqs, frames = _frames(distort)
    tracked = batched_step_parity(p, (rcam, rcam), frames, seqs[0], B, shared_frames=False,
                                  imus=_per_lane_imu(seqs, FRAMES), tol=stereo_tol)
    assert tracked > 0


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_stereo_option_step_calls_nothing_that_syncs_on_the_card(option):
    """A step after the first under each option makes none of the calls
    that sync on the card (constants reach a device once, at build)."""
    p, _, _ = tiny_stereo_setup()
    for key, value in OPTIONS[option].items():
        group, name = key.split(".")
        p.set_parameter(group, name, value)
    coeffs = EUROC_K + (0.0,) if option == "rectify_distorted" else ()
    cam = build_pinhole(FX, FX, 48.0, 32.0, coeffs, width=W, height=H)
    seqs, frames = _frames(bool(coeffs))
    imus = _per_lane_imu(seqs, FRAMES)
    init, step, _ = make_batched_vio(p, PortDerived.from_parameters(p), (cam, cam), batch_size=B,
                                     max_tracks=12, dtype=torch.float64, device="cpu")
    tensors = lambda fi: tuple(torch.as_tensor(f) for f in frames[fi])
    imu = lambda i: ImuBatch(*map(torch.as_tensor, imus[i]))
    state = init(tensors(0), np.full(B, seqs[0].frame_times[0]), np.arange(B))
    state, _ = step(state, imu(0), tensors(1))
    args = (imu(1), tensors(2))
    lint = _SyncLint()
    with lint:
        step(state, *args)
    assert not lint.hits, dict(lint.hits)
