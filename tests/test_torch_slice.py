"""The whole stereo batched VIO step of the port against the reference's
``make_batched_vio(shared_frames=True)``: B=2 lanes, 5 rendered frames,
both packages started from one state through ``convert``.

After every frame, every integer and boolean field of the state and of the
FrameOutput (track ids, statuses, keyframe and trail bookkeeping, point
cloud statuses, tracking status) must be equal and the positions must agree
to 1e-6 m. Other floats agree to the tolerances below: the front-end runs
in float32 on both sides and sums its windows in another order (a few ulp
of the pixel coordinates, carried on by LK), which reaches the float64
filter through the measured pixels."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from hybvio_tpu.odometry.backend import ImuBatch as RImuBatch
from hybvio_tpu.parallel.batched import make_batched_vio as r_make_batched_vio
from hybvio_tpu_torch import convert
from hybvio_tpu_torch.config import DerivedParameters as PortDerived
from hybvio_tpu_torch.odometry.backend import ImuBatch
from hybvio_tpu_torch.parallel.batched import make_batched_vio

from torch_parity import imu_batches, mismatches, stereo_frame, tiny_sequence, tiny_stereo_setup

torch.set_num_threads(1)

B, FRAMES = 2, 5
PIXEL_FIELDS = ("px", "kf_pix", "pixels", "prev_pixels", "track_prev_pixels", "last_kf_px")
# visualization payload: also where LK landed for FAILED tracks, whose
# unconverged iterations carry the rounding further
VIZ_FIELDS = ("viz_pixels", "track_pixels")


def _tol(path):
    field = path.rsplit(".", 1)[-1].split("[")[0]
    if field == "position":
        return 1e-6  # m
    if field in PIXEL_FIELDS:
        return 2e-4  # px, f32 front-end
    if field in VIZ_FIELDS:
        return 1e-2  # px
    if field in ("P", "position_cov", "velocity_cov", "bias_cov_diag"):
        return 1e-3  # covariance entries up to ~1e4
    return 1e-5


def test_batched_stereo_step_matches_reference():
    p, derived, rcam = tiny_stereo_setup()
    seq = tiny_sequence(FRAMES)
    frames = [stereo_frame(seq, fi) for fi in range(FRAMES + 1)]
    rinit, rstep = r_make_batched_vio(p, derived, (rcam, rcam), batch_size=B, max_tracks=12,
                                      dtype=jnp.float64, shared_frames=True)
    rstate = rinit(tuple(jnp.asarray(f) for f in frames[0]), np.full(B, seq.frame_times[0]),
                   np.arange(B))
    cam = convert.camera_from_jax(rcam)
    tinit, tstep, _ = make_batched_vio(p, PortDerived.from_parameters(p), (cam, cam), batch_size=B,
                                       max_tracks=12, dtype=torch.float64, device="cpu")
    # the port's own initialization equals the reference's
    own = tinit(tuple(torch.as_tensor(f) for f in frames[0]), np.full(B, seq.frame_times[0]),
                np.arange(B))
    diff = mismatches(convert.to_numpy(own), jax.tree.map(np.asarray, rstate), _tol, "init")
    assert not diff, diff

    state = convert.from_jax(jax.tree.map(np.asarray, rstate))
    tracked = 0
    for fi, imu in enumerate(imu_batches(seq, FRAMES, B), start=1):
        pair = frames[fi]
        rstate, rout = rstep(rstate, RImuBatch(*map(jnp.asarray, imu)),
                             tuple(jnp.asarray(f) for f in pair))
        state, out = tstep(state, ImuBatch(*map(torch.as_tensor, imu)),
                           tuple(torch.as_tensor(f) for f in pair))
        diff = (mismatches(convert.to_numpy(state), jax.tree.map(np.asarray, rstate), _tol,
                           f"frame {fi} state")
                + mismatches(convert.to_numpy(out), jax.tree.map(np.asarray, rout), _tol,
                             f"frame {fi} output"))
        assert not diff, f"first parting: {diff[0]} (all: {diff})"
        tracked += int((np.asarray(rout.track_ids) >= 0).sum())
        assert np.isfinite(out.position.numpy()).all()
    assert tracked > 0


def test_uint8_frames_initialize_like_reference():
    """Raw 8-bit frames are normalized to [0, 1] on the device, as the
    reference's normalize_input does."""
    p, derived, rcam = tiny_stereo_setup()
    seq = tiny_sequence(1)
    pair = tuple(np.round(f * 255).astype(np.uint8) for f in stereo_frame(seq, 0))
    rinit, _ = r_make_batched_vio(p, derived, (rcam, rcam), batch_size=B, max_tracks=12,
                                  dtype=jnp.float64, shared_frames=True)
    rstate = rinit(tuple(jnp.asarray(f) for f in pair), np.full(B, 10.0), np.arange(B))
    cam = convert.camera_from_jax(rcam)
    tinit, _, _ = make_batched_vio(p, PortDerived.from_parameters(p), (cam, cam), batch_size=B,
                                   max_tracks=12, dtype=torch.float64, device="cpu")
    state = tinit(tuple(torch.as_tensor(f) for f in pair), np.full(B, 10.0), np.arange(B))
    assert state.tracker.prev_pyr[0].dtype == torch.float32
    diff = mismatches(convert.to_numpy(state), jax.tree.map(np.asarray, rstate), _tol, "init")
    assert not diff, diff
