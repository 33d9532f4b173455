"""Entry points of a quick check of the port (counterpart of the reference
repository's ``__graft_entry__.py``): one VIO step of a tiny mono set-up,
and an in-process dry run of the multi-device layer over a mesh.

    python -m hybvio_tpu_torch.graft_entry              # the step, on the card
    python -m hybvio_tpu_torch.graft_entry --dryrun N   # the mesh of N cards
    (append --cpu to either to run on the CPU)
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .config import DerivedParameters, Parameters
from .geometry.cameras import build_pinhole
from .io.synthetic import SYNTH_IMU_TO_CAMERA
from .odometry.backend import ImuBatch
from .parallel.batched import make_batched_vio, make_mesh
from .runtime import filter_dtype
from .slam.ba import BAProblem, make_sharded_ba

IMU_SAMPLES = 8


def _tiny_setup(width=96, height=64, trail=4, max_tracks=12):
    """(params, derived, camera) of the tiny mono configuration."""
    p = Parameters()
    p.odometry.cameraTrailLength = trail
    p.tracker.maxTracks = max_tracks
    p.odometry.maxVisualUpdates = 4
    p.tracker.focalLength = 80.0
    p.tracker.principalPointX = width / 2
    p.tracker.principalPointY = height / 2
    p.tracker.pyrLKWindowSize = 9
    p.tracker.pyrLKMaxLevel = 1
    p.tracker.gfttMinDistance = 40.0
    p.odometry.imuToCameraMatrix = tuple(SYNTH_IMU_TO_CAMERA.T.flatten())
    derived = DerivedParameters.from_parameters(p)
    cam = build_pinhole(80.0, 80.0, width / 2, height / 2, width=width, height=height)
    return p, derived, cam


def _imu(rng, lanes, dtype, device) -> ImuBatch:
    """IMU_SAMPLES samples at 200 Hz after t = 10 s, near rest, per lane."""
    S = IMU_SAMPLES
    t = np.tile(10.0 + (1 + np.arange(S)) * 0.005, (lanes, 1))
    gyro = 0.01 * rng.randn(lanes, S, 3)
    acc = np.tile([0.0, 0.0, 9.819], (lanes, S, 1)) + 0.01 * rng.randn(lanes, S, 3)
    f = lambda a: torch.as_tensor(a, dtype=dtype).to(device)
    return ImuBatch(f(t), f(gyro), f(acc), torch.ones((lanes, S), dtype=torch.bool, device=device))


def _image(rng, lanes, device):
    return torch.as_tensor(rng.rand(lanes, 64, 96), dtype=torch.float32).to(device)


def entry(device="cuda"):
    """(step, example_args): one full VIO frame step (image front-end and
    EKF backend) of the tiny mono configuration at 96x64, one lane, on the
    card unless ``device`` is "cpu"; ``step(*example_args)`` -> (state,
    FrameOutput)."""
    device = torch.device(device)
    p, derived, cam = _tiny_setup()
    init, step, _ = make_batched_vio(p, derived, (cam,), batch_size=1,
                                     max_tracks=p.tracker.maxTracks, device=device)
    rng = np.random.RandomState(0)
    state = init(_image(rng, 1, device), np.full(1, 10.0), np.arange(1))
    imu = _imu(rng, 1, filter_dtype(device), device)
    return step, (state, imu, _image(rng, 1, device))


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The multi-device layer in process over ``make_mesh(n_devices,
    device)``: one batched step of n_devices independent sequences (one
    lane a shard), whose positions must be finite, and the sharded bundle
    adjustment at NK = 4 keyframes and MP = 2 n_devices map points, whose
    cost must be finite. Raises on a failure (and, on the card, where
    fewer than n_devices cards exist); returns the positions and the cost.
    """
    mesh = make_mesh(n_devices, device)
    home = mesh.devices[0]
    dtype = filter_dtype(home)
    p, derived, cam = _tiny_setup()
    B = n_devices
    init, step, _ = make_batched_vio(p, derived, (cam,), batch_size=B,
                                     max_tracks=p.tracker.maxTracks, mesh=mesh)
    rng = np.random.RandomState(0)
    states = init(_image(rng, B, home), np.full(B, 10.0), np.arange(B))
    imu = _imu(rng, B, dtype, home)
    states, outs = step(states, imu, _image(rng, B, home))
    positions = outs.position.cpu().numpy()
    if positions.shape != (B, 3) or not np.isfinite(positions).all():
        raise AssertionError(f"dryrun_multichip({n_devices}): positions {positions}")

    # the sharded bundle adjustment: map points over the mesh, the pose
    # normal equations summed across its shards
    NK, MP = 4, 2 * n_devices
    pts = np.stack([rng.uniform(-1, 1, MP), rng.uniform(-1, 1, MP), rng.uniform(3, 6, MP)], 1)
    poses = np.zeros((NK, 7))
    poses[:, 3] = 1.0
    poses[:, 0] = np.linspace(0, 0.5, NK)
    obs = np.stack([(pts - poses[k, :3])[:, :2] / (pts - poses[k, :3])[:, 2:3]
                    for k in range(NK)])
    prior_rel = np.zeros((NK - 1, 7))
    prior_rel[:, 3] = 1.0
    prior_rel[:, 0] = np.diff(poses[:, 0])
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype).to(home)
    ones = lambda *shape: torch.ones(shape, dtype=torch.bool, device=home)
    problem = BAProblem(
        poses=f(poses), points=f(pts), obs_ip=f(obs), obs_mask=ones(NK, MP),
        pose_valid=ones(NK), point_valid=ones(MP), prior_rel=f(prior_rel),
        prior_mask=ones(NK - 1), prior_w_pos=f(10.0), prior_w_rot=f(10.0))
    _, _, cost = make_sharded_ba(mesh, iterations=2)(problem)
    cost = float(cost)
    if not np.isfinite(cost):
        raise AssertionError(f"dryrun_multichip({n_devices}): BA cost {cost}")
    return {"devices": [str(d) for d in mesh.devices], "positions": positions, "ba_cost": cost}


def main(argv) -> int:
    device = "cpu" if "--cpu" in argv else "cuda"
    if "--dryrun" in argv:
        n = int(argv[argv.index("--dryrun") + 1])
        print(f"dryrun_multichip({n}) OK: {dryrun_multichip(n, device)}")
    else:
        step, args = entry(device)
        _, out = step(*args)
        print("entry() step OK; position:", out.position.cpu().numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
