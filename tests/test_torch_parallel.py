"""The port's multi-device layer on the CPU: the mesh (parallel/batched.py
Mesh, make_mesh), the batched step over a mesh, the scanned offline mode
(make_batched_scan), the sharded bundle adjustment (slam/ba.py
make_sharded_ba), the SLAM session over a mesh (Slam.set_ba_mesh) and the
entry points (graft_entry). A CPU mesh lists the CPU once a shard, as the
reference's tests lay out 8 virtual CPU devices (tests/conftest.py): every
line of the splitting and the reductions runs, but no copy between cards.

Tolerances: the sharded BA against the port's unsharded one to 1e-10 in
float64 (only the order of the sums across shards differs), against the
reference's sharded BA to test_torch_slam.py's SOLVE_TOL; the session over
a mesh against the reference's frame by frame (test_torch_slam_session.py's
_same: ids exactly, poses and points to its POSE_TOL); the step over a mesh
against the same call without one at rtol 1e-6 / atol 1e-8 (the
reference's own bound, tests/test_parallel.py). The unsharded step is held
to the reference by test_torch_per_lane.py and test_torch_mono.py, so this
closes the chain from the port's mesh step to the reference's. The scan is
the eager step in a loop, so the two are equal."""
import os
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from hybvio_tpu.parallel.batched import make_mesh as r_make_mesh
from hybvio_tpu.slam import ba as r_ba
from hybvio_tpu.slam.session import Slam as RSlam
from hybvio_tpu_torch import convert, graft_entry
from hybvio_tpu_torch.config import DerivedParameters as PortDerived
from hybvio_tpu_torch.config import Parameters
from hybvio_tpu_torch.io.synthetic import SYNTH_IMU_TO_CAMERA, generate_sequence, render_view
from hybvio_tpu_torch.odometry.backend import ImuBatch
from hybvio_tpu_torch.parallel.batched import (
    Mesh, gather_lanes, make_batched_scan, make_batched_vio, make_mesh,
)
from hybvio_tpu_torch.slam import ba
from hybvio_tpu_torch.slam.session import Slam
from test_parallel import tiny_setup
from test_torch_slam import SOLVE_TOL
from test_torch_slam_session import _run

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
W, H, FX, S = 96, 64, 80.0, 10


# ------------------------------------------------------------ the sharded BA

def _scene(seed=0, NK=6, MP=64):
    """tests/test_parallel.py's sharded-BA problem (numpy fields): points
    in front of a camera line along x, observations with 1e-3 noise,
    perturbed starting poses and points."""
    rng = np.random.RandomState(seed)
    gt_pts = np.stack([rng.uniform(-2, 2, MP), rng.uniform(-2, 2, MP), rng.uniform(4, 8, MP)], 1)
    poses = np.zeros((NK, 7))
    poses[:, 3] = 1.0
    poses[:, 0] = np.linspace(0, 1.0, NK)
    obs = np.zeros((NK, MP, 2))
    for k in range(NK):
        rel = gt_pts - poses[k, :3]
        obs[k] = rel[:, :2] / rel[:, 2:3] + 1e-3 * rng.randn(MP, 2)
    prior_rel = np.zeros((NK - 1, 7))
    prior_rel[:, 3] = 1.0
    prior_rel[:, 0] = np.diff(poses[:, 0])
    return dict(
        poses=poses + np.concatenate([0.01 * rng.randn(NK, 3), np.zeros((NK, 4))], 1),
        points=gt_pts + 0.05 * rng.randn(MP, 3), obs_ip=obs, obs_mask=np.ones((NK, MP), bool),
        pose_valid=np.ones(NK, bool), point_valid=np.ones(MP, bool), prior_rel=prior_rel,
        prior_mask=np.ones(NK - 1, bool), prior_w_pos=np.float64(10.0),
        prior_w_rot=np.float64(10.0))


def _port_problem(fields):
    return ba.BAProblem(**{k: torch.as_tensor(np.asarray(v)) for k, v in fields.items()})


def _close(got, want, atol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


def test_sharded_ba_equals_unsharded():
    """Eight point shards of eight points against one shard of 64: the
    same Schur system, summed in another order."""
    problem = _port_problem(_scene())
    got = ba.make_sharded_ba(make_mesh(8, "cpu"), iterations=5)(problem)
    want = ba.ba_iterate(problem, iterations=5)
    assert got[1].shape == (64, 3)
    _close(got, want, 1e-10)
    assert float(got[2]) < 1e-3  # it refined the scene


def test_sharded_ba_equals_reference_sharded_ba():
    """The port's sharded BA over 8 CPU shards against the reference's
    shard_map over the conftest's 8 virtual devices."""
    fields = _scene()
    got = ba.make_sharded_ba(make_mesh(8, "cpu"), iterations=5)(_port_problem(fields))
    want = r_ba.make_sharded_ba(r_make_mesh(8), iterations=5)(
        r_ba.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()}))
    _close(got, want, SOLVE_TOL)


@pytest.mark.parametrize("fix_first", [True, False])
def test_sharded_ba_with_padding_masks(fix_first):
    """Masks that pad the point axis (the whole last shard and part of the
    one before it) and the last pose, as the session pads its problem:
    sharded equals unsharded, and padded points and poses stay put."""
    fields = _scene(seed=3)
    fields["point_valid"] = np.arange(64) < 51
    fields["pose_valid"] = np.arange(6) < 5
    fields["prior_mask"] = np.arange(5) < 4
    problem = _port_problem(fields)
    got = ba.make_sharded_ba(make_mesh(8, "cpu"), iterations=5,
                             fix_first_pose=fix_first)(problem)
    want = ba.ba_iterate(problem, iterations=5, fix_first_pose=fix_first)
    _close(got, want, 1e-10)
    np.testing.assert_array_equal(got[1][51:].numpy(), fields["points"][51:])
    np.testing.assert_allclose(got[0][5].numpy(), fields["poses"][5], rtol=0, atol=1e-15)
    assert np.abs(got[1][:51].numpy() - fields["points"][:51]).max() > 1e-4


def test_session_with_sharded_ba_equals_reference(monkeypatch):
    """tests/test_parallel.py's session scene (a keyframe every frame,
    local BA on) with set_ba_mesh on both sides: the port over 8 CPU
    shards, the reference over its 8 virtual devices, frame by frame."""
    for cls, mesh in ((Slam, make_mesh(8, "cpu")), (RSlam, r_make_mesh(8))):
        def init(self, *args, _init=cls.__init__, _mesh=mesh, **kwargs):
            _init(self, *args, **kwargs)
            self.set_ba_mesh(_mesh)

        monkeypatch.setattr(cls, "__init__", init)

    def setup(p):
        p.slam.keyframeDecisionAlways = True
        p.slam.applyLocalBundleAdjustment = True

    rng = np.random.RandomState(0)
    F = 24
    gt_pts = np.stack([rng.uniform(-2, 2, F), rng.uniform(-2, 2, F), rng.uniform(4, 8, F)], 1)
    frames = []
    for fi in range(8):
        pose = np.eye(4)
        pose[0, 3] = 0.15 * fi
        rel = gt_pts - pose[:3, 3]
        frames.append((None, pose, np.arange(F), rel[:, :2] / rel[:, 2:3]
                       + 1e-3 * rng.randn(F, 2), float(fi) * 0.5, fi))
    port, _ = _run(frames, setup, dict(compute_descriptors=False))
    assert port._ba_sharded is not None and len(port.kf_order) == 8
    tri = [mp for mp in port.points.values() if mp.triangulated]
    err = np.array([np.linalg.norm(mp.position - gt_pts[mp.track_id]) for mp in tri])
    assert len(tri) >= 10 and np.median(err) < 0.3, np.median(err)


# --------------------------------------------------- the step over a mesh

def _worlds(lanes, n_frames):
    """Per-lane mono frames (n_frames + 1, lanes, H, W) of distinct worlds
    (seed 1000 + b, as bench.py's seed-diverse leg) and per-lane IMU
    batches, at tests/test_parallel.py's tiny size."""
    seqs = [generate_sequence(duration=(n_frames + 2) / 20.0, imu_rate=200.0, frame_rate=20.0,
                              n_landmarks=300, landmark_radius=6.0, gyro_noise=5e-4,
                              acc_noise=5e-3, seed=1000 + b) for b in range(lanes)]
    idx, times = seqs[0].frame_sample_idx, seqs[0].times
    frames = np.stack([[render_view(s.landmarks, s.pos[idx[fi]], s.quat[idx[fi]],
                                    SYNTH_IMU_TO_CAMERA, FX, FX, W / 2, H / 2, W, H)
                        for s in seqs] for fi in range(n_frames + 1)]).astype(np.float32)
    imus, prev = [], idx[0] + 1
    for fi in range(1, n_frames + 1):
        k = idx[fi] + 1
        n = k - prev
        pad = lambda a: np.pad(a, [(0, S - n)] + [(0, 0)] * (a.ndim - 1), mode="edge")
        imus.append(ImuBatch(
            torch.as_tensor(np.tile(pad(times[prev:k]), (lanes, 1))),
            torch.as_tensor(np.stack([pad(s.gyro[prev:k]) for s in seqs])),
            torch.as_tensor(np.stack([pad(s.acc[prev:k]) for s in seqs])),
            torch.as_tensor(np.tile(np.arange(S) < n, (lanes, 1)))))
        prev = k
    return torch.as_tensor(frames), imus, seqs[0].frame_times[0]


def _tiny():
    p, _, rcam = tiny_setup()
    return p, PortDerived.from_parameters(p), (convert.camera_from_jax(rcam),)


def _steps(mesh, frames, imus, t0, lanes):
    init, step, _ = make_batched_vio(*_tiny(), batch_size=lanes, max_tracks=12,
                                     device="cpu", mesh=mesh)
    state = init(frames[0], np.full(lanes, t0), np.arange(lanes))
    positions = []
    for fi, imu in enumerate(imus, start=1):
        state, out = step(state, imu, frames[fi])
        positions.append(out.position)
    if mesh is not None:
        assert len(state) == mesh.size
        state = gather_lanes(state, torch.device("cpu"))
    return torch.stack(positions).numpy(), state


def test_mesh_step_equals_unsharded():
    """B = 8 lanes of 8 worlds over a mesh of 4 CPU shards, 3 steps,
    against the same call without a mesh: positions and every state field,
    lane by lane (the shards draw lane b's RANSAC and sampling keys from
    its own seed, as the unsharded step does)."""
    lanes = 8
    frames, imus, t0 = _worlds(lanes, 3)
    pos, state = _steps(None, frames, imus, t0, lanes)
    mpos, mstate = _steps(make_mesh(4, "cpu"), frames, imus, t0, lanes)
    assert np.isfinite(mpos).all() and mpos.shape == (3, lanes, 3)
    np.testing.assert_allclose(mpos, pos, rtol=1e-6, atol=1e-8)
    want, got = convert.to_numpy(state), convert.to_numpy(mstate)
    for path, a, b in _leaves(got, want):
        assert a.shape == b.shape, path
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8, err_msg=path)
    assert (want.tracker.track_ids >= 0).sum() > lanes  # the lanes track


def _leaves(a, b, path="state"):
    if isinstance(a, tuple):
        names = getattr(a, "_fields", range(len(a)))
        for name, x, y in zip(names, a, b):
            yield from _leaves(x, y, f"{path}.{name}")
    elif a is not None:
        yield path, a, b


def test_scan_equals_eager_loop():
    """make_batched_scan over a staged sequence (shared frames, B = 4, 4
    frames) against the eager step in a loop: the same step, so the same
    positions and state bit for bit."""
    B, F = 4, 4
    frames, imus, t0 = _worlds(1, F)
    frames = frames[:, 0]
    imus = [ImuBatch(*(x.expand((B,) + x.shape[1:]).clone() for x in imu)) for imu in imus]
    gyro = torch.as_tensor(0.02 * np.random.RandomState(5).randn(F, B, S, 3))
    imus = [imu._replace(gyro=imu.gyro + g) for imu, g in zip(imus, gyro)]

    init, step, _ = make_batched_vio(*_tiny(), batch_size=B, max_tracks=12, device="cpu",
                                     shared_frames=True)
    state = init(frames[0], np.full(B, t0), np.arange(B))
    eager = []
    for fi, imu in enumerate(imus, start=1):
        state, out = step(state, imu, frames[fi])
        eager.append(out.position)

    sinit, scan_run = make_batched_scan(*_tiny(), batch_size=B, max_tracks=12, device="cpu")
    sstate = sinit(frames[0], np.full(B, t0), np.arange(B))
    imu_stack = ImuBatch(*(torch.stack(xs) for xs in zip(*imus)))
    sstate, positions = scan_run(sstate, imu_stack, frames[1:])
    assert positions.shape == (F, B, 3)
    assert torch.equal(positions, torch.stack(eager))
    for path, a, b in _leaves(convert.to_numpy(sstate), convert.to_numpy(state)):
        np.testing.assert_array_equal(a, b, err_msg=path)


_BARE_CUDA = re.compile(r"""torch\.device\(\s*["']cuda["']\s*\)|device\s*=\s*["']cuda["']"""
                        r"""|\.to\(\s*["']cuda["']|\.cuda\(\s*\)|default_device\(\)""")


def test_step_names_no_bare_cuda_device():
    """No line the step runs over a mesh names the current card ("cuda"
    without an index, or ``runtime.default_device()``): a replica on
    cuda:1 would put such a tensor on cuda:0. Every line the port executes
    in one step of a 2-shard mesh is traced here; the kernel wrappers'
    launch lines, which the CPU does not run, are read whole (they launch
    on the current device's stream, the shard's)."""
    lanes = 2
    frames, imus, t0 = _worlds(lanes, 1)
    init, step, _ = make_batched_vio(*_tiny(), batch_size=lanes, max_tracks=12, device="cpu",
                                     mesh=make_mesh(2, "cpu"))
    state = init(frames[0], np.full(lanes, t0), np.arange(lanes))
    port = str(REPO / "hybvio_tpu_torch")
    ran = set()

    def trace(frame, event, arg):
        if not frame.f_code.co_filename.startswith(port):
            return None
        ran.add((frame.f_code.co_filename, frame.f_lineno))
        return trace

    sys.settrace(trace)
    try:
        step(state, imus[0], frames[1])
    finally:
        sys.settrace(None)
    files = {f for f, _ in ran}
    assert any(f.endswith("odometry/vio.py") for f in files) and len(ran) > 500
    sources = {f: Path(f).read_text().splitlines() for f in files}
    bare = [f"{f}:{n}: {sources[f][n - 1].strip()}" for f, n in sorted(ran)
            if _BARE_CUDA.search(sources[f][n - 1])]
    for path in sorted((REPO / "hybvio_tpu_torch" / "ops").glob("*.py")):
        bare += [f"{path}:{n}: {line.strip()}"
                 for n, line in enumerate(path.read_text().splitlines(), start=1)
                 if _BARE_CUDA.search(line)]
    assert not bare, bare


# ------------------------------------------------- the mesh and its errors

def test_make_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1)


def test_make_mesh_takes_only_the_cards_present(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 cards asked for, 1 present"):
        make_mesh(2)
    assert make_mesh() == make_mesh(1) == Mesh((torch.device("cuda", 0),))
    with pytest.raises(ValueError, match="by its index"):
        Mesh(("cuda",))
    mesh = make_mesh(3, "cpu")
    assert mesh.size == 3 and mesh.axis == "data" and mesh.devices == (torch.device("cpu"),) * 3


def test_uneven_splits_raise():
    """A batch or a point count that the mesh does not divide raises, as
    the reference's shardings do; so does a session whose BA points do
    not divide."""
    with pytest.raises(ValueError, match="a batch of 6 does not split evenly over a mesh of 4"):
        make_batched_vio(*_tiny(), batch_size=6, device="cpu", mesh=make_mesh(4, "cpu"))
    with pytest.raises(ValueError, match="map points of 64 does not split evenly"):
        ba.make_sharded_ba(make_mesh(3, "cpu"))(_port_problem(_scene()))
    with pytest.raises(AssertionError):
        Slam(Parameters(), device="cpu").set_ba_mesh(make_mesh(3, "cpu"))


# ------------------------------------------------------- the entry points

def test_dryrun_multichip_on_the_cpu():
    out = graft_entry.dryrun_multichip(2, device="cpu")
    assert out["devices"] == ["cpu", "cpu"] and out["positions"].shape == (2, 3)
    assert np.isfinite(out["positions"]).all() and np.isfinite(out["ba_cost"])


def test_entry_steps_on_the_cpu_and_takes_the_card_by_default(monkeypatch):
    step, args = graft_entry.entry("cpu")
    state, out = step(*args)
    assert out.position.shape == (1, 3) and torch.isfinite(out.position).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(1)
