"""The port's local bundle adjustment (``slam/ba.py``: Gauss-Newton with
the points eliminated by the Schur complement) against the benchmark's
plain reference (``benchmark/reference_slam.py``: the same normal equations
solved dense, in float64), and the reference's map check.

Tolerance: ``BA_TOL`` = 1e-8 m on every valid pose position and point. The
elimination is exact algebra, so the two differ by float64 rounding carried
through 8 iterations: at most ~1e-12 m on these problems. The port's BA run
in float32 on the same problems (a lower precision than the session's
float64) is 5e-6 m off or more, so it fails the tolerance by two orders of
magnitude. On the card the session's captured BA is held to the same
tolerance (``-m cuda``).
"""
import numpy as np
import pytest
import torch

from benchmark import check, world
from benchmark import reference_slam as rs
from benchmark.cell import find_cell
from benchmark.drivers.vislam import slam_pose_err
from hybvio_tpu_torch.slam import ba
from hybvio_tpu_torch.slam.host import np_quat_to_rmat, np_relative_pose, np_rmat_to_quat

BA_TOL = 1e-8  # m (the module docstring)
# (seed, keyframes, map points): NK 4-6, MP 16-40
SHAPES = [(0, 4, 16), (1, 5, 24), (2, 6, 40), (3, 4, 33), (4, 6, 21), (5, 5, 37)]
CASES = [(seed, nk, mp, fix, priors) for seed, nk, mp in SHAPES
         for fix in (True, False) for priors in (True, False)]


def _ids(case):
    seed, nk, mp, fix, priors = case
    return f"s{seed}-nk{nk}-mp{mp}-{'fixed' if fix else 'free'}-{'priors' if priors else 'bare'}"


def random_problem(seed: int, NK: int, MP: int, priors: bool) -> dict:
    """A seeded BA problem (numpy fields of ``BAProblem``): a camera moving
    sideways and turning past points 4-8 m ahead, noisy observations with
    about 15% masked, the last pose invalid on odd seeds and up to four
    padding points, the start perturbed from the truth."""
    rng = np.random.RandomState(seed)
    poses = np.zeros((NK, 7))
    for k in range(NK):
        a = 0.15 * k + 0.05 * rng.randn()
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        poses[k] = np.concatenate([[0.3 * k, 0.05 * rng.randn(), 0.02 * k], np_rmat_to_quat(R)])
    points = np.stack([rng.uniform(-2, 3, MP), rng.uniform(-1.5, 1.5, MP),
                       rng.uniform(4, 8, MP)], axis=1)
    obs = np.zeros((NK, MP, 2))
    mask = np.zeros((NK, MP), bool)
    for k in range(NK):
        c = (points - poses[k, :3]) @ np_quat_to_rmat(poses[k, 3:])
        obs[k] = c[:, :2] / c[:, 2:] + 0.003 * rng.randn(MP, 2)
        mask[k] = (c[:, 2] > 0.5) & (rng.rand(MP) > 0.15)
    rel = np.stack([np_relative_pose(poses[k], poses[k + 1]) for k in range(NK - 1)])
    start = poses.copy()
    start[:, :3] += 0.03 * rng.randn(NK, 3)
    q = start[:, 3:] + 0.01 * rng.randn(NK, 4)
    start[:, 3:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    nk_valid = NK - seed % 2
    return dict(poses=start, points=points + 0.1 * rng.randn(MP, 3), obs_ip=obs, obs_mask=mask,
                pose_valid=np.arange(NK) < nk_valid,
                point_valid=np.arange(MP) < MP - rng.randint(0, 5), prior_rel=rel,
                prior_mask=(np.arange(NK - 1) < nk_valid - 1) & priors,
                prior_w_pos=np.float64(0.5), prior_w_rot=np.float64(5.0))


def _port(problem: dict, dtype, fix: bool, device="cpu"):
    fields = {k: torch.as_tensor(np.asarray(v)).to(
        device, dtype if np.asarray(v).dtype == np.float64 else None) for k, v in problem.items()}
    return ba.ba_iterate(ba.BAProblem(**fields), iterations=8, fix_first_pose=fix)


def _err(problem, got, want) -> float:
    pv, mv = problem["pose_valid"], problem["point_valid"]
    g = [x.double().cpu().numpy() for x in got[:2]]
    w = [x.cpu().numpy() for x in want[:2]]
    return max(np.abs(g[0][pv, :3] - w[0][pv, :3]).max(), np.abs(g[1][mv] - w[1][mv]).max())


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_port_ba_equals_the_dense_reference(case):
    seed, nk, mp, fix, priors = case
    problem = random_problem(seed, nk, mp, priors)
    want = rs.local_ba(problem, fix_first_pose=fix)
    got = _port(problem, torch.float64, fix)
    assert _err(problem, got, want) <= BA_TOL
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-9)
    # the solve moved the problem: agreement is not both standing still
    assert np.abs(want[1].numpy() - problem["points"])[problem["point_valid"]].max() > 0.05


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_float32_ba_fails_the_tolerance(case):
    seed, nk, mp, fix, priors = case
    problem = random_problem(seed, nk, mp, priors)
    want = rs.local_ba(problem, fix_first_pose=fix)
    assert _err(problem, _port(problem, torch.float32, fix), want) > 100 * BA_TOL


def test_ba_position_err_reads_the_valid_entries():
    problem = random_problem(1, 5, 24, True)
    got = _port(problem, torch.float64, True)
    assert rs.ba_position_err(problem, got) <= BA_TOL
    off = (got[0].clone(), got[1].clone())
    off[1][~torch.as_tensor(problem["point_valid"])] += 5.0  # padding does not count
    assert rs.ba_position_err(problem, off) <= BA_TOL
    off[1][0, 2] += 1e-3
    assert abs(rs.ba_position_err(problem, off) - 1e-3) < 1e-6
    off[0][0, 0] = float("nan")
    assert rs.ba_position_err(problem, off) == float("inf")


def _plays(seed=7, n=30):
    """One play of a cell-like world: the camera centres of n keyframes of
    the truth, seen in a map frame rotated and moved from the world's."""
    seq = world.lane_worlds(seed, 1, {"radius_m": [1.7, 2.3], "angular_speed_rad_s": [0.34, 0.46],
                                      "z_wobble_m": [0.1, 0.2], "n_landmarks": 50,
                                      "landmark_radius_m": 6.0, "gyro_noise": 0.0,
                                      "acc_noise": 0.0}, 200, 20.0, 200.0)[0]
    k = seq.frame_sample_idx[np.linspace(0, 199, n).astype(int)]
    truth = rs.camera_centres(seq.pos[k], seq.quat[k], world.IMU_TO_CAMERA)
    a = 0.7
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    return [(truth @ R.T + np.array([1.0, -2.0, 0.5]), truth)]


@pytest.mark.parametrize("added, ba_ran, plays", [
    (0, True, "map"), (3, False, "map"), (0, False, "map"), (3, True, "none"),
    (3, True, "one keyframe")])
def test_map_check_is_inf_without_window_work(added, ba_ran, plays):
    p = {"map": _plays(), "none": [], "one keyframe": [(x[:1], y[:1]) for x, y in _plays()]}
    assert rs.map_pose_err(p[plays], added, ba_ran) == float("inf")


def test_map_check_aligns_each_play():
    plays = _plays()
    assert rs.map_pose_err(plays, 3, True) < 1e-9
    est, truth = plays[0]
    moved = est.copy()
    moved[5] += [0.0, 0.0, 0.4]
    assert 0.3 < rs.map_pose_err([(moved, truth)], 3, True) < 0.45


def test_camera_centres_of_the_rig():
    """The camera centre of a rig with the camera 0.1 m along the body's y
    axis is that far from the body along its rotated y."""
    T = world.IMU_TO_CAMERA.copy()
    centre_body = np.array([0.0, 0.1, 0.0])
    T[:3, 3] = -T[:3, :3] @ centre_body
    a = 0.3
    q = np.array([[np.cos(a / 2), 0.0, 0.0, np.sin(a / 2)]])  # world -> body
    got = rs.camera_centres(np.array([[1.0, 2.0, 3.0]]), q, T)[0]
    body_to_world = np_quat_to_rmat(q[0]).T
    np.testing.assert_allclose(got, np.array([1.0, 2.0, 3.0]) + body_to_world @ centre_body,
                               atol=1e-15)


def cell_problem(seed: int = 3100000011, NK: int = 20, MP: int = 128) -> dict:
    """A local BA problem of the session's size from the ``vislam`` cell's
    world: NK keyframes 8 frames apart on the trajectory (camera to world),
    the world's landmarks they see, observations with 1 px noise at 458 px,
    the start perturbed, odometry priors at the session's weights."""
    cfg = {"radius_m": [1.7, 2.3], "angular_speed_rad_s": [0.34, 0.46],
           "z_wobble_m": [0.1, 0.2], "n_landmarks": 500, "landmark_radius_m": 6.0,
           "gyro_noise": 0.0, "acc_noise": 0.0}
    seq = world.lane_worlds(seed, 1, cfg, 8 * NK + 8, 20.0, 200.0)[0]
    rng = np.random.RandomState(seed % 2**31)
    k = seq.frame_sample_idx[8 + 8 * np.arange(NK)]
    T = world.IMU_TO_CAMERA
    poses = np.zeros((NK, 7))
    for i, s in enumerate(k):
        R_wc = np_quat_to_rmat(seq.quat[s]).T @ T[:3, :3].T  # camera to world
        poses[i] = np.concatenate([rs.camera_centres(seq.pos[s][None], seq.quat[s][None], T)[0],
                                   np_rmat_to_quat(R_wc)])
    cam = [(seq.landmarks - poses[i, :3]) @ np_quat_to_rmat(poses[i, 3:]) for i in range(NK)]
    seen = np.stack([(c[:, 2] > 0.3) & (np.abs(c[:, 0] / c[:, 2]) < 0.8)
                     & (np.abs(c[:, 1] / c[:, 2]) < 0.5) for c in cam])
    order = np.argsort(-seen.sum(0))[:MP]
    pts = seq.landmarks[order]
    mask = seen[:, order] & (seen[:, order].sum(0) >= 2)[None]
    obs = np.stack([c[order, :2] / np.where(np.abs(c[order, 2:]) > 1e-9, c[order, 2:], 1.0)
                    for c in cam]) + rng.randn(NK, MP, 2) / 458.0
    rel = np.stack([np_relative_pose(poses[i], poses[i + 1]) for i in range(NK - 1)])
    start = poses.copy()
    start[1:, :3] += 0.02 * rng.randn(NK - 1, 3)
    return dict(poses=start, points=pts + 0.05 * rng.randn(MP, 3), obs_ip=obs, obs_mask=mask,
                pose_valid=np.ones(NK, bool), point_valid=mask.sum(0) >= 2, prior_rel=rel,
                prior_mask=np.ones(NK - 1, bool), prior_w_pos=np.float64(500.0 / 100.0),
                prior_w_rot=np.float64(5000.0 / 100.0))


def _session_ba(problem: dict, device: str):
    """The session's own local BA program (``Slam._ba_fn``, captured on the
    card) on ``problem``, called three times: the warm-up, the capture,
    then a replay, whose result is returned."""
    from hybvio_tpu_torch.config import Parameters
    from hybvio_tpu_torch.slam.session import Slam

    session = Slam(Parameters(), device=device)
    run = session._ba_fn()
    for _ in range(3):
        out = run(ba.BAProblem(**problem))
    return session, out


def test_cell_sized_problem_on_the_cpu():
    problem = cell_problem()
    _, got = _session_ba(problem, "cpu")
    want = rs.local_ba(problem)
    assert _err(problem, [torch.as_tensor(g) for g in got], want) <= BA_TOL


@pytest.mark.parametrize("dtype, correct", [(torch.float64, True), (torch.float32, False)],
                         ids=["float64", "float32"])
def test_ba_err_decides_the_cells_correct(dtype, correct):
    """A run of ``vislam.online_b1`` whose last local BA (here the cell's
    problem) ran in float32 is not correct, whatever its poses read; in
    float64, as the configuration states, the BA does not refuse it."""
    cell = find_cell("vislam.online_b1")
    problem = cell_problem()
    ba_err = rs.ba_position_err(problem, _port(problem, dtype, True))
    pose = slam_pose_err(0.03, 0.02, ba_err, cell.workload["ba_err_limit"])
    ok, compared = check.judge({"pose_err_m": pose, "pyramid_err": 0.0},
                               cell.workload["check"]["limits"])
    assert bool(ok) == correct
    assert compared["pose_err_m"]["value"] == (0.03 if correct else float("inf"))


@pytest.mark.parametrize("ba_err", [float("nan"), float("inf"), 2e-8])
def test_a_ba_off_the_reference_makes_the_pose_number_inf(ba_err):
    assert slam_pose_err(0.03, 0.02, ba_err, 1e-8) == float("inf")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the session's captured local BA runs on the card")


@pytest.mark.cuda
def test_captured_session_ba_on_the_card_equals_the_reference(card):
    problem = cell_problem()
    session, got = _session_ba(problem, "cuda")
    assert session._ba_program.captures == 1 and session._ba_program.replays >= 1
    want = rs.local_ba(problem, device="cuda")
    assert _err(problem, [torch.as_tensor(g) for g in got], want) <= BA_TOL
