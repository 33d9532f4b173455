"""The ``vislam`` driver's run of ``vislam.online_b1`` at a tiny size on
the CPU (192x160 frames, 24 tracks, a SLAM frame and a keyframe at every
keyframe, a map of 3 adjacent keyframes, 40-frame rounds), judged by the
cell's own limits: a sound run is correct, and does SLAM work in its
window; the same run with the session's local BA in float32, a precision
below the configuration's float64, is not, through ``ba_err``. At the
cell's own size, a filter whose state stays where it started reads far
over the cell's pose limit on its worlds."""
import json

import numpy as np
import pytest
import torch

from benchmark import cell as C
from benchmark import check, reference, world
from benchmark.run import run_cell
from hybvio_tpu_torch.slam import session as slam_session

CELL = "vislam.online_b1"
SIZE = {"width": 192, "height": 160, "focal": 120.0}
SMALL = {"tracker.maxTracks": 24, "tracker.pyrLKMaxLevel": 1, "tracker.pyrLKWindowSize": 11,
         "tracker.pyrLKMaxIter": 5, "tracker.focalLength": 120.0,
         "slam.keyframeCandidateInterval": 1, "slam.adjacentSpaceSize": 3,
         "slam.keyframeDecisionAlways": True, "slam.minTriangulationAngleTwoObs": 0.5}


@pytest.fixture
def tiny_cell(tmp_path):
    spec = C.load_json(C.ROOT / "BENCHMARK.json")
    real = C.find_cell(CELL)
    cfg = json.loads(json.dumps(real.config))
    cfg["camera"].update(SIZE)
    cfg["overrides"].update(SMALL)
    cfg["slam"].update(keyframeCandidateInterval=1, adjacentSpaceSize=3)
    cfg["world"].update(angular_speed_rad_s=[1.6, 1.8])
    cfg.update(sequence_frames=40)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    (tmp_path / f"{CELL}.json").write_text(json.dumps(dict(real.workload, warmup_frames=12)))
    for c in spec["configs"]:
        if c["name"] == cfg["name"]:
            c["file"] = str(tmp_path / "cfg.json")
    return C.find_cell(CELL, spec, tmp_path)


PORT_BA = slam_session.ba_iterate


def float32_ba_iterate(problem, iterations):
    """The port's BA on ``problem`` in float32, its result in float64."""
    low = slam_session.BAProblem(*(v.to(torch.float32) if v.dtype == torch.float64 else v
                                   for v in problem))
    return tuple(o.to(torch.float64) for o in PORT_BA(low, iterations=iterations))


@pytest.mark.parametrize("ba", ["float64", "float32"])
def test_tiny_run_is_judged_by_its_ba(tiny_cell, monkeypatch, ba):
    torch.set_num_threads(2)
    if ba == "float32":
        monkeypatch.setattr(slam_session, "ba_iterate", float32_ba_iterate)
    out = run_cell(tiny_cell, 2**31 + 21, 2.0, True, "cpu")
    ok, compared = check.judge(out["numbers"], tiny_cell.workload["check"]["limits"])
    d = out["details"]
    assert out["failed"] == 0 and d["keyframes_in_window"] >= 1 and d["local_ba_in_window"]
    assert d["captures_in_window"] == 0 and out["record"]["path"] == "online"
    assert d["slam_counters"]["slam.loop_queries"] >= 1
    limit = tiny_cell.workload["ba_err_limit"]
    if ba == "float64":
        assert bool(ok) and d["ba_err"] <= limit
        assert compared["pose_err_m"]["value"] == max(d["pose_err_outputs_m"], d["pose_err_map_m"])
    else:
        assert not ok and d["ba_err"] > 100 * limit
        assert compared["pose_err_m"]["value"] == float("inf")
        assert np.isfinite(d["pose_err_outputs_m"])  # the poses alone would not tell


@pytest.mark.parametrize("seed", [2**31 + 3, 3_900_000_001, 5])
def test_frozen_filter_at_the_cells_geometry_is_not_correct(seed):
    """Outputs that stay where the stream started, over the 240 frames of
    set-up alone (a window adds ~250 more), read over 1.4 times the
    ``pose_err_m`` limit on the cell's own worlds: 2.1-2.6 m."""
    cell = C.find_cell(CELL)
    cfg, limits = cell.config, cell.workload["check"]["limits"]
    cam, n = cfg["camera"], cell.workload["warmup_frames"]
    seqs = world.lane_worlds(seed, 1, cfg["world"], cfg["sequence_frames"], cam["rate_hz"],
                             cfg["imu_rate_hz"])
    frame = torch.randint(0, 256, (1, 32, 32), dtype=torch.uint8)  # a sound pyramid
    numbers, _ = check.numbers(seqs, [(0, seqs[0].frame_sample_idx[1:n + 1], np.zeros((n, 3)))],
                               (frame, *reference.pyramid(frame, 2)))
    assert numbers["pose_err_m"] > 1.4 * limits["pose_err_m"], numbers
    assert not check.judge(numbers, limits)[0]
