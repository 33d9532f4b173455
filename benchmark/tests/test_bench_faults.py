"""The harness's check catches a broken timed path, and its control, at a
tiny size on the CPU: a run skips only the look for a card (the drivers
take the CPU) and judges the outputs by the cell's own limits. A sound run
is correct; a run whose step returns its state unchanged, leaves half of
the lanes out, or alters an answer where it is produced, and the control
(the frames in bfloat16, products in TF32), are not. The tiny size keeps
the world's fast trajectory short, so the faults that freeze a state show
in the pyramid, and an answer altered by 50 m in the pose. At each cell's
own trajectories and window, a filter whose state stays where it started
reads far over the cell's pose limit, whatever the tracker does."""
import json

import numpy as np
import pytest
import torch

from benchmark import cell as C
from benchmark import check, control, program, reference, world
from benchmark.run import run_cell

SIZE = {"width": 192, "height": 160, "focal": 120.0}
SMALL = {"tracker.maxTracks": 24, "tracker.pyrLKMaxLevel": 1, "tracker.pyrLKWindowSize": 11,
         "tracker.pyrLKMaxIter": 5, "tracker.focalLength": 120.0}
CELLS = {"lanes": "tumvi_fisheye.offline_b28", "api": "euroc_stereo.online_b1"}


def tiny_cell(tmp_path, driver):
    """The cell at a tiny size: 192x160 frames, 24 tracks, one LK level,
    2 lanes, 14-frame rounds, 6 frames of warm-up online, a fast
    trajectory; the cell's own limits."""
    name = CELLS[driver]
    spec = C.load_json(C.ROOT / "BENCHMARK.json")
    real = C.find_cell(name)
    cfg = json.loads(json.dumps(real.config))
    cfg["camera"].update(SIZE)
    cfg["overrides"].update(SMALL)
    cfg["world"].update(angular_speed_rad_s=[1.6, 1.8])
    cfg.update(sequences=2, sequence_frames=14)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    wl = dict(real.workload)
    if driver == "api":
        wl["warmup_frames"] = 6
    (tmp_path / f"{name}.json").write_text(json.dumps(wl))
    for c in spec["configs"]:
        if c["name"] == cfg["name"]:
            c["file"] = str(tmp_path / "cfg.json")
    return C.find_cell(name, spec, tmp_path)


def correct(cell, seconds=4.0):
    out = run_cell(cell, 2**31 + 21, seconds, False, "cpu")
    ok, _ = check.judge(out["numbers"], cell.workload["check"]["limits"])
    return ok and out["failed"] == 0, out


def unchanged(step, at=None):
    def broken(state, imu, frames):
        return state, step(state, imu, frames)[1]
    return broken


def half_the_lanes(step, at=None):
    """The second half of the lanes left out: their state is not stepped
    and their outputs are the first half's."""
    def broken(state, imu, frames):
        new, out = step(state, imu, frames)
        h = out.position.shape[0] // 2

        def keep_first(a, b):
            if not isinstance(a, torch.Tensor):
                return type(a)(*(keep_first(x, y) for x, y in zip(a, b))) \
                    if hasattr(a, "_fields") else tuple(keep_first(x, y) for x, y in zip(a, b))
            if a.dim() == 0 or a.shape[0] != 2 * h:
                return a
            return torch.cat([a[:h], b[h:]]) if a.stride(0) else a
        return keep_first(new, state), out._replace(
            **{f: torch.cat([getattr(out, f)[:h]] * 2)
               for f in ("position", "track_status", "track_prev_pixels", "track_pixels")})
    return broken


def altered(step, at=7):
    """The pose of the ``at``-th step moved by 50 m: the first step of the
    window (set-up makes one step offline and five online)."""
    calls = [0]

    def broken(state, imu, frames):
        state, out = step(state, imu, frames)
        calls[0] += 1
        if calls[0] == at:
            out = out._replace(position=out.position + torch.tensor([50.0, 0.0, 0.0],
                                                                    dtype=out.position.dtype))
        return state, out
    return broken


def break_lanes(monkeypatch, fault):
    made = program.batched_vio

    def patched(*a, **k):
        init, step, vio = made(*a, **k)
        broken = fault(step, at=2) if fault is altered else fault(step)
        broken.graphs = step.graphs
        return init, broken, vio
    monkeypatch.setattr(program, "batched_vio", patched)


def break_api(monkeypatch, fault):
    made = program.vio_api

    def patched(*a, **k):
        api = made(*a, **k)
        step, kwargs = api._step, {}
        broken = fault(lambda s, i, f: step(s, i, *f, **kwargs))

        def api_step(state, imu, *images, **kw):
            kwargs.clear()
            kwargs.update(kw)
            return broken(state, imu, images)
        api._step = api_step
        return api
    monkeypatch.setattr(program, "vio_api", patched)


@pytest.mark.parametrize("driver", ["lanes", "api"])
def test_sound_run_is_correct(tmp_path, driver):
    ok, out = correct(tiny_cell(tmp_path, driver))
    assert ok, (out["numbers"], out["details"])


@pytest.mark.parametrize("driver,fault", [("lanes", unchanged), ("lanes", half_the_lanes),
                                          ("lanes", altered), ("api", unchanged),
                                          ("api", altered)],
                         ids=lambda x: getattr(x, "__name__", x))
def test_broken_step_is_not_correct(tmp_path, monkeypatch, driver, fault):
    cell = tiny_cell(tmp_path, driver)
    (break_lanes if driver == "lanes" else break_api)(monkeypatch, fault)
    ok, out = correct(cell)
    assert not ok, (out["numbers"], out["details"])


def test_control_is_not_correct(tmp_path, monkeypatch):
    from hybvio_tpu_torch import runtime
    from hybvio_tpu_torch.odometry import vio

    monkeypatch.setattr(runtime, "configure_precision", runtime.configure_precision)
    monkeypatch.setattr(vio, "normalize_input", vio.normalize_input)
    control.lower_precision()
    ok, out = correct(tiny_cell(tmp_path, "lanes"))
    assert not ok, (out["numbers"], out["details"])


# frames a lane's round holds when the window closes, a little under the
# slowest run measured on the card (offline: 107 frames/s over 28 lanes in
# 30 s, 115 a lane; online: the 120 frames of set-up alone)
GEOMETRY_FRAMES = {"tumvi_fisheye.offline_b28": 110, "euroc_stereo.online_b1": 120}


@pytest.mark.parametrize("name", sorted(GEOMETRY_FRAMES))
def test_frozen_filter_at_the_cells_geometry_is_not_correct(name):
    """The filter's state left where it started (its position constant)
    while the tracker runs on: the pose number alone judges it, since the
    tracker's pyramid stays sound. One frozen lane of the cell's own
    worlds is enough to fail, on every seed tried."""
    cell = C.find_cell(name)
    cfg, limit = cell.config, cell.workload["check"]["limits"]["pose_err_m"]
    cam, n = cfg["camera"], GEOMETRY_FRAMES[name]
    lanes = cfg["sequences"] if cell.workload["driver"] == "lanes" else 1
    frame = torch.randint(0, 256, (1, 32, 32), dtype=torch.uint8)  # a sound pyramid
    for seed in (2**31 + 3, 3_900_000_001, 5):
        seqs = world.lane_worlds(seed, lanes, cfg["world"], cfg["sequence_frames"],
                                 cam["rate_hz"], cfg["imu_rate_hz"])
        idx = seqs[0].frame_sample_idx[1:n + 1]
        for frozen in range(lanes):
            # the other lanes sound: their positions the truth
            poses = [(b, idx, seqs[b].pos[idx] - seqs[b].pos[seqs[b].frame_sample_idx[0]]
                      if b != frozen else np.zeros((n, 3))) for b in range(lanes)]
            numbers, _ = check.numbers(seqs, poses, (frame, *reference.pyramid(frame, 2)))
            assert numbers["pose_err_m"] > 1.4 * limit, (seed, frozen, numbers)
            ok, _ = check.judge(numbers, cell.workload["check"]["limits"])
            assert not ok
