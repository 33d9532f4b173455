"""The benchmark's ``vislam.online_b1`` cell in its own files: found by
name (``benchmark.cell.find_cell``) with its configuration, workload and
metrics; its configuration is the port's ``models.vislam`` at HybVIO's SLAM
defaults; each of its per-layer readers reads a number from a stand-in
record of the driver's shape and nothing from a record without it."""
import json

import pytest

from benchmark import cell as C
from benchmark import program
from benchmark.drivers import vislam

CELL = "vislam.online_b1"
NEW_METRICS = ("slam_frame_ms.online", "slam_ba_ms.online", "slam_queue_ms.online",
               "slam_dropped_pct.online")
SPEC = C.load_json(C.ROOT / "BENCHMARK.json")


def _record():
    """A record as the driver's traced run leaves it (``vislam.summarize``
    of a drain)."""
    drain = {"spans": [
        {"id": 1, "name": "slam.frame", "kind": "span", "start_ns": 0, "end_ns": 120_000_000,
         "parent": None, "thread": 2, "frame": 1.0},
        {"id": 2, "name": "slam.local_ba", "kind": "span", "start_ns": 50_000_000,
         "end_ns": 80_000_000, "parent": 1, "thread": 2, "frame": 1.0},
        {"id": 3, "name": "slam.local_ba_device", "kind": "interval", "start_ns": 55_000_000,
         "end_ns": 75_000_000, "parent": None, "thread": 2, "frame": None},
        {"id": 4, "name": "slam.queue", "kind": "interval", "start_ns": 0, "end_ns": 4_000_000,
         "parent": None, "thread": 2, "frame": 1.0},
        {"id": 5, "name": "slam.queue", "kind": "interval", "start_ns": 0, "end_ns": 2_000_000,
         "parent": None, "thread": 2, "frame": 2.0}],
        "counters": {"slam.candidates": 8, "slam.submitted": 6, "slam.dropped": 2},
        "dropped": 0}
    return {"path": "online", "api_call_ms": 121.5, "stages_ms": {"frontend": 21.0},
            "recorder": vislam.summarize(drain)}


def test_cell_found_by_name():
    cell = C.find_cell(CELL)
    assert cell.entry["chips"] == 1 and cell.workload["driver"] == "vislam"
    assert [m["name"] for m in cell.end_to_end] == ["frame_ms_p95", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == set(NEW_METRICS)
    assert set(cell.workload["check"]["limits"]) == {"pose_err_m", "pyramid_err"}
    assert 0 < cell.workload["ba_err_limit"] <= 1e-6


def test_configuration_is_the_ports_vislam_at_hybvio_defaults():
    cfg = C.find_cell(CELL).config
    assert (cfg["preset"], cfg["filter_dtype"], cfg["reduced"]) == ("vislam", "float32",
                                                                    ["sequence_frames"])
    cam = cfg["camera"]
    assert (cam["width"], cam["height"], cam["focal"], cam["baseline"]) == (752, 480, 458.0, None)
    assert list(cfg["overrides"]) == ["odometry.imuToCameraMatrix"]
    assert len(cfg["source"]) <= 200
    params, _, cams = program.build_params(cfg)
    assert params.slam.useSlam and len(cams) == 1 and not params.tracker.useStereo
    for key, value in cfg["slam"].items():
        assert getattr(params.slam, key) == value, key
    defaults = type(params.slam)()
    for key in cfg["slam"]:
        assert getattr(defaults, key) == getattr(params.slam, key), key


@pytest.mark.parametrize("metric", NEW_METRICS)
def test_metric_entry_lists_the_cell_alone(metric):
    entry = next(m for m in SPEC["per_layer"] if m["name"] == metric)
    assert entry["workloads"] == [CELL] and entry["moves"] == "frame_ms_p95"
    e2e = next(m for m in SPEC["end_to_end"] if m["name"] == "frame_ms_p95")
    assert e2e["workloads"][-1] == CELL


@pytest.mark.parametrize("metric, want", [
    ("slam_frame_ms.online", 120.0), ("slam_ba_ms.online", 20.0), ("slam_queue_ms.online", 3.0),
    ("slam_dropped_pct.online", 25.0)])
def test_reader_reads_a_stand_in_record(metric, want):
    read = C.reader(metric)
    assert read(_record()) == pytest.approx(want)
    assert read({}) is None
    assert read({"path": "online", "api_call_ms": 112.0}) is None  # no recorder


@pytest.mark.parametrize("metric, want", [("api_call_ms.online", 121.5),
                                          ("frontend_ms.online", 21.0)])
def test_accepted_online_reader_reads_the_cells_record(metric, want):
    """The record is the online path's: listing the cell under an accepted
    online metric is all a later PR needs for it to read there."""
    assert C.reader(metric)(_record()) == pytest.approx(want)


def test_per_layer_line_of_the_cell():
    got = C.read_per_layer(C.find_cell(CELL), _record())
    assert set(got) == set(NEW_METRICS)
    assert json.dumps(got)


def test_summary_keeps_the_stage_parents():
    rec = _record()["recorder"]
    assert rec["slam_stage_parents"] == ["slam.frame"]
    assert rec["n"]["slam.queue"] == 2 and rec["counters"]["slam.dropped"] == 2


def test_driver_finds_what_it_reads_in_the_program():
    vislam.require_program()
