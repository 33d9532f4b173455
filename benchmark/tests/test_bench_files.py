"""Every cell, configuration and metric of BENCHMARK.json is found by name
in its own files, the file keeps the contract's shape, and a new cell,
configuration or metric is new files plus new entries."""
import json
import re

import pytest

from benchmark import cell as C

SPEC = C.load_json(C.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][:3] == ["python3", "-m",
                                                                     "benchmark.run"]
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((C.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and entry["file"].startswith("benchmark/")
    cfg = C.load_json(C.ROOT / entry["file"])
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    assert all(k in cfg for k in entry["reduced"])
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda e: e["name"])
def test_cell_found_by_name(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    cell = C.find_cell(entry["name"])
    assert cell.workload["name"] == entry["name"]
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert set(cell.workload["check"]["limits"]) == {"pose_err_m", "pyramid_err"}


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        moved = next(m for m in SPEC["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", metric["workloads"]))
        read = C.reader(metric["name"])
        assert read({}) is None  # nothing to read: no number, not 0


def test_new_cell_config_and_metric_are_new_files(tmp_path):
    """A throwaway configuration, cell and metric, each a file in a
    temporary directory plus an entry, load without an edit elsewhere."""
    cfg = dict(C.load_json(C.ROOT / "benchmark/configs/euroc_stereo.json"), name="tmp_config")
    (tmp_path / "tmp_config.json").write_text(json.dumps(cfg))
    wl = dict(C.load_json(C.HERE / "workloads/tumvi_fisheye.offline_b28.json"),
              name="tmp_config.tmp_traffic", config="tmp_config", traffic="tmp_traffic")
    (tmp_path / "tmp_config.tmp_traffic.json").write_text(json.dumps(wl))
    (tmp_path / "tmp_metric.offline.py").write_text(
        "def read(record):\n    return record.get('steps')\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "tmp_config", "source": "x", "reduced": [], "why": "x",
                            "file": str(tmp_path / "tmp_config.json")})
    spec["workloads"].append({"name": "tmp_config.tmp_traffic", "config": "tmp_config",
                              "traffic": "tmp_traffic", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "tmp_metric.offline", "unit": "1", "better": "higher",
                              "source": "program_counter", "layer": "x",
                              "moves": "frames_per_s",
                              "workloads": ["tmp_config.tmp_traffic"]})
    spec["end_to_end"][0]["workloads"].append("tmp_config.tmp_traffic")
    cell = C.find_cell("tmp_config.tmp_traffic", spec, tmp_path)
    assert cell.config["name"] == "tmp_config" and cell.config["sequences"] == 11
    assert cell.workload["driver"] == "lanes"
    assert [m["name"] for m in cell.end_to_end] == ["frames_per_s", "setup_s"]
    got = {m["name"]: C.reader(m["name"], tmp_path if m["name"].startswith("tmp")
                               else None)({"steps": 7}) for m in cell.per_layer}
    assert got["tmp_metric.offline"] == 7
    assert all(v is None for k, v in got.items() if k != "tmp_metric.offline")
