"""Each cell for a few seconds on the card, as the driver runs it (a new
process a run); skips without a card. Run on the card:

    python -m pytest --noconftest benchmark/tests/test_bench_card.py -m cuda -q
"""
import json
import subprocess
import sys

import pytest
import torch

from benchmark import cell as C

CELLS = [w["name"] for w in C.load_json(C.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(card, name, trace):
    res = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", name,
                          "--seed", str(2**31 + 101), "--seconds", "3", "--trace", str(trace)],
                         cwd=C.ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "check"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert line["attempted"] > 0 and line["failed"] == 0
    cell = C.find_cell(name)
    want = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) == {m["name"] for m in want}
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"]
