"""What the harness's process loads and how it ends without a card."""
import os
import subprocess
import sys

import pytest
import torch

from benchmark import cell as C
from benchmark.run import FORBIDDEN, forbidden_modules

MODULES = ["benchmark.run", "benchmark.control", "benchmark.drivers.lanes",
           "benchmark.drivers.api", "benchmark.program", "benchmark.check",
           "benchmark.trace", "benchmark.readers"]


def _python(code, cwd=C.ROOT):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_nothing_of_jax_is_loaded():
    """The harness and the port it drives, the parameters built and the
    batched step made on the CPU, load no module whose top-level name is
    JAX's or the JAX package's."""
    code = (f"import importlib, json, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "from benchmark import program\n"
            "from benchmark.cell import find_cell\n"
            "cell = find_cell('euroc_stereo.online_b1')\n"
            "program.build_params(cell.config)\n"
            "import hybvio_tpu_torch.api.vio, hybvio_tpu_torch.parallel.batched\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    res = _python(code)
    assert res.returncode == 0, res.stderr
    tops = set(eval(res.stdout.strip().splitlines()[-1]))
    assert "hybvio_tpu_torch" in tops
    assert not tops & set(FORBIDDEN)


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hybvio_tpu_torch_extra", sys)
    assert "hybvio_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "hybvio_tpu.odometry", sys)
    assert forbidden_modules() == ["hybvio_tpu"]


@pytest.mark.parametrize("name", [w["name"] for w in C.load_json(C.ROOT / "BENCHMARK.json")
                                  ["workloads"]])
def test_without_a_card_it_fails_and_prints_no_result(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the machine without one")
    res = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", name,
                          "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
                         cwd=C.ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr


def test_a_checkout_without_the_port_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files, a run ends with an error and no result."""
    import shutil

    shutil.copy(C.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(C.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "tumvi_fisheye.offline_b28", "--seed", "5", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert res.returncode != 0 and res.stdout.strip() == ""
