"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in ``BENCHMARK.json`` names
its configuration and traffic; its workload file (``workloads/<cell>.json``)
names the driver (``drivers/<driver>.py``) that generates the traffic and
steps the port, ``hybvio_tpu_torch``, on the card. With ``--trace 0`` the
line's metrics are the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics, each read from the run's record by ``metrics/<name>.py``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1``
also ``breakdown``) and, last, ``check``: each number compared with the
plain reference beside its limit, also the last lines of standard error.
Without a card, with fewer cards than the cell asks for, or with JAX or
the JAX package loaded in the process, it prints no result and exits 2.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from .cell import ROOT, find_cell, read_per_layer  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "hybvio_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``hybvio_tpu_torch`` is not ``hybvio_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def pin_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own kernel and native libraries build into ``build/`` there)."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def device_info(torch, chips: int, peak: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak)}


def plain(x):
    """``x`` with every float that is not finite as None, so that the line
    stays JSON."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return 2


def run_cell(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """The driver's run of ``cell`` (``drivers/<driver>.py``)."""
    driver = importlib.import_module(f"benchmark.drivers.{cell.workload['driver']}")
    return driver.run(cell, seed, seconds, trace, device)


def result_line(cell, out: dict, trace: bool, device: dict, t_start: float):
    """(correct, the line's object)."""
    from .check import judge

    correct, compared = judge(out["numbers"], cell.workload["check"]["limits"])
    correct = correct and out["failed"] == 0
    if trace:
        metrics = read_per_layer(cell, out["record"])
        tr = out["record"].get("trace") or {}
        device = dict(device, busy_s=tr.get("busy_s", 0.0), window_s=tr.get("window_s", 0.0))
    else:
        values = dict(out["e2e"], setup_s=out["setup_done"] - t_start)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if trace and out["record"].get("trace"):
        tr = out["record"]["trace"]
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["check"] = dict(compared, failed={"value": out["failed"], "limit": 0})
    return correct, line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_caches()
    cell = find_cell(args.workload)

    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the port on the card only")
    if torch.cuda.device_count() < chips:
        return fail(f"the cell asks for {chips} cards, {torch.cuda.device_count()} present")
    torch.cuda.set_device(0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        return fail(f"modules of JAX or the JAX package were loaded: {', '.join(found)}")
    correct, line = result_line(cell, out, bool(args.trace),
                                device_info(torch, chips, out["memory_peak_bytes"]), T_START)
    print(json.dumps(plain({"details": out["details"]})), file=sys.stderr)
    for name, c in line["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(plain(line), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
