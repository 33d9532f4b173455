"""The readings that the limits of ``check.py`` are set from, at a cell's
own size on the card: the numbers that sound runs of the program give on
many seeds, and the numbers its control gives. The benchmark's own runs
never run this.

The control is the program one precision below what the configuration
states: the filter's float32 products with TF32 on (the port keeps TF32
off: ``runtime.configure_precision``), and the frames as the front end
takes them, float32, rounded to bfloat16 (``odometry.vio.normalize_input``).

    python3 -m benchmark.control --workload <cell> --seconds <s> \\
        --program-seeds <n> ... --control-seeds <n> ...

prints one JSON line a run: {"side", "seed", "numbers", "details",
"failed", "attempted"}.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from .cell import find_cell
from .run import pin_caches, run_cell


def lower_precision() -> None:
    """Switch the program to the control's precision, for every step and
    capture after this call."""
    from hybvio_tpu_torch import runtime
    from hybvio_tpu_torch.odometry import vio

    def tf32_policy():
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        if torch.version.cuda is not None:
            torch.backends.cuda.preferred_linalg_library("cusolver")

    normalize = vio.normalize_input

    def bf16_frames(img):
        x = normalize(img)
        return None if x is None else x.to(torch.bfloat16).to(x.dtype)

    runtime.configure_precision = tf32_policy
    vio.normalize_input = bf16_frames


def readings(cell, seeds, seconds: float, side: str, device) -> list:
    out = []
    for seed in seeds:
        res = run_cell(cell, seed, seconds, False, device)
        line = {"side": side, "seed": seed, "numbers": res["numbers"],
                "details": res["details"], "failed": res["failed"],
                "attempted": res["attempted"], "e2e": res["e2e"]}
        print(json.dumps(line), flush=True)
        out.append(line)
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    pin_caches()
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
        return 2
    cell = find_cell(args.workload)
    device = torch.device("cuda", 0)
    readings(cell, args.program_seeds, args.seconds, "program", device)
    if args.control_seeds:
        lower_precision()
        readings(cell, args.control_seeds, args.seconds, "control", device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
