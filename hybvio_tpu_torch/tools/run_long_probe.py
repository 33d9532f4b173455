"""Run the long textured accuracy protocol (``eval/long_probe.py``) for
several families in one process, one JSON line each:

    python -m hybvio_tpu_torch.tools.run_long_probe [family ...] [--duration 60]
        [--seed 8] [--frame-rate 10] [--width W] [--override group.name=value ...]
        [--device cpu]

Families default to mono stereo fisheye vislam. Runs on the card unless
``--device cpu`` or HYBVIO_PLATFORM=cpu; ``--width`` runs a reduced shape.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from ..eval import long_probe
from ..cli.main import _platform_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("families", nargs="*", default=["mono", "stereo", "fisheye", "vislam"])
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--frame-rate", type=float, default=10.0)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--override", action="append", default=[],
                    help="group.name=value parameter override")
    ap.add_argument("--device", default=None, help="the card unless given (e.g. cpu)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.override:
        k, _, v = kv.partition("=")
        overrides[k] = v
    device = _platform_device(args.device)
    where = {} if device is None else {"device": device}

    for family in args.families:
        t0 = time.perf_counter()
        r = long_probe.run_long_probe(family, duration=args.duration, seed=args.seed,
                                      frame_rate=args.frame_rate, width=args.width,
                                      overrides=overrides or None, **where)
        r["family"] = family
        r["total_wall_s"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(r))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
