"""Multi-sequence benchmark runner: each sequence through the port's CLI
(``hybvio_tpu_torch.cli.main``) with the same parameter flags, its ATE
against the ground truth and its frames/s, then one summary JSON line.

    python -m hybvio_tpu_torch.tools.run_benchmark seq_dir1 seq_dir2 ... [-params...]
    python -m hybvio_tpu_torch.tools.run_benchmark --glob '/data/euroc/*' [--maxFrames=N]

A sequence directory holds data.jsonl (the ground truth in its echo lines)
or a EuRoC mav0 tree (the ground-truth CSV). Each sequence runs on the card
unless ``--device=cpu`` or HYBVIO_PLATFORM=cpu says otherwise; each builds
its own ``VioApi``, whose step graphs are captured again into the memory
the previous sequence's gave back (the JAX package's tool reuses its
compiled programs through the JAX cache instead).
"""
from __future__ import annotations

import gc
import glob as globmod
import json
import os
import sys
import tempfile
import time

import numpy as np

from ..cli.main import run as cli_run
from ..eval.ate import ate_rmse
from ..io.jsonl import get_pose_histories


def gt_from_dataset(dataset: str):
    """(N, 4) rows of t, x, y, z from the EuRoC ground-truth CSV or the
    data.jsonl echo lines; None where the dataset has neither."""
    gt_csv = os.path.join(dataset, "state_groundtruth_estimate0", "data.csv")
    if not os.path.exists(gt_csv):
        gt_csv = os.path.join(dataset, "mav0", "state_groundtruth_estimate0", "data.csv")
    if os.path.exists(gt_csv):
        rows = []
        with open(gt_csv) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                v = line.strip().split(",")
                rows.append([int(v[0]) * 1e-9] + [float(x) for x in v[1:4]])
        return np.asarray(rows)
    data_jsonl = os.path.join(dataset, "data.jsonl")
    if os.path.exists(data_jsonl):
        gt = get_pose_histories(data_jsonl).get("groundTruth")
        if gt is not None and len(gt):
            return gt[:, :4]  # t, x, y, z
    return None


def run_sequence(dataset: str, extra_args, max_frames: int = 0, device=None) -> dict:
    """One sequence through the CLI: {"dataset", "frames", "fps",
    "ate_rmse_m"} (or {"dataset", "error"} when the CLI fails)."""
    out_path = os.path.join(tempfile.mkdtemp(), "out.jsonl")
    args = [f"-i={dataset}", f"-o={out_path}"] + list(extra_args)
    if max_frames:
        args.append(f"-maxFrames={max_frames}")
    t0 = time.time()
    rc = cli_run(args, device=device)
    elapsed = time.time() - t0
    # free the run's VioApi and its step graphs before the next sequence
    # captures: a reference cycle through the run's frames would keep them,
    # and their graph-pool memory, until a later collection
    gc.collect()
    if rc != 0:
        return {"dataset": dataset, "error": f"cli exit {rc}"}
    est = []
    with open(out_path) as f:
        for line in f:
            d = json.loads(line)
            est.append([d["time"], d["position"]["x"], d["position"]["y"],
                        d["position"]["z"]])
    est = np.asarray(est)
    result = {"dataset": os.path.basename(dataset.rstrip("/")),
              "frames": len(est),
              "fps": round(len(est) / max(elapsed, 1e-9), 2)}
    gt = gt_from_dataset(dataset)
    if gt is not None and len(est) > 5:
        gt_at = np.stack([np.interp(est[:, 0], gt[:, 0], gt[:, 1 + i]) for i in range(3)],
                         axis=1)
        gt_at -= gt_at[0]
        if np.isfinite(est[:, 1:4]).all():
            result["ate_rmse_m"] = round(float(ate_rmse(est[:, 1:4], gt_at)), 4)
        else:
            result["ate_rmse_m"] = None
    return result


def main(argv=None, device=None) -> int:
    """Run every sequence and print the summary line; ``device`` (or
    ``--device=``) as the CLI's."""
    argv = list(sys.argv[1:] if argv is None else argv)
    datasets, extra, max_frames = [], [], 0
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--glob":
            i += 1
            datasets.extend(sorted(d for d in globmod.glob(argv[i]) if os.path.isdir(d)))
        elif a.startswith("--maxFrames="):
            max_frames = int(a.split("=", 1)[1])
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("-"):
            extra.append(a)
        else:
            datasets.append(a)
        i += 1
    if not datasets:
        print(__doc__)
        return 2
    results = [run_sequence(d, extra, max_frames, device=device) for d in datasets]
    ates = [r["ate_rmse_m"] for r in results if r.get("ate_rmse_m") is not None]
    summary = {
        "sequences": results,
        "ate_rmse_m_median": round(float(np.median(ates)), 4) if ates else None,
        "ate_rmse_m_mean": round(float(np.mean(ates)), 4) if ates else None,
        "completed": sum(1 for r in results if "error" not in r),
        "total": len(results),
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
