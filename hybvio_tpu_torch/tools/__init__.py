"""The port's tools, one module per tool of the JAX package's ``tools/``
directory, each run as ``python -m hybvio_tpu_torch.tools.<name>``:

* ``worlds``: ``build_config``, the benchmark worlds (preset, cameras,
  host renderer) of ``bench.py``'s config families;
* ``make_synthetic_dataset``: a synthetic dataset in the JSONL layout
  (textured or blob world, a zooming lens) or the EuRoC mav0 layout;
* ``run_benchmark``: the CLI over several sequences, ATE and frames/s each;
* ``run_long_probe``: the long textured protocol, several families a run;
* ``profile_step``: the batched step's time at B = 16 by stage;
* ``slam_cost_curve``: the SLAM session's cost a keyframe as its map grows;
* ``scaling_bench``: the BA's cost over map points and keyframes, and the
  sharded BA against the unsharded one.

Each runs on the card unless asked for the CPU (``--device cpu``,
``device="cpu"`` or ``HYBVIO_PLATFORM=cpu``, the CLI's rule).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` if given, else HYBVIO_PLATFORM, else the card (raising
    without one): the CLI's rule."""
    from ..cli.main import _platform_device
    from ..runtime import default_device

    chosen = _platform_device(device)
    return torch.device(chosen) if chosen is not None else default_device()


def split_device(argv) -> tuple:
    """(the value of ``--device X`` or ``--device=X`` in ``argv`` or None,
    the other arguments)."""
    device, rest, args = None, [], iter(argv)
    for a in args:
        if a == "--device":
            device = next(args)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return device, rest
