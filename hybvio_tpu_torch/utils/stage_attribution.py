"""Per-stage timing for the `-timer` report (port of the reference
package's ``utils/stage_attribution.py``).

The reference scope-times each pipeline stage inside its single thread and
reports per-label per-frame ms at exit (reference: timer macro sites
ekf.cpp:355, tracker.cpp:56,249, ransac_pipeline.cpp:206-283; report
main.cpp:1008-1016). The port's step is one stream of many launches, so its
sub-stages are not scope-timed from the host mid-step. Instead,
`StageProbes` runs the tracker's own sub-stages (the same modules and
kernels the step runs, at the tracker's own parameters) on the current
frame's images and track positions when `-timer` is on, one sample per
label per frame, over the whole run (the reference's accumulate-every-frame
semantics). Each probe is timed on the card by CUDA events around its
launches (on the host clock for CPU tensors). Treat the labels as
attribution (what each stage costs in isolation), not an exact
decomposition of the step.
"""
from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from .. import random as jr
from ..frontend.lk import lk_track_pyramid
from ..frontend.ransac import ransac2, ransac3, ransac5
from ..frontend.tracker import _lanes
from ..runtime import full_precision


class StageProbes:
    """The front end's sub-stages for per-frame `-timer` attribution, on a
    ``tracker`` (``frontend.tracker.Tracker``) at B = 1.

    `run_frame` times one execution of each probe on the CURRENT frame's
    data and returns {label: seconds}. Labels mirror the reference's
    `-timer` table: image pyramids, optical flow (temporal pyramidal LK),
    stereo matching, keypoint detection, and the RANSAC variant of the
    camera setup (RANSAC3 in stereo, RANSAC5 in mono)."""

    def __init__(self, tracker, use_stereo: bool):
        self.tracker = tracker
        self.use_stereo = use_stereo
        self.T = tracker.T
        self.key = None  # (1, 2) threefry key, made on the first frame's device
        cam0 = tracker.cam0
        # (label, fn(image, second, pyramids, pts, valid, key)) in reference table order
        self._probes: Dict[str, Callable] = {}
        self._probes["image pyramids"] = lambda im, sim, pyr, pp, v, k: tracker.pyramids(im, sim)
        self._probes["optical flow (LK)"] = lambda im, sim, pyr, pp, v, k: lk_track_pyramid(
            _lanes(pyr[0], 1), [tuple(_lanes(g, 1)) for g in pyr[2]], _lanes(pyr[0], 1), pp,
            initial_pts=pp, params=tracker.lk)
        if use_stereo:
            self._probes["stereo matching (LK)"] = lambda im, sim, pyr, pp, v, k: (
                tracker.stereo_match(pyr[0], pyr[2], pyr[1], pp, v, guesses=pp))
        self._probes["keypoint detection"] = lambda im, sim, pyr, pp, v, k: tracker.detect(
            im, pp, v, torch.zeros((1,), device=pp.device), self.T)
        self._probes["ransac2 (rotation)"] = lambda im, sim, pyr, pp, v, k: ransac2(
            cam0, cam0, pp, pp + 1.0, v, k, tracker.ransac2_threshold, int_bits=tracker.int_bits)
        center = (cam0.cx, cam0.cy)
        foc = (cam0.fx, cam0.fy)

        def norm(pp):
            return torch.stack([(pp[..., 0] - center[0]) / foc[0],
                                (pp[..., 1] - center[1]) / foc[1]], dim=-1)

        if use_stereo:
            def r3_one(im, sim, pyr, pp, v, k):
                n = norm(pp)
                p3 = torch.cat([n, torch.ones_like(n[..., :1])], dim=-1) * 3.0
                return ransac3(p3, p3 * 1.01, n, v, k, int_bits=tracker.int_bits)

            self._probes["ransac3 (2D-3D)"] = r3_one
        else:
            self._probes["ransac5 (essential)"] = lambda im, sim, pyr, pp, v, k: ransac5(
                norm(pp), norm(pp) * 1.01, v, k, tracker.ransac5_threshold,
                int_bits=tracker.int_bits)

    def run_frame(self, image, second, pts, valid) -> Dict[str, float]:
        """Time one execution of each probe on this frame's data.

        image / second: (1, H, W) float32 frames in [0, 1] (second None in
        mono); pts: (1, T, 2) current track pixels (the step's actual
        positions, so the LK / RANSAC probe cost is content-true); valid:
        (1, T) bool."""
        dev = image.device
        if self.key is None:
            self.key = jr.prng_key(torch.zeros((1,), dtype=torch.int64)).to(dev)
        with full_precision():
            pyr = self.tracker.pyramids(image, second)
            out: Dict[str, float] = {}
            if dev.type == "cuda":
                events = {}
                for label, fn in self._probes.items():
                    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    a.record()
                    fn(image, second, pyr, pts, valid, self.key)
                    b.record()
                    events[label] = (a, b)
                for label, (a, b) in events.items():
                    b.synchronize()
                    out[label] = 1e-3 * a.elapsed_time(b)
            else:
                for label, fn in self._probes.items():
                    t0 = time.perf_counter()
                    fn(image, second, pyr, pts, valid, self.key)
                    out[label] = time.perf_counter() - t0
        return out

