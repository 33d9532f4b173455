"""Timing / profiling: per-label, per-frame wall-clock statistics (port of
the reference package's ``utils/timer.py``).

Port of the reference RAII scope timers (reference: src/util/timer.{hpp,cpp}):
`TimeStats` accumulates named scopes, delimited into frames by start_frame(),
and reports per-frame averages per label at exit (the reference's `-timer`
flag output). Times are host wall-clock; a scope given a ``probe`` tensor
waits at its exit until the card has finished the work queued before it, so
device work inside the scope is attributed to it.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


def wait_for(probe) -> None:
    """Block until the work queued so far on ``probe``'s device is done (a
    CUDA event on the current stream); nothing for a CPU tensor, whose work
    is done when it exists."""
    import torch

    if isinstance(probe, torch.Tensor) and probe.is_cuda:
        with torch.cuda.device(probe.device):
            event = torch.cuda.Event()
            event.record()
            event.synchronize()


class TimeStats:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.frames = 0

    def start_frame(self) -> None:
        if self.enabled:
            self.frames += 1

    @contextmanager
    def scope(self, name: str, probe=None):
        """Time a named scope (reference: `timer(stats, name)` macro).

        probe: optional tensor; at scope exit the host waits until the work
        queued on its device's current stream is done (a CUDA event), so
        device work inside the scope is attributed correctly.
        """
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if probe is not None:
                wait_for(probe)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def add_sample(self, name: str, seconds: float) -> None:
        """Accumulate one externally timed sample into a label (used by the
        per-frame StageProbes attribution: one sample per label per frame,
        so per_frame_timings reports the mean over the actual run)."""
        self.totals[name] += seconds
        self.counts[name] += 1

    def add_attribution(self, name: str, ms_per_frame: float) -> None:
        """Record an externally measured per-frame stage time.

        The step's sub-stages are not scope-timed from the host mid-frame
        (the reference scope-times inside its single thread,
        ransac_pipeline.cpp:206-283); stage attribution instead times
        dedicated sub-programs on the session's own data
        (utils/stage_attribution.py) and folds the result in here so the
        `-timer` report carries the reference's per-label table."""
        self._attrib = getattr(self, "_attrib", {})
        self._attrib[name] = ms_per_frame

    def per_frame_timings(self) -> Dict[str, float]:
        """Mean milliseconds per frame per label (reference:
        TimeStats::perFrameTimings)."""
        n = max(self.frames, 1)
        out = {k: 1000.0 * v / n for k, v in sorted(self.totals.items())}
        out.update(getattr(self, "_attrib", {}))
        return out

    def report(self) -> str:
        lines = [f"--- per-frame timings over {self.frames} frames ---"]
        attrib = getattr(self, "_attrib", {})
        for k, ms in self.per_frame_timings().items():
            tag = "  [attributed]" if k in attrib else f"  (x{self.counts[k]})"
            lines.append(f"{ms:10.3f} ms  {k}{tag}")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self._attrib = {}
        self.frames = 0



# the SLAM worker's per-keyframe stage timers (reference: the slam::TIME_STATS
# singleton, util/timer.cpp:8-11); off until the CLI's -timer turns them on.
# One frame per keyframe; the stages Slam.add_frame times, in its order:
SLAM_STAGES = ("orb descriptors", "multi-scale keypoints", "bow vocabulary", "map points",
               "loop closure", "local BA", "culling")
SLAM_TIME_STATS = TimeStats(enabled=False)
