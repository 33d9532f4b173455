"""The end-to-end metrics' arithmetic: a rate over all the work and all
the time of the window, and a tail over all of its frames."""
from __future__ import annotations

import numpy as np


def rate(done: int, wall_s: float) -> float:
    """Frames completed per second of the window."""
    return done / wall_s


def tail_ms(latencies_ms, q: float = 95.0) -> float:
    """The q-th percentile of every frame's latency; inf without one."""
    return float(np.percentile(latencies_ms, q)) if len(latencies_ms) else float("inf")
