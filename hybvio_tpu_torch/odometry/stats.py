"""Per-track visual-update outcome statistics (a copy of the reference
package's ``odometry/stats.py``; reference:
src/odometry/visual_update_stats.hpp)."""
from __future__ import annotations

from collections import Counter
from typing import Optional

OUTCOMES = (
    "used", "blacklisted", "not_enough_frames", "bad_triangulation",
    "outlier_rmse", "outlier_chi2", "behind", "point_cloud_only", "skipped",
)


class VisualUpdateStats:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.frame = Counter()
        self.total = Counter()
        self.frames = 0

    def count(self, outcome: str, n: int = 1) -> None:
        if not self.enabled:
            return
        assert outcome in OUTCOMES, outcome
        self.frame[outcome] += n

    def count_from_output(self, point_cloud_status, attempted=None) -> None:
        """Accumulate from a FrameOutput's point-cloud statuses
        (PF_POSE_TRAIL=1 used, PF_HYBRID=2 used, PF_OUTLIER=4 outlier)."""
        if not self.enabled:
            return
        import numpy as np

        st = np.asarray(point_cloud_status)
        self.frame["used"] += int(((st == 1) | (st == 2)).sum())
        self.frame["outlier_chi2"] += int((st == 4).sum())

    def finish_frame(self) -> Optional[str]:
        if not self.enabled:
            return None
        self.frames += 1
        line = " ".join(f"{k}={v}" for k, v in sorted(self.frame.items()))
        self.total.update(self.frame)
        self.frame.clear()
        return line

    def report(self) -> str:
        lines = [f"--- visual update stats over {self.frames} frames ---"]
        for k in OUTCOMES:
            if self.total[k]:
                lines.append(f"{k:>20}: {self.total[k]}")
        return "\n".join(lines)
