"""Debug publisher hooks (a copy of the reference package's
``odometry/debug.py``; reference: src/odometry/debug.hpp): an optional
observer interface the pipeline feeds with per-frame internals for 3D debug
viewers / dashboards. Host-side only: ``VioApi`` calls it from the packed
output each frame already copies back (no device round trip, no host sync
in the step); ``start_frame`` gets the session's state as it stands on the
device."""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np


class DebugPublisher:
    """Subclass and override the callbacks of interest
    (reference: DebugPublisher, debug.hpp:25-47)."""

    def start_frame(self, t: float, state: Any) -> None:
        pass

    def add_sample(self, t: float, gyro, acc) -> None:
        pass

    def start_visual_update(self, t: float, track_id: int, image_features) -> None:
        pass

    def push_triangulation_point(self, point) -> None:
        pass

    def finish_successful_visual_update(self, t: float, track_id: int) -> None:
        pass

    def add_point_cloud(self, points) -> None:
        pass


class RecordingPublisher(DebugPublisher):
    """Collects everything into lists (testing / offline inspection)."""

    def __init__(self):
        self.frames: List[float] = []
        self.samples: List[tuple] = []
        self.triangulations: List[np.ndarray] = []
        self.point_clouds: List[np.ndarray] = []
        self.visual_updates: List[tuple] = []  # (t, track_id)
        self.successful_updates: List[tuple] = []  # (t, track_id)

    def start_frame(self, t, state):
        self.frames.append(float(t))

    def add_sample(self, t, gyro, acc):
        self.samples.append((float(t), np.asarray(gyro), np.asarray(acc)))

    def start_visual_update(self, t, track_id, image_features):
        self.visual_updates.append((float(t), int(track_id)))

    def finish_successful_visual_update(self, t, track_id):
        self.successful_updates.append((float(t), int(track_id)))

    def push_triangulation_point(self, point):
        self.triangulations.append(np.asarray(point))

    def add_point_cloud(self, points):
        self.point_clouds.append(np.asarray(points))


class DebugAPI:
    """Aggregates publisher + SLAM debug + end callback
    (reference: DebugAPI, debug.hpp:49-67)."""

    def __init__(self, publisher: Optional[DebugPublisher] = None,
                 end_callback: Optional[Callable] = None):
        self.publisher = publisher
        self.end_debug_callback = end_callback
