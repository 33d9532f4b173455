"""Latency-smoothing output buffer + FPS/latency statistics (a copy of the
reference package's ``api/output_buffer.py``; reference:
src/api/output_buffer.hpp)."""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Optional


class OutputBuffer:
    """Delays outputs by targetOutputDelaySeconds (frame-timestamp keyed) to
    even out uneven processing; tracks FPS / latency / skip statistics."""

    def __init__(self, target_output_delay_seconds: float = 0.0):
        self.delay = target_output_delay_seconds
        self.buf: Deque = deque()
        self._emit_times: Deque[float] = deque(maxlen=100)
        self._latencies: Deque[float] = deque(maxlen=100)
        self._skips = 0
        self._wall_anchor: Optional[float] = None
        self._t_anchor: Optional[float] = None

    def add_processed_frame(self, output) -> None:
        self.buf.append(output)

    def poll_output(self):
        """Return the next output whose scheduled emit time has passed."""
        if not self.buf:
            return None
        out = self.buf[0]
        now = time.monotonic()
        if self._wall_anchor is None:
            self._wall_anchor = now
            self._t_anchor = out.t
        emit_at = self._wall_anchor + (out.t - self._t_anchor) + self.delay
        if self.delay > 0 and now < emit_at:
            return None
        self.buf.popleft()
        # drop backlog beyond 3 outputs (skip accounting)
        while len(self.buf) > 3:
            self.buf.popleft()
            self._skips += 1
        self._emit_times.append(now)
        self._latencies.append(now - emit_at + self.delay)
        return out

    @property
    def fps(self) -> float:
        if len(self._emit_times) < 2:
            return 0.0
        dt = self._emit_times[-1] - self._emit_times[0]
        return (len(self._emit_times) - 1) / dt if dt > 0 else 0.0

    @property
    def mean_latency(self) -> float:
        return sum(self._latencies) / len(self._latencies) if self._latencies else 0.0

    @property
    def skips_total(self) -> int:
        return self._skips
