"""Timing / profiling: per-label, per-frame wall-clock statistics (port of
the reference package's ``utils/timer.py``), and the span recorder.

Port of the reference RAII scope timers (reference: src/util/timer.{hpp,cpp}):
`TimeStats` accumulates named scopes, delimited into frames by start_frame(),
and reports per-frame averages per label at exit (the reference's `-timer`
flag output). Times are host wall-clock; a scope given a ``probe`` tensor
waits at its exit until the card has finished the work queued before it, so
device work inside the scope is attributed to it.

The span recorder traces the path as it normally runs, without waiting on
the card. It is off until ``enable()``; while off, each site checks one
flag and enters one shared null context. While on, it keeps in memory, up
to its bound (``dropped`` counts the rest):

- ``span(name, frame=None)``: host work, a context manager. Its record has
  the span it opened inside (``parent``, in the same thread), the thread
  and a frame id, the parent's where none is given;
- ``interval(name, start_ns, end_ns, frame)``: a wait that does not hold
  the host (a frame held by the synchronizer, a step in flight);
- ``count(name, n=1)``: a counter.

``drain()`` returns {"spans", "counters", "dropped"} and clears them.
``slam_stage`` opens a SLAM stage's ``SLAM_TIME_STATS`` scope and its span
at once; ``device_timer`` adds a block's device time as an interval.
Times are ``time.time_ns()``, the clock of ``torch.profiler``'s (kineto's)
events; while a profiler runs, each span also opens a
``torch.profiler.record_function`` of its name, so that it lies on the
profiler's timeline beside the device's work.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import Counter, defaultdict
from contextlib import contextmanager
from typing import Dict

import torch


def wait_for(probe) -> None:
    """Block until the work queued so far on ``probe``'s device is done (a
    CUDA event on the current stream); nothing for a CPU tensor, whose work
    is done when it exists."""
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

    def per_frame_timings(self) -> Dict[str, float]:
        """Mean milliseconds per frame per label (reference:
        TimeStats::perFrameTimings)."""
        n = max(self.frames, 1)
        return {k: 1000.0 * v / n for k, v in sorted(self.totals.items())}

    def report(self) -> str:
        lines = [f"--- per-frame timings over {self.frames} frames ---"]
        for k, ms in self.per_frame_timings().items():
            lines.append(f"{ms:10.3f} ms  {k}  (x{self.counts[k]})")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.frames = 0



# the SLAM worker's per-keyframe stage timers (reference: the slam::TIME_STATS
# singleton, util/timer.cpp:8-11); off until the CLI's -timer turns them on.
# One frame per keyframe; the stages Slam.add_frame times, in its order:
SLAM_STAGES = ("orb descriptors", "multi-scale keypoints", "bow vocabulary", "map points",
               "loop closure", "local BA", "culling")
SLAM_TIME_STATS = TimeStats(enabled=False)
# the span recorder's name of each stage (children of the worker's slam.frame)
SLAM_SPANS = dict(zip(SLAM_STAGES, ("slam.orb", "slam.keypoints", "slam.bow", "slam.map_points",
                                    "slam.loop", "slam.local_ba", "slam.cull")))


@contextmanager
def slam_stage(label: str):
    """A stage of the SLAM worker's keyframe: its scope in
    ``SLAM_TIME_STATS`` (the ``-timer`` table) and its span in the
    recorder (``SLAM_SPANS``), each off until turned on."""
    with SLAM_TIME_STATS.scope(label), RECORDER.span(SLAM_SPANS[label]):
        yield


# --- the span recorder (the module docstring) ---

_NULL = contextlib.nullcontext()  # every site's context while the recorder is off


class _Span:
    """An open span of a Recorder (``Recorder.span``'s context manager):
    ``start_ns`` once entered, ``end_ns`` once left."""

    __slots__ = ("rec", "name", "frame", "id", "parent", "start_ns", "end_ns", "_fn")

    def __init__(self, rec: "Recorder", name: str, frame):
        self.rec, self.name, self.frame = rec, name, frame
        self.end_ns = None
        self._fn = None

    def __enter__(self):
        stack = self.rec._stack()
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        if self.frame is None and parent is not None:
            self.frame = parent.frame
        self.id = next(self.rec._ids)
        self.start_ns = time.time_ns()
        if torch.autograd._profiler_enabled():
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        self.rec._stack().pop()
        if self._fn is not None:
            self._fn.__exit__(*exc)
        self.rec._add({"id": self.id, "name": self.name, "kind": "span",
                       "start_ns": self.start_ns, "end_ns": self.end_ns, "parent": self.parent,
                       "thread": threading.get_ident(), "frame": self.frame})
        return False


class Recorder:
    """Spans, intervals and counters in memory, thread-safe; at most
    ``limit`` records between two drains (``dropped`` counts those past
    it). Off until ``enable``."""

    def __init__(self, limit: int = 200_000):
        self.on = False
        self.limit = limit
        self._lock = threading.Lock()
        self._local = threading.local()  # .stack: this thread's open spans
        self._ids = itertools.count()
        self._records = []
        self._counters = Counter()
        self._dropped = 0

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        """Stop recording; what was recorded stays until ``drain``."""
        self.on = False

    def span(self, name: str, frame=None):
        """A context manager over host work (the module docstring); the
        shared null context while off."""
        if not self.on:
            return _NULL
        return _Span(self, name, frame)

    def interval(self, name: str, start_ns: int, end_ns: int, frame=None) -> None:
        """A wait that does not hold the host, from ``start_ns`` to
        ``end_ns`` (``now_ns`` times)."""
        if self.on:
            self._add({"id": next(self._ids), "name": name, "kind": "interval",
                       "start_ns": int(start_ns), "end_ns": int(end_ns), "parent": None,
                       "thread": threading.get_ident(), "frame": frame})

    def count(self, name: str, n: int = 1) -> None:
        if self.on:
            with self._lock:
                self._counters[name] += n

    def drain(self) -> dict:
        """{"spans": the records in the order they ended, "counters",
        "dropped"}; clears them."""
        with self._lock:
            out = {"spans": self._records, "counters": dict(self._counters),
                   "dropped": self._dropped}
            self._records, self._counters, self._dropped = [], Counter(), 0
        return out

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, record: dict) -> None:
        with self._lock:
            if len(self._records) < self.limit:
                self._records.append(record)
            else:
                self._dropped += 1


def self_ns(spans) -> Dict[int, int]:
    """Each span's own time (id -> ns): its duration less its children's."""
    out = {r["id"]: r["end_ns"] - r["start_ns"] for r in spans if r["kind"] == "span"}
    for r in spans:
        if r["kind"] == "span" and r["parent"] in out:
            out[r["parent"]] -= r["end_ns"] - r["start_ns"]
    return out


class DeviceTimer:
    """The device time of the work queued on the current stream between
    this timer's making and ``stop()``: CUDA events on the card; on the
    CPU, where that work is done when ``stop()`` is reached, the host
    clock. ``emit(name)`` adds it to the recorder as an interval that ends
    at the host clock, once the host has waited for that work (a copy of
    its result to the host does)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.start_ns = time.perf_counter_ns()

    def stop(self) -> None:
        if self.cuda:
            self.end.record()
        else:
            self.elapsed_ns = time.perf_counter_ns() - self.start_ns

    def emit(self, name: str, frame=None) -> None:
        if self.cuda:
            self.end.synchronize()  # done already: the caller waited for the work
            self.elapsed_ns = int(self.start.elapsed_time(self.end) * 1e6)
        end = now_ns()
        RECORDER.interval(name, end - self.elapsed_ns, end, frame)


def device_timer(device):
    """A ``DeviceTimer`` started now on ``device``'s current stream while
    the recorder is on; None while it is off."""
    return DeviceTimer(device) if RECORDER.on else None


now_ns = time.time_ns  # the recorder's clock
RECORDER = Recorder()  # the process's recorder, which the port's sites write to
enable, disable, drain = RECORDER.enable, RECORDER.disable, RECORDER.drain
span, interval, count = RECORDER.span, RECORDER.interval, RECORDER.count


def recording() -> bool:
    return RECORDER.on
