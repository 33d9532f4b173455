"""What the profiler's trace of a traced window says: the device's busy
time, the operations that took most of it, the idle gaps labelled by the
benchmark's span that was open on the host, and each of the port's five
kernels' device time on the path.

The traced window is a block under ``torch.profiler`` (CPU and CUDA
activity) inside a ``record_function(WINDOW)``; the benchmark's host
spans are ``record_function``s named in ``SPANS``.
"""
from __future__ import annotations

import collections

WINDOW = "bench.window"
SPANS = ("bench.step", "bench.pace", "bench.init", "bench.imu", "bench.frame", "bench.sync")
DEVICE_ACTIVITY = ("kernel", "gpu_memcpy", "gpu_memset")

# the port's kernels by the name of their __global__ function (csrc/*.cu)
KERNEL_FUNCTIONS = {
    "patch_gather": "patch_gather_kernel",
    "pyramid": "pyramid_kernel",
    "scharr": "scharr_kernel",
    "corner_response": "corner_response_kernel",
    "greedy_nms": "greedy_nms_kernel",
}


def kernel_of(name: str):
    """The port's kernel a device operation's name is, or None."""
    for kernel, fn in KERNEL_FUNCTIONS.items():
        if fn in name:
            return kernel
    return None


def activity(e) -> str:
    """The kineto activity of an event: ``activity_type()`` where the
    build has it, else told from its device and name ("kernel",
    "gpu_memcpy", "gpu_memset", "user_annotation" for the benchmark's
    host spans, "gpu_user_annotation" for their copies on the device,
    "cpu_op")."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    on_device = "cuda" in str(e.device_type()).lower()
    name = e.name()
    if name == WINDOW or name in SPANS:
        return "gpu_user_annotation" if on_device else "user_annotation"
    if not on_device:
        return "cpu_op"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events) -> dict:
    """The traced window of a list of kineto events (``start_ns()``,
    ``end_ns()``, ``name()``, ``activity_type()``, ``device_type()``):
    {"window_s", "busy_s", "device_ops" [[name, s]], "idle_gaps" [[span,
    s]], "kernel_s" {kernel: s}, "device_events"}; None without a window
    or without any device operation in it."""
    windows = [(e.start_ns(), e.end_ns()) for e in events
               if e.name() == WINDOW and activity(e) == "user_annotation"]
    if not windows:
        return None
    w0, w1 = windows[0]
    dev, spans = [], []
    for e in events:
        act = activity(e)
        if act in DEVICE_ACTIVITY:
            s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
            if t > s:
                dev.append((s, t, e.name()))
        elif act == "user_annotation" and e.name() in SPANS:
            spans.append((e.start_ns(), e.end_ns(), e.name()))
    if not dev:
        return None
    busy = _merge([(s, t) for s, t, _ in dev])
    by_name = collections.Counter()
    kernel_ns = collections.Counter()
    for s, t, name in dev:
        by_name[name] += t - s
        k = kernel_of(name)
        if k is not None:
            kernel_ns[k] += t - s
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((b - a, a))
    gaps.sort(reverse=True)

    def open_span(t):
        inner = [(s, e, n) for s, e, n in spans if s <= t < e]
        return min(inner, key=lambda x: x[1] - x[0])[2] if inner else "outside any span"

    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "device_ops": [[n, v / 1e9] for n, v in by_name.most_common(10)],
        "idle_gaps": [[open_span(a), g / 1e9] for g, a in gaps[:10]],
        "kernel_s": {k: v / 1e9 for k, v in kernel_ns.items()},
        "device_events": len(dev),
    }


def profile_block():
    """A profiler over CPU and CUDA activity, not yet started."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def read_profile(prof) -> dict:
    """``summarize`` of a finished profiler's events."""
    return summarize(prof.profiler.kineto_results.events())
