"""The port's own spans, counters and stage markers in a cell's traced
window, beside the benchmark's:

    python3 -m benchmark.inside --workload <cell> --seed <n> --seconds <s> [--off]

runs the cell as ``python3 -m benchmark.run --trace 1`` does, with the
port's span recorder (``hybvio_tpu_torch.utils.timer``) on from the end of
set-up through the traced block (the untraced window's end-to-end metrics
pay for it; ``--off`` leaves it off throughout, for its cost), and prints
one JSON line: ``correct``, the run's end-to-end metrics and ``setup_s``,
its per-layer metrics as ``benchmark.run`` reads them, and ``inside``, the
numbers read from inside the program, per frame or step, in ms:

- ``sync_hold_ms``, ``step_host_ms``, ``inflight_ms``, ``retire_ms`` (online):
  the recorder's ``api.sync_hold``, ``api.step``, ``api.inflight`` and
  ``api.retire`` of the frames delivered in the untraced window, and
  ``add_to_output_ms``, their ``add_frame_*`` call to their ``on_output``;
- ``step_host_ms`` (offline): ``graph.call`` in the untraced window;
- ``step_imu_ms``, ``step_frontend_ms``, ``step_estimator_ms`` (traced
  block): the card's busy time in each replay of the step before its
  ``hv_mark_imu_done`` marker, between the markers and after
  ``hv_mark_frontend_done``;
- ``copy_ms`` (traced block): the card's time in the operations launched
  inside ``graph.copy_in`` and ``graph.copy_out``;
- ``busy_ms`` (traced block): the card's busy time, per replay.

The host numbers come from the untraced window because the profiler slows
the host: a graph launch under it costs hundreds of ms. The recorder puts
the program's spans on the profiler's device timeline too (their
``gpu_user_annotation`` twins); where the build has no ``activity_type()``,
``trace.activity`` would take them for kernels, so the traced block is
summarized as ``trace.read_profile`` does with each event's activity told
by ``activity`` below, and the per-layer device metrics, ``device.busy_s``
and the breakdown read the card's work alone.

Details (the ten longest idle gaps under the innermost span open on the
host, program's or benchmark's; every span's mean in the untraced window
and under the profiler; the counters) go to
``chiprun_out/inside/<cell>.<seed>.<on|off>.json``. The functions below
read kineto events as ``trace.summarize`` does and import nothing of JAX.
``run_inside`` wraps four names of the harness (``profile_block``,
``read_profile``, ``program.settle``, and online ``Stream.on_output``): a
name that is gone, or a hook the driver no longer calls, fails the run.
"""
from __future__ import annotations

from . import run  # first: its clock starts the run's set-up

import argparse  # noqa: E402
import bisect  # noqa: E402
import collections  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from . import trace  # noqa: E402
from .cell import ROOT, find_cell, read_per_layer  # noqa: E402

PROGRAM_SPANS = ("api.add_frame", "api.step", "api.retire", "api.retire_wait", "api.output",
                 "graph.call", "graph.flatten", "graph.copy_in", "graph.replay", "graph.copy_out",
                 "bench.on_output")
MARKERS = ("hv_mark_imu_done", "hv_mark_frontend_done")  # csrc/empty.cu, in the step's order
STAGES = ("imu", "frontend", "estimator")
COPY_SPANS = ("graph.copy_in", "graph.copy_out")
RUNTIME = ("cuda_runtime", "cuda_driver")


def recorder():
    """The port's span recorder module, or None where it has none."""
    from hybvio_tpu_torch.utils import timer

    return timer if hasattr(timer, "RECORDER") else None


def trace_on() -> bool:
    """The recorder on, emptied first; False where the port has none."""
    timer = recorder()
    if timer is None:
        return False
    timer.drain()
    timer.enable()
    return True


def trace_off():
    """The recorder off: {"spans", "counters", "dropped"} since
    ``trace_on``, or None where the port has none."""
    timer = recorder()
    if timer is None:
        return None
    timer.disable()
    return timer.drain()


def activity(e) -> str:
    """``trace.activity``, which also tells the program's spans as user
    annotations, and the runtime's calls, where the build has no
    ``activity_type()``."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    on_device = "cuda" in str(e.device_type()).lower()
    if e.name() in PROGRAM_SPANS:
        return "gpu_user_annotation" if on_device else "user_annotation"
    if not on_device and e.name().startswith("cu"):
        return "cuda_runtime"
    return trace.activity(e)


class Told:
    """A kineto event that tells its activity as ``activity`` does, for
    ``trace.summarize``; the rest is the event's own."""

    __slots__ = ("_e",)

    def __init__(self, e):
        self._e = e

    def activity_type(self) -> str:
        return activity(self._e)

    def __getattr__(self, name):
        return getattr(self._e, name)


def _corr(e):
    c = e.correlation_id() if hasattr(e, "correlation_id") else None
    return c or None


def _busy_ns(intervals, lo, hi) -> int:
    """The length of the union of ``intervals`` clipped to [lo, hi)."""
    clipped = [(max(s, lo), min(t, hi)) for s, t in intervals]
    return sum(t - s for s, t in trace._merge([iv for iv in clipped if iv[1] > iv[0]]))


def device_split(events) -> dict:
    """What the traced window of kineto ``events`` says from inside the
    program: {"replays" (replays of the step, those with both markers),
    "stage_s" {stage: s}, "copy_s", "copy_launches", "busy_s", "window_s",
    "idle_gaps" [[innermost span, s]] (ten), "bench_span_ms" {name: mean
    ms}}; None without a window."""
    windows = [(e.start_ns(), e.end_ns()) for e in events
               if e.name() == trace.WINDOW and activity(e) == "user_annotation"]
    if not windows:
        return None
    w0, w1 = windows[0]
    dev, calls, spans = [], [], []
    for e in events:
        act = activity(e)
        if act in trace.DEVICE_ACTIVITY:
            s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
            if t > s:
                dev.append((s, t, e.name(), _corr(e)))
        elif act in RUNTIME:
            calls.append((e.start_ns(), e.end_ns(), e.name(), _corr(e)))
        elif act == "user_annotation" and w0 <= e.start_ns() < w1 and e.name() != trace.WINDOW:
            spans.append((e.start_ns(), e.end_ns(), e.name()))
    by_corr = collections.defaultdict(list)
    for s, t, name, c in dev:
        if c is not None:
            by_corr[c].append((s, t, name))

    # the copies: device operations of the runtime calls made inside a copy span
    copy_spans = [(s, t) for s, t, n in spans if n in COPY_SPANS]
    copy_corr = {c for s, _, _, c in calls
                 if c is not None and any(a <= s < b for a, b in copy_spans)}
    copy_ops = [(s, t) for c in copy_corr for s, t, _ in by_corr.get(c, ())]

    # the stages: each graph launch's operations, split at its markers
    stage_ns = dict.fromkeys(STAGES, 0)
    replays = 0
    for _, _, name, c in calls:
        ops = sorted(by_corr.get(c, ())) if "GraphLaunch" in name else ()
        ends = {m: max((t for _, t, n in ops if m in n), default=None) for m in MARKERS}
        if not ops or None in ends.values():
            continue
        replays += 1
        edges = [ops[0][0], ends[MARKERS[0]], ends[MARKERS[1]], max(t for _, t, _ in ops)]
        work = [(s, t) for s, t, n in ops if not any(m in n for m in MARKERS)]
        for stage, lo, hi in zip(STAGES, edges, edges[1:]):
            stage_ns[stage] += _busy_ns(work, lo, hi)

    busy = trace._merge([(s, t) for s, t, _, _ in dev])
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((b - a, a))
    gaps.sort(reverse=True)

    def innermost(t):
        inner = [(e - s, n) for s, e, n in spans if s <= t < e]
        return min(inner)[1] if inner else "outside any span"

    bench = collections.defaultdict(list)
    for s, t, n in spans:
        if n in trace.SPANS:
            bench[n].append(t - s)
    return {
        "replays": replays,
        "stage_s": {k: v / 1e9 for k, v in stage_ns.items()},
        "copy_s": _busy_ns(copy_ops, w0, w1) / 1e9,
        "copy_launches": len(copy_corr),
        "busy_s": sum(t - s for s, t in busy) / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "idle_gaps": [[innermost(a), g / 1e9] for g, a in gaps[:10]],
        "bench_span_ms": {n: sum(v) / len(v) / 1e6 for n, v in sorted(bench.items())},
    }


def twin_offsets(events, spans) -> dict:
    """How far each recorder span's start lies from its ``record_function``
    twin's on the profiler's timeline (the nearest start of that name):
    {"n", "median_ns" (twin - recorder), "max_abs_ns"}; None without twins."""
    starts = collections.defaultdict(list)
    for e in events:
        if e.name() in PROGRAM_SPANS and activity(e) == "user_annotation":
            starts[e.name()].append(e.start_ns())
    for v in starts.values():
        v.sort()
    offs = []
    for r in spans:
        got = starts.get(r["name"])
        if r["kind"] != "span" or not got:
            continue
        i = bisect.bisect_left(got, r["start_ns"])
        offs.append(min((got[j] - r["start_ns"] for j in (i - 1, i) if 0 <= j < len(got)),
                        key=abs))
    if not offs:
        return None
    offs.sort()
    return {"n": len(offs), "median_ns": offs[len(offs) // 2], "max_abs_ns": max(map(abs, offs))}


def _mean_ms(values):
    return sum(values) / len(values) / 1e6 if values else None


def span_means(program: dict) -> dict:
    """{name: mean ms} of each span and interval the recorder kept, and per
    delivered frame (online: a frame with an ``api.retire`` and a
    ``bench.on_output``) the means of its chain, keyed as the metrics:
    ``sync_hold_ms``, ``step_host_ms``, ``inflight_ms``, ``retire_ms``,
    ``add_to_output_ms``, and ``frames``."""
    by_name = collections.defaultdict(list)
    frames = collections.defaultdict(dict)
    for r in program["spans"]:
        d = r["end_ns"] - r["start_ns"]
        by_name[r["name"]].append(d)
        if r["frame"] is not None and r["name"] not in frames[r["frame"]]:
            frames[r["frame"]][r["name"]] = r
    out = {"spans_ms": {n: _mean_ms(v) for n, v in sorted(by_name.items())}}
    chain = ("api.add_frame", "api.sync_hold", "api.step", "api.inflight", "api.retire",
             "bench.on_output")
    done = [f for f in frames.values() if all(n in f for n in chain)]
    if done:
        for key, name in (("sync_hold_ms", "api.sync_hold"), ("step_host_ms", "api.step"),
                          ("inflight_ms", "api.inflight"), ("retire_ms", "api.retire")):
            out[key] = _mean_ms([f[name]["end_ns"] - f[name]["start_ns"] for f in done])
        out["add_to_output_ms"] = _mean_ms([f["bench.on_output"]["start_ns"]
                                            - f["api.add_frame"]["start_ns"] for f in done])
        out["frames"] = len(done)
    elif by_name.get("graph.call"):
        out["step_host_ms"] = _mean_ms(by_name["graph.call"])
    return out


def inside_metrics(path: str, split: dict, program) -> dict:
    """The inside numbers of a run on ``path`` ("offline" or "online"),
    named as per-layer metrics: ``<number>.<path>``."""
    out = {}
    if split and split["replays"]:
        n = split["replays"]
        for stage in STAGES:
            out[f"step_{stage}_ms.{path}"] = 1e3 * split["stage_s"][stage] / n
        out[f"busy_ms.{path}"] = 1e3 * split["busy_s"] / n
        if split["copy_launches"]:
            out[f"copy_ms.{path}"] = 1e3 * split["copy_s"] / n
    if program is not None:
        means = span_means(program)
        keys = (("sync_hold_ms", "inflight_ms", "retire_ms", "step_host_ms", "add_to_output_ms")
                if path == "online" else ("step_host_ms",))
        for k in keys:
            if means.get(k) is not None:
                out[f"{k}.{path}"] = means[k]
    return out


def run_inside(driver, cell, seed: int, seconds: float, on: bool, device) -> tuple:
    """(``driver.run``'s ``--trace 1`` run of ``cell``, what was read inside
    it). With ``on`` the recorder runs from the driver's first
    ``program.settle`` (the end of set-up) through the traced block, and
    online the stream's ``on_output`` runs inside a ``bench.on_output``
    span; what it recorded before the traced block is ``"untraced"``, in
    it ``"program"``. The traced block's events give ``"split"`` and the
    driver's record its summary, each event's activity told by
    ``activity``."""
    timer = recorder()
    if on and timer is None:
        raise RuntimeError("the port has no span recorder (hybvio_tpu_torch.utils.timer)")
    got = {}
    settle, profile_block = driver.program.settle, driver.profile_block

    def settle_inside(dev):
        t = settle(dev)
        if on and not got:  # the end of set-up
            got["on"] = trace_on()
        return t

    def profile_inside():
        if on:
            got["untraced"] = timer.drain()
        return profile_block()

    def read_inside(prof):
        events = prof.profiler.kineto_results.events()
        got["split"] = device_split(events)
        if on:
            got["program"] = trace_off()
            got["twins"] = twin_offsets(events, got["program"]["spans"])
        return trace.summarize([Told(e) for e in events])

    patches = [(driver, "profile_block", profile_inside), (driver, "read_profile", read_inside),
               (driver.program, "settle", settle_inside)]
    if on and cell.workload["driver"] == "api":
        on_output = driver.Stream.on_output

        def on_output_inside(self, vo):
            with timer.span("bench.on_output"):
                on_output(self, vo)

        patches.append((driver.Stream, "on_output", on_output_inside))
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        out = driver.run(cell, seed, seconds, True, device)
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
        trace_off()
    if "split" not in got or (on and not (got.get("on") and "untraced" in got)):
        raise RuntimeError(f"{driver.__name__}.run no longer calls the hooks benchmark.inside "
                           "wraps (program.settle, profile_block, read_profile)")
    return out, got


def _details(program) -> dict:
    if program is None:
        return None
    return dict(span_means(program), counters=program["counters"], dropped=program["dropped"],
                records=len(program["spans"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--off", action="store_true",
                    help="the recorder off throughout: what it costs, against a run with it on")
    args = ap.parse_args(argv)
    run.pin_caches()
    cell = find_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        return run.fail("no CUDA device: the inside reading is of the card")
    torch.cuda.set_device(0)
    driver = importlib.import_module(f"benchmark.drivers.{cell.workload['driver']}")
    out, got = run_inside(driver, cell, args.seed, args.seconds, not args.off,
                          torch.device("cuda", 0))
    setup_s = out["setup_done"] - run.T_START
    correct, line = run.result_line(
        cell, out, True, run.device_info(torch, cell.entry["chips"], out["memory_peak_bytes"]),
        run.T_START)
    path = out["record"]["path"]
    recorder_state = "off" if args.off else "on"
    result = {"correct": correct, "workload": cell.name, "seed": args.seed,
              "recorder": recorder_state, "e2e": dict(out["e2e"], setup_s=setup_s),
              "api_call_ms": out["record"].get("api_call_ms"),
              "per_layer": {k: v["value"] for k, v in read_per_layer(cell, out["record"]).items()},
              "inside": inside_metrics(path, got["split"], got.get("untraced")),
              "device": line["device"]}
    if got.get("twins") is not None:
        result["twins"] = got["twins"]
    details = {"split": got["split"], "breakdown": line.get("breakdown"),
               "untraced": _details(got.get("untraced")),
               "under_profiler": _details(got.get("program"))}
    where = ROOT / "chiprun_out" / "inside"
    where.mkdir(parents=True, exist_ok=True)
    with open(where / f"{cell.name}.{args.seed}.{recorder_state}.json", "w") as f:
        json.dump(run.plain(dict(result, details=details)), f, indent=1)
    print(json.dumps(run.plain(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
