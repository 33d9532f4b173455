"""The inside reading (``benchmark/inside.py``) on fixed kineto-like events
and recorder records: the stage split at the markers, the copies through
the runtime calls' correlation ids, the gaps under the innermost span, the
frames' chains, the recorder switched on and off, and the runner's hooks
into a driver."""
import types

import pytest

from benchmark import inside, trace


class Ev:
    def __init__(self, name, act, s, e, corr=0):
        self._n, self._a, self._s, self._e, self._c = name, act, s, e, corr

    def name(self):
        return self._n

    def activity_type(self):
        return self._a

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c


class Bare:
    """An event of a build without ``activity_type()``."""

    def __init__(self, name, device):
        self._n, self._d = name, device

    def name(self):
        return self._n

    def device_type(self):
        return self._d


U, K, R = "user_annotation", "kernel", "cuda_runtime"
EVENTS = [
    Ev(trace.WINDOW, U, 0, 1000),
    Ev("bench.step", U, 0, 500),
    Ev("bench.step", U, 500, 1000),
    Ev("graph.call", U, 5, 45),
    Ev("graph.copy_in", U, 10, 20),
    Ev("graph.replay", U, 20, 30),
    Ev("graph.copy_out", U, 30, 40),
    Ev("api.retire", U, 460, 495),
    Ev("cudaLaunchKernel", R, 12, 13, corr=1),  # the copy in
    Ev("cudaGraphLaunch", R, 22, 25, corr=2),
    Ev("cudaLaunchKernel", R, 32, 33, corr=3),  # the copy out
    Ev("cudaLaunchKernel", R, 47, 48, corr=4),  # outside the copies
    Ev("multi_tensor_apply_kernel", K, 100, 110, corr=1),
    Ev("imu kernel", K, 110, 150, corr=2),
    Ev("imu kernel 2", K, 150, 160, corr=2),
    Ev("void (anonymous namespace)::hv_mark_imu_done()", K, 160, 161, corr=2),
    Ev("front end", K, 161, 300, corr=2),
    Ev("void (anonymous namespace)::hv_mark_frontend_done()", K, 300, 301, corr=2),
    Ev("estimator", K, 301, 400, corr=2),
    Ev("estimator 2", K, 390, 450, corr=2),
    Ev("multi_tensor_apply_kernel", K, 450, 470, corr=3),
    Ev("cat", K, 480, 490, corr=4),
    Ev("bench.step", "gpu_user_annotation", 0, 1000),  # not device work
]


def test_stage_split_copies_and_gaps():
    s = inside.device_split(EVENTS)
    assert s["replays"] == 1
    assert s["stage_s"] == pytest.approx({"imu": 50e-9, "frontend": 139e-9,
                                          "estimator": 149e-9})
    assert s["copy_s"] == pytest.approx(30e-9) and s["copy_launches"] == 2
    assert s["busy_s"] == pytest.approx(380e-9)  # [100, 470] + [480, 490]
    assert s["window_s"] == pytest.approx(1000e-9)
    # [490, 1000] under the program's retire; [0, 100] under the benchmark's step
    assert s["idle_gaps"][0] == ["api.retire", pytest.approx(510e-9)]
    assert s["idle_gaps"][1] == ["bench.step", pytest.approx(100e-9)]
    assert s["idle_gaps"][2] == ["api.retire", pytest.approx(10e-9)]  # [470, 480]
    assert s["bench_span_ms"] == {"bench.step": pytest.approx(500e-6)}
    assert trace.summarize(EVENTS)["busy_s"] == pytest.approx(s["busy_s"])
    assert inside.device_split(EVENTS[1:]) is None  # no window


def test_a_replay_without_both_markers_is_no_step():
    events = [e for e in EVENTS if "hv_mark_frontend" not in e.name()]
    s = inside.device_split(events)
    assert s["replays"] == 0 and s["stage_s"] == {"imu": 0, "frontend": 0, "estimator": 0}
    assert inside.inside_metrics("offline", s, None) == {}


def test_program_spans_are_annotations_without_activity_type():
    assert inside.activity(Bare("graph.copy_in", "DeviceType.CPU")) == "user_annotation"
    assert inside.activity(Bare("api.retire", "DeviceType.CUDA")) == "gpu_user_annotation"
    assert inside.activity(Bare("cudaGraphLaunch", "DeviceType.CPU")) == "cuda_runtime"
    assert inside.activity(Bare("bench.step", "DeviceType.CPU")) == "user_annotation"
    assert inside.activity(Bare("aten::add", "DeviceType.CPU")) == "cpu_op"


def _rec(name, s, e, frame, kind="span"):
    return {"id": 0, "name": name, "kind": kind, "start_ns": s, "end_ns": e, "parent": None,
            "thread": 1, "frame": frame}


PROGRAM = {"spans": [
    _rec("api.add_frame", 0, 10, 1.0), _rec("api.sync_hold", 0, 100, 1.0, "interval"),
    _rec("api.step", 105, 150, 1.0), _rec("graph.call", 110, 140, 1.0),
    _rec("api.inflight", 150, 300, 1.0, "interval"), _rec("api.retire", 300, 320, 1.0),
    _rec("bench.on_output", 310, 311, 1.0),
    _rec("api.add_frame", 400, 402, 2.0), _rec("api.sync_hold", 400, 500, 2.0, "interval"),
], "counters": {"graph.copy_tensors": 145}, "dropped": 0}


def test_span_means_follow_the_delivered_frames():
    m = inside.span_means(PROGRAM)
    assert m["frames"] == 1  # frame 2 was not delivered
    assert m["sync_hold_ms"] == pytest.approx(100e-6)
    assert m["step_host_ms"] == pytest.approx(45e-6)
    assert m["inflight_ms"] == pytest.approx(150e-6)
    assert m["retire_ms"] == pytest.approx(20e-6)
    assert m["add_to_output_ms"] == pytest.approx(310e-6)
    assert m["spans_ms"]["api.sync_hold"] == pytest.approx(100e-6)
    online = inside.inside_metrics("online", inside.device_split(EVENTS), PROGRAM)
    assert set(online) == {"sync_hold_ms.online", "inflight_ms.online", "retire_ms.online",
                           "step_host_ms.online", "add_to_output_ms.online",
                           "step_imu_ms.online", "step_frontend_ms.online",
                           "step_estimator_ms.online", "copy_ms.online", "busy_ms.online"}
    assert online["copy_ms.online"] == pytest.approx(30e-6)
    offline = inside.inside_metrics("offline", None, {"spans": PROGRAM["spans"][3:4]})
    assert offline == {"step_host_ms.offline": pytest.approx(30e-6)}
    assert inside.inside_metrics("online", None, None) == {}


def test_trace_on_and_off_wrap_the_port_recorder():
    from hybvio_tpu_torch.utils import timer

    assert inside.trace_on() and timer.recording()
    with timer.span("graph.call"):
        timer.count("graph.copy_tensors", 2)
    got = inside.trace_off()
    assert not timer.recording()
    assert [r["name"] for r in got["spans"]] == ["graph.call"]
    assert got["counters"] == {"graph.copy_tensors": 2} and got["dropped"] == 0
    assert inside.trace_off() == {"spans": [], "counters": {}, "dropped": 0}


def test_twin_offsets_pair_each_span_with_the_nearest_twin():
    spans = [_rec("graph.copy_in", 9, 20, None), _rec("graph.replay", 21, 30, None),
             _rec("api.sync_hold", 0, 5, None, "interval")]
    assert inside.twin_offsets(EVENTS, spans) == {"n": 2, "median_ns": 1, "max_abs_ns": 1}
    assert inside.twin_offsets(EVENTS, spans[2:]) is None


class Timed(Bare):
    """An event of a build without ``activity_type()``, with its times."""

    def __init__(self, name, device, s, e):
        super().__init__(name, device)
        self._s, self._e = s, e

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


def test_told_events_keep_the_program_spans_twins_off_the_card():
    cpu, cuda = "DeviceType.CPU", "DeviceType.CUDA"
    events = [Timed(trace.WINDOW, cpu, 0, 100), Timed("bench.step", cpu, 0, 100),
              Timed("api.retire", cpu, 40, 90), Timed("api.retire", cuda, 40, 90),
              Timed("some_kernel", cuda, 10, 30)]
    bare = trace.summarize(events)
    told = trace.summarize([inside.Told(e) for e in events])
    assert bare["busy_s"] == pytest.approx(70e-9)  # the twin read as a kernel
    assert told["busy_s"] == pytest.approx(20e-9) and told["device_events"] == 1
    assert told["idle_gaps"][0] == ["bench.step", pytest.approx(70e-9)]  # [30, 100]
    assert inside.device_split(events)["busy_s"] == pytest.approx(told["busy_s"])


class Prof:
    def __init__(self, events):
        self.profiler = types.SimpleNamespace(
            kineto_results=types.SimpleNamespace(events=lambda: events))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _driver(settles=True, stream=True):
    """A driver as ``benchmark.drivers.*`` are, over the fixed events: set-up,
    an untraced window with one ``graph.call``, a traced block with one."""
    from hybvio_tpu_torch.utils import timer

    d = types.ModuleType("fake_driver")
    d.program = types.SimpleNamespace(settle=lambda dev: 0.0)
    d.profile_block = lambda: Prof(EVENTS)
    d.read_profile = lambda prof: "the harness's own summary"
    if stream:
        d.Stream = type("Stream", (), {"on_output": lambda self, vo: None})

    def run(cell, seed, seconds, trace_, device):
        with timer.span("graph.call"):  # set-up: before the recorder
            pass
        if settles:
            d.program.settle(device)
        with timer.span("graph.call"):
            d.Stream().on_output(None) if stream else None
        with d.profile_block() as prof:
            with timer.span("graph.replay"):
                pass
        return {"record": {"trace": d.read_profile(prof)}}

    d.run = run
    return d


API = types.SimpleNamespace(workload={"driver": "api"})


def test_run_inside_reads_the_untraced_window_and_the_traced_block():
    from hybvio_tpu_torch.utils import timer

    d = _driver()
    out, got = inside.run_inside(d, API, 1, 1.0, True, "cpu")
    assert [r["name"] for r in got["untraced"]["spans"]] == ["bench.on_output", "graph.call"]
    assert [r["name"] for r in got["program"]["spans"]] == ["graph.replay"]
    assert got["split"]["replays"] == 1 and got["twins"]["n"] == 1
    assert out["record"]["trace"] == trace.summarize([inside.Told(e) for e in EVENTS])
    assert not timer.recording()
    assert d.read_profile(None) == "the harness's own summary"  # put back
    out, got = inside.run_inside(_driver(), API, 1, 1.0, False, "cpu")
    assert "untraced" not in got and "program" not in got and got["split"]["replays"] == 1


@pytest.mark.parametrize("gone", ["stream", "settle"])
def test_run_inside_fails_when_a_hook_is_gone(gone):
    from hybvio_tpu_torch.utils import timer

    d = _driver(settles=gone != "settle", stream=gone != "stream")
    with pytest.raises(AttributeError if gone == "stream" else RuntimeError):
        inside.run_inside(d, API, 1, 1.0, True, "cpu")
    assert not timer.recording()
