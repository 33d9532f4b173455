"""The span recorder (``utils/timer.py``) and the port's spans, counters and
stage markers: off, it records nothing and opens no ``record_function``;
on, spans get their parents, threads and frame ids, the bound counts what
it drops, and a span lies beside its profiler twin on one clock. On a CPU
``VioApi`` stream every delivered frame carries its whole path (add, held
by the synchronizer, step, in flight, retire) under its own id, covering
its add-to-output time. The card-only cases (marked ``cuda``) find the
stage markers in a captured step's replay and its copies in the counters:

    python -m pytest --noconftest tests/test_torch_trace.py -m cuda -q
"""
import re
import threading
import time
from pathlib import Path

import pytest
import torch

from hybvio_tpu_torch import graphs
from hybvio_tpu_torch.api.vio import VioApi
from hybvio_tpu_torch.config import Parameters
from hybvio_tpu_torch.ops import _lib
from hybvio_tpu_torch.utils import timer

CHAIN = ("api.add_frame", "api.sync_hold", "api.step", "api.inflight", "api.retire")


@pytest.fixture
def recorder():
    """The process's recorder, on and empty; off and empty after."""
    timer.drain()
    timer.enable()
    try:
        yield timer
    finally:
        timer.disable()
        timer.drain()


def _profiled(fn):
    """The names and start times of the CPU profiler's events over ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name(), e.start_ns()) for e in prof.profiler.kineto_results.events()]


def test_off_records_nothing_and_opens_no_record_function(monkeypatch):
    timer.drain()
    assert not timer.recording()
    assert timer.span("a") is timer.span("b", frame=1.0)  # one shared null context

    def refuse(*a, **k):
        raise AssertionError("record_function opened while the recorder is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)

    def body():
        with timer.span("graph.call") as sp:
            assert sp is None
            timer.interval("api.inflight", 0, 1, frame=2.0)
            timer.count("graph.copy_bytes", 8)

    names = [n for n, _ in _profiled(body)]
    assert "graph.call" not in names
    assert timer.drain() == {"spans": [], "counters": {}, "dropped": 0}


def test_nested_spans_get_parents_threads_and_frames(recorder):
    def other():
        with timer.span("worker", frame=9.0):
            pass

    with timer.span("outer", frame=5.0) as outer:
        with timer.span("inner") as inner:
            with timer.span("leaf", frame=7.0):
                time.sleep(0.002)
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    timer.interval("wait", 10, 30, frame=5.0)
    timer.count("n")
    timer.count("n", 3)
    got = timer.drain()
    assert got["counters"] == {"n": 4} and got["dropped"] == 0
    r = {x["name"]: x for x in got["spans"]}
    assert [x["name"] for x in got["spans"]] == ["leaf", "inner", "worker", "outer", "wait"]
    assert r["outer"]["parent"] is None and r["inner"]["parent"] == r["outer"]["id"]
    assert r["leaf"]["parent"] == r["inner"]["id"]
    assert r["inner"]["frame"] == 5.0 and r["leaf"]["frame"] == 7.0  # inherited, given
    assert r["worker"]["parent"] is None and r["worker"]["frame"] == 9.0
    assert r["worker"]["thread"] != r["outer"]["thread"] == threading.get_ident()
    assert r["wait"] == dict(r["wait"], kind="interval", start_ns=10, end_ns=30, frame=5.0)
    assert (outer.start_ns, outer.end_ns) == (r["outer"]["start_ns"], r["outer"]["end_ns"])
    assert inner.start_ns <= r["leaf"]["start_ns"] <= r["leaf"]["end_ns"] <= inner.end_ns
    own = timer.self_ns(got["spans"])
    dur = {n: x["end_ns"] - x["start_ns"] for n, x in r.items()}
    assert own[r["inner"]["id"]] == dur["inner"] - dur["leaf"]
    assert own[r["outer"]["id"]] == dur["outer"] - dur["inner"]  # the worker's is its own
    assert own[r["leaf"]["id"]] == dur["leaf"] >= 2_000_000


def test_bound_counts_what_it_drops():
    rec = timer.Recorder(limit=3)
    rec.enable()
    for i in range(5):
        with rec.span(f"s{i}"):
            pass
    rec.interval("w", 0, 1)
    rec.disable()
    with rec.span("off"):
        pass
    got = rec.drain()
    assert [x["name"] for x in got["spans"]] == ["s0", "s1", "s2"] and got["dropped"] == 3
    assert rec.drain() == {"spans": [], "counters": {}, "dropped": 0}


def test_a_span_starts_within_a_millisecond_of_its_profiler_twin(recorder):
    def body():
        with timer.span("warm-up"):  # the first record_function of a process is slow
            pass
        for _ in range(20):
            with timer.span("graph.copy_in"):
                pass

    twins = [s for n, s in _profiled(body) if n == "graph.copy_in"]
    mine = [x["start_ns"] for x in timer.drain()["spans"] if x["name"] == "graph.copy_in"]
    assert len(twins) == len(mine) == 20
    for a, b in zip(sorted(twins), sorted(mine)):
        assert abs(a - b) < 1_000_000


def _stream_params(W, H, worker: bool):
    from hybvio_tpu_torch.io.synthetic import SYNTH_IMU_TO_CAMERA

    p = Parameters()
    p.odometry.cameraTrailLength = 6
    p.tracker.maxTracks = 24
    p.tracker.focalLength = 130.0
    p.tracker.principalPointX = W / 2
    p.tracker.principalPointY = H / 2
    p.tracker.pyrLKWindowSize = 11
    p.tracker.pyrLKMaxLevel = 1
    p.tracker.gfttMinDistance = 18.0
    p.odometry.imuToCameraMatrix = tuple(SYNTH_IMU_TO_CAMERA.T.flatten())
    p.odometry.visualR = 0.3
    p.odometry.processingQueueSize = 2 if worker else 0
    return p


def _covered_ns(intervals, lo, hi) -> int:
    ivs = sorted((max(s, lo), min(e, hi)) for s, e in intervals)
    total, reach = 0, lo
    for s, e in ivs:
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


@pytest.mark.parametrize("worker", [False, True], ids=["inline", "worker"])
def test_api_frames_carry_their_path(recorder, worker):
    """Each frame that reaches ``on_output`` has its add, hold, step, in
    flight and retire under its own id, in that order, and with the worker
    thread its queue: together they cover its add-to-output time within
    1 ms."""
    from hybvio_tpu_torch.io.synthetic import SYNTH_IMU_TO_CAMERA, generate_sequence, render_view

    W, H, n_frames = 160, 120, 7
    seq = generate_sequence(duration=1.0, imu_rate=200.0, frame_rate=10.0, n_landmarks=200,
                            seed=3)
    api = VioApi(_stream_params(W, H, worker), W, H, device="cpu")
    delivered = []

    def on_output(vo):
        with timer.span("test.on_output") as sp:
            delivered.append(sp)

    api.on_output = on_output
    frame_set = set(seq.frame_sample_idx[:n_frames].tolist())
    for k in range(seq.frame_sample_idx[n_frames - 1] + 1):
        api.add_gyro(seq.times[k], seq.gyro[k])
        api.add_acc(seq.times[k], seq.acc[k])
        if k in frame_set:
            api.add_frame_mono(seq.times[k], render_view(
                seq.landmarks, seq.pos[k], seq.quat[k], SYNTH_IMU_TO_CAMERA, 130.0, 130.0,
                W / 2, H / 2, W, H, blob_sigma=1.2))
    api.finish()
    got = timer.drain()
    assert len(delivered) >= 3 and got["dropped"] == 0
    by_frame = {}
    for r in got["spans"]:
        by_frame.setdefault(r["frame"], {}).setdefault(r["name"], []).append(r)
    added = [float(seq.times[k]) for k in sorted(frame_set)]
    chain = CHAIN[:2] + (("api.queue",) if worker else ()) + CHAIN[2:]
    for sp in delivered:
        rec = by_frame[sp.frame]
        assert sp.frame in added
        assert all(len(rec[n]) == 1 for n in chain), sorted(rec)
        r = [rec[n][0] for n in chain]
        assert r[0]["start_ns"] == r[1]["start_ns"]  # held from the add call
        for a, b in zip(r[1:], r[2:]):
            assert a["end_ns"] <= b["start_ns"]
        step, inflight, retire = rec["api.step"][0], rec["api.inflight"][0], rec["api.retire"][0]
        assert (step["end_ns"], retire["start_ns"]) == (inflight["start_ns"], inflight["end_ns"])
        assert retire["start_ns"] <= sp.start_ns <= retire["end_ns"]
        lo, hi = r[0]["start_ns"], sp.start_ns
        assert hi - lo - _covered_ns([(x["start_ns"], x["end_ns"]) for x in r[1:]], lo, hi) \
            < 1_000_000
        assert {x["name"] for x in got["spans"] if x["parent"] == retire["id"]} >= {"api.output"}
        assert rec["api.output"][0]["parent"] == retire["id"]


def test_captured_step_spans_on_the_cpu(recorder):
    """On the CPU a captured step is its eager call: ``graph.call`` with
    its signature's ``graph.flatten``, and nothing copied."""
    step = graphs.CapturedStep(lambda x: x + 1, "plus one")
    assert torch.equal(step(torch.zeros(3)), torch.ones(3))
    got = timer.drain()
    names = {r["name"]: r for r in got["spans"]}
    assert set(names) == {"graph.call", "graph.flatten"}
    assert names["graph.flatten"]["parent"] == names["graph.call"]["id"]
    assert got["counters"] == {}


def test_stage_markers_launch_nothing_on_the_cpu(monkeypatch):
    monkeypatch.setattr(_lib, "library", lambda: pytest.fail("built on the CPU"))
    for stage in _lib.STAGE_MARKS:
        _lib.mark_stage(stage, torch.zeros(2))
    src = (Path(_lib.CSRC) / "empty.cu").read_text()
    assert [m for m in re.findall(r"__global__ void hv_mark_(\w+)_done", src)] == \
        list(_lib.STAGE_MARKS)


# ------------------------------------------------------------------ the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; benchmark.inside reads the markers at size")


def _replay_profile(kind):
    """(a replay's kineto events, its CapturedStep, the records the
    recorder kept over it): the small ``kind`` path of
    ``test_torch_graph`` on the card, captured, then one replay profiled
    with the recorder on."""
    from test_torch_graph import _path

    state, step, _, frames, imus = _path(kind, "cuda")
    state, _ = step(state, imus[0], frames[0])  # the eager run and the capture
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    timer.drain()
    timer.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(state, imus[1], frames[1])
            torch.cuda.synchronize()
    finally:
        timer.disable()
    return list(prof.profiler.kineto_results.events()), step.graphs[0], timer.drain()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["stereo", "fisheye"])
def test_replay_carries_the_stage_markers(card, kind):
    events, captured, got = _replay_profile(kind)
    on_card = lambda e: "cuda" in str(e.device_type()).lower()  # noqa: E731
    launch = [e for e in events if "GraphLaunch" in e.name() and not on_card(e)]
    assert len(launch) == 1
    ops = sorted((e for e in events if on_card(e) and not e.name().startswith("graph.")
                  and e.correlation_id() == launch[0].correlation_id()),
                 key=lambda e: e.start_ns())
    names = [e.name() for e in ops]
    marks = [i for i, n in enumerate(names) if "hv_mark_" in n]
    assert len(marks) == 2 and "hv_mark_imu_done" in names[marks[0]]
    assert "hv_mark_frontend_done" in names[marks[1]]
    assert 0 < marks[0] < marks[1] < len(ops) - 1  # work in each of the three stages
    busy = sum(e.end_ns() - e.start_ns() for e in ops)
    assert busy > 0
    entry = next(iter(captured._graphs.values()))
    assert got["counters"]["graph.copy_bytes"] == entry.copy_bytes > 0
    assert got["counters"]["graph.copy_tensors"] == len(entry.inputs) + len(entry.outputs)
    spans = {r["name"] for r in got["spans"]}
    assert spans >= {"graph.call", "graph.flatten", "graph.copy_in", "graph.replay",
                     "graph.copy_out"}
