"""The SLAM side's spans and counters on the span recorder
(``utils/timer.py``): a short VISLAM stream through ``VioApi`` on the CPU,
with the SLAM worker thread on and off. On, every submitted frame has its
``slam.submit``, ``slam.queue``, ``slam.frame`` and (once consumed)
``slam.pending``, the session's stages are spans inside ``slam.frame``, and
each local BA has its device time (``slam.local_ba_device``, the host clock
on the CPU); the counters add up. Off, nothing is written, and the
``-timer`` table's SLAM stages are the same either way."""
import numpy as np
import pytest
import torch

from hybvio_tpu_torch.api.vio import VioApi
from hybvio_tpu_torch.config import Parameters
from hybvio_tpu_torch.io.synthetic import SYNTH_IMU_TO_CAMERA, generate_sequence, render_view
from hybvio_tpu_torch.utils import timer

W, H, F, FRAMES = 320, 240, 260.0, 12
STAGE_SPANS = ("slam.orb", "slam.keypoints", "slam.bow", "slam.map_points", "slam.loop",
               "slam.local_ba", "slam.cull")
SUBMIT_SPANS = ("slam.submit", "slam.frame", "slam.queue")
IMAGE_STAGES = ("slam.orb", "slam.keypoints", "slam.bow")


def _params(thread: bool):
    p = Parameters()
    p.odometry.cameraTrailLength = 6
    p.tracker.maxTracks = 32
    p.tracker.focalLength = F
    p.tracker.principalPointX = W / 2
    p.tracker.principalPointY = H / 2
    p.tracker.pyrLKWindowSize = 13
    p.tracker.pyrLKMaxLevel = 2
    p.tracker.gfttMinDistance = 30.0
    p.odometry.imuToCameraMatrix = tuple(SYNTH_IMU_TO_CAMERA.T.flatten())
    p.odometry.visualR = 0.3
    p.slam.useSlam = True
    p.slam.slamThread = thread
    # a SLAM frame at every keyframe, each a keyframe of the map, and a
    # local BA once three keyframes hold points
    p.slam.keyframeCandidateInterval = 1
    p.slam.keyframeDecisionAlways = True
    p.slam.minTriangulationAngleTwoObs = 0.5
    p.slam.adjacentSpaceSize = 3
    return p


_STREAM = {}


def _stream():
    """The frames and IMU samples of the short stream, made once."""
    if not _STREAM:
        seq = generate_sequence(duration=1.6, imu_rate=200.0, frame_rate=10.0,
                                n_landmarks=300, seed=5)
        frames = {int(k): render_view(seq.landmarks, seq.pos[k], seq.quat[k],
                                      SYNTH_IMU_TO_CAMERA, F, F, W / 2, H / 2, W, H,
                                      blob_sigma=1.2)
                  for k in seq.frame_sample_idx[:FRAMES]}
        _STREAM.update(seq=seq, frames=frames)
    return _STREAM["seq"], _STREAM["frames"]


def _run(thread: bool, record: bool):
    """(the recorder's drain, the API, the -timer SLAM table) of the stream
    through VioApi."""
    seq, frames = _stream()
    timer.drain()
    stats = timer.TimeStats(enabled=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(timer, "SLAM_TIME_STATS", stats)
        if record:
            timer.enable()
        try:
            api = VioApi(_params(thread), W, H, device="cpu")
            for k in range(max(frames) + 1):
                api.add_gyro(seq.times[k], seq.gyro[k])
                api.add_acc(seq.times[k], seq.acc[k])
                if k in frames:
                    api.add_frame_mono(seq.times[k], frames[k])
            api.slam.wait_idle()
            api.finish()
        finally:
            timer.disable()
    return timer.drain(), api, stats


@pytest.fixture(scope="module")
def runs():
    """{(worker thread, recorder on): _run's}."""
    torch.set_num_threads(2)
    return {key: _run(*key) for key in ((False, True), (True, True), (True, False))}


@pytest.mark.parametrize("thread", [False, True], ids=["inline", "worker"])
def test_every_slam_span_nested_under_its_frame(runs, thread):
    got, api, _ = runs[(thread, True)]
    spans = got["spans"]
    by_name = {}
    for r in spans:
        by_name.setdefault(r["name"], []).append(r)
    submitted = got["counters"]["slam.submitted"]
    assert submitted >= 4 and got["dropped"] == 0
    for name in SUBMIT_SPANS + ("slam.pending",):
        assert len(by_name[name]) == submitted, name
    frames = {r["id"] for r in by_name["slam.frame"]}
    keyframes = got["counters"]["slam.keyframes"]
    for name in STAGE_SPANS:
        # the image stages run on a keyframe with features (most), the rest on each
        n = len(by_name[name])
        assert (1 <= n <= keyframes) if name in IMAGE_STAGES else n == keyframes, name
        assert all(r["parent"] in frames for r in by_name[name]), name
    submit_thread = by_name["slam.submit"][0]["thread"]
    assert all((r["thread"] != submit_thread) == thread for r in by_name["slam.frame"])
    for q in by_name["slam.queue"]:
        # queued from the submission to the worker's start; pending from the
        # submission to the consumption, after the worker's end
        f = next(x for x in by_name["slam.frame"] if x["frame"] == q["frame"])
        p = next(x for x in by_name["slam.pending"] if x["frame"] == q["frame"])
        assert q["kind"] == p["kind"] == "interval"
        assert q["end_ns"] <= f["start_ns"] and p["start_ns"] == q["start_ns"]
        assert p["end_ns"] >= f["end_ns"]
    bas = got["counters"]["slam.local_ba"]
    device = by_name["slam.local_ba_device"]
    assert bas >= 1 and len(device) == bas
    assert all(r["kind"] == "interval" and r["end_ns"] > r["start_ns"] for r in device)


@pytest.mark.parametrize("thread", [False, True], ids=["inline", "worker"])
def test_slam_counters_add_up(runs, thread):
    got, api, _ = runs[(thread, True)]
    c = got["counters"]
    assert c["slam.candidates"] == c["slam.submitted"] + c.get("slam.dropped", 0)
    assert c.get("slam.dropped", 0) == api.slam.dropped
    assert 1 <= c["slam.local_ba"] <= c["slam.keyframes"] <= c["slam.submitted"]
    assert c["slam.keyframes"] == api.slam.slam.next_kf_id
    assert c["slam.ba_points"] >= 3 * c["slam.local_ba"]
    assert c["slam.ba_obs"] >= 2 * c["slam.ba_points"]
    assert c["slam.loop_queries"] <= c["slam.keyframes"]
    assert c.get("slam.loop_candidates", 0) <= 3 * c["slam.loop_queries"]
    prob, (poses, points, cost) = api.slam.slam.last_local_ba
    assert poses.shape == prob.poses.shape and np.isfinite(points).all()


def test_off_writes_nothing(runs):
    got, api, _ = runs[(True, False)]
    assert got == {"spans": [], "counters": {}, "dropped": 0}
    assert api.slam.slam.last_local_ba is not None  # the session ran


@pytest.mark.parametrize("record", [False, True], ids=["recorder_off", "recorder_on"])
def test_timer_table_keeps_its_slam_stages(runs, record):
    """-timer's SLAM table (``SLAM_TIME_STATS``) has every stage, one
    sample a keyframe each (the image stages a keyframe with features),
    whether the recorder is on or not."""
    _, api, stats = runs[(True, record)]
    keyframes = api.slam.slam.next_kf_id
    assert keyframes >= 4 and stats.frames == keyframes
    assert set(stats.counts) == set(timer.SLAM_STAGES)
    for label, n in stats.counts.items():
        span = timer.SLAM_SPANS[label]
        assert (1 <= n <= keyframes) if span in IMAGE_STAGES else n == keyframes, label
    report = stats.report()
    assert all(label in report for label in timer.SLAM_STAGES)


def test_warm_programs_runs_the_later_programs(runs):
    """``Slam.warm_programs`` runs the loop matcher and the vocabulary's
    k-means on the map (on the CPU, which captures nothing, the pools'
    eager calls plus one each) and changes nothing of the map."""
    _, api, _ = runs[(False, True)]
    session = api.slam.slam
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        for program in (session._match_program, session.vocabulary.kmeans_program):
            def counted(*a, _eager=program.eager, _name=program.name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _eager(*a, **k)
            mp.setattr(program, "eager", counted)
        keyframes, codebook = list(session.kf_order), session.vocabulary.codebook.copy()
        names = session.warm_programs()
    assert names == ["slam descriptor matcher", "slam vocabulary k-means"]
    assert calls == {n: session.graph_pools.eager_calls + 1 for n in names}
    assert session.kf_order == keyframes
    np.testing.assert_array_equal(session.vocabulary.codebook, codebook)
