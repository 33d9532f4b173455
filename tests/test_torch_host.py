"""The port's host modules (copied or ported from the reference package)
against the reference on the same inputs: the sample synchronizer, the
JSONL reader / writer, the parameter loader, the CLI flag surface, the
output buffer, the visual-update stats, the timer, the allocator, the frame
sources, the image utilities, the command queue, the quaternion helpers and
state transforms of the API, and the EuRoC-like presets. Every comparison is
exact, except the tensor image ops at 1e-6."""
import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybvio_tpu import models as rmodels
from hybvio_tpu.api import output_buffer as r_ob
from hybvio_tpu.cli import command_queue as r_cq
from hybvio_tpu.config import Parameters as RParams
from hybvio_tpu.config import cmd_params_generated as r_cmd
from hybvio_tpu.config import loader as r_loader
from hybvio_tpu.ekf import transforms as r_tf
from hybvio_tpu.frontend import image_utils as r_iu
from hybvio_tpu.geometry import quaternion as r_q
from hybvio_tpu.io import jsonl as r_jsonl
from hybvio_tpu.io import video as r_video
from hybvio_tpu.odometry import sample_sync as r_ss
from hybvio_tpu.odometry import stats as r_stats
from hybvio_tpu.utils import allocator as r_alloc
from hybvio_tpu.utils import timer as r_timer
from hybvio_tpu_torch import models as pmodels
from hybvio_tpu_torch.api import output_buffer as p_ob
from hybvio_tpu_torch.cli import command_queue as p_cq
from hybvio_tpu_torch.config import Parameters as PParams
from hybvio_tpu_torch.config import cmd_params_generated as p_cmd
from hybvio_tpu_torch.config import loader as p_loader
from hybvio_tpu_torch.ekf import EKFState
from hybvio_tpu_torch.ekf import transforms as p_tf
from hybvio_tpu_torch.frontend import image_utils as p_iu
from hybvio_tpu_torch.geometry import quaternion as p_q
from hybvio_tpu_torch.io import jsonl as p_jsonl
from hybvio_tpu_torch.io import video as p_video
from hybvio_tpu_torch.odometry import sample_sync as p_ss
from hybvio_tpu_torch.odometry import stats as p_stats
from hybvio_tpu_torch.utils import allocator as p_alloc
from hybvio_tpu_torch.utils import timer as p_timer

torch.set_num_threads(1)


def _params_dict(p):
    return {g: dataclasses.asdict(getattr(p, g)) for g in ("odometry", "tracker", "slam")}


# ------------------------------------------------------------- sample sync

def _sync(mod, P, **odo):
    p = P()
    p.odometry.sampleSyncLag = 25
    p.odometry.visualUpdateEnabled = True
    for k, v in odo.items():
        setattr(p.odometry, k, v)
    return mod.SampleSync(p.odometry)


def _drain(ss, log):
    while True:
        s = ss.poll_synced_sample()
        if s is None:
            return
        fr = s.frame
        log.append((s.t, s.l, s.tF, s.f) + ((fr.t, fr.num, fr.leader_index, fr.leader_time_diff)
                                            if fr is not None else ()))


def _no_choke(ss, log):
    t = 5.0
    while t < 8.0:
        ss.add_sample_leader(t, (t, t, t))
        ss.add_sample_follower(t, (t, t, t))
        _drain(ss, log)
        log.append((ss.countL, ss.countF, ss.indexL, ss.indexF, ss.is_ready()))
        t += 0.01


def _frame_pairing(ss, log):
    t, i = 1.0, 0
    while t < 5.0:
        ss.add_sample_leader(t, (t, t, t))
        ss.add_sample_follower(t, (t, t, t))
        if i % 10 == 3:
            ss.add_frame(t + 0.002)
        _drain(ss, log)
        i += 1
        t += 0.01


def _out_of_order_and_late_start(ss, log):
    log.append(ss.poll_synced_sample())
    lf_shift, t_acc_start, t_acc_end, scale = 0.003, 5.1, 7.8, 0.5
    t, i = 5.0, 0
    while t < 8.0:
        tr = t
        if i % 6 == 2:
            tr += 0.033 * scale
        if i % 11 == 3:
            tr -= 0.011 * scale
        ss.add_sample_leader(tr, (tr, tr, tr))
        t += lf_shift
        if t_acc_start < t < t_acc_end:
            tr = t
            if i % 7 == 3:
                tr += 0.052 * scale
            if i % 3 == 2:
                tr -= 0.031 * scale
            ss.add_sample_follower(tr, (tr, tr, tr))
        if i % 10 == 3:
            ss.add_frame(t)
        t += 0.01 - lf_shift
        i += 1
        _drain(ss, log)


def _time_shift_applied(ss, log):
    ss.set_imu_to_camera_time_shift(0.005)
    for i in range(60):
        t = 1.0 + 0.01 * i
        ss.add_sample_leader(t, (t, t, t))
        ss.add_sample_follower(t, (t, t, t))
    ss.add_frame(1.3)
    ss.add_frame(1.4)
    _drain(ss, log)


def _buffer_culling_and_limiter(ss, log):
    """Frames faster than the leader clock fill the frame buffer (culling)
    while the smart limiter drops frames."""
    for i in range(400):
        t = 1.0 + 0.01 * i
        ss.add_sample_leader(t, (t, 2 * t, 3 * t))
        ss.add_sample_follower(t + 0.001, (t, t, t))
        ss.add_frame(t + 0.004)
        if i % 3 == 0:
            _drain(ss, log)


SYNC_CASES = {
    "no_choke": (_no_choke, {}),
    "frame_pairing": (_frame_pairing, {}),
    "out_of_order_and_late_start": (_out_of_order_and_late_start, {}),
    "time_shift_applied": (_time_shift_applied, {}),
    "buffer_culling_and_limiter": (_buffer_culling_and_limiter,
                                   {"sampleSyncSmartFrameRateLimiter": True,
                                    "secondImuToCameraShiftSeconds": 0.002}),
}


@pytest.mark.parametrize("case", sorted(SYNC_CASES))
def test_sample_sync_equals_reference(case):
    """The cases of tests/test_sample_sync.py (and buffer culling with the
    smart frame-rate limiter): every synced sample and frame pairing is the
    reference's."""
    fn, odo = SYNC_CASES[case]
    logs = []
    for mod, P in ((p_ss, PParams), (r_ss, RParams)):
        log = []
        fn(_sync(mod, P, **odo), log)
        logs.append(log)
    assert len(logs[0]) > 0
    assert logs[0] == logs[1]


# ------------------------------------------------------------------ jsonl

def _record(mod, out_dir):
    rec = mod.Recorder(str(out_dir))
    rng = np.random.RandomState(0)
    rec.f.write(json.dumps({"imuToCamera": [[0, 1, 0, 0.1], [-1, 0, 0, 0], [0, 0, 1, 0],
                                            [0, 0, 0, 1]], "cameraInd": 0}) + "\n")
    rec.f.write(json.dumps({"imuToCamera": list(range(16)), "cameraInd": 1}) + "\n")
    rec.f.write(json.dumps({"model": "KANNALA_BRANDT4", "coeffs": [0.1, 0.2, 0.3, 0.4, 0.5],
                            "cameraInd": 1}) + "\n")
    for k in range(12):
        t = 1.0 + 0.01 * k
        rec.gyro(t, rng.randn(3))
        rec.acc(t, rng.randn(3))
        if k % 4 == 0:
            imgs = [rng.rand(6, 8).astype(np.float32) for _ in range(2)]
            rec.frame(t, imgs, [{"focalLengthX": 200.0 + k, "focalLengthY": 201.0,
                                 "principalPointX": 4.0, "principalPointY": 3.0},
                                {"focalLength": 190.0}])
            rec.ground_truth(t, rng.randn(3), [1.0, 0.0, 0.0, 0.0])
    rec.close()
    return os.path.join(str(out_dir), "data.jsonl")


def _events(mod, path):
    return [(e.kind, e.t, e.values, e.frames_index, e.raw,
             [dataclasses.astuple(f) for f in e.frames or []]) for e in mod.read_jsonl_events(path)]


@pytest.mark.parametrize("reader", ["native", "python"])
def test_jsonl_round_trip_equals_reference(tmp_path, monkeypatch, reader):
    """The port's Recorder writes the reference's bytes and frames; the
    port's reader gives the events of the reference's, each on its native
    parser (the default; echo events for the calibration lines included) or
    each on its Python loop, and the same pose histories."""
    from hybvio_tpu.io import native_jsonl
    from hybvio_tpu_torch.io import native_jsonl as p_native_jsonl

    if reader == "python":
        monkeypatch.setattr(native_jsonl, "iter_events", lambda path: None)
        monkeypatch.setattr(p_native_jsonl, "iter_events", lambda path: None)
    p_path = _record(p_jsonl, tmp_path / "port")
    r_path = _record(r_jsonl, tmp_path / "ref")
    assert open(p_path).read() == open(r_path).read()
    for n in range(3):
        for c in range(2):
            name = f"frame_{n:06d}_cam{c}.npy"
            np.testing.assert_array_equal(np.load(tmp_path / "port" / name),
                                          np.load(tmp_path / "ref" / name))
    events = _events(p_jsonl, p_path)
    assert [e[0] for e in events].count(p_jsonl.FRAME) == 3
    assert p_jsonl.read_jsonl_events(p_path).reader == reader
    assert [e[0] for e in events].count(p_jsonl.ECHO) == (6 if reader == "native" else 3)
    assert events == _events(r_jsonl, r_path)
    ph, rh = p_jsonl.get_pose_histories(p_path), r_jsonl.get_pose_histories(r_path)
    assert sorted(ph) == sorted(rh) == ["groundTruth"]
    np.testing.assert_array_equal(ph["groundTruth"], rh["groundTruth"])


def test_set_parameters_from_data_equals_reference(tmp_path):
    path = _record(p_jsonl, tmp_path)
    p, r = PParams(), RParams()
    p_jsonl.set_parameters_from_data(p, path)
    r_jsonl.set_parameters_from_data(r, path)
    assert p.tracker.fisheyeCamera and p.tracker.secondDistortionCoeffs == (0.1, 0.2, 0.3, 0.4)
    assert _params_dict(p) == _params_dict(r)


@pytest.mark.parametrize("trail, extras", [(False, None), (True, {"status": 1, "x": [1.5]})])
def test_output_to_json_equals_reference(trail, extras):
    rng = np.random.RandomState(1)
    args = (10.25, rng.randn(3), rng.randn(4), rng.randn(3), rng.randn(4, 7) if trail else None)
    assert (p_jsonl.output_to_json(*args, extras=extras)
            == r_jsonl.output_to_json(*args, extras=extras))


# ------------------------------------------------------------------ loader

def _both(fn):
    p, r = PParams(), RParams()
    fn(p_loader, p)
    fn(r_loader, r)
    assert _params_dict(p) == _params_dict(r)
    return p


def test_apply_argv_equals_reference():
    argv = ["-cameraTrailLength=7", "-tracker.maxTracks=33", "-useStereo", "-visualR=0.25",
            "-imuToCameraMatrix=0,1,0,-1,0,0,0,0,1", "-videoRotation=CW90", "-unknownKey=3",
            "plain"]
    rests = []
    p = _both(lambda m, q: rests.append(m.apply_argv(q, argv)))
    assert rests[0] == rests[1] == ["-unknownKey=3", "plain"]
    assert p.odometry.cameraTrailLength == 7 and p.tracker.useStereo
    assert p.videoRotationSteps == 1


def test_apply_parameters_text_equals_reference():
    text = "ransac2Threshold 8.0;\nransac5Threshold 4.0;\n#note\nvisualR 0.5; odometry.rngSeed 3"
    p = _both(lambda m, q: m.apply_parameters_text(q, text))
    assert p.tracker.ransac2Threshold == 8.0 and p.odometry.rngSeed == 3
    for m in (p_loader, r_loader):
        with pytest.raises(ValueError):
            m.apply_parameters_text(PParams() if m is p_loader else RParams(), "visualR")
        with pytest.raises(m.UnknownParameterError):
            m.set_key_value(PParams() if m is p_loader else RParams(), "noSuchKey", "1")


@pytest.mark.parametrize("pyyaml", [True, False])
def test_apply_yaml_equals_reference(pyyaml, monkeypatch):
    """Through pyyaml and through the flat no-pyyaml subset."""
    if not pyyaml:
        monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml raises ImportError
    text = ("cameraTrailLength: 9\nmaxTracks: 40  # comment\n"
            + ("odometry:\n  visualR: 0.2\n" if pyyaml else "odometry.visualR: 0.2\n"))
    p = _both(lambda m, q: m.apply_yaml(q, text))
    assert p.odometry.cameraTrailLength == 9 and p.odometry.visualR == 0.2


def test_apply_calibration_json_equals_reference():
    calib = json.dumps({"cameras": [
        {"model": "kannala-brandt4", "focalLengthX": 458.0, "focalLengthY": 457.0,
         "principalPointX": 367.0, "principalPointY": 248.0,
         "distortionCoefficients": [0.01, 0.02, 0.0, 0.001],
         "imuToCameraMatrix": [[0, 1, 0, 0], [-1, 0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]},
        {"focalLength": 460.0, "principalPointX": 370.0, "principalPointY": 250.0,
         "imuToCameraMatrix": list(np.eye(4).flatten())}]})
    p = _both(lambda m, q: m.apply_calibration_json(q, calib))
    assert p.tracker.fisheyeCamera and p.tracker.secondFocalLength == 460.0


def test_load_parameters_equals_reference():
    kw = dict(parameters_txt="cameraTrailLength 10", yaml_text="maxTracks: 50",
              calibration_json='{"focalLength": 300.0}', argv=["-cameraTrailLength=6"])
    p, r = p_loader.load_parameters(**kw), r_loader.load_parameters(**kw)
    assert _params_dict(p) == _params_dict(r)
    assert p.odometry.cameraTrailLength == 6 and p.tracker.focalLength == 300.0


# --------------------------------------------------------- CLI flag surface

def test_cmd_params_equal_reference():
    assert p_cmd.CMD_PARAMS == r_cmd.CMD_PARAMS
    assert p_cmd.SHORT_TO_NAME == r_cmd.SHORT_TO_NAME
    assert p_cmd.flat_keys() == r_cmd.flat_keys()
    assert p_cmd.help_text() == r_cmd.help_text()
    for key in ("i", "o", "maxFrames", "frames", "timer", "c", "noSuchFlag"):
        assert p_cmd.lookup(key) == r_cmd.lookup(key)
    for tname, value in (("bool", ""), ("bool", "false"), ("int", "3.6"), ("float", "2"),
                         ("str", "x")):
        assert p_cmd.coerce(tname, value) == r_cmd.coerce(tname, value)


def test_command_queue_equals_reference():
    cmds = []
    for mod in (p_cq, r_cq):
        q = mod.CommandQueue()
        for key in "pqbcx s r":
            q.push_key(key)
        cmds.append([q.poll().name for _ in range(10)] + [q.step_mode])
    assert cmds[0] == cmds[1]


# ------------------------------------------------- buffer, stats, timer, pool

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.013
        return self.t


class _Out:
    def __init__(self, t):
        self.t = t


@pytest.mark.parametrize("delay", [0.0, 0.05])
def test_output_buffer_equals_reference(delay, monkeypatch):
    """The same outputs, skips, fps and latency on the same clock."""
    got = []
    for mod in (p_ob, r_ob):
        monkeypatch.setattr(mod.time, "monotonic", _Clock())
        ob = mod.OutputBuffer(delay)
        seq = []
        for k in range(30):
            ob.add_processed_frame(_Out(1.0 + 0.033 * k))
            if k % 2:
                ob.add_processed_frame(_Out(1.0 + 0.033 * k + 0.01))
            out = ob.poll_output()
            seq.append(None if out is None else out.t)
        got.append((seq, ob.fps, ob.mean_latency, ob.skips_total))
    assert got[0] == got[1]


def test_visual_update_stats_equal_reference():
    lines = []
    for mod in (p_stats, r_stats):
        s = mod.VisualUpdateStats(enabled=True)
        out = []
        for st in ([1, 1, 2, 4, 0], [4, 4, 0], []):
            s.count_from_output(np.array(st, dtype=np.int32))
            s.count("skipped", 2)
            out.append(s.finish_frame())
        lines.append((out, s.report()))
    assert lines[0] == lines[1]


def test_time_stats_equal_reference(monkeypatch):
    reports = []
    for mod in (p_timer, r_timer):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock())
        ts = mod.TimeStats()
        for _ in range(3):
            ts.start_frame()
            with ts.scope("predict"):
                pass
            ts.add_sample("image pyramids", 0.004)
        reports.append((ts.per_frame_timings(), ts.report(), dict(ts.counts)))
    assert reports[0] == reports[1]
    ts = p_timer.TimeStats()
    with ts.scope("cpu probe", probe=torch.zeros(3)):  # a CPU tensor: nothing to wait on
        pass
    assert ts.counts["cpu probe"] == 1


def test_allocator_equals_reference():
    """The same reuse and growth decisions on the same reference pattern."""
    seqs = []
    for mod in (p_alloc, r_alloc):
        made = []
        pool = mod.Allocator(lambda: made.append(len(made)) or np.zeros(3), max_size=7)
        held, seq = [], []
        for k in range(12):
            obj = pool.next()
            seq.append(next(i for i, o in enumerate(pool.pool) if o is obj))
            if k % 3:
                held.append(obj)
            if k % 4 == 3:
                held.pop(0)
            del obj
        seqs.append((seq, len(made)))
    assert seqs[0] == seqs[1]
    pool = p_alloc.Allocator(lambda: torch.empty(2), max_size=5)
    a = pool.next()
    assert pool.next() is not a  # a torch tensor in use is not handed out again
    del a
    assert pool.next() is pool.pool[0]


# ------------------------------------------------------------ frame sources

def test_frame_sources_equal_reference(tmp_path):
    rng = np.random.RandomState(2)
    for n in range(3):
        for c in range(2):
            np.save(tmp_path / f"frame_{n:06d}_cam{c}.npy", rng.rand(6, 8).astype(np.float32))
    rgb = tmp_path / "rgb"
    rgb.mkdir()
    for n in range(2):
        np.save(rgb / f"frame_{n:06d}_cam0.npy", rng.rand(6, 8, 3).astype(np.float32))
    for threads, gray, d in ((False, False, tmp_path), (True, False, tmp_path), (True, True, rgb)):
        p = p_video.open_frame_source(str(d), reader_threads=threads, convert_to_gray=gray)
        r = r_video.open_frame_source(str(d), reader_threads=threads, convert_to_gray=gray)
        assert p.shape == r.shape
        for n, c in ((0, 0), (1, 0), (0, 1), (2, 1)) if d == tmp_path else ((0, 0), (1, 0)):
            np.testing.assert_array_equal(p.frame(n, c), np.asarray(r.frame(n, c)))
    # a video: the reference's frames through cv2, and its error for a file
    # cv2 cannot read (tests/test_torch_visualizations.py holds the decode
    # of .avi and .mp4 against the reference frame by frame)
    import cv2

    path = str(tmp_path / "data.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (8, 6))
    for n in range(3):
        writer.write((rng.rand(6, 8, 3) * 255).astype(np.uint8))
    writer.release()
    p, r = p_video.open_frame_source(path), r_video.open_frame_source(path)
    assert p.shape == r.shape == (6, 8)
    for n in range(3):
        np.testing.assert_array_equal(p.frame(n), r.frame(n))
    (tmp_path / "data.mp4").write_bytes(b"")
    for mod in (p_video, r_video):
        with pytest.raises(RuntimeError, match="cannot read"):
            mod.open_frame_source(str(tmp_path / "data.mp4"))


def test_prefetching_source_reads_each_frame_once():
    """The reader thread over a sequential source (a video reads forward
    only): each frame is decoded once, in order, however the consumer's
    read-ahead requests interleave with the decoding (the reference
    package's copy queues a frame again while it is being decoded: 20 of 40
    frames twice in this set-up)."""
    import time

    class Sequential(p_video.FrameSource):
        def __init__(self):
            self.read = []

        def frame(self, number, camera_ind=0):
            self.read.append(number)
            time.sleep(0.003)
            return np.full((2, 2), number, np.float32)

        @property
        def shape(self):
            return (2, 2)

    inner = Sequential()
    src = p_video.PrefetchingSource(inner, lookahead=4)
    for n in range(40):
        assert src.frame(n)[0, 0] == n
        time.sleep(0.0015)
    assert inner.read[:40] == list(range(40)) and len(set(inner.read)) == len(inner.read)


def test_load_image_file_equals_reference(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(4)
    path = str(tmp_path / "f.jpg")
    Image.fromarray((rng.rand(12, 16, 3) * 255).astype(np.uint8)).save(path)
    got = p_video.load_image_file(path)
    assert got.dtype == np.uint8 and got.shape == (12, 16)
    np.testing.assert_array_equal(got, r_video.load_image_file(path))


# ------------------------------------------------------------ image utils

def test_host_image_utils_equal_reference():
    rng = np.random.RandomState(3)
    for img in (rng.rand(20, 30, 3).astype(np.float32),
                (rng.rand(20, 30, 3) * 255).astype(np.uint8)):
        np.testing.assert_array_equal(p_iu.rgb_to_gray(img), r_iu.rgb_to_gray(img))
    for img in (rng.rand(24, 36).astype(np.float32), (rng.rand(24, 36) * 255).astype(np.uint8)):
        for h, w in ((12, 18), (24, 36), (31, 40)):
            a, b = p_iu.resize_bilinear_np(img, h, w), r_iu.resize_bilinear_np(img, h, w)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_tensor_image_utils_equal_reference():
    rng = np.random.RandomState(5)
    a, b = rng.rand(24, 36).astype(np.float32), (0.5 * rng.rand(24, 36) + 0.2).astype(np.float32)
    for k in range(5):
        np.testing.assert_array_equal(p_iu.rotate(torch.as_tensor(a), k).numpy(),
                                      np.asarray(r_iu.rotate(jnp.asarray(a), k)))
    for strength in (1.0, 0.3):
        got = p_iu.match_intensities(torch.as_tensor(a), torch.as_tensor(b), strength).numpy()
        want = np.asarray(r_iu.match_intensities(jnp.asarray(a), jnp.asarray(b), strength))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ------------------------------------------- quaternions and state transforms

def _quats(rng, n):
    q = rng.randn(n, 4)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_quaternion_helpers_equal_reference():
    rng = np.random.RandomState(6)
    a, b = _quats(rng, 5), _quats(rng, 5)
    t = lambda x: torch.as_tensor(np.array(x))
    np.testing.assert_array_equal(p_q.quat_mul(t(a), t(b)).numpy(),
                                  np.asarray(r_q.quat_mul(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(p_q.quat_conj(t(a)).numpy(), np.asarray(r_q.quat_conj(jnp.asarray(a))))
    np.testing.assert_array_equal(p_q.quat_right_mul_matrix(t(a)).numpy(),
                                  np.asarray(r_q.quat_right_mul_matrix(jnp.asarray(a))))
    R = np.asarray(r_q.quat_to_rmat(jnp.asarray(a)))
    np.testing.assert_allclose(p_q.rmat_to_quat(t(R)).numpy(),
                               np.asarray(r_q.rmat_to_quat(jnp.asarray(R))), rtol=0, atol=1e-15)


def _ekf_states(L=3, B=2, seed=7):
    """B random float64 filter states with a trail of L poses (port, and
    the reference's lane by lane)."""
    from hybvio_tpu.ekf.state import EKFState as REKF

    rng = np.random.RandomState(seed)
    d = 20 + 7 * L
    m = rng.randn(B, d)
    m[:, 6:10] = _quats(rng, B)
    for i in range(L):
        m[:, 20 + 7 * i + 3:20 + 7 * i + 7] = _quats(rng, B)
    A = rng.randn(B, d, d)
    P = A @ A.transpose(0, 2, 1) / d + np.eye(d)
    rest = dict(time=np.zeros(B), prev_sample_t=np.zeros(B), first_sample_t=np.zeros(B),
                got_first_sample=np.ones(B, bool), zupt_time=np.zeros(B),
                zrupt_time=np.zeros(B), init_zupt_time=np.zeros(B),
                was_stationary=np.zeros(B, bool), augment_count=np.zeros(B, np.int32),
                pose_times=np.zeros((B, L)))
    port = EKFState(m=torch.as_tensor(m), P=torch.as_tensor(P),
                    **{k: torch.as_tensor(v) for k, v in rest.items()})
    refs = [REKF(m=jnp.asarray(m[b]), P=jnp.asarray(P[b]),
                 **{k: jnp.asarray(v[b]) for k, v in rest.items()}) for b in range(B)]
    return port, refs, rng


@pytest.mark.parametrize("op", ["translate_to", "transform_to", "transform_to_trail_pose",
                                "condition_on_last_pose", "lock_biases"])
def test_state_transforms_equal_reference(op):
    """The API's state surgery, batch-first, against the reference lane by
    lane (float64)."""
    L = 3
    port, refs, rng = _ekf_states(L)
    pos, q = rng.randn(2, 3), _quats(rng, 2)
    if op == "translate_to":
        got = p_tf.translate_to(port, torch.as_tensor(pos), L)
        want = [r_tf.translate_to(r, jnp.asarray(pos[b]), L) for b, r in enumerate(refs)]
    elif op.startswith("transform_to"):
        k = 1 if op.endswith("trail_pose") else -1
        got = p_tf.transform_to(port, torch.as_tensor(pos), torch.as_tensor(q), L, pose_index=k)
        want = [r_tf.transform_to(r, jnp.asarray(pos[b]), jnp.asarray(q[b]), L, pose_index=k)
                for b, r in enumerate(refs)]
    elif op == "condition_on_last_pose":
        got = p_tf.condition_on_last_pose(port, L)
        want = [r_tf.condition_on_last_pose(r, L) for r in refs]
    else:
        got = p_tf.lock_biases(port)
        want = [r_tf.lock_biases(r) for r in refs]
    for b, w in enumerate(want):
        np.testing.assert_allclose(got.m[b].numpy(), np.asarray(w.m), rtol=0, atol=1e-12)
        np.testing.assert_allclose(got.P[b].numpy(), np.asarray(w.P), rtol=0, atol=1e-11)


# ----------------------------------------------------------------- presets

@pytest.mark.parametrize("name", ["euroc_mono", "euroc_stereo"])
def test_euroc_presets_equal_reference(name):
    from hybvio_tpu_torch import convert

    kw = {"odometry.cameraTrailLength": 8}
    p, d, cams = getattr(pmodels, name)(**kw)
    r, rd, rcams = getattr(rmodels, name)(**kw)
    assert _params_dict(p) == _params_dict(r)
    for f in ("imu_to_camera", "second_imu_to_camera", "imu_to_output"):
        np.testing.assert_array_equal(getattr(d, f), getattr(rd, f))
    assert len(cams) == len(rcams) == (2 if name == "euroc_stereo" else 1)
    for c, rc in zip(cams, rcams):
        assert c == convert.camera_from_jax(rc)
