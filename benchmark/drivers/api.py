"""Online traffic: one camera and IMU streamed through the port's host
entry point, ``VioApi``, as the CLI replays a recording.

The configuration gives the frames of the stream (``sequence_frames``);
a workload file of this driver gives ``warmup_frames`` (fed in set-up: the init, the step's eager run
and capture, and the first seconds of the stream, while the estimated
camera-IMU time shift settles; until it does, a frame's pose can come
~90 ms later, a second mode of the tail that a window would read on some
runs and not on others), ``drain_frames`` (the most fed after the window:
the synchronizer holds a frame until later ones come), ``round_gap_s``
(the clock's step between two plays of the stream) and ``trace_steps``.

Set-up draws the world of lane 0 from the seed, renders its frames on the
card as the sensors' 8-bit images into pinned host memory, builds the API
with the configuration's parameters and feeds the first frames (the init
and the step's eager run and capture). The window then feeds the stream in
a closed loop: for each frame the IMU samples since the last frame
(``add_gyro``, ``add_acc``), then the frame (``add_frame_stereo`` or
``add_frame_mono``), the next as soon as the API returns. A frame's
latency runs from its ``add_frame_*`` call to the ``on_output`` call that
delivers its pose. A stream that ends inside the window is played again
after ``VioApi.reset()``, its clock moved on. After the window the next
frame's IMU samples are fed and the API is drained (``wait_idle``), so
every frame of the window gets its output, late ones with their wait.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import check, program, timing, world
from ..trace import profile_block, read_profile

STAGE_REPS = 10  # replays a stage is timed over in the traced run


class Stream:
    """The stream of one run, the API it feeds and what came back."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.device = cell, torch.device(device)
        self.config, self.workload = cell.config, cell.workload
        cam = self.config["camera"]
        self.F = self.config["sequence_frames"]
        self.seq = world.lane_worlds(seed, 1, self.config["world"], self.F, cam["rate_hz"],
                                     self.config["imu_rate_hz"])[0]
        render = world.make_renderer(cam, device)
        idx = self.seq.frame_sample_idx
        C = len(world.camera_extrinsics(cam))
        pin = self.device.type == "cuda"
        self.frames = torch.empty((self.F, C, cam["height"], cam["width"]), dtype=torch.uint8,
                                  pin_memory=pin)
        landmarks = torch.as_tensor(self.seq.landmarks[None], dtype=torch.float32, device=device)
        for f in range(self.F):
            self.frames[f] = world.to_u8(render(landmarks, self.seq.pos[idx[f]][None],
                                                self.seq.quat[idx[f]][None]))[0].cpu()
        self.host = self.frames.numpy()
        self.api = program.vio_api(self.config, device)
        self.api.on_output = self.on_output
        self.stereo = C == 2
        self.gap = self.F / cam["rate_hz"] + self.workload["round_gap_s"]
        self.round = 0
        self.f = 0  # the next frame to feed
        self.prev = 0  # the IMU sample after the last one fed
        self.calls = {}  # (round, frame) -> host clock at its add_frame call
        self.outputs = []  # (round, frame, host clock, position)
        self.call_s = []  # host seconds inside the API's calls, per frame fed
        self.spans = False

    def time_of(self, k: int) -> float:
        return float(self.seq.times[k]) + self.round * self.gap

    def frame_of(self, t: float) -> tuple:
        """(round, frame) of an output's time."""
        dt = t - self.seq.frame_times[0]
        r = int(np.floor((dt + 0.5 / self.config["camera"]["rate_hz"]) / self.gap))
        return r, int(round((dt - r * self.gap) * self.config["camera"]["rate_hz"]))

    def on_output(self, vo):
        now = time.perf_counter()
        r, f = self.frame_of(vo.t)
        self.outputs.append((r, f, now, np.array(vo.position, np.float64)))

    def span(self, name):
        return torch.profiler.record_function(name) if self.spans else contextlib.nullcontext()

    def feed_imu(self, upto: int) -> None:
        seq, api = self.seq, self.api
        with self.span("bench.imu"):
            for k in range(self.prev, upto + 1):
                t = self.time_of(k)
                api.add_gyro(t, seq.gyro[k])
                api.add_acc(t, seq.acc[k])
        self.prev = upto + 1

    def feed_one(self) -> tuple:
        """Feed the next frame and its IMU samples; its (round, frame)."""
        if self.f == self.F:
            self.api.reset(t=self.time_of(self.seq.frame_sample_idx[-1]))
            self.round += 1
            self.f, self.prev = 0, 0
        k = self.seq.frame_sample_idx[self.f]
        t0 = time.perf_counter()
        self.feed_imu(k)
        img = self.host[self.f]
        with self.span("bench.frame"):
            t1 = time.perf_counter()
            self.calls[(self.round, self.f)] = t1
            if self.stereo:
                self.api.add_frame_stereo(self.time_of(k), img[0], img[1])
            else:
                self.api.add_frame_mono(self.time_of(k), img[0])
        self.call_s.append(time.perf_counter() - t0)
        self.f += 1
        return self.round, self.f - 1

    def drain(self, keys) -> None:
        """Feed later frames until every frame of ``keys`` ((round, frame))
        has its output, at most ``drain_frames`` of them (the synchronizer
        holds a frame until later ones come), then retire every frame in
        flight."""
        for _ in range(self.workload["drain_frames"]):
            done = {(o[0], o[1]) for o in self.outputs}
            if all(k in done for k in keys):
                break
            self.feed_one()
        self.api.wait_idle()


def run(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run of an online cell, as ``lanes.run``'s."""
    s = Stream(cell, seed, device)
    for _ in range(cell.workload["warmup_frames"]):
        s.feed_one()
    program.settle(device)
    setup_done = time.perf_counter()
    first = len(s.call_s)
    graphs = [g for g in (s.api._step, s.api._imu_only) if hasattr(g, "captures")]
    captures = sum(g.captures for g in graphs)
    window_frames = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        window_frames.append(s.feed_one())
    s.drain(window_frames)
    captures = sum(g.captures for g in graphs) - captures
    peak = torch.cuda.max_memory_allocated(device) if s.device.type == "cuda" else 0
    got = {(r, f): (t, pos) for r, f, t, pos in s.outputs}
    lat = [1e3 * (got[key][0] - s.calls[key]) for key in window_frames if key in got]
    failed = sum(1 for key in window_frames
                 if key not in got or not np.isfinite(got[key][1]).all())
    record = {"path": "online", "api_call_ms": 1e3 * float(np.mean(s.call_s[first:]))}
    if trace and s.device.type == "cuda":
        program.reset_launches()
        s.spans = True
        with profile_block() as prof:
            with torch.profiler.record_function("bench.window"):
                traced = []
                for _ in range(cell.workload["trace_steps"]):
                    traced.append(s.feed_one())
                s.drain(traced)
        s.spans = False
        record["trace"] = read_profile(prof)
        record["launches"] = program.launches()
        record["stages_ms"] = api_stages(s, STAGE_REPS)

    # the check: poses per round, the last pyramid
    idx = s.seq.frame_sample_idx
    poses = []
    for r in sorted({o[0] for o in s.outputs}):
        outs = sorted((o for o in s.outputs if o[0] == r), key=lambda o: o[1])
        poses.append((0, idx[[o[1] for o in outs]], np.stack([o[3] for o in outs])))
    # the state's pyramid is of the last frame stepped: every stepped frame
    # has been retired (wait_idle), so it is the last output's frame
    ts = s.api._state.tracker
    left = torch.as_tensor(s.host[s.outputs[-1][1]][0][None])
    pyramid = (left, [p.detach().clone() for p in ts.prev_pyr],
               [(x.detach().clone(), y.detach().clone()) for x, y in zip(ts.prev_ix, ts.prev_iy)])
    seqs = [s.seq]
    s.api.finish()
    del s, ts
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers, details = check.numbers(seqs, poses, pyramid)
    return {
        "setup_done": setup_done,
        "e2e": {"frame_ms_p95": timing.tail_ms(lat, 95.0)},
        "attempted": len(window_frames),
        "failed": failed,
        "memory_peak_bytes": peak,
        "record": record,
        "numbers": numbers,
        "details": dict(details, **{f"frame_ms_p{q}": timing.tail_ms(lat, q) for q in (50, 90)},
                        frame_ms_max=timing.tail_ms(lat, 100.0),
                        window_frames=len(window_frames), captures_in_window=captures),
    }


def api_stages(s: Stream, reps: int) -> dict:
    """The stage split at the API's shapes (one lane, its IMU batch of
    ``S`` columns with the bucketed count a frame's samples give), from the
    API's state."""
    from hybvio_tpu_torch.odometry.backend import bucket_n_valid

    api, dev = s.api, s.device
    S = api.S
    k = s.seq.frame_sample_idx[min(s.f, s.F - 1)]
    n = int(s.seq.frame_sample_idx[1] - s.seq.frame_sample_idx[0])
    f64 = dict(dtype=api._dtype, device=dev)
    t = torch.full((1, S), s.time_of(k), **f64)
    t[0, :n] = torch.as_tensor([s.time_of(j) for j in range(k - n + 1, k + 1)], **f64)
    g = torch.zeros((1, S, 3), **f64)
    a = torch.zeros((1, S, 3), **f64)
    g[0, :n] = torch.as_tensor(s.seq.gyro[k - n + 1:k + 1], **f64)
    a[0, :n] = torch.as_tensor(s.seq.acc[k - n + 1:k + 1], **f64)
    valid = torch.arange(S, device=dev)[None] < n
    img = s.frames[min(s.f, s.F - 1)].to(dev)
    images = (img[0][None], img[1][None] if s.stereo else None)
    return program.stage_split(api._vio, api._state, program.imu_batch(t, g, a, valid), images,
                               reps, n_valid=bucket_n_valid(n, S))
