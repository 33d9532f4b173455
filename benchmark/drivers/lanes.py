"""Offline traffic: B recorded sequences evaluated together on one card,
one lane each, through the port's batched step with a frame of its own
per lane.

The configuration gives the lanes, one per sequence of its set
(``sequences``, B), and the frames of a round of every sequence
(``sequence_frames``); the workload file the steps of the traced window
(``trace_steps``).

Set-up draws B worlds from the seed, renders every frame of a round on the
card as the sensors' 8-bit images, stages the IMU batches there, starts
the lanes (``init``) on frame 0 and steps frame 1 (the step's eager run and
its capture). The window then steps frames 2, 3, ... in a closed loop:
each step is queued as soon as the host may, and the window ends on a
synchronize once its seconds have passed. A round that ends inside the
window starts again with ``init`` on frame 0, in the window.
"""
from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch

from .. import check, program, timing, world
from ..trace import profile_block, read_profile

MAX_AHEAD = 2  # steps the host may queue before it waits for the oldest
STAGE_REPS = 10  # replays a stage is timed over in the traced run


def stage_world(config: dict, seed: int, device):
    """(sequences, F frames (B, C, H, W) uint8 on ``device``, F IMU batches
    (B, S) on ``device``)."""
    cam = config["camera"]
    F, B = config["sequence_frames"], config["sequences"]
    seqs = world.lane_worlds(seed, B, config["world"], F, cam["rate_hz"], config["imu_rate_hz"])
    render = world.make_renderer(cam, device)
    landmarks = torch.as_tensor(np.stack([s.landmarks for s in seqs]), dtype=torch.float32,
                                device=device)
    idx = seqs[0].frame_sample_idx
    # one allocation a frame: every step's inputs share one layout, so the
    # captured step has one signature whatever the frame
    frames = []
    for f in range(F):
        k = idx[f]
        frames.append(world.to_u8(render(landmarks, np.stack([s.pos[k] for s in seqs]),
                                         np.stack([s.quat[k] for s in seqs]))))
    # frame f's IMU window: the samples after frame f - 1's, up to its own
    S = int(idx[1] - idx[0])
    first = idx[0] + 1 - S
    f32 = dict(dtype=torch.float32, device=device)
    t = np.stack([s.times[first:first + F * S] for s in seqs]).reshape(B, F, S)
    g = np.stack([s.gyro[first:first + F * S] for s in seqs]).reshape(B, F, S, 3)
    a = np.stack([s.acc[first:first + F * S] for s in seqs]).reshape(B, F, S, 3)
    valid = torch.ones((B, S), dtype=torch.bool, device=device)
    imu = [program.imu_batch(torch.as_tensor(t[:, f], **f32), torch.as_tensor(g[:, f], **f32),
                             torch.as_tensor(a[:, f], **f32), valid.clone())
           for f in range(F)]
    return seqs, frames, imu


def frame_at(frames, f):
    """The step's frame input: a (left, right) pair of (B, H, W) images, or
    one image."""
    x = frames[f]
    return (x[:, 0], x[:, 1]) if x.shape[1] == 2 else x[:, 0]


class Lanes:
    """The stepping loop of one run, and what it kept for the check."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.device = cell, torch.device(device)
        self.workload, self.config = cell.workload, cell.config
        self.B, self.F = self.config["sequences"], self.config["sequence_frames"]
        self.seqs, self.frames, self.imu = stage_world(self.config, seed, device)
        self.init, self.step, self.vio = program.batched_vio(self.config, self.B, device)
        rng = np.random.RandomState(np.random.SeedSequence([int(seed), 1]).generate_state(1)[0])
        self.lane_seeds = rng.randint(0, 2**31 - 1, size=self.B)
        self.t0s = np.full(self.B, float(self.seqs[0].frame_times[0]))
        self.rounds = []  # per round: the frames stepped and their positions
        self.state = None
        self.f = 0

    def start_round(self):
        self.state = self.init(frame_at(self.frames, 0), self.t0s, self.lane_seeds)
        self.rounds.append([])
        self.f = 1

    def step_once(self):
        if self.f == self.F:
            self.start_round()
        self.state, out = self.step(self.state, self.imu[self.f],
                                    frame_at(self.frames, self.f))
        self.rounds[-1].append((self.f, out.position))
        self.f += 1

    def loop(self, seconds=None, steps=None, events=None, spans=False):
        """Step until ``seconds`` have passed or ``steps`` are done, with at
        most ``MAX_AHEAD`` steps queued; ends on a synchronize. Returns
        (steps, wall s). ``events`` collects a pair of CUDA events around
        each step; ``spans`` names the host's work for the profiler."""
        ahead = collections.deque()
        cuda = self.device.type == "cuda"
        span = torch.profiler.record_function if spans else contextlib.nullcontext
        n = 0
        t0 = time.perf_counter()
        while True:
            with span("bench.step"):
                if events is not None:
                    a = torch.cuda.Event(enable_timing=True)
                    a.record()
                self.step_once()
                if events is not None:
                    b = torch.cuda.Event(enable_timing=True)
                    b.record()
                    events.append((a, b))
            n += 1
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                ahead.append(ev)
                if len(ahead) > MAX_AHEAD:
                    with span("bench.pace"):
                        ahead.popleft().synchronize()
            if steps is not None and n >= steps:
                break
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
        with span("bench.sync"):
            t1 = program.settle(self.device)
        return n, t1 - t0

    def outputs(self):
        """(poses, the last frame's left images (B, H, W) uint8, the
        state's pyramid)."""
        idx = self.seqs[0].frame_sample_idx
        poses = []
        for outs in self.rounds:
            if not outs:
                continue
            fs = [f for f, _ in outs]
            pos = torch.stack([p for _, p in outs]).cpu().numpy()  # (N, B, 3)
            poses.extend((b, idx[fs], pos[:, b]) for b in range(self.B))
        ts = self.state.tracker
        left = self.frames[self.f - 1][:, 0]
        return poses, left, (ts.prev_pyr, list(zip(ts.prev_ix, ts.prev_iy)))


def run(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run of an offline cell: {"setup_done" (host clock), "e2e",
    "attempted", "failed", "memory_peak_bytes", "record" (for the
    per-layer readers), "numbers" and "details" (of the check)}."""
    lanes = Lanes(cell, seed, device)
    lanes.start_round()
    lanes.step_once()  # the step's eager run and its capture
    program.settle(device)
    setup_done = time.perf_counter()

    events = [] if trace else None
    captures = sum(g.captures for g in lanes.step.graphs)
    steps, wall = lanes.loop(seconds=seconds, events=events)
    captures = sum(g.captures for g in lanes.step.graphs) - captures
    peak = torch.cuda.max_memory_allocated(device) if lanes.device.type == "cuda" else 0
    window = [p for outs in lanes.rounds for _, p in outs][1:1 + steps]  # after the warm-up
    failed = int((~torch.isfinite(torch.stack(window)).all(dim=-1)).sum())
    record = {"path": "offline"}
    if trace:
        record["replay_ms"] = sum(a.elapsed_time(b) for a, b in events) / len(events)
        if lanes.device.type == "cuda":
            program.reset_launches()
            with profile_block() as prof:
                with torch.profiler.record_function("bench.window"):
                    lanes.loop(steps=cell.workload["trace_steps"], spans=True)
            record["trace"] = read_profile(prof)
            record["launches"] = program.launches()
            f = lanes.f if lanes.f < lanes.F else 1
            record["stages_ms"] = program.stage_split(
                lanes.vio, lanes.state, lanes.imu[f], _pair(frame_at(lanes.frames, f)),
                STAGE_REPS)

    poses, left, pyr = lanes.outputs()
    pyramid = (left, [p.detach().clone() for p in pyr[0]],
               [(x.detach().clone(), y.detach().clone()) for x, y in pyr[1]])
    seqs = lanes.seqs
    del lanes, pyr, events, window
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers, details = check.numbers(seqs, poses, pyramid)
    return {
        "setup_done": setup_done,
        "e2e": {"frames_per_s": timing.rate(steps * len(seqs), wall)},
        "attempted": steps * len(seqs),
        "failed": failed,
        "memory_peak_bytes": peak,
        "record": record,
        "numbers": numbers,
        "details": dict(details, captures_in_window=captures),
    }


def _pair(frame):
    return frame if isinstance(frame, tuple) else (frame, None)
