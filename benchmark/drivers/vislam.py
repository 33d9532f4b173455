"""Online VISLAM traffic: one mono camera and IMU streamed through the
port's host entry point, ``VioApi``, with the SLAM session on
(``slam.useSlam``, HybVIO's ``-useSlam``), as ``drivers/api.py`` streams
it (its ``Stream``: the same world, frames, closed loop and latency).

A workload file of this driver gives, beside ``api``'s keys,
``slam_programs``: the session's programs the stream runs (``graphs``
names), each of which set-up leaves captured; and ``ba_err_limit``.

Set-up feeds ``warmup_frames`` frames, then more, 8 at a time, until the
SLAM map holds at least ``adjacentSpaceSize + 1`` keyframes once its
culling is done (each later keyframe is the map's ``adjacentSpaceSize +
2``-th or more when it queries: loop retrieval runs on every keyframe of
the window) and every program of ``slam_programs`` is captured: the two
the stream reaches only on a revisit or a retrain, the loop matcher and
the vocabulary's k-means, are warmed on the map as it stands
(``Slam.warm_programs``).

With ``--trace 1`` the span recorder is on over the untraced window and
off under the profiler; its records are drained, the SLAM worker idle,
before the traced block, and summarized in the record. The record is the
``online`` path's as ``api.run`` leaves it (``api_call_ms``, ``trace``,
``launches``, ``stages_ms``) plus ``recorder``.

The check, after ``VioApi.finish()``: ``pose_err_m`` is the larger of the
output positions' error (``check.lane_pose_errs``, SLAM-corrected) and
the SLAM map's keyframes' error against the world's truth
(``reference_slam.map_pose_err``: inf where the window added no keyframe
or ran no local BA), and inf where ``ba_err``, the window's last local BA
against ``reference_slam``'s dense float64 one on the same problem, is
over ``ba_err_limit`` (``slam_pose_err``); ``pyramid_err`` as ``api``'s.
``details`` has ``ba_err`` and ``ba_err_float32``, the port's BA in float32
on the same problem (a lower precision that ``ba_err_limit`` refuses).
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from .. import check, program, reference_slam, timing, world
from ..trace import profile_block, read_profile
from .api import STAGE_REPS, Stream, api_stages


def require_program() -> None:
    """Fail before any set-up where the program lacks what this driver
    reads (the recorder's SLAM stages, ``Slam.last_local_ba`` and
    ``Slam.warm_programs`` came together)."""
    from hybvio_tpu_torch.utils import timer

    if not hasattr(timer, "slam_stage"):
        raise RuntimeError("the program lacks what the vislam driver reads: "
                           "utils.timer.slam_stage, Slam.last_local_ba, Slam.warm_programs")


def all_captures(session) -> int:
    """Captures so far of the VIO steps' graphs and the session's."""
    from hybvio_tpu_torch import graphs

    return sum(p.captures for p in graphs.STEP_POOLS.programs + session.graph_pools.programs)


def check_slam_params(s: Stream) -> None:
    """The session runs with the SLAM parameters the configuration states."""
    ps = s.api.params.slam
    wrong = {k: getattr(ps, k) for k, v in s.config["slam"].items() if getattr(ps, k) != v}
    if not ps.useSlam or wrong:
        raise RuntimeError(f"the SLAM parameters differ from the configuration's: {wrong}")


def uncaptured(session, wanted) -> list:
    """The programs of ``wanted`` (``graphs`` names) not yet captured."""
    captured = {p.name for p in session.graph_pools.programs if p.captures}
    return [n for n in wanted if n not in captured]


def set_up(s: Stream, workload: dict) -> int:
    """Feed the set-up frames (the module docstring); their count. On the
    CPU, where nothing is captured, the map alone decides."""
    wanted = workload["slam_programs"] if s.device.type == "cuda" else []
    coupling = s.api.slam
    session = coupling.slam
    fed = 0
    while True:
        n = 8 if fed else workload["warmup_frames"]
        for _ in range(n):
            s.feed_one()
        fed += n
        coupling.wait_idle()
        if len(session.kf_order) + 1 >= session.ps.adjacentSpaceSize + 2:
            session.warm_programs()
            if not uncaptured(session, wanted):
                return fed
        if fed >= 3 * workload["warmup_frames"]:
            raise RuntimeError(f"the SLAM map is not ready after {fed} frames "
                               f"(uncaptured: {uncaptured(session, wanted)})")


def slam_pose_err(output_err: float, map_err: float, ba_err: float, ba_err_limit: float) -> float:
    """``pose_err_m`` of a run: the larger of the outputs' and the map's
    errors; inf where ``ba_err``, the window's last local BA's distance
    from the dense float64 reference, is over ``ba_err_limit`` or not
    finite (a wrong or lower-precision BA is not correct)."""
    if not (np.isfinite(ba_err) and ba_err <= ba_err_limit):
        return float("inf")
    return max(output_err, map_err)


def summarize(recs: dict) -> dict:
    """The recorder's drain as {"ms": name -> mean duration, "n": name ->
    records, "counters", "dropped", "slam_stage_parents": the names of the
    spans that the session's stages opened inside}."""
    dur = collections.defaultdict(list)
    for r in recs["spans"]:
        dur[r["name"]].append(1e-6 * (r["end_ns"] - r["start_ns"]))
    names = {r["id"]: r["name"] for r in recs["spans"]}
    from hybvio_tpu_torch.utils import timer

    stages = set(timer.SLAM_SPANS.values())
    parents = sorted({names.get(r["parent"], "none") for r in recs["spans"]
                      if r["name"] in stages})
    return {"ms": {k: float(np.mean(v)) for k, v in sorted(dur.items())},
            "n": {k: len(v) for k, v in sorted(dur.items())},
            "counters": dict(recs["counters"]), "dropped": recs["dropped"],
            "slam_stage_parents": parents}


def map_plays(s: Stream, session) -> list:
    """(estimated, truth) camera centres of the map's keyframes, one pair a
    play of the stream."""
    i2c = world.camera_extrinsics(s.config["camera"])[0]
    idx = s.seq.frame_sample_idx
    plays = collections.defaultdict(list)
    for kid in session.kf_order:
        kf = session.keyframes[kid]
        r, f = s.frame_of(kf.t)
        if 0 <= f < s.F:
            plays[r].append((kf.pose[:3], idx[f]))
    out = []
    for r in sorted(plays):
        est = np.stack([p for p, _ in plays[r]])
        k = np.array([k for _, k in plays[r]])
        out.append((est, reference_slam.camera_centres(s.seq.pos[k], s.seq.quat[k], i2c)))
    return out


def run(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run of a VISLAM cell, as ``api.run``'s."""
    require_program()
    from hybvio_tpu_torch.slam.ba import BAProblem, ba_iterate
    from hybvio_tpu_torch.utils import timer

    w = cell.workload
    s = Stream(cell, seed, device)
    check_slam_params(s)
    coupling = s.api.slam
    session = coupling.slam
    setup_frames = set_up(s, w)
    program.settle(device)
    setup_done = time.perf_counter()
    first = len(s.call_s)
    captures = all_captures(session)
    kf0, ba0, map0 = session.next_kf_id, session.last_local_ba, len(session.kf_order)
    if trace:
        timer.drain()
        timer.enable()
    window_frames = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        window_frames.append(s.feed_one())
    s.drain(window_frames)
    record = {"path": "online", "api_call_ms": 1e3 * float(np.mean(s.call_s[first:]))}
    if trace:
        coupling.wait_idle()
        timer.disable()
        record["recorder"] = summarize(timer.drain())
    if trace and s.device.type == "cuda":
        program.reset_launches()
        s.spans = True
        with profile_block() as prof:
            with torch.profiler.record_function("bench.window"):
                traced = []
                for _ in range(w["trace_steps"]):
                    traced.append(s.feed_one())
                s.drain(traced)
        s.spans = False
        record["trace"] = read_profile(prof)
        record["launches"] = program.launches()
    coupling.wait_idle()
    captures = all_captures(session) - captures
    peak = torch.cuda.max_memory_allocated(device) if s.device.type == "cuda" else 0
    if trace and s.device.type == "cuda":
        record["stages_ms"] = api_stages(s, STAGE_REPS)  # after the count: it captures
    kf_added, ba_ran = session.next_kf_id - kf0, session.last_local_ba is not ba0
    got = {(r, f): (t, pos) for r, f, t, pos in s.outputs}
    lat = [1e3 * (got[key][0] - s.calls[key]) for key in window_frames if key in got]
    failed = sum(1 for key in window_frames
                 if key not in got or not np.isfinite(got[key][1]).all())

    # the window's last local BA against the dense float64 reference, and
    # the port's BA in float32 on the same problem (the precision control)
    ba_err = ba_err_f32 = float("inf")
    if session.last_local_ba is not None:
        prob, result = session.last_local_ba
        ba_err = reference_slam.ba_position_err(prob, result, device=s.device)
        f32 = BAProblem(*(torch.as_tensor(np.asarray(v)).to(
            s.device, torch.float32 if np.asarray(v).dtype == np.float64 else None)
            for v in prob))
        ba_err_f32 = reference_slam.ba_position_err(prob, ba_iterate(f32, iterations=8),
                                                    device=s.device)

    # the check: poses per round, the last pyramid, then the map
    idx = s.seq.frame_sample_idx
    poses = []
    for r in sorted({o[0] for o in s.outputs}):
        outs = sorted((o for o in s.outputs if o[0] == r), key=lambda o: o[1])
        poses.append((0, idx[[o[1] for o in outs]], np.stack([o[3] for o in outs])))
    ts = s.api._state.tracker
    left = torch.as_tensor(s.host[s.outputs[-1][1]][0][None])
    pyramid = (left, [p.detach().clone() for p in ts.prev_pyr],
               [(x.detach().clone(), y.detach().clone()) for x, y in zip(ts.prev_ix, ts.prev_iy)])
    seqs = [s.seq]
    s.api.finish()
    map_err = reference_slam.map_pose_err(map_plays(s, session), kf_added, ba_ran)
    map_keyframes = len(session.kf_order)
    del s, ts, session, coupling
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers, details = check.numbers(seqs, poses, pyramid)
    output_err = numbers["pose_err_m"]
    numbers["pose_err_m"] = slam_pose_err(output_err, map_err, ba_err, w["ba_err_limit"])
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
                        window_frames=len(window_frames), captures_in_window=captures,
                        setup_frames=setup_frames, pose_err_outputs_m=output_err,
                        pose_err_map_m=map_err, keyframes_in_window=kf_added,
                        local_ba_in_window=ba_ran, map_keyframes_at_window=map0,
                        map_keyframes=map_keyframes, ba_err=ba_err, ba_err_float32=ba_err_f32,
                        ba_err_limit=w["ba_err_limit"],
                        **{k: (record.get("recorder") or {}).get(v) for k, v in (
                            ("slam_counters", "counters"), ("recorder_ms", "ms"),
                            ("slam_stage_parents", "slam_stage_parents"))}),
    }
