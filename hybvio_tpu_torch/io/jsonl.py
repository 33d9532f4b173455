"""JSONL dataset reading/writing, reference-format compatible (port of the
reference package's ``io/jsonl.py``: the reader, which dispatches to the
native bulk parser ``io/native_jsonl.py`` where the library loads and to
the Python loop elsewhere, and the legacy CSV reader ``read_csv_events``).

Input format (reference: src/commandline/input_jsonl.cpp): one JSON object per
line in ``data.jsonl``:
  {"time": t, "sensor": {"type": "gyroscope"|"accelerometer", "values": [x,y,z]}}
  {"time": t, "number": n, "frames": [{"cameraInd": 0, "time": t,
      "cameraParameters": {"focalLengthX": ..., ...}}, ...]}
  {"time": t, "groundTruth"|"ARKit"|"arcore"|...: {"position": {...},
      "orientation": {...}}}
  {"model": "...KANNALA_BRANDT4...", "coeffs": [...], "cameraInd": i}
  {"imuToCamera": [...column-major...] | [[row],[row],...], "cameraInd": i}

Output format matches api::outputToJson (reference: src/api/type_convert.cpp:
70-98): {"time", "position": {x,y,z}, "orientation": {w,x,y,z}, "velocity",
["poseTrail"]}.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

GYROSCOPE = "gyroscope"
ACCELEROMETER = "accelerometer"
FRAME = "frame"
ECHO = "echo"

_ECHO_KEYS = ("groundTruth", "ARKit", "arengine", "arcore", "realsense", "gps",
              "rtkgps", "zed", "output")


@dataclass
class InputFrame:
    camera_ind: int
    t: float
    focal_length_x: float = -1.0
    focal_length_y: float = -1.0
    principal_point_x: float = -1.0
    principal_point_y: float = -1.0
    number: int = -1


@dataclass
class InputEvent:
    kind: str
    t: float
    values: Optional[Tuple[float, float, float]] = None
    frames: Optional[List[InputFrame]] = None
    frames_index: int = -1
    raw: Optional[dict] = None


class JsonlEvents:
    """The events of one data.jsonl, iterated once, as a generator is;
    ``reader`` names the parser that yields them: "native" or "python"."""

    def __init__(self, path: str):
        from .native_jsonl import iter_events

        native = iter_events(path)
        self.reader = "python" if native is None else "native"
        self._events = python_events(path) if native is None else native

    def __iter__(self) -> Iterator[InputEvent]:
        return self._events

    def __next__(self) -> InputEvent:
        return next(self._events)


def read_jsonl_events(path: str) -> JsonlEvents:
    """Stream events from a data.jsonl file (reference: InputJSONL::nextType).

    Dispatches to the native (C++) bulk parser where the library loads (the
    reference parses input in C++ on the input thread, input_jsonl.cpp); it
    also yields an echo event for every line that is neither a sample nor a
    frame group. ``python_events`` is the behavioural spec and the
    fallback; ``.reader`` of the result says which ran."""
    return JsonlEvents(path)


def python_events(path: str) -> Iterator[InputEvent]:
    """The Python reader: samples, frame groups, and echo events for the
    pose and GPS lines (_ECHO_KEYS) only."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            j = json.loads(line)
            if "sensor" in j:
                t = float(j["time"])
                typ = j["sensor"]["type"]
                v = j["sensor"]["values"]
                if typ == GYROSCOPE:
                    yield InputEvent(GYROSCOPE, t, values=(v[0], v[1], v[2]))
                elif typ == ACCELEROMETER:
                    yield InputEvent(ACCELEROMETER, t, values=(v[0], v[1], v[2]))
            elif "frames" in j:
                frames = []
                for jf in j["frames"]:
                    cp = jf.get("cameraParameters") or {}
                    fx = cp.get("focalLengthX", -1.0)
                    fy = cp.get("focalLengthY", -1.0)
                    if (fx <= 0 or fy <= 0) and cp.get("focalLength"):
                        fx = fy = cp["focalLength"]
                    frames.append(InputFrame(
                        camera_ind=int(jf["cameraInd"]),
                        t=float(jf["time"]),
                        focal_length_x=fx, focal_length_y=fy,
                        principal_point_x=cp.get("principalPointX", -1.0),
                        principal_point_y=cp.get("principalPointY", -1.0),
                        number=int(jf.get("number", j.get("number", -1))),
                    ))
                if frames:
                    frames.sort(key=lambda fr: fr.camera_ind)
                    yield InputEvent(FRAME, frames[0].t, frames=frames,
                                     frames_index=int(j.get("number", -1)))
            elif any(k in j for k in _ECHO_KEYS):
                yield InputEvent(ECHO, float(j.get("time", 0.0)), raw=j)


def set_parameters_from_data(params, path: str) -> None:
    """Auto-detect fisheye coeffs / imuToCamera from the data file
    (reference: InputJSONL::setAlgorithmParametersFromData)."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            j = json.loads(line)
            if "model" in j and "KANNALA_BRANDT4" in str(j["model"]):
                coeffs = list(j["coeffs"])[:4]
                params.tracker.fisheyeCamera = True
                if j.get("cameraInd", 0) == 0:
                    params.tracker.distortionCoeffs = tuple(coeffs)
                else:
                    params.tracker.secondDistortionCoeffs = tuple(coeffs)
            if "imuToCamera" in j:
                v = j["imuToCamera"]
                if v and isinstance(v[0], list):
                    M = np.asarray(v, dtype=float)
                    flat = tuple(M.T.flatten())  # row-major nested -> col-major flat
                else:
                    flat = tuple(float(x) for x in v)
                if j.get("cameraInd", 0) == 0:
                    params.odometry.imuToCameraMatrix = flat
                else:
                    params.odometry.secondImuToCameraMatrix = flat


def get_pose_histories(path: str) -> Dict[str, np.ndarray]:
    """Extract pose histories (groundTruth / ARKit / ...) as (N, 8) arrays of
    [t, px, py, pz, qw, qx, qy, qz] (reference: InputJSONL::getPoseHistories)."""
    out: Dict[str, List[List[float]]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            j = json.loads(line)
            for k in _ECHO_KEYS:
                if k in j and isinstance(j[k], dict) and "position" in j[k]:
                    p = j[k]["position"]
                    q = j[k].get("orientation", {"w": 1, "x": 0, "y": 0, "z": 0})
                    out.setdefault(k, []).append([
                        float(j["time"]), p["x"], p["y"], p["z"],
                        q.get("w", 1.0), q.get("x", 0.0), q.get("y", 0.0), q.get("z", 0.0)])
    return {k: np.asarray(v) for k, v in out.items()}


def output_to_json(t, position, orientation, velocity, pose_trail=None,
                   extras: Optional[dict] = None) -> str:
    """Serialize one output pose (reference: api::outputToJson)."""
    o = dict(extras) if extras else {}
    o["time"] = float(t)
    o["position"] = {"x": float(position[0]), "y": float(position[1]), "z": float(position[2])}
    o["orientation"] = {
        "w": float(orientation[0]), "x": float(orientation[1]),
        "y": float(orientation[2]), "z": float(orientation[3])}
    o["velocity"] = {"x": float(velocity[0]), "y": float(velocity[1]), "z": float(velocity[2])}
    if pose_trail is not None:
        o["poseTrail"] = [
            {
                "position": {"x": float(p[0]), "y": float(p[1]), "z": float(p[2])},
                "orientation": {"w": float(p[3]), "x": float(p[4]), "y": float(p[5]), "z": float(p[6])},
            }
            for p in pose_trail
        ]
    return json.dumps(o)


class Recorder:
    """Session recording: inputs to JSONL + frames to .npz, enabling
    deterministic replay (the reference's checkpoint/resume equivalent;
    reference: api.cpp:631-710 via jsonl-recorder)."""

    def __init__(self, out_dir: str, save_frames: bool = True):
        # accept either a directory or a path/to/recording.jsonl (reference:
        # -recordingPath takes a JSONL file path)
        if out_dir.endswith(".jsonl"):
            jsonl_path = out_dir
            out_dir = os.path.dirname(out_dir) or "."
        else:
            jsonl_path = os.path.join(out_dir, "data.jsonl")
        os.makedirs(out_dir, exist_ok=True)
        self.dir = out_dir
        self.f = open(jsonl_path, "w")
        self.save_frames = save_frames
        self.frame_count = 0

    def gyro(self, t, v):
        self.f.write(json.dumps(
            {"time": float(t), "sensor": {"type": GYROSCOPE, "values": [float(x) for x in v]}}) + "\n")

    def acc(self, t, v):
        self.f.write(json.dumps(
            {"time": float(t), "sensor": {"type": ACCELEROMETER, "values": [float(x) for x in v]}}) + "\n")

    def frame(self, t, images, camera_params: Optional[List[dict]] = None):
        n = self.frame_count
        self.frame_count += 1
        frames = []
        for ci, img in enumerate(images):
            if self.save_frames:
                np.save(os.path.join(self.dir, f"frame_{n:06d}_cam{ci}.npy"),
                        np.asarray(img, dtype=np.float32))
            fr = {"cameraInd": ci, "time": float(t)}
            if camera_params and ci < len(camera_params):
                fr["cameraParameters"] = camera_params[ci]
            frames.append(fr)
        self.f.write(json.dumps({"time": float(t), "number": n, "frames": frames}) + "\n")

    def ground_truth(self, t, position, orientation):
        self.f.write(json.dumps({
            "time": float(t),
            "groundTruth": {
                "position": {"x": float(position[0]), "y": float(position[1]), "z": float(position[2])},
                "orientation": {"w": float(orientation[0]), "x": float(orientation[1]),
                                "y": float(orientation[2]), "z": float(orientation[3])},
            }}) + "\n")

    def close(self):
        self.f.close()


# numeric sensor-type codes in the legacy CSV format
# (reference: src/commandline/input_csv.cpp:15-19)
CSV_FRAME = 1
CSV_GPS = 2
CSV_ACCELEROMETER = 3
CSV_GYROSCOPE = 4
CSV_ARKIT = 7


def read_csv_events(path: str) -> Iterator[InputEvent]:
    """Legacy CSV reader (reference: src/commandline/input_csv.cpp:128-193):
    rows of `t, type, ...` with numeric sensor-type codes.

      1 FRAME: t, 1, ind[, fx, fy, px, py[, cameraInd[, syncedInd]]]
      2 GPS:   t, 2, lat, lon, accuracy, alt   -> echo (pose-plot overlay)
      3 ACC /  4 GYRO: t, code, x, y, z
      7 ARKIT: t, 7, ind, x, y, z, ...[, fx@9, fy@10] — a FRAME row (iPhone
        recordings pair each ARKit pose with a video frame) that also feeds
        the ARKit pose-history overlay.
    """
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split(",")]
            if len(parts) < 2:
                continue
            v = [float(x) for x in parts]
            t = v[0]
            code = int(v[1])
            if code == CSV_GYROSCOPE:
                yield InputEvent(GYROSCOPE, t, values=(v[2], v[3], v[4]))
            elif code == CSV_ACCELEROMETER:
                yield InputEvent(ACCELEROMETER, t, values=(v[2], v[3], v[4]))
            elif code == CSV_FRAME:
                ind = int(v[2])
                fx = fy = px = py = -1.0
                if len(v) >= 7:
                    fx, fy, px, py = v[3], v[4], v[5], v[6]
                cam_ind = int(v[7]) if len(v) >= 8 else 0
                fr = InputFrame(camera_ind=cam_ind, t=t, focal_length_x=fx,
                                focal_length_y=fy, principal_point_x=px,
                                principal_point_y=py, number=ind)
                yield InputEvent(FRAME, t, frames=[fr], frames_index=ind)
            elif code == CSV_ARKIT:
                # overlay echo first (reference getPoseHistories reorders the
                # stored axes: input_csv.cpp:281-287)
                yield InputEvent(ECHO, t, raw={
                    "time": t,
                    "ARKit": {"position": {"x": v[5], "y": v[3], "z": v[4]}}})
                ind = int(v[2])
                fx = fy = -1.0
                if len(v) >= 11 and (v[9] + v[10]) > 0:
                    fx = fy = (v[9] + v[10]) / 2.0
                fr = InputFrame(camera_ind=0, t=t, focal_length_x=fx,
                                focal_length_y=fy, number=ind)
                yield InputEvent(FRAME, t, frames=[fr], frames_index=ind)
            elif code == CSV_GPS:
                yield InputEvent(ECHO, t, raw={
                    "time": t,
                    "gps": {"latitude": v[2], "longitude": v[3],
                            "accuracy": v[4],
                            "altitude": v[5] if len(v) >= 6 else 0.0}})
