"""Direct EuRoC MAV dataset (ASL / mav0 layout) reader (port of the
reference package's ``io/euroc.py``, host-side numpy).

The original C++ system consumes EuRoC only after conversion to its JSONL
format. This module reads the raw ASL layout directly, producing the same
``InputEvent`` stream as ``read_jsonl_events`` plus per-camera calibration,
so EuRoC sequences run without a conversion step:

    mav0/
      cam0/data.csv          # timestamp [ns], filename
      cam0/data/*.png
      cam0/sensor.yaml       # intrinsics, distortion, T_BS (IMU->cam extrinsic)
      cam1/...
      imu0/data.csv          # timestamp [ns], w_xyz [rad/s], a_xyz [m/s^2]
      state_groundtruth_estimate0/data.csv   # timestamp, p, q(wxyz), v, bw, ba

Calibration conventions: sensor.yaml's T_BS is body(=IMU)->sensor pose of the
sensor in the body frame; the filter wants imuToCamera = T_BS^-1 (reference
uses the same matrix via its converted JSONL "imuToCamera" field).
"""
from __future__ import annotations

import csv
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np

from .jsonl import (ACCELEROMETER, ECHO, FRAME, GYROSCOPE, InputEvent,
                    InputFrame)

NS = 1e-9


@dataclass
class EurocCameraCalib:
    width: int = 0
    height: int = 0
    focal_length_x: float = 0.0
    focal_length_y: float = 0.0
    principal_point_x: float = 0.0
    principal_point_y: float = 0.0
    model: str = "pinhole"            # "pinhole" (+radial-tangential) only in EuRoC
    distortion: List[float] = field(default_factory=list)
    imu_to_camera: Optional[np.ndarray] = None  # 4x4


def _parse_simple_yaml(path: str) -> dict:
    """Tiny parser for the flat EuRoC sensor.yaml files (no external deps).

    Handles scalars, inline flow lists ([...]) possibly spanning lines, and
    one level of nesting (T_BS: {rows,cols,data}).
    """
    out: dict = {}
    stack = [out]
    indents = [0]
    with open(path) as f:
        text = f.read()
    # join multi-line flow sequences
    text = re.sub(r"\[[^\]]*\]", lambda m: m.group(0).replace("\n", " "), text)
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip() or line.lstrip().startswith("%"):
            continue
        indent = len(line) - len(line.lstrip())
        key, _, val = line.lstrip().partition(":")
        val = val.strip()
        while indent < indents[-1]:
            stack.pop()
            indents.pop()
        cur = stack[-1]
        if not val:
            child: dict = {}
            cur[key] = child
            stack.append(child)
            indents.append(indent + 1)
            continue
        if val.startswith("["):
            items = [v.strip() for v in val.strip("[]").split(",") if v.strip()]
            try:
                cur[key] = [float(v) for v in items]
            except ValueError:
                cur[key] = items
        else:
            try:
                cur[key] = float(val) if "." in val or "e" in val.lower() else int(val)
            except ValueError:
                cur[key] = val
    return out


def read_camera_calib(cam_dir: str) -> EurocCameraCalib:
    y = _parse_simple_yaml(os.path.join(cam_dir, "sensor.yaml"))
    c = EurocCameraCalib()
    res = y.get("resolution", [0, 0])
    c.width, c.height = int(res[0]), int(res[1])
    intr = y.get("intrinsics", [0.0, 0.0, 0.0, 0.0])
    c.focal_length_x, c.focal_length_y = float(intr[0]), float(intr[1])
    c.principal_point_x, c.principal_point_y = float(intr[2]), float(intr[3])
    c.distortion = [float(v) for v in y.get("distortion_coefficients", [])]
    model = str(y.get("distortion_model", "radial-tangential"))
    c.model = "kannala-brandt" if "equi" in model else "pinhole"
    tbs = y.get("T_BS", {})
    data = tbs.get("data") if isinstance(tbs, dict) else None
    if data is not None and len(data) == 16:
        T_BS = np.asarray(data, dtype=np.float64).reshape(4, 4)
        c.imu_to_camera = np.linalg.inv(T_BS)
    return c


def _read_csv_rows(path: str) -> Iterator[List[str]]:
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].lstrip().startswith("#"):
                continue
            yield [v.strip() for v in row]


def read_euroc_events(mav_dir: str, cameras: int = 2) -> Iterator[InputEvent]:
    """Merged, time-ordered InputEvent stream from a mav0 directory.

    Frame events carry ``raw={"paths": [cam0_png, cam1_png, ...]}`` so the
    caller can load images lazily. Ground truth (when present) is emitted as
    ECHO events matching the JSONL reader's groundTruth convention.
    """
    events: List[InputEvent] = []

    imu_csv = os.path.join(mav_dir, "imu0", "data.csv")
    if os.path.exists(imu_csv):
        for row in _read_csv_rows(imu_csv):
            t = int(row[0]) * NS
            w = tuple(float(v) for v in row[1:4])
            a = tuple(float(v) for v in row[4:7])
            events.append(InputEvent(kind=GYROSCOPE, t=t, values=w))
            events.append(InputEvent(kind=ACCELEROMETER, t=t, values=a))

    # frames: join cam0/cam1 rows by timestamp (EuRoC cams are synchronized)
    cam_rows: List[Dict[int, str]] = []
    by_time: Dict[int, Dict[int, str]] = {}
    for ci in range(cameras):
        cam_csv = os.path.join(mav_dir, f"cam{ci}", "data.csv")
        if not os.path.exists(cam_csv):
            continue
        for row in _read_csv_rows(cam_csv):
            ts = int(row[0])
            fn = row[1] if len(row) > 1 else f"{ts}.png"
            by_time.setdefault(ts, {})[ci] = os.path.join(
                mav_dir, f"cam{ci}", "data", fn)
    number = 0
    for ts in sorted(by_time):
        paths = by_time[ts]
        t = ts * NS
        frames = [InputFrame(camera_ind=ci, t=t, number=number)
                  for ci in sorted(paths)]
        events.append(InputEvent(
            kind=FRAME, t=t, frames=frames,
            raw={"paths": [paths[ci] for ci in sorted(paths)]}))
        number += 1

    gt_csv = os.path.join(mav_dir, "state_groundtruth_estimate0", "data.csv")
    if os.path.exists(gt_csv):
        for row in _read_csv_rows(gt_csv):
            t = int(row[0]) * NS
            p = [float(v) for v in row[1:4]]
            q = [float(v) for v in row[4:8]]  # w, x, y, z
            events.append(InputEvent(kind=ECHO, t=t, raw={
                "time": t,
                "groundTruth": {
                    "position": {"x": p[0], "y": p[1], "z": p[2]},
                    "orientation": {"w": q[0], "x": q[1], "y": q[2], "z": q[3]},
                },
            }))

    events.sort(key=lambda e: (e.t, 0 if e.kind != FRAME else 1))
    yield from events


def read_euroc_calibration(mav_dir: str, cameras: int = 2) -> List[dict]:
    """Calibration dicts in the loader's calibration.json "cameras" format
    (config/loader.py): focal lengths, principal point, model, coeffs,
    imuToCamera row-major 4x4 list."""
    out = []
    for ci in range(cameras):
        cam_dir = os.path.join(mav_dir, f"cam{ci}")
        if not os.path.exists(os.path.join(cam_dir, "sensor.yaml")):
            continue
        c = read_camera_calib(cam_dir)
        d: dict = {
            "imageWidth": c.width,
            "imageHeight": c.height,
            "focalLengthX": c.focal_length_x,
            "focalLengthY": c.focal_length_y,
            "principalPointX": c.principal_point_x,
            "principalPointY": c.principal_point_y,
            "model": "kannala-brandt4" if c.model == "kannala-brandt" else "pinhole",
        }
        if c.model == "kannala-brandt":
            d["distortionCoefficients"] = (c.distortion + [0.0] * 4)[:4]
        else:
            # EuRoC radial-tangential: k1 k2 p1 p2 -> our pinhole k1 k2 k3
            # (tangential terms are ~1e-5 on EuRoC; dropped)
            ks = (c.distortion + [0.0] * 2)[:2]
            d["distortionCoefficients"] = [ks[0], ks[1], 0.0]
        if c.imu_to_camera is not None:
            d["imuToCameraMatrix"] = [
                [float(v) for v in row] for row in c.imu_to_camera]
        out.append(d)
    return out

