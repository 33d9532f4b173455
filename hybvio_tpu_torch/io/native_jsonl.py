"""ctypes bindings for the native (C++) JSONL dataset reader (port of the
reference package's ``io/native_jsonl.py``).

The native library (``native/jsonl_reader.cpp``, built by
``utils/native.py``) scans a data.jsonl once and returns the high-rate
sensor/frame events as packed numpy arrays (reference equivalent:
src/commandline/input_jsonl.cpp parsing with nlohmann-json on the input
thread). Every other line comes back as an echo event, a byte range that
``echo_json`` parses lazily: the ground truth, pose and GPS lines, and also
the calibration lines the Python reader skips. ``io/jsonl.py
read_jsonl_events`` dispatches here first, as the reference's does.
"""
from __future__ import annotations

import ctypes
import json
from typing import Iterator, Optional

import numpy as np

from ..utils import native

KIND_GYRO = 0
KIND_ACC = 1
KIND_FRAME = 2
KIND_ECHO = 3

_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_SIGNATURES = {  # name -> (restype, argtypes)
    "hyb_jsonl_open": (ctypes.c_void_p, [ctypes.c_char_p]),
    "hyb_jsonl_num_events": (ctypes.c_int64, [ctypes.c_void_p]),
    "hyb_jsonl_num_frames": (ctypes.c_int64, [ctypes.c_void_p]),
    "hyb_jsonl_events": (None, [ctypes.c_void_p, _I32, _F64, _F64, _I32, _I32, _I32, _I64,
                                _I64]),
    "hyb_jsonl_frames": (None, [ctypes.c_void_p, _F64, _I32, _I32]),
    "hyb_jsonl_close": (None, [ctypes.c_void_p]),
}


class PackedEvents:
    """Packed event arrays for one data.jsonl file."""

    def __init__(self, kind, time, values, frame_begin, frame_count,
                 frames_index, line_off, line_len, frames, frame_cam, frame_number, path):
        self.kind = kind          # (N,) int32, KIND_*
        self.time = time          # (N,) float64
        self.values = values      # (N, 3) float64 (gyro/acc)
        self.frame_begin = frame_begin  # (N,) int32 index into frames
        self.frame_count = frame_count  # (N,) int32
        self.frames_index = frames_index  # (N,) int32 frame-group "number"
        self.line_off = line_off  # (N,) int64 byte offsets (echo laziness)
        self.line_len = line_len
        self.frames = frames      # (F, 5) float64: t, fx, fy, px, py
        self.frame_cam = frame_cam  # (F,) int32
        self.frame_number = frame_number  # (F,) int32
        self.path = path

    def echo_json(self, i: int) -> dict:
        """Lazily parse the raw line of event i (KIND_ECHO)."""
        with open(self.path, "rb") as f:
            f.seek(int(self.line_off[i]))
            raw = f.read(int(self.line_len[i]))
        return json.loads(raw)


def read_packed(path: str) -> Optional[PackedEvents]:
    """Parse a data.jsonl natively into packed arrays; None if the library
    is unavailable or cannot open the file."""
    lib = native.bind(_SIGNATURES)
    if lib is None:
        return None
    h = lib.hyb_jsonl_open(path.encode())
    if not h:
        return None
    try:
        n = int(lib.hyb_jsonl_num_events(h))
        nf = int(lib.hyb_jsonl_num_frames(h))
        kind = np.empty(n, np.int32)
        time = np.empty(n, np.float64)
        values = np.empty((n, 3), np.float64)
        frame_begin = np.empty(n, np.int32)
        frame_count = np.empty(n, np.int32)
        frames_index = np.empty(n, np.int32)
        line_off = np.empty(n, np.int64)
        line_len = np.empty(n, np.int64)
        if n:
            lib.hyb_jsonl_events(h, kind, time, values.reshape(-1), frame_begin, frame_count,
                                 frames_index, line_off, line_len)
        frames = np.empty((nf, 5), np.float64)
        frame_cam = np.empty(nf, np.int32)
        frame_number = np.empty(nf, np.int32)
        if nf:
            lib.hyb_jsonl_frames(h, frames.reshape(-1), frame_cam, frame_number)
        return PackedEvents(kind, time, values, frame_begin, frame_count, frames_index,
                            line_off, line_len, frames, frame_cam, frame_number, path)
    finally:
        lib.hyb_jsonl_close(h)


def iter_events(path: str) -> Optional[Iterator]:
    """Yield InputEvent objects from the native packed arrays (the stream
    of ``io.jsonl.read_jsonl_events``, echo events included); None when the
    library is unavailable."""
    pe = read_packed(path)
    if pe is None:
        return None
    from .jsonl import ACCELEROMETER, ECHO, FRAME, GYROSCOPE, InputEvent, InputFrame

    def gen():
        for i in range(pe.kind.shape[0]):
            k = int(pe.kind[i])
            if k == KIND_GYRO or k == KIND_ACC:
                v = pe.values[i]
                yield InputEvent(GYROSCOPE if k == KIND_GYRO else ACCELEROMETER,
                                 float(pe.time[i]),
                                 values=(float(v[0]), float(v[1]), float(v[2])))
            elif k == KIND_FRAME:
                b = int(pe.frame_begin[i])
                c = int(pe.frame_count[i])
                frames = []
                for j in range(b, b + c):
                    t, fx, fy, px, py = (float(x) for x in pe.frames[j])
                    frames.append(InputFrame(
                        camera_ind=int(pe.frame_cam[j]), t=t,
                        focal_length_x=fx, focal_length_y=fy,
                        principal_point_x=px, principal_point_y=py,
                        number=int(pe.frame_number[j])))
                yield InputEvent(FRAME, frames[0].t, frames=frames,
                                 frames_index=int(pe.frames_index[i]))
            else:  # echo: parse the single line lazily
                yield InputEvent(ECHO, float(pe.time[i]), raw=pe.echo_json(i))

    return gen()
