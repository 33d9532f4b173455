"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every source for ``sm_90a`` (one process
per source, all at once) and links them into one shared library with a
plain C interface under ``build/`` at the repository root, and ``ctypes``
loads it. Each C entry point launches on the stream it is
given and returns ``cudaGetLastError()``. Nothing here runs at import: the
CPU tests import every module and never build.

A launch made while a CUDA graph is captured (``recording_launches``, in
the capturing thread) runs at each replay, not then: it is recorded, not
counted, and the graph adds its record to the counts at every replay
(``add_launches``).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
LIB_PATH = BUILD_DIR / "libhybvio_tpu_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC"]

# kernel name -> launches since the last reset (counted by the wrappers)
LAUNCHES = {"patch_gather": 0, "pyr_down": 0, "scharr": 0, "pyramid_scharr": 0,
            "corner_response": 0, "greedy_nms": 0}
# (kernel name, input shape the wrapper names) -> launches since the last reset
SHAPE_LAUNCHES = {}

_P = ctypes.c_void_p
_SIGNATURES = {
    "hv_patch_gather": [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, _P, _P],
    "hv_pyramid": [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, _P, _P],
    "hv_pyramid_scharr": [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_int, _P],
    "hv_scharr": [_P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P, _P, _P],
    "hv_corner_response": [_P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, _P, _P],
    "hv_greedy_nms": [_P, ctypes.c_longlong, _P, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, _P, _P],
    "hv_empty": [_P],
    "hv_mark_stage": [ctypes.c_int, _P],
}

_loaded = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def build(force: bool = False) -> float:
    """Compile the kernels if the library is missing or older than a
    source; returns the seconds spent compiling (0 when up to date)."""
    sources = sorted(CSRC.glob("*.cu"))
    if (not force and LIB_PATH.exists()
            and LIB_PATH.stat().st_mtime >= max(s.stat().st_mtime for s in sources)):
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    objects = [BUILD_DIR / (s.stem + ".o") for s in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for s, o in zip(sources, objects)]
    failed = []
    for s, proc in zip(sources, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{s.name} ({proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = LIB_PATH.with_suffix(".so.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0


def library():
    """The loaded kernel library (built on first use)."""
    if "lib" not in _loaded:
        build()
        lib = ctypes.CDLL(str(LIB_PATH))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded["lib"] = lib
    return _loaded["lib"]


_capture = threading.local()  # .record: the Counter of the capture this thread makes


def launch(kernel: str, fn_name: str, *args, shape: tuple) -> None:
    """Call a C entry point on the current stream; raise if the launch
    failed; count it, in total and for its input ``shape`` (or, inside
    ``recording_launches``, record it)."""
    _call(fn_name, *args)
    record = getattr(_capture, "record", None)
    if record is not None:
        record[(kernel, shape)] += 1
        return
    add_launches({(kernel, shape): 1})


def add_launches(record) -> None:
    """Count the launches of a record ((kernel, shape) -> launches)."""
    for (kernel, shape), n in record.items():
        LAUNCHES[kernel] += n
        SHAPE_LAUNCHES[(kernel, shape)] = SHAPE_LAUNCHES.get((kernel, shape), 0) + n


@contextlib.contextmanager
def recording_launches():
    """A block whose launches in this thread are recorded in the Counter it
    yields ((kernel, shape) -> launches), not counted: a graph capture's."""
    saved = getattr(_capture, "record", None)
    _capture.record = collections.Counter()
    try:
        yield _capture.record
    finally:
        _capture.record = saved


def launch_empty() -> None:
    """Launch the empty kernel (the card's per-launch floor); not counted."""
    _call("hv_empty")


STAGE_MARKS = ("imu", "frontend")  # the step's stage markers, in its order


def mark_stage(stage: str, like: torch.Tensor) -> None:
    """Launch the empty kernel that marks the end of ``stage`` of the step
    (``hv_mark_<stage>_done`` on the profiler's timeline) on the current
    stream, where ``like`` is on the card; not counted; nothing on the CPU.
    A capture records it like any kernel, so every replay carries it."""
    if like.device.type == "cuda":
        _call("hv_mark_stage", STAGE_MARKS.index(stage))


def _call(fn_name: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err}")


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SHAPE_LAUNCHES.clear()


def lane_layout(images):
    """(lanes, lane stride in elements) of one or more images of one shape,
    each (H, W) (one lane, stride 0) or (B, H, W) with contiguous rows and
    one lane stride for all of them; raises on any other layout."""
    shape = images[0].shape
    if any(img.shape != shape for img in images) or len(shape) not in (2, 3):
        raise ValueError(f"expected (H, W) or (B, H, W) images of one shape, got "
                         f"{[tuple(i.shape) for i in images]}")
    W = shape[-1]
    for img in images:
        if img.stride(-1) != 1 or img.stride(-2) != W:
            raise ValueError(f"image rows must be contiguous, got strides {img.stride()}")
    if len(shape) == 2:
        return 1, 0
    strides = {img.stride(0) if shape[0] > 1 else 0 for img in images}
    if len(strides) != 1:
        raise ValueError(f"the images' lanes must share one stride, got {sorted(strides)}")
    return shape[0], strides.pop()


def require_cuda(*tensors, dtype=None) -> None:
    """Raise unless every tensor is on one CUDA device (and of ``dtype``)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"expected CUDA tensors on one device, got {t.device}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"expected {dtype}, got {t.dtype}")
