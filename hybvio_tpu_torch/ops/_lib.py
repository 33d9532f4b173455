"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every source for ``sm_90a`` (one process
per source, all at once) and links them into one shared library with a
plain C interface under ``build/`` at the repository root, and ``ctypes``
loads it. Each C entry point launches on the stream it is
given and returns ``cudaGetLastError()``. Nothing here runs at import: the
CPU tests import every module and never build.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
LIB_PATH = BUILD_DIR / "libhybvio_tpu_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC"]

# kernel name -> launches since the last reset (counted by the wrappers)
LAUNCHES = {"patch_gather": 0, "pyr_down": 0, "scharr": 0,
            "corner_response": 0, "greedy_nms": 0}

_P = ctypes.c_void_p
_SIGNATURES = {
    "hv_patch_gather": [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, _P, _P],
    "hv_pyr_down": [_P, ctypes.c_int, ctypes.c_int, _P, _P],
    "hv_scharr": [_P, ctypes.c_int, ctypes.c_int, _P, _P, _P],
    "hv_corner_response": [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P],
    "hv_greedy_nms": [_P, ctypes.c_longlong, _P, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, _P, _P],
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


def launch(kernel: str, fn_name: str, *args) -> None:
    """Call a C entry point on the current stream; raise if the launch
    failed; count it."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err}")
    LAUNCHES[kernel] += 1


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def require_cuda(*tensors, dtype=None) -> None:
    """Raise unless every tensor is on one CUDA device (and of ``dtype``)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"expected CUDA tensors on one device, got {t.device}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"expected {dtype}, got {t.dtype}")
