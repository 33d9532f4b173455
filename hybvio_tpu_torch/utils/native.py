"""The port's native host library: the sample synchronizer, the JSONL
reader and the multi-scale ORB detector (``native/sample_sync.cpp``,
``jsonl_reader.cpp`` and ``orb_detect.cpp`` in this package, its own copies
of the reference package's sources), built by ``g++`` into
``build/libhybvio_native.so`` at the repository root at first use, with the
reference's flags (``-O3 -march=native``), and rebuilt when a source is
newer. Nothing runs at import.

``library()`` returns the loaded ``ctypes.CDLL`` or None; when it is None,
``unavailable_reason()`` says why, and the failure was logged once. The
bindings (``io/native_sync.py``, ``io/native_jsonl.py``,
``slam/native_orb.py``) declare the signatures they use (``bind``).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

from .logging import log_warn

SOURCE_DIR = Path(__file__).resolve().parent.parent / "native"
SOURCES = tuple(SOURCE_DIR / f for f in ("sample_sync.cpp", "jsonl_reader.cpp", "orb_detect.cpp"))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
LIB_PATH = BUILD_DIR / "libhybvio_native.so"

_lock = threading.Lock()
_state = {"lib": None, "error": None}


def build(force: bool = False) -> float:
    """Compile the library if it is missing or older than a source; returns
    the seconds spent (0 when up to date). Raises if ``g++`` is missing or
    fails. The library is written atomically: a concurrent build or load
    never sees half a file."""
    if not force and LIB_PATH.exists() and all(
            LIB_PATH.stat().st_mtime >= s.stat().st_mtime for s in SOURCES):
        return 0.0
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native library is built with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = BUILD_DIR / f".{LIB_PATH.name}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([gxx, "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
                           "-pthread", "-o", str(tmp), *map(str, SOURCES)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {LIB_PATH.name} failed:\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0


def library():
    """The loaded library, or None (the reason in ``unavailable_reason``,
    logged once as a warning)."""
    with _lock:
        if _state["lib"] is not None or _state["error"] is not None:
            return _state["lib"]
        try:
            build()
            _state["lib"] = ctypes.CDLL(str(LIB_PATH))
        except (OSError, RuntimeError) as e:
            _state["error"] = str(e)
            log_warn("the native library (utils/native.py) is unavailable: %s", e)
        return _state["lib"]


def bind(signatures):
    """The library with each named function's ctypes (restype, argtypes)
    set from ``signatures``, or None where it does not load."""
    lib = library()
    if lib is not None:
        for name, (res, args) in signatures.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
    return lib


def unavailable_reason() -> Optional[str]:
    """None when the library loads, else why it does not."""
    library()
    return _state["error"]
