"""ctypes bindings for the native image decoder (port of the reference
package's ``io/native_image.py``; source ``native/image_decode.cpp`` in this
package, the port's own copy).

PNG (8/16-bit gray, RGB(A), gray+alpha) and PGM (P5) to uint8 grayscale
(the reference's float32 form is not ported: the port's loader reads
uint8). At first use ``g++`` compiles the source into
``build/libhybvio_image_decode.so`` at the repository root (rebuilt when the
source is newer), as ``ops/_lib.py`` builds the kernels; nothing runs at
import. Where zlib's header is missing the library decodes PGM only
(``png_supported()`` says which). The C call releases the GIL, so prefetch
threads decode beside the step.
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

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "image_decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
LIB_PATH = BUILD_DIR / "libhybvio_image_decode.so"

_lock = threading.Lock()
_state = {"lib": None, "error": None}


def build(force: bool = False) -> float:
    """Compile the decoder if the library is missing or older than its
    source; returns the seconds spent (0 when up to date). Links zlib where
    its header is there. Raises if ``g++`` is missing or fails."""
    if not force and LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= SOURCE.stat().st_mtime:
        return 0.0
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native image decoder is built with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = BUILD_DIR / f".{LIB_PATH.name}.{os.getpid()}.tmp"
    base = [gxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(base + ["-lz"], capture_output=True, text=True)
    if proc.returncode != 0:  # no libz to link: the PGM-only build
        proc = subprocess.run(base, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent build never loads half a file
    return time.perf_counter() - t0


def _load():
    """The loaded library, or None (the reason in ``unavailable_reason``)."""
    with _lock:
        if _state["lib"] is not None or _state["error"] is not None:
            return _state["lib"]
        try:
            build()
            lib = ctypes.CDLL(str(LIB_PATH))
        except (OSError, RuntimeError) as e:
            _state["error"] = str(e)
            return None
        lib.hyb_img_png_supported.restype = ctypes.c_int
        lib.hyb_img_probe.restype = ctypes.c_int
        lib.hyb_img_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_int)]
        lib.hyb_img_decode_u8.restype = ctypes.c_int
        lib.hyb_img_decode_u8.argtypes = [
            ctypes.c_char_p, np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_int]
        _state["lib"] = lib
        return lib


def unavailable_reason() -> Optional[str]:
    """None when the decoder loads, else why it does not."""
    _load()
    return _state["error"]


def png_supported() -> bool:
    """Whether the decoder reads PNG (it was built with zlib)."""
    lib = _load()
    return lib is not None and bool(lib.hyb_img_png_supported())


def decode_gray_u8_native(path: str) -> Optional[np.ndarray]:
    """(H, W) uint8 raw 0-255, or None if the decoder is unavailable or does
    not read this file. 8-bit sources stay 8-bit: the step normalizes on
    the device, so the copy to it is 1/4 the bytes of float32."""
    lib = _load()
    if lib is None:
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    p = path.encode()
    if lib.hyb_img_probe(p, ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    out = np.empty((h.value, w.value), np.uint8)
    if lib.hyb_img_decode_u8(p, out, h.value, w.value) != 0:
        return None
    return out
