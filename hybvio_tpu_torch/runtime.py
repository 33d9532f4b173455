"""Device and precision policy of the PyTorch port.

* The filter (EKF, trail, triangulation) runs in float64 on the CPU, where
  the tests hold it against the reference bit for bit in spirit, and in
  float32 on CUDA, as the reference does on its accelerator.
* The image front-end always runs in float32 (the reference builds its
  tracker with ``image_dtype=float32`` even under x64).
* TF32 stays off: the covariance algebra does not survive reduced-precision
  products (README numerics note), and PyTorch turns TF32 on for cuDNN by
  default. The step scopes this policy (``full_precision``) whatever the
  caller set, as the reference forces "highest" inside its visual updates.
* The SLAM session's worker thread needs the policy too while the step
  runs beside it: a VioApi with SLAM holds it (``hold_precision``) from
  its construction to its ``finish``.
* The step makes no host sync: every constant it needs goes to the device
  once (``constant``), since a copy from the host waits for the card.
* The small batched factorizations (``linalg.qr``, ``cholesky_ex``,
  ``lu_factor_ex``, ``solve_ex``, ``cholesky_solve``) go to cuSOLVER and
  cuBLAS, never to MAGMA, whose routines wait on the host and cannot be
  captured in a CUDA graph: the eager and the captured step run the same
  library (``graphs.py``).
"""
from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch

IMAGE_DTYPE = torch.float32


def configure_precision() -> None:
    """Full float32 products everywhere (no TF32); cuSOLVER for the
    factorizations on a CUDA build."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    if torch.version.cuda is not None:
        torch.backends.cuda.preferred_linalg_library("cusolver")


# The policy is process-global: a thread that restores the caller's setting
# would drop TF32-off under another thread's products. While a hold is taken
# (``hold_precision``, e.g. by a VioApi whose SLAM worker runs beside its
# step) every ``full_precision`` block keeps the policy when it ends, and
# the last release restores the setting from before the first hold.
_POLICY_LOCK = threading.Lock()
_holds = [0, None]  # count, the setting saved by the first hold


def _current_policy():
    backend = torch._C._get_linalg_preferred_backend() if torch.version.cuda is not None else None
    return torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32, backend


def _restore_policy(saved) -> None:
    torch.set_float32_matmul_precision(saved[0])
    torch.backends.cudnn.allow_tf32 = saved[1]
    if saved[2] is not None:
        torch._C._set_linalg_preferred_backend(saved[2])


def hold_precision() -> None:
    """Keep ``configure_precision`` in force in every thread until the
    matching ``release_precision``."""
    with _POLICY_LOCK:
        if _holds[0] == 0:
            _holds[1] = _current_policy()
        _holds[0] += 1
        configure_precision()


def release_precision() -> None:
    """End one hold; the last restores the setting from before the first."""
    with _POLICY_LOCK:
        _holds[0] -= 1
        if _holds[0] == 0:
            _restore_policy(_holds[1])


@contextlib.contextmanager
def full_precision():
    """``configure_precision`` inside the block; the caller's matmul
    precision and cuDNN TF32 flag are restored after it, unless a hold
    (``hold_precision``) keeps the policy for another thread."""
    with _POLICY_LOCK:
        saved = _current_policy()
        configure_precision()
    try:
        yield
    finally:
        with _POLICY_LOCK:
            if not _holds[0]:
                _restore_policy(saved)


def scoped_precision(fn):
    """``fn`` run under ``full_precision``."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with full_precision():
            return fn(*args, **kwargs)
    return wrapped


# torch.func.jacfwd keeps its forward-AD dual level in a process-global: two
# threads in forward mode at once break each other's level ("no level
# exists"), e.g. two VioApis stepped from two threads. Each forward-mode
# Jacobian of the step is taken under this lock (the SLAM side takes jacrev).
FORWARD_AD_LOCK = threading.RLock()


@functools.lru_cache(maxsize=None)
def _constant(values, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values), dtype=dtype).to(device)


def constant(values, dtype, device) -> torch.Tensor:
    """The fixed ``values`` (a number, or nested tuples of numbers) as a
    tensor of ``dtype`` on ``device``, copied there once per (values,
    dtype, device) and shared by every later call: never write into it."""
    return _constant(values, dtype, torch.device(device))


def default_device() -> torch.device:
    """The card. The port's entry points run on it unless the caller asks
    for the CPU; there is no silent fallback."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def device_scope(device):
    """A block with ``device`` current: its launches go to that device's
    current stream in this thread. A no-op for the CPU."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def filter_dtype(device) -> torch.dtype:
    """float64 on the CPU (parity with the reference's x64 tests), float32
    on CUDA."""
    return torch.float64 if torch.device(device).type == "cpu" else torch.float32


def random_int_bits(dtype: torch.dtype) -> int:
    """Width jax.random.randint samples at: int64 under x64 (the float64
    filter), int32 otherwise."""
    return 64 if dtype == torch.float64 else 32
