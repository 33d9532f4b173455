"""Device and precision policy of the PyTorch port.

* The filter (EKF, trail, triangulation) runs in float64 on the CPU, where
  the tests hold it against the reference bit for bit in spirit, and in
  float32 on CUDA, as the reference does on its accelerator.
* The image front-end always runs in float32 (the reference builds its
  tracker with ``image_dtype=float32`` even under x64).
* TF32 stays off: the covariance algebra does not survive reduced-precision
  products (README numerics note), and PyTorch turns TF32 on for cuDNN by
  default.
"""
from __future__ import annotations

import torch

IMAGE_DTYPE = torch.float32


def configure_precision() -> None:
    """Full float32 products everywhere (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def default_device() -> torch.device:
    """The card. The port's entry points run on it unless the caller asks
    for the CPU; there is no silent fallback."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def filter_dtype(device) -> torch.dtype:
    """float64 on the CPU (parity with the reference's x64 tests), float32
    on CUDA."""
    return torch.float64 if torch.device(device).type == "cpu" else torch.float32


def random_int_bits(dtype: torch.dtype) -> int:
    """Width jax.random.randint samples at: int64 under x64 (the float64
    filter), int32 otherwise."""
    return 64 if dtype == torch.float64 else 32
