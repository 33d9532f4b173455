"""Counter-based threefry2x32 generator, bit-exact with ``jax.random``.

The reference package draws RANSAC hypotheses and the visual-update order
from ``jax.random`` keys (threefry2x32 with ``jax_threefry_partitionable``,
the default since jax 0.5). Reproducing that stream bit for bit keeps the two
packages on one trajectory step by step; any other generator would allow only
statistical parity of a chaotic filter.

A key is an int64 tensor ``(..., 2)`` holding two uint32 words; the leading
dims are the lanes (one key per sequence). Arithmetic runs in int64 with
32-bit masking, so the same code gives the same bits on the CPU and on CUDA.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block (20 rounds) on broadcastable uint32-in-int64
    tensors; returns the two output words."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed) -> torch.Tensor:
    """``jax.random.PRNGKey`` for a non-negative integer seed tensor
    (any shape) -> keys ``seed.shape + (2,)``."""
    seed = torch.as_tensor(seed, dtype=torch.int64)
    return torch.stack([(seed >> 32) & _MASK, seed & _MASK], dim=-1)


def _counts(shape, device):
    """Flat uint64 iota over ``shape`` as (hi, lo) uint32 words."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return (idx >> 32) & _MASK, idx & _MASK


def _bits(key, shape):
    """Both threefry output words for every counter of ``shape``:
    ``key.shape[:-1] + shape`` each."""
    shape = tuple(shape)
    hi, lo = _counts(shape, key.device)
    view = key.shape[:-1] + (1,) * len(shape)
    k0 = key[..., 0].reshape(view)
    k1 = key[..., 1].reshape(view)
    return threefry2x32(k0, k1, hi, lo)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` -> ``(..., num, 2)``."""
    b1, b2 = _bits(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with a Python integer."""
    d = int(data) & _MASK
    zero = torch.zeros_like(key[..., 0])
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], zero, zero + d)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key, bit_width: int, shape):
    """``_threefry_random_bits_partitionable`` for 32 or 64 bits. The 64-bit
    form returns its two 32-bit halves (hi, lo); int64 cannot hold a uint64."""
    b1, b2 = _bits(key, shape)
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        return b1, b2
    raise NotImplementedError(f"random bits of width {bit_width}")


def uniform(key, shape, dtype=torch.float32, minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` on [minval, maxval): the mantissa bits with
    exponent 0, minus one, which is exactly ``mantissa * 2**-nmant``, then
    ``max(minval, floats * (maxval - minval) + minval)`` with the bounds and
    their difference rounded to ``dtype`` as jax rounds them."""
    if dtype == torch.float32:
        mant = random_bits(key, 32, shape) >> 9
        floats = mant.to(torch.float32) * (2.0 ** -23)
        np_dtype = np.float32
    elif dtype == torch.float64:
        hi, lo = random_bits(key, 64, shape)
        mant = (hi << 20) | (lo >> 12)
        floats = mant.to(torch.float64) * (2.0 ** -52)
        np_dtype = np.float64
    else:
        raise NotImplementedError(f"uniform of {dtype}")
    if minval == 0.0 and maxval == 1.0:
        return floats
    lo, hi = np_dtype(minval), np_dtype(maxval)
    return torch.clamp(floats * float(hi - lo) + float(lo), min=float(lo))


def normal(key, shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal``: sqrt(2) erfinv(u) of u uniform on
    (nextafter(-1, 0), 1) from the same bits. The uniform draw is bit-exact;
    ``torch.erfinv`` and XLA's ``erf_inv`` are different approximations, so
    the result agrees to their rounding, not bit for bit."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    lo = np.nextafter(np_dtype(-1.0), np_dtype(0.0))
    u = uniform(key, shape, dtype, float(lo), 1.0)
    return torch.erfinv(u) * float(np.asarray(np.sqrt(2), np_dtype))


def randint(key, shape, minval, maxval, bits: int = 32) -> torch.Tensor:
    """``jax.random.randint`` in [minval, maxval) as int64.

    ``bits`` is the sampling width: jax samples int64 when x64 is enabled
    and int32 otherwise. ``minval``/``maxval`` are Python ints or tensors of
    the key's lane shape ``key.shape[:-1]`` (one bound per lane, already on
    the key's device), spans < 2**31.
    """
    shape = tuple(shape)
    view = key.shape[:-1] + (1,) * len(shape)

    def bound(v):  # a Python int stays one: making it a tensor would copy it to the device
        if not isinstance(v, torch.Tensor):
            return int(v)
        v = v.to(torch.int64)
        return v.reshape(view) if v.dim() else v

    minval, maxval = bound(minval), bound(maxval)
    if isinstance(minval, int) and isinstance(maxval, int):
        span = maxval - minval if maxval > minval else 1
    else:
        span = torch.where(maxval <= minval, 1, maxval - minval)
    k = split(key)
    k1, k2 = k[..., 0, :], k[..., 1, :]

    def rem(b):
        if bits == 32:
            return random_bits(b, 32, shape) % span
        # (hi * 2**32 + lo) % span, in int64 without overflow (span < 2**31)
        hi, lo = random_bits(b, 64, shape)
        return ((hi % span) * ((1 << 32) % span) + lo % span) % span

    mult = ((1 << (bits // 2)) % span) ** 2 % span
    off = (rem(k1) * mult + rem(k2)) % span
    return minval + off
