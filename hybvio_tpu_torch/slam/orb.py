"""ORB-style binary descriptors for loop closure (port of the reference
package's ``slam/orb.py``).

Rotated-BRIEF-256 descriptors steered by the intensity-centroid orientation
of a smoothed image, as +/-1 vectors, so the per-frame signature (mean
descriptor) and pairwise Hamming matching are dot products. The BRIEF
pairs are the reference's: the same numpy stream (RandomState(20240401)),
bit for bit. Every point is sampled at once: (T, 961) patch samples and
(T, 256) pair samples in a few batched tensor operations on the image's
device.

The descriptor gives the same bits on every device. Its only reductions,
the intensity-centroid moments, sum float32 samples times integer offsets
in float64, where those sums are exact, so their order does not matter:
in a flat patch they are exactly 0 (a float32 sum leaves order-dependent
rounding noise there, whose angle is noise too). The angle's cosine and
sine are taken in float64 and rounded, and the pairs are rotated by
elementwise products. The reference sums in float32 in XLA's order: on a
textured patch the two give the same bits; where the angle is rounding
noise, or a pair's two samples in a flat region differ by rounding only,
bits may differ.
"""
from __future__ import annotations

import numpy as np
import torch

from ..frontend.pyramid import _sep_conv2d, bilinear_sample
from ..runtime import constant

N_BITS = 256
_PATCH_R = 15  # BRIEF sampling radius (31x31 patch like ORB)

# deterministic BRIEF sampling pattern (gaussian-ish like ORB's learned pairs)
_rng = np.random.RandomState(20240401)
_PAIRS_A = np.clip(_rng.randn(N_BITS, 2) * _PATCH_R / 2.5, -_PATCH_R, _PATCH_R)
_PAIRS_B = np.clip(_rng.randn(N_BITS, 2) * _PATCH_R / 2.5, -_PATCH_R, _PATCH_R)
_SMOOTH = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
# the pairs as nested tuples, for runtime.constant (copied to a device once)
_PAIRS = tuple(tuple(map(tuple, p.tolist())) for p in (_PAIRS_A, _PAIRS_B))


def _rotate(pairs, c, s):
    """pairs (N_BITS, 2) rotated by each point's angle (c, s (T,)):
    ``pairs @ R.T`` with R = [[c, -s], [s, c]], (T, N_BITS, 2), as
    elementwise float products (no fused multiply-add)."""
    px, py = pairs[:, 0], pairs[:, 1]
    c, s = c[:, None], s[:, None]
    return torch.stack([px * c - py * s, px * s + py * c], dim=-1)


def orb_descriptors(image: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor):
    """N_BITS binary descriptors at pts (T, 2) of image (H, W): (desc (T,
    N_BITS) in {-1, +1} of the image's dtype, ok (T,)). Orientation by
    intensity centroid (reference ORB semantics; slam.orb* parameters)."""
    dtype, dev = image.dtype, image.device
    img = _sep_conv2d(image, _SMOOTH, _SMOOTH)  # BRIEF needs blur
    H, W = img.shape

    r = _PATCH_R
    ax = torch.arange(-r, r + 1, dtype=dtype, device=dev)
    ox, oy = torch.meshgrid(ax, ax, indexing="xy")
    circf = ((ox * ox + oy * oy) <= r * r).reshape(-1).to(dtype)
    offs = torch.stack([ox, oy], dim=-1).reshape(-1, 2)
    pa, pb = (constant(p, dtype, dev) for p in _PAIRS)

    patch = bilinear_sample(img, pts[:, None, :] + offs) * circf  # (T, 961)
    patch = patch.to(torch.float64)  # exact sums of float32 x integer offsets
    m10 = torch.sum(patch * offs[:, 0].to(torch.float64), dim=-1)
    m01 = torch.sum(patch * offs[:, 1].to(torch.float64), dim=-1)
    theta = torch.atan2(m01, m10)
    c, s = torch.cos(theta).to(dtype), torch.sin(theta).to(dtype)
    va = bilinear_sample(img, pts[:, None, :] + _rotate(pa, c, s))
    vb = bilinear_sample(img, pts[:, None, :] + _rotate(pb, c, s))
    one = torch.ones((), dtype=dtype, device=dev)
    desc = torch.where(va > vb, one, -one)
    x, y = pts[:, 0], pts[:, 1]
    in_bounds = (x >= r + 1) & (x < W - r - 1) & (y >= r + 1) & (y < H - r - 1)
    return desc, valid & in_bounds


def frame_signature(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Global frame signature: the mean of the +/-1 descriptors over valid
    features, normalized (a vocabulary-free BoW stand-in)."""
    w = valid.to(desc.dtype)[:, None]
    s = torch.sum(desc * w, dim=0) / torch.clamp(torch.sum(w), min=1.0)
    n = torch.linalg.norm(s)
    return s / torch.where(n > 1e-9, n, torch.ones_like(n))


def match_descriptors(desc_a, valid_a, desc_b, valid_b, lowe_ratio: float = 0.7):
    """Mutual best matching with the Lowe ratio test
    (reference: slam.loopClosureFeatureMatchLoweRatio).

    desc in {-1,+1}: dot product similarity == N_BITS - 2*hamming; argmax
    ties go to the first index, as in the reference. Returns (match_idx
    (Ta,) int32 index into b or -1, score (Ta,))."""
    neg = torch.full((), -1e9, dtype=desc_a.dtype, device=desc_a.device)
    both = valid_a[:, None] & valid_b[None, :]
    sim = torch.where(both, desc_a @ desc_b.T, neg)  # (Ta, Tb)
    best = torch.argmax(sim, dim=1)
    s1 = torch.amax(sim, dim=1)
    rows = torch.arange(sim.shape[0], device=sim.device)
    sim2 = sim.clone()
    sim2[rows, best] = neg
    s2 = torch.amax(sim2, dim=1)
    # similarity -> hamming distance for the ratio test
    d1 = (N_BITS - s1) / 2
    d2 = (N_BITS - s2) / 2
    ratio_ok = d1 <= lowe_ratio * torch.clamp(d2, min=1.0)
    back = torch.argmax(sim, dim=0)  # mutual check
    mutual = back[best] == rows
    ok = valid_a & ratio_ok & mutual & (s1 > neg / 2)
    return torch.where(ok, best, -1).to(torch.int32), s1
