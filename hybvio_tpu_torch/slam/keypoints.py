"""Self-detected multi-scale ORB keypoints for SLAM keyframes (port of the
reference package's ``slam/keypoints.py``).

The reference SLAM module detects its own ORB features on an
``orbScaleLevels``-level x``orbScaleFactor`` pyramid with dual FAST
thresholds ``orbInitialFastThreshold``/``orbMinFastThreshold``, giving
hundreds of scale-indexed keypoints per keyframe; sampling the rotated-BRIEF
pattern on the level where a keypoint is detected makes its descriptor
(approximately) scale-invariant.

Per level, on the image's device: a bilinear resize from the previous level
(antialiased when it shrinks, as ``jax.image.resize`` is; in float64,
rounded once, so every device gets the same level image), the FAST response
(``frontend/fast.py``), the packed per-cell block max with the
dual-threshold preference, a top-k, and rotated-BRIEF sampling on the level
image. The top-k is a stable descending sort cut at k: ``lax.top_k`` puts
the lower index first among equal scores (the -inf of empty cells and the
16-bit quantized scores tie often), which ``torch.topk`` does not promise.
"""
from __future__ import annotations

import numpy as np
import torch

from ..frontend.fast import fast_score
from ..frontend.gftt import block_max_packed
from ..graphs import CapturedStep
from ..runtime import constant
from .orb import orb_descriptors


def _level_geometry(H: int, W: int, n_levels: int, scale_factor: float,
                    total: int, min_dim: int = 48):
    """Static per-level (Hl, Wl, k_l) allocation.

    Feature counts follow ORB-SLAM's geometric split (proportional to
    1/scale^l so coarse levels contribute fewer but non-zero keypoints);
    levels smaller than min_dim are dropped.
    """
    shapes = []
    for l in range(n_levels):
        s = scale_factor ** l
        Hl, Wl = int(round(H / s)), int(round(W / s))
        if min(Hl, Wl) < min_dim:
            break
        shapes.append((Hl, Wl))
    n = len(shapes)
    inv = np.array([1.0 / scale_factor ** l for l in range(n)])
    frac = inv / inv.sum()
    ks = np.maximum(np.round(frac * total).astype(int), 8)
    return [(Hl, Wl, int(k)) for (Hl, Wl), k in zip(shapes, ks)]


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of ``jax.image.resize``'s "bilinear"
    along one axis (its ``compute_weight_mat``): half-pixel centres, a
    triangle kernel widened by 1/scale (antialiased) when shrinking, each
    output's weights normalized, computed in float64 and rounded."""
    inv = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / max(inv, 1.0)
    w = np.maximum(0.0, 1.0 - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0.0)
    return w.T.astype(np.float32)


def resize_bilinear(img: torch.Tensor, mh: torch.Tensor, mw: torch.Tensor) -> torch.Tensor:
    """``jax.image.resize(img, (Hl, Wl), "bilinear")`` of an (H, W) float32
    image as its two contractions, with the weight matrices mh (Hl, H) and
    mw (Wl, W) of ``resize_matrix`` (float64 on the image's device): the
    products are exact in float64 and the sums nearly so, rounded to
    float32 once, which gives the same image on every device."""
    return (mh @ img.to(torch.float64) @ mw.T).to(img.dtype)


def make_multiscale_orb(H: int, W: int, n_levels: int = 8,
                        scale_factor: float = 1.2, total_kps: int = 256,
                        thr_init: float = 20.0 / 255.0,
                        thr_min: float = 7.0 / 255.0, cell: int = 16):
    """The multi-scale detector for an (H, W) image.

    Returns (fn, N): fn(image) -> (pts (N,2) level-0 pixel xy, level (N,)
    int32, desc (N,256) +/-1 float32, valid (N,)) as numpy arrays (one copy
    from the image's device), computed on the device of ``image`` (an (H,
    W) float tensor), on the card by one captured program (``fn.program``,
    a ``graphs.CapturedStep``); N is the keypoint capacity (sum of
    per-level budgets).
    """
    geom = _level_geometry(H, W, n_levels, scale_factor, total_kps)
    N = sum(k for _, _, k in geom)

    def level(img_l, k):
        Hl, Wl = img_l.shape
        dtype = img_l.dtype
        # dual-threshold FAST in one pass at thr_min: a score above thr_init
        # certifies a window whose taps all clear thr_init. Masking scores to
        # > thr_init never changes a cell's argmax pixel, so one block max
        # serves both thresholds: a cell is "strong" iff its best
        # weak-threshold corner clears thr_init (the ORB-SLAM 20/7 retry).
        s_lo, xy = block_max_packed(fast_score(img_l, thr_min), cell)
        score = torch.where(s_lo > thr_init, s_lo + 1.0, s_lo)  # prefer strong
        score = torch.where(s_lo > 0, score, torch.full_like(score, float("-inf")))
        kk = min(k, score.shape[0])
        top_s, top_i = torch.sort(score, descending=True, stable=True)
        top_s, top_i = top_s[:kk], top_i[:kk]
        top_xy = xy[top_i].to(dtype)
        desc, ok = orb_descriptors(img_l, top_xy, torch.isfinite(top_s))
        pts0 = top_xy * constant((W / Wl, H / Hl), dtype, img_l.device)
        if kk < k:  # pad (tiny levels with fewer cells than budget)
            pad = k - kk
            pts0 = torch.cat([pts0, pts0.new_zeros((pad, 2))])
            desc = torch.cat([desc, desc.new_zeros((pad, desc.shape[1]))])
            ok = torch.cat([ok, ok.new_zeros((pad,))])
        return pts0, desc, ok

    mats = {}  # device -> the resize matrices of each level

    def level_matrices(device):
        if device not in mats:
            f64 = lambda a: torch.as_tensor(a, dtype=torch.float64).to(device)
            mats[device] = [(f64(resize_matrix(geom[l - 1][0], Hl)),
                             f64(resize_matrix(geom[l - 1][1], Wl)))
                            for l, (Hl, Wl, _) in enumerate(geom) if l > 0]
        return mats[device]

    def levels(img):
        pts_all, desc_all, ok_all = [], [], []
        level_img = img
        resize = level_matrices(img.device)
        for l, (Hl, Wl, k) in enumerate(geom):
            if l > 0:  # chained 1/scale steps stay crisper than one big decimation
                level_img = resize_bilinear(level_img, *resize[l - 1])
            pts0, desc, ok = level(level_img, k)
            pts_all.append(pts0)
            desc_all.append(desc)
            ok_all.append(ok)
        return torch.cat(pts_all), torch.cat(desc_all), torch.cat(ok_all)

    # every level in one CUDA graph on the card (the reference jits each)
    program = CapturedStep(levels, "slam multi-scale keypoints")
    lvl = np.concatenate([np.full((k,), l, np.int32) for l, (_, _, k) in enumerate(geom)])

    def detect(img):
        pts, desc, ok = program(img)
        return pts.cpu().numpy(), lvl, desc.cpu().numpy(), ok.cpu().numpy()

    detect.program = program
    return detect, N
