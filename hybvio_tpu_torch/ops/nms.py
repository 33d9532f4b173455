"""Greedy min-distance selection (kernel ``csrc/greedy_nms.cu``; replaces
the reference's ``ops/nms_pallas.py`` greedy_min_distance_pallas) and its
plain PyTorch version, the reference's sequential scan."""
from __future__ import annotations

import torch

from ._lib import launch, require_cuda


def greedy_min_distance_plain(d2, cand_ok, min_d2: float):
    """taken (B, K): walk candidates in index order, take i if eligible and
    no taken j has d2[i, j] < min_d2."""
    B, K = cand_ok.shape
    taken = torch.zeros((B, K), dtype=torch.bool, device=cand_ok.device)
    close = d2 < min_d2
    for i in range(K):
        near = torch.any(taken & close[:, i], dim=1)
        taken[:, i] = cand_ok[:, i] & ~near
    return taken


MAX_K = 1024  # the kernel keeps one 32-bit taken word per lane of a warp


def greedy_min_distance(d2, cand_ok, min_d2: float):
    """d2: f32 (B, K, K), rows contiguous, batch stride may be 0 (one d2
    shared by the lanes); cand_ok: bool (B, K), K <= MAX_K. Kernel on CUDA,
    plain version on CPU. A launch is counted under (B, K, "shared" or
    "per-lane" d2)."""
    if d2.device.type == "cpu" and cand_ok.device.type == "cpu":
        return greedy_min_distance_plain(d2, cand_ok, min_d2)
    require_cuda(d2, dtype=torch.float32)
    require_cuda(cand_ok, dtype=torch.bool)
    B, K = cand_ok.shape
    if d2.shape != (B, K, K) or d2.stride(2) != 1 or d2.stride(1) != K:
        raise ValueError(f"d2 {tuple(d2.shape)} must be (B, K, K) with contiguous rows")
    if not cand_ok.is_contiguous():
        raise ValueError("cand_ok must be contiguous")
    if K > MAX_K:
        raise ValueError(f"{K} candidates: the kernel takes at most {MAX_K}")
    taken = torch.empty((B, K), dtype=torch.bool, device=d2.device)
    stride = d2.stride(0) if B > 1 else 0
    launch("greedy_nms", "hv_greedy_nms", d2.data_ptr(), stride, cand_ok.data_ptr(), B, K,
           float(min_d2), taken.data_ptr(), shape=(B, K, "per-lane" if stride else "shared"))
    return taken
