"""Pose-graph optimization over ALL keyframes (port of the reference
package's ``slam/posegraph.py``).

Keyframe poses only (map points are corrected afterwards through their
anchor keyframe), as one fixed-shape Gauss-Newton problem: N padded poses,
E padded relative-pose edges (consecutive odometry constraints +
loop-closure constraints). Each iteration builds the edge Jacobians by
autodiff (``ba.pair_jacobians``), assembles the dense (6N, 6N) normal equations with
scatter-adds, and solves with the first pose gauge-fixed. N is padded to
the next power of two, as in the reference. The scatter-adds are
``index_put_(accumulate=True)``, which adds a row's terms in edge order on
every device (``index_add_`` adds them in any order on the card), so the
captured and the eager solve give the same bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .ba import _apply_pose_delta, _solve, pair_jacobians


class PoseGraphProblem(NamedTuple):
    poses: torch.Tensor       # (N, 7) camera-to-world [p, q(wxyz)]
    pose_valid: torch.Tensor  # (N,) bool
    edge_i: torch.Tensor      # (E,) int64 source pose index
    edge_j: torch.Tensor      # (E,) int64 target pose index
    edge_rel: torch.Tensor    # (E, 7) measured relative pose i->j (in i's frame)
    edge_w_pos: torch.Tensor  # (E,) position weight (0 = padded edge)
    edge_w_rot: torch.Tensor  # (E,) rotation weight


def optimize_pose_graph(problem: PoseGraphProblem, iterations: int = 10,
                        damping: float = 1e-6) -> torch.Tensor:
    """GN over the pose graph; returns optimized (N, 7) poses.

    Gauge: the first valid pose is held fixed (loop edges otherwise leave a
    global 6-DOF freedom).
    """
    N = problem.poses.shape[0]
    dtype, dev = problem.poses.dtype, problem.poses.device
    ii, jj = problem.edge_i.long(), problem.edge_j.long()
    # the first valid pose, compared on the device (a 0-d index would be
    # read back to the host)
    pin = ~problem.pose_valid | (torch.arange(N, device=dev)
                                 == torch.argmax(problem.pose_valid.to(torch.int32)))
    pin6 = torch.repeat_interleave(pin, 6)
    pin_mat = pin6[:, None] | pin6[None, :]
    diag = torch.diag(torch.where(pin6, 1.0, damping).to(dtype))
    eps = damping * torch.eye(N * 6, dtype=dtype, device=dev)

    poses = problem.poses
    for _ in range(iterations):
        r, J = pair_jacobians(poses[ii], poses[jj], problem.edge_rel, problem.edge_w_pos,
                              problem.edge_w_rot)  # (E,6), (E,6,12)
        Ja, Jb = J[..., :6], J[..., 6:]
        # dense normal equations with scatter-adds
        H = torch.zeros((N, N, 6, 6), dtype=dtype, device=dev)
        b = torch.zeros((N, 6), dtype=dtype, device=dev)
        H.index_put_((ii, ii), torch.einsum("eri,erj->eij", Ja, Ja), accumulate=True)
        H.index_put_((jj, jj), torch.einsum("eri,erj->eij", Jb, Jb), accumulate=True)
        H.index_put_((ii, jj), torch.einsum("eri,erj->eij", Ja, Jb), accumulate=True)
        H.index_put_((jj, ii), torch.einsum("eri,erj->eij", Jb, Ja), accumulate=True)
        b.index_put_((ii,), -torch.einsum("eri,er->ei", Ja, r), accumulate=True)
        b.index_put_((jj,), -torch.einsum("eri,er->ei", Jb, r), accumulate=True)

        Hf = H.permute(0, 2, 1, 3).reshape(N * 6, N * 6)
        bf = b.reshape(N * 6)
        # pin invalid poses + the first valid pose (gauge)
        Hf = torch.where(pin_mat, torch.zeros_like(Hf), Hf) + diag
        bf = torch.where(pin6, torch.zeros_like(bf), bf)
        d = _solve(Hf + eps, bf)
        poses = _apply_pose_delta(poses, d.reshape(N, 6))
    return poses


def next_pow2(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p *= 2
    return p
