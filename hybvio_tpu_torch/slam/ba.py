"""Bundle adjustment: Gauss-Newton with the Schur complement (port of the
reference package's ``slam/ba.py``).

The problem is fixed-shape arrays:

  poses:   (NK, 7)  keyframe camera-to-world [pos(3), quat(4) wxyz]
  points:  (MP, 3)  map points (world)
  obs:     (NK, MP) observation mask + (NK, MP, 2) normalized image points

Each GN iteration builds the reprojection Jacobian blocks per observation by
autodiff (``torch.func.vmap(jacrev(...))``; the reference takes
``jax.vmap(jax.jacfwd(...))``, the same derivatives to rounding; no solve
sits inside the differentiated function). Reverse mode, because PyTorch's
forward mode keeps its dual level in a process-global, and the SLAM worker
thread's Jacobians would race with the VIO step's own ``jacfwd`` on the
caller's thread. It then reduces them into the camera system with the point (3x3) blocks
eliminated by the Schur complement, solves the reduced (NK*6) system (first
pose gauge-fixed), and back-substitutes points. Masked observations
contribute zero. The solves take the ``_ex`` forms, which do not wait for
the card to report a singular matrix.

``make_sharded_ba`` splits the point axis over a device mesh: the per-point
half of an iteration runs per shard (``_point_system``, the one body both
paths share) and the pose-side partials are summed across shards where the
reference sums them with ``psum``. The session captures ``ba_iterate`` in a
CUDA graph on the card (``slam/session.py``); ``make_sharded_ba`` captures
its own.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacrev, vmap

from ..geometry.quaternion import quat_mul, quat_normalize, quat_to_rmat
from ..graphs import CapturedStep
from ..runtime import constant, device_scope

POSE_DOF = 6  # se3 delta: [translation(3), rotation(3)]


def _conj_sign(q):
    return constant((1.0, -1.0, -1.0, -1.0), q.dtype, q.device)


def _apply_pose_delta(pose, delta):
    """pose (..., 7) [p, q(wxyz)] with local delta (..., 6) [dt(3), dw(3)]
    (q' = q * exp(dw) to second order, p' = p + dt)."""
    p = pose[..., :3] + delta[..., :3]
    dw = delta[..., 3:]
    angle2 = torch.sum(dw * dw, dim=-1, keepdim=True)
    w = 1.0 - angle2 / 8.0
    xyz = dw * (0.5 - angle2 / 48.0)
    q = quat_normalize(quat_mul(pose[..., 3:], torch.cat([w, xyz], dim=-1)))
    return torch.cat([p, q], dim=-1)


def _project(pose, point):
    """Normalized-plane projection of world points from camera-to-world
    poses (leading dims broadcast): (xy (..., 2), depth (...))."""
    Rcw = quat_to_rmat(pose[..., 3:])  # camera-to-world rotation
    pc = torch.einsum("...ji,...j->...i", Rcw, point - pose[..., :3])
    z = pc[..., 2]
    safe = torch.where(torch.abs(z) > 1e-9, z, torch.ones_like(z))
    return pc[..., :2] / safe[..., None], z


def _residual(pose, point, ip):
    proj, z = _project(pose, point)
    return proj - ip, z


class BAProblem(NamedTuple):
    poses: torch.Tensor  # (NK, 7) camera-to-world
    points: torch.Tensor  # (MP, 3)
    obs_ip: torch.Tensor  # (NK, MP, 2) normalized image points
    obs_mask: torch.Tensor  # (NK, MP) bool
    pose_valid: torch.Tensor  # (NK,) bool
    point_valid: torch.Tensor  # (MP,) bool
    # odometry relative-pose priors between consecutive keyframes
    # (reference: odometryPriorStrengthPosition/Rotation)
    prior_rel: torch.Tensor  # (NK-1, 7) measured relative pose k -> k+1 (cam-to-cam)
    prior_mask: torch.Tensor  # (NK-1,) bool
    prior_w_pos: torch.Tensor  # () weight
    prior_w_rot: torch.Tensor  # ()


def _relative_pose(pose_a, pose_b):
    """Relative pose a->b in a's frame: (Ra^T (pb - pa), qa^-1 * qb)."""
    qa = pose_a[..., 3:]
    Ra = quat_to_rmat(qa)
    dp = torch.einsum("...ji,...j->...i", Ra, pose_b[..., :3] - pose_a[..., :3])
    qab = quat_mul(qa * _conj_sign(qa), pose_b[..., 3:])
    return torch.cat([dp, qab], dim=-1)


def _prior_residual(pose_a, pose_b, rel_meas, w_pos, w_rot):
    rel = _relative_pose(pose_a, pose_b)
    dp = (rel[..., :3] - rel_meas[..., :3]) * w_pos[..., None]
    # quaternion difference (vector part of q_meas^-1 * q)
    qd = quat_mul(rel_meas[..., 3:] * _conj_sign(rel), rel[..., 3:])
    dr = qd[..., 1:] * torch.sign(qd[..., :1]) * 2.0 * w_rot[..., None]
    return torch.cat([dp, dr], dim=-1)  # (..., 6)


def _obs_residual(x, pose, point, ip):
    """One observation's residual at the local delta x (9,) = [dpose(6),
    dpoint(3)]."""
    return _residual(_apply_pose_delta(pose, x[:6]), point + x[6:], ip)[0]


def _pair_residual(x, pose_a, pose_b, rel, w_pos, w_rot):
    """One relative-pose edge's residual at the deltas x (12,) of its two
    poses."""
    return _prior_residual(_apply_pose_delta(pose_a, x[:6]), _apply_pose_delta(pose_b, x[6:]),
                           rel, w_pos, w_rot)


_obs_jacobians = vmap(jacrev(_obs_residual))
_pair_jacobians = vmap(jacrev(_pair_residual))


def pair_jacobians(pose_a, pose_b, rel, w_pos, w_rot):
    """(residuals (E, 6), Jacobians (E, 6, 12)) of E relative-pose edges
    (weights (E,))."""
    r0 = _prior_residual(pose_a, pose_b, rel, w_pos, w_rot)
    x0 = pose_a.new_zeros((pose_a.shape[0], 12))
    return r0, _pair_jacobians(x0, pose_a, pose_b, rel, w_pos, w_rot)


def _solve(A, b):
    return torch.linalg.solve_ex(A, b)[0]


class _PointShard(NamedTuple):
    """One shard of the problem's point axis, on its device."""
    points: torch.Tensor  # (m, 3)
    obs_ip: torch.Tensor  # (NK, m, 2)
    wmask: torch.Tensor  # (NK, m, 1) observation weights (mask x pose and point validity)
    valid: torch.Tensor  # (m, 1) point validity, in the problem's dtype


def _point_shard(problem: BAProblem, cut: slice, device) -> _PointShard:
    obs_w = problem.obs_mask[:, cut] & problem.pose_valid[:, None] & problem.point_valid[None, cut]
    dtype = problem.poses.dtype
    return _PointShard(*(x.to(device, non_blocking=True) for x in (
        problem.points[cut], problem.obs_ip[:, cut], obs_w.to(dtype)[..., None],
        problem.point_valid[cut, None].to(dtype))))


def _point_system(poses, shard: _PointShard, damping, huber_delta):
    """The per-point half of one GN iteration on one shard: its partial sums
    of the pose-side system (U, Jc^T r, W V^-1 W^T, W V^-1 bp, the cost)
    and what its points' back-substitution needs (V^-1, W, bp)."""
    NK, MP = shard.obs_ip.shape[:2]
    dtype = poses.dtype
    # --- per-observation residuals & Jacobians ---
    P = poses[:, None].expand(NK, MP, 7).reshape(-1, 7)
    X = shard.points[None].expand(NK, MP, 3).reshape(-1, 3)
    ip = shard.obs_ip.reshape(-1, 2)
    r0, z = _residual(P, X, ip)
    J = _obs_jacobians(P.new_zeros((NK * MP, 9)), P, X, ip)  # (NK*MP, 2, 9)
    # Huber weights + behind-camera rejection
    rn = torch.linalg.norm(r0, dim=-1)
    w = torch.sqrt(torch.where(rn > huber_delta, huber_delta / torch.clamp(rn, min=1e-12),
                               torch.ones_like(rn)))
    w = torch.where(z > 0.01, w, torch.zeros_like(w))
    r_all = (r0 * w[:, None]).reshape(NK, MP, 2) * shard.wmask
    J_all = (J * w[:, None, None]).reshape(NK, MP, 2, 9) * shard.wmask[..., None]
    Jc = J_all[..., :6]  # (NK,MP,2,6) camera blocks
    Jp = J_all[..., 6:]  # (NK,MP,2,3) point blocks

    U = torch.einsum("kmri,kmrj->kij", Jc, Jc)  # (NK,6,6)
    V = torch.einsum("kmri,kmrj->mij", Jp, Jp)  # (MP,3,3)
    Wkm = torch.einsum("kmri,kmrj->kmij", Jc, Jp)  # (NK,MP,6,3)
    Jr = torch.einsum("kmri,kmr->ki", Jc, r_all)  # (NK,6); bc = -Jr
    bp = -torch.einsum("kmri,kmr->mi", Jp, r_all)  # (MP,3)
    V = V + damping * torch.eye(3, dtype=dtype, device=V.device)[None]
    # --- Schur complement: the points' terms ---
    Vinv = torch.linalg.inv_ex(V)[0]  # (MP,3,3); damped, invertible
    WVinv = torch.einsum("kmij,mjl->kmil", Wkm, Vinv)  # (NK,MP,6,3)
    WVW = torch.einsum("kmil,qmjl->kqij", WVinv, Wkm)  # (NK,NK,6,6)
    WVb = torch.einsum("kmil,ml->ki", WVinv, bp)  # (NK,6)
    return (U, Jr, WVW, WVb, torch.sum(r_all * r_all)), (Vinv, Wkm, bp)


class _PoseSide(NamedTuple):
    """The problem's pose side: its poses, priors and gauge, on one device."""
    poses: torch.Tensor
    pose_valid: torch.Tensor
    prior_rel: torch.Tensor
    prior_mask: torch.Tensor
    prior_w_pos: torch.Tensor
    prior_w_rot: torch.Tensor


def _pose_side(problem: BAProblem, device) -> _PoseSide:
    return _PoseSide(*(getattr(problem, f).to(device, non_blocking=True)
                       for f in _PoseSide._fields))


def _allsum(parts, device):
    """The shards' partials added in shard order on ``device`` (each copied
    there after the work that made it); one shard's partial as it is."""
    total = parts[0].to(device, non_blocking=True)
    for p in parts[1:]:
        total = total + p.to(device, non_blocking=True)
    return total


def _pose_update(side: _PoseSide, poses, U, Jr, WVW, WVb, damping, fix_first_pose):
    """The pose half of one GN iteration, on the pose side's device: the
    odometry priors added to the shards' summed partials (U, Jc^T r,
    W V^-1 W^T, W V^-1 bp), the reduced (NK*6) system gauge-fixed and
    solved. Returns (the pose delta dc (NK, 6), the updated poses)."""
    NK = poses.shape[0]
    dtype, dev = poses.dtype, poses.device
    w_pos = side.prior_w_pos.expand(NK - 1)
    w_rot = side.prior_w_rot.expand(NK - 1)
    prior_m = side.prior_mask.to(dtype)
    ar = torch.arange(NK, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    pin = ~side.pose_valid
    if fix_first_pose:  # compared on the device: a 0-d index would be read back to the host
        pin = pin | (ar == torch.argmax(side.pose_valid.to(torch.int32)))
    pin6 = torch.repeat_interleave(pin, 6)
    pin_mat = pin6[:, None] | pin6[None, :]
    pin_diag = torch.diag(pin6.to(dtype))
    S_eps = 1e-12 * torch.eye(NK * 6, dtype=dtype, device=dev)
    bc = -Jr

    # --- odometry relative-pose priors between consecutive keyframes ---
    rp, Jp2 = pair_jacobians(poses[:-1], poses[1:], side.prior_rel, w_pos, w_rot)
    rp = rp * prior_m[:, None]
    Jp2 = Jp2 * prior_m[:, None, None]
    Ja, Jb = Jp2[..., :6], Jp2[..., 6:]
    U = U.clone()
    U[:-1] += torch.einsum("kri,krj->kij", Ja, Ja)
    U[1:] += torch.einsum("kri,krj->kij", Jb, Jb)
    W_prior = torch.einsum("kri,krj->kij", Ja, Jb)  # coupling k,k+1 (6,6)
    bc = bc.clone()
    bc[:-1] += -torch.einsum("kri,kr->ki", Ja, rp)
    bc[1:] += -torch.einsum("kri,kr->ki", Jb, rp)
    U = U + damping * eye6[None]

    # --- Schur complement: S = U - sum_m W V^-1 W^T (with the prior coupling) ---
    S_full = -WVW
    S_full[ar, ar] += U
    S_full[ar[:-1], ar[1:]] += W_prior
    S_full[ar[1:], ar[:-1]] += W_prior.transpose(-1, -2)
    b_red = bc - WVb  # (NK,6)

    S = S_full.permute(0, 2, 1, 3).reshape(NK * 6, NK * 6)
    b = b_red.reshape(NK * 6)
    # gauge fixing + invalid poses: pin their deltas to zero
    S = torch.where(pin_mat, torch.zeros_like(S), S) + pin_diag
    b = torch.where(pin6, torch.zeros_like(b), b)
    dc = _solve(S + S_eps, b).reshape(NK, 6)
    return dc, _apply_pose_delta(poses, dc)


def _back_substitute(points, valid, Vinv, Wkm, bp, dc):
    """One shard's points after the pose delta dc: the Schur
    back-substitution."""
    dp_pts = torch.einsum("mij,mj->mi", Vinv, bp - torch.einsum("kmij,ki->mj", Wkm, dc))
    return points + dp_pts * valid


_STAGES = (_point_system, _pose_update, _back_substitute)


def _gauss_newton(side: _PoseSide, shards, devices, iterations, damping, huber_delta,
                  fix_first_pose, stages=_STAGES):
    """GN over the point shards ``shards`` (shard s on ``devices[s]``); the
    pose side (its poses, priors and gauge) on its own device, where the
    shards' partials are summed and the reduced system is solved. Each
    iteration runs ``stages`` (the per-shard point system, the pose update,
    the per-shard back-substitution: the plain functions, or captured forms
    of them). Returns (poses, points in shard order, final cost) there."""
    point_system, pose_update, back_substitute = stages
    dev = side.poses.device
    poses, cost = side.poses, None
    for _ in range(iterations):
        partial, backsub = [], []
        for shard, d in zip(shards, devices):
            with device_scope(d):
                part, keep = point_system(poses.to(d, non_blocking=True), shard, damping,
                                          huber_delta)
            partial.append(part)
            backsub.append(keep)
        U, Jr, WVW, WVb, cost = (_allsum(list(p), dev) for p in zip(*partial))
        dc, poses = pose_update(side, poses, U, Jr, WVW, WVb, damping, fix_first_pose)
        for s, ((Vinv, Wkm, bp), d) in enumerate(zip(backsub, devices)):
            with device_scope(d):
                shard = shards[s]
                shards[s] = shard._replace(points=back_substitute(
                    shard.points, shard.valid, Vinv, Wkm, bp, dc.to(d, non_blocking=True)))
    points = torch.cat([s.points.to(dev, non_blocking=True) for s in shards])
    return poses, points, cost


def ba_iterate(problem: BAProblem, iterations: int = 10, damping: float = 1e-4,
               huber_delta: float = 0.01, fix_first_pose: bool = True):
    """Run GN iterations; returns (poses, points, final_cost).

    Gauge: the first valid pose is held fixed (the odometry priors otherwise
    leave a global 6-DOF + scale-ish gauge freedom in mono).
    """
    dev = problem.poses.device
    shard = _point_shard(problem, slice(None), dev)
    return _gauss_newton(_pose_side(problem, dev), [shard], [dev], iterations, damping,
                         huber_delta, fix_first_pose)


def make_sharded_ba(mesh, iterations: int = 10, damping: float = 1e-4,
                    huber_delta: float = 0.01, fix_first_pose: bool = True,
                    axis: str = "data"):
    """Bundle adjustment over a mesh (``parallel.batched.Mesh``): the
    problem's MAP-POINT axis splits into ``mesh.size`` contiguous shards,
    shard s on ``mesh.devices[s]``. Each shard's per-observation Jacobians,
    V inversions, Schur products and point back-substitution run on its
    device; the pose-side partials (U, Jc^T r, W V^-1 W^T, W V^-1 bp, the
    cost) are copied to ``mesh.devices[0]`` and summed there in shard
    order, where the small (NK*6)^2 system is solved once and its pose
    delta copied back to every shard. (The reference sums with psum and
    solves on every device: the same values.)

    Returns sharded_ba(problem) -> (poses, points, cost) on
    ``mesh.devices[0]``, the points concatenated back in point order. The
    problem may lie anywhere; its point count must divide by the mesh size.
    Each shard's work is queued on its device's current stream in the
    calling thread.

    Compiled as the reference compiles its ``shard_map`` (``graphs``
    ``CapturedStep``s, ``sharded_ba.programs``): a mesh whose shards all
    lie on one card runs as one CUDA graph, the problem copied there first;
    over several cards each part of an iteration is a graph on its card
    (the point system and the back-substitution a shard, the pose update
    on ``mesh.devices[0]``), the cross-card copies and sums between the
    replays (written and unverified: the card host has one card)."""
    if axis != mesh.axis:
        raise ValueError(f"a mesh over axis {mesh.axis!r}, not {axis!r}")
    home = mesh.devices[0]

    def run(problem: BAProblem, stages=_STAGES):
        cuts = mesh.shards(problem.points.shape[0], "map points")
        shards = [_point_shard(problem, cut, d) for cut, d in zip(cuts, mesh.devices)]
        return _gauss_newton(_pose_side(problem, home), shards, mesh.devices, iterations,
                             damping, huber_delta, fix_first_pose, stages)

    if len({torch.device(d) for d in mesh.devices}) == 1:
        whole = CapturedStep(run, "slam sharded BA")

        def sharded_ba(problem: BAProblem):
            return whole(BAProblem(*(x.to(home) for x in problem)))

        sharded_ba.programs = [whole]
    else:
        parts = tuple(CapturedStep(fn, f"slam sharded BA: {what}") for fn, what in zip(
            _STAGES, ("point system", "pose update", "back-substitution")))

        def sharded_ba(problem: BAProblem):
            return run(problem, parts)

        sharded_ba.programs = list(parts)
    return sharded_ba


def triangulate_points_linear(poses, obs_ip, obs_mask):
    """Linear multi-view triangulation of all map points from keyframe
    observations (initialization for BA). poses: (NK,7) cam-to-world."""
    dtype = poses.dtype
    Rcw = quat_to_rmat(poses[:, 3:])  # (NK,3,3) cam-to-world
    # world ray of each observation
    v = torch.cat([obs_ip, torch.ones_like(obs_ip[..., :1])], dim=-1)  # (NK,MP,3)
    vw = torch.einsum("kij,kmj->kmi", Rcw, v)
    vn = vw / torch.linalg.norm(vw, dim=-1, keepdim=True)
    eye = torch.eye(3, dtype=dtype, device=poses.device)
    A = eye[None, None] - vn[..., :, None] * vn[..., None, :]
    A = A * obs_mask.to(dtype)[..., None, None]
    S0 = torch.sum(A, dim=0)  # (MP,3,3)
    S1 = torch.einsum("kmij,kj->mi", A, poses[:, :3])
    pts = _solve(S0 + 1e-9 * eye[None], S1[..., None]).squeeze(-1)
    ok = torch.sum(obs_mask, dim=0) >= 2
    return pts, ok
