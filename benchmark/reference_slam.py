"""The plain reference of the SLAM side of the ``vislam`` configuration:
a local bundle adjustment solved as dense Gauss-Newton in float64, and the
check of the SLAM map's keyframes against the world's truth. It imports
nothing of the port; it works from the numbers of a BA problem as the
session posed it and from the world (``world.py``).

Local BA: keyframe poses camera-to-world ``[p, q]`` (wxyz Hamilton
quaternions), map points in the world, normalized image observations.
Every unknown is solved together: x = (a 6-vector a pose, its translation
then its rotation; a 3-vector a point), over all poses and points, the
normal equations built whole, with no Schur complement.

* Update of a pose by its delta (dt, dw): p + dt, and q * e(dw), with e(dw)
  the unit quaternion of the rotation vector dw to second order,
  ``[1 - |dw|^2 / 8, dw (1/2 - |dw|^2 / 48)]``, then normalized. A point
  moves by its delta.
* Reprojection of point m in keyframe k: the point in the camera,
  ``c = R_k^T (X_m - p_k)`` (R_k the rotation of q_k), its normalized image
  point ``c_xy / c_z`` (``c_z`` taken as 1 where ``|c_z| <= 1e-9``), less
  the observation. Its weight is the square root of the Huber weight at
  0.01, ``min(1, 0.01 / |r|)``, taken at the point the iteration
  linearizes about and held there; 0 where ``c_z <= 0.01`` (behind the
  camera), and 0 unless the observation is in the mask and its pose and
  point are valid.
* Odometry prior between keyframes k and k + 1, where its mask is set:
  the relative pose ``(R_k^T (p_{k+1} - p_k), q_k^-1 q_{k+1})`` against
  the measured one ``(t, s)``: ``w_pos`` times the difference of the
  translations, and ``2 w_rot sign(d_w) d_xyz`` with ``d = s^-1 q_k^-1
  q_{k+1}``.
* An iteration: the residuals' Jacobian in x at x = 0 (forward-mode
  autodiff of the stacked residuals), ``(J^T J + 1e-4 I) x = -J^T r``, with
  1e-12 more on the poses' diagonal. A pinned pose (an invalid one, and the
  first valid one when the first pose is fixed) has its rows and columns
  zeroed, 1 on its diagonal and 0 on its right-hand side: its delta is 0.
  Every pose is then updated by its delta and every point moved by its
  delta. 8 iterations. The cost returned is the sum of the weighted
  reprojection residuals' squares at the last iteration's linearization
  point.

A Schur complement that eliminates the points is exact algebra on these
normal equations, so a program that solves them that way must give this
solution to rounding.

Departures from the published description (HybVIO's SLAM module is of the
OpenVSLAM lineage, whose local BA runs g2o's Levenberg-Marquardt): the
damping is fixed at 1e-4 with no step acceptance; the iterations are 8;
the rotation's update is the second-order series above, normalized, not
the exponential map; the Huber weight is held through an iteration
(iteratively reweighted least squares), not differentiated; a prior whose
mask is set counts whatever the validity of its two poses, as the session
sets priors only between valid ones.

Map check: the SLAM map's keyframe positions (camera centres, camera to
world) against the camera centres of the world's truth at their frames:
the body's (IMU's) position plus its rotation of the camera centre in the
body frame, ``-R_c^T t_c`` of the IMU-to-camera matrix ``[R_c | t_c]``.
Each play of the stream is aligned onto the truth (rigid, ``umeyama``).
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import aligned_errors

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ITERATIONS = 8
DAMPING = 1e-4
HUBER = 0.01
POSE_EPS = 1e-12
FIELDS = ("poses", "points", "obs_ip", "obs_mask", "pose_valid", "point_valid", "prior_rel",
          "prior_mask", "prior_w_pos", "prior_w_rot")


# -- quaternions (wxyz, Hamilton) -------------------------------------------
def qmul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def qconj(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def rmat(q):
    """The rotation matrix of q (quadratic in q)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z,
    ], dim=-1).reshape(q.shape[:-1] + (3, 3))


def update_poses(poses, delta):
    """(NK, 7) poses moved by (NK, 6) deltas (the module docstring)."""
    dw = delta[:, 3:]
    a2 = (dw * dw).sum(-1, keepdim=True)
    e = torch.cat([1.0 - a2 / 8.0, dw * (0.5 - a2 / 48.0)], dim=-1)
    q = qmul(poses[:, 3:], e)
    return torch.cat([poses[:, :3] + delta[:, :3], q / q.norm(dim=-1, keepdim=True)], dim=-1)


# -- the local BA ------------------------------------------------------------
def _reprojection(poses, points, obs_ip):
    """((NK, MP, 2) residuals, (NK, MP) depths)."""
    R = rmat(poses[:, 3:])  # (NK, 3, 3)
    c = torch.einsum("kji,kmj->kmi", R, points[None] - poses[:, None, :3])
    z = c[..., 2]
    z_safe = torch.where(z.abs() > 1e-9, z, torch.ones_like(z))
    return c[..., :2] / z_safe[..., None] - obs_ip, z


def _priors(poses, rel, w_pos, w_rot):
    """(NK - 1, 6) residuals of the odometry priors."""
    a, b = poses[:-1], poses[1:]
    dp = torch.einsum("kji,kj->ki", rmat(a[:, 3:]), b[:, :3] - a[:, :3])
    q_rel = qmul(qconj(a[:, 3:]), b[:, 3:])
    d = qmul(qconj(rel[:, 3:]), q_rel)
    return torch.cat([(dp - rel[:, :3]) * w_pos,
                      d[:, 1:] * torch.sign(d[:, :1]) * 2.0 * w_rot], dim=-1)


def local_ba(problem: dict, fix_first_pose: bool = True, iterations: int = ITERATIONS,
             device="cpu"):
    """(poses (NK, 7), points (MP, 3), cost) of the dense Gauss-Newton on a
    BA problem (a mapping or a named tuple of the session's ``BAProblem``
    fields, numpy or tensors), in float64 on ``device``."""
    get = problem._asdict() if hasattr(problem, "_asdict") else dict(problem)
    t = {k: torch.as_tensor(np.asarray(_host(get[k]))).to(device) for k in FIELDS}
    f64 = lambda k: t[k].to(torch.float64)
    poses, points, obs_ip, rel = f64("poses"), f64("points"), f64("obs_ip"), f64("prior_rel")
    w_pos, w_rot = f64("prior_w_pos"), f64("prior_w_rot")
    pose_valid, point_valid = t["pose_valid"].bool(), t["point_valid"].bool()
    obs = (t["obs_mask"].bool() & pose_valid[:, None] & point_valid[None]).to(torch.float64)
    prior = t["prior_mask"].bool().to(torch.float64)
    NK, MP = obs_ip.shape[:2]
    n_pose = NK * 6
    pin = ~pose_valid
    if fix_first_pose and bool(pose_valid.any()):
        pin = pin.clone()
        pin[int(torch.nonzero(pose_valid)[0, 0])] = True
    pin_x = torch.cat([pin.repeat_interleave(6), torch.zeros(MP * 3, dtype=torch.bool,
                                                            device=pin.device)])
    N = n_pose + MP * 3
    eye = torch.eye(N, dtype=torch.float64, device=poses.device)
    reg = DAMPING * eye
    reg[:n_pose, :n_pose] += POSE_EPS * torch.eye(n_pose, dtype=torch.float64,
                                                  device=poses.device)
    cost = None
    for _ in range(iterations):
        r0, z = _reprojection(poses, points, obs_ip)
        rn = r0.norm(dim=-1)
        w = torch.sqrt(torch.where(rn > HUBER, HUBER / rn.clamp(min=1e-12), torch.ones_like(rn)))
        w = torch.where(z > 0.01, w, torch.zeros_like(w)) * obs
        cost = ((r0 * w[..., None]) ** 2).sum()

        def residuals(x, poses=poses, points=points, w=w):
            p = update_poses(poses, x[:n_pose].reshape(NK, 6))
            X = points + x[n_pose:].reshape(MP, 3)
            r, _ = _reprojection(p, X, obs_ip)
            return torch.cat([(r * w[..., None]).reshape(-1),
                              (_priors(p, rel, w_pos, w_rot) * prior[:, None]).reshape(-1)])

        x0 = torch.zeros(N, dtype=torch.float64, device=poses.device)
        J = torch.func.jacfwd(residuals)(x0)  # (residuals, N)
        r = residuals(x0)
        H = J.T @ J
        g = -(J.T @ r)
        H = torch.where(pin_x[:, None] | pin_x[None, :], torch.zeros_like(H), H)
        H = H + torch.diag(pin_x.to(torch.float64)) + reg
        g = torch.where(pin_x, torch.zeros_like(g), g)
        x = torch.linalg.solve(H, g)
        poses = update_poses(poses, x[:n_pose].reshape(NK, 6))
        points = points + x[n_pose:].reshape(MP, 3)
    return poses, points, cost


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


def ba_position_err(problem, result, device="cpu") -> float:
    """The largest distance (m) between a BA's result (poses, points, ...)
    and the reference's on its problem, over the valid poses' positions
    and the valid points; inf where the result is not finite."""
    get = problem._asdict() if hasattr(problem, "_asdict") else dict(problem)
    poses, points = (np.asarray(_host(v), np.float64) for v in result[:2])
    ref_poses, ref_points, _ = local_ba(problem, device=device)
    pv, mv = np.asarray(_host(get["pose_valid"]), bool), np.asarray(_host(get["point_valid"]), bool)
    got = np.concatenate([poses[pv, :3], points[mv]])
    want = np.concatenate([ref_poses.cpu().numpy()[pv, :3], ref_points.cpu().numpy()[mv]])
    if not np.isfinite(got).all():
        return float("inf")
    return float(np.abs(got - want).max()) if len(got) else 0.0


# -- the map ------------------------------------------------------------------
def camera_centres(pos, quat, imu_to_camera) -> np.ndarray:
    """(N, 3) world positions of the camera centre of the body's poses: pos
    (N, 3), quat (N, 4) world -> body (IMU), ``imu_to_camera`` 4x4."""
    T = np.asarray(imu_to_camera, np.float64)
    centre_body = -T[:3, :3].T @ T[:3, 3]  # the camera centre in the body frame
    world_to_body = rmat(torch.as_tensor(np.asarray(quat, np.float64))).numpy()
    body_to_world = np.transpose(world_to_body, (0, 2, 1))
    return np.asarray(pos, np.float64) + body_to_world @ centre_body


def map_pose_err(plays, keyframes_added: int, ba_ran: bool) -> float:
    """The largest aligned distance (m) of a map's keyframe positions from
    the truth: ``plays`` is a list of (estimated (N, 3), truth (N, 3)), one
    a play of the stream. inf where the window added no keyframe to the map
    or ran no local BA, or no play has two keyframes."""
    if keyframes_added <= 0 or not ba_ran:
        return float("inf")
    errs = [float(aligned_errors(est, gt).max()) for est, gt in plays if len(est) >= 2]
    return max(errs) if errs else float("inf")
