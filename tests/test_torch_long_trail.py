"""``predict_flow`` over a pose trail long enough for its triangulated
distance: with cameraTrailLength = 10 a track seen in the 11 trail slots
0..10 takes its LK guess from the widest-baseline two-view triangulation
(``has_baseline``), which the 4-slot trail of the other whole-step tests
cannot reach.

In both packages the branch is never taken by the step itself:
``feature_exists`` keeps the contiguous prefix of a track's slots from slot
0, and slot 0 is the empty head keyframe that ``process_frame`` pushes at
the end of every step, so no track exists when the next step predicts its
flow. The first test holds the port's step to the reference's over 12
steps of the long trail (every integer field exactly, the trails included),
and its ``has_baseline`` to the reference's rule at every step; the second
fills the trail of a real state so that the branch is taken, and holds the
port's predicted pixels to the reference's composition of the same
functions."""
import types

import pytest

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hybvio_tpu.geometry.cameras import pixel_to_ray as r_pixel_to_ray
from hybvio_tpu.geometry.cameras import ray_to_pixel as r_ray_to_pixel
from hybvio_tpu.geometry.poses import (
    to_camera_to_world as r_to_camera_to_world, to_world_to_camera as r_to_world_to_camera,
    transform_vec3 as r_transform_vec3,
)
from hybvio_tpu.odometry import trail as rtr
from hybvio_tpu.odometry.triangulation import (
    camera_poses_from_states as r_camera_poses, triangulate_two_cameras as r_triangulate_two,
)
from hybvio_tpu_torch.odometry.batched_update import gather_pose_states
from hybvio_tpu_torch.odometry.triangulation import camera_poses_from_states

from torch_parity import (
    batched_step_parity, long_trail_tol, stereo_frame, tiny_sequence, tiny_stereo_setup,
)

torch.set_num_threads(1)

B, FRAMES, TRAIL = 2, 13, 10
POS, ORI, CAM, POSE_DIM = 0, 6, 20, 7


def _ref_has_baseline(trail, track_ids):
    """The reference's rule (vio.py predict_flow) on one lane's trail."""
    exists = rtr.feature_exists(types.SimpleNamespace(kf_track_id=trail), track_ids)
    ks = jnp.arange(exists.shape[0])[:, None]
    k0 = jnp.min(jnp.where(exists, ks, exists.shape[0]), axis=0)
    k1 = jnp.max(jnp.where(exists, ks, -1), axis=0)
    return (k1 - k0) >= 10


@pytest.fixture(scope="module")
def long_run():
    """(params, camera, [(vio, state at step i's flow prediction)]) of the
    whole-step parity run over the long trail (it raises on the first field
    that parts from the reference)."""
    p, _, rcam = tiny_stereo_setup()
    p.odometry.cameraTrailLength = TRAIL
    seq = tiny_sequence(FRAMES)
    frames = [stereo_frame(seq, fi) for fi in range(FRAMES + 1)]
    states = []
    assert batched_step_parity(p, (rcam, rcam), frames, seq, B, tol=long_trail_tol,
                               on_step=lambda vio, state, imu: states.append(
                                   (vio, vio.imu_only(state, imu)))) > 0
    return p, rcam, states


def test_stereo_step_with_a_long_trail_matches_reference(long_run):
    _, _, states = long_run
    assert len(states) == FRAMES
    for vio, state in states:
        _, _, has_baseline = vio.predict_flow(state.backend, state.tracker)
        want = jax.vmap(_ref_has_baseline)(jnp.asarray(state.backend.trail.kf_track_id.numpy()),
                                           jnp.asarray(state.tracker.track_ids.numpy()))
        np.testing.assert_array_equal(has_baseline.numpy(), np.asarray(want))


def _ref_predict_flow(m, kf_track_id, kf_norm, track_ids, px, i2c, i2c2, cam0, cam1, L,
                      min_dist):
    """One lane of the reference's predict_flow (vio.py), composed of the
    reference's own functions."""
    K = L + 1
    cur = jnp.concatenate([m[POS:POS + 3], m[ORI:ORI + 4]])
    pose_states = jnp.concatenate([cur[None, :], m[CAM:CAM + POSE_DIM * L].reshape(L, POSE_DIM)])
    cposes = r_camera_poses(pose_states, i2c)
    has_baseline = _ref_has_baseline(kf_track_id, track_ids)
    exists = rtr.feature_exists(types.SimpleNamespace(kf_track_id=kf_track_id), track_ids)
    ks = jnp.arange(K)[:, None]
    k0 = jnp.clip(jnp.min(jnp.where(exists, ks, K), axis=0), 0, K - 1)
    k1 = jnp.clip(jnp.max(jnp.where(exists, ks, -1), axis=0), 0, K - 1)
    slot = jnp.arange(track_ids.shape[0])
    pf = jax.vmap(lambda a, b, ia, ib: r_triangulate_two(
        cposes.p[a], cposes.R[a], cposes.p[b], cposes.R[b], ia, ib))(
        k0, k1, kf_norm[k0, slot, 0, :], kf_norm[k1, slot, 0, :])
    dist = jnp.maximum(jnp.where(has_baseline & (pf[:, 2] > 0.0), jnp.linalg.norm(pf, axis=-1),
                                 -1.0), min_dist)
    prev_px = px[:, 0, :]
    ray0, ok0 = r_pixel_to_ray(cam0, prev_px)
    pw = r_transform_vec3(r_to_camera_to_world(pose_states[1, :3], pose_states[1, 3:], i2c),
                          ray0 * dist[:, None])
    pix1, ok1 = r_ray_to_pixel(cam0, r_transform_vec3(
        r_to_world_to_camera(m[POS:POS + 3], m[ORI:ORI + 4], i2c), pw))
    guess = jnp.where((ok0 & ok1)[:, None], pix1, prev_px)
    pix2, ok2 = r_ray_to_pixel(cam1, r_transform_vec3(
        r_to_world_to_camera(m[POS:POS + 3], m[ORI:ORI + 4], i2c2), pw))
    return guess, jnp.where((ok0 & ok2)[:, None], pix2, guess), has_baseline


def test_predict_flow_triangulated_distance_matches_reference(long_run):
    """A state after 12 steps of the long trail whose trail is made to hold
    every live track in all 11 slots, at the projections of a point 6 m in
    front of the current camera (twice the minimum distance): the branch is
    taken (the guesses move off
    the minimum-distance ones) and the port's guesses (both cameras) equal
    the reference's composition."""
    p, rcam, states = long_run
    vio, state = states[-1]
    plain_guess = vio.predict_flow(state.backend, state.tracker)[0]
    bstate, tstate = state.backend, state.tracker
    m = bstate.ekf.m
    K = TRAIL + 1
    cp = camera_poses_from_states(gather_pose_states(m, TRAIL), vio.backend.imu_to_camera)
    live = tstate.track_ids >= 0
    T = live.shape[1]
    rays = torch.cat([torch.linspace(-0.3, 0.3, T, dtype=m.dtype).expand(B, T)[..., None],
                      torch.zeros((B, T, 1), dtype=m.dtype), torch.ones((B, T, 1), dtype=m.dtype)],
                     dim=-1)
    depth = 2 * p.tracker.predictOpticalFlowMinTriangulationDistance
    X = cp.p[:, 0, None, :] + (rays * depth) @ cp.R[:, 0]  # world points, (B, T, 3)
    c = torch.einsum("bkij,bktj->bkti", cp.R, X[:, None] - cp.p[:, :, None, :])  # (B, K, T, 3)
    trail = bstate.trail._replace(
        kf_track_id=tstate.track_ids[:, None, :].expand(B, K, T).clone(),
        kf_norm=bstate.trail.kf_norm.clone())
    trail.kf_norm[:, :, :, 0, :] = c[..., :2] / c[..., 2:]
    bstate = bstate._replace(trail=trail)
    guess, guess2, has_baseline = vio.predict_flow(bstate, tstate)
    assert (has_baseline & live).any()
    assert (guess != plain_guess).any(dim=-1)[has_baseline & live].any()

    rcams = (rcam, rcam)
    derived_i2c = jnp.asarray(vio.backend.imu_to_camera.numpy())
    derived_i2c2 = jnp.asarray(vio.backend.second_imu_to_camera.numpy())
    want = jax.vmap(lambda *a: _ref_predict_flow(*a, derived_i2c, derived_i2c2, *rcams, TRAIL,
                                                 p.tracker.predictOpticalFlowMinTriangulationDistance))(
        *(jnp.asarray(t.numpy()) for t in (m, trail.kf_track_id, trail.kf_norm, tstate.track_ids,
                                           tstate.px.to(m.dtype))))
    np.testing.assert_array_equal(has_baseline.numpy(), np.asarray(want[2]))
    for got, ref in zip((guess, guess2), want[:2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), rtol=0, atol=1e-4)
