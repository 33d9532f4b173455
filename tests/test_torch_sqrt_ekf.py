"""The port's square-root filter (``ekf/sqrt.py``, ``useSquareRootEkf``)
against the reference's, on the CPU in float64.

The factor's column signs are free, so factors are compared as W W^T.
Tolerances: the primitives (W W^T, the mean, S_half S_half^T, chi^2) to
1e-10; the Backend frame by frame on the reference's
``test_backend_sqrt_matches_dense_f64`` set-up (3 s, mono, B = 1):
positions to 1e-6 m, W W^T to 1e-6 relative to its largest entry, every
integer field exactly; the whole batched stereo step (B = 2, 5 frames) to
``torch_parity.step_tol`` with W W^T in place of W; each state operation
(lock_biases, condition_on_last_pose, transform_to, initialize_orientation,
insert_map_point, augment_pose, undo_augmentation) on a random factor, the
mean and W W^T to 1e-10 relative; the CLI with
-useSquareRootEkf line by line, each step from the reference's state, as
tests/test_torch_cli.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybvio_tpu.ekf import sqrt as rsqrt
from hybvio_tpu.odometry import backend as rb
from hybvio_tpu_torch import convert
from hybvio_tpu_torch.config import DerivedParameters as PortDerived
from hybvio_tpu_torch.ekf import CAM, POSE_DIM
from hybvio_tpu_torch.ekf import sqrt as psqrt
from hybvio_tpu_torch.odometry.backend import Backend, ImuBatch, TrackerInput

import torch_parity as tp
from torch_parity import mismatches
from test_backend import make_setup

torch.set_num_threads(1)

TOL = 1e-10


def _factor(d, k, seed):
    """A random (d, k) factor whose rows span five orders of magnitude, as
    the filter's do."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((d, k)) * 10.0 ** rng.uniform(-3, 2, size=d)[:, None]


def _gram(W):
    W = np.asarray(W)
    return W @ np.swapaxes(W, -1, -2)


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL, atol=TOL * np.abs(b).max(),
                               err_msg=what)


def _lanes(*arrays):
    return tuple(torch.as_tensor(np.asarray(a)) for a in arrays)


PRIMITIVES = ("qr_factor", "sr_update", "sr_update_masked", "sr_add_diag_noise",
              "sr_innovation_chi2", "cov_accessors")


@pytest.mark.parametrize("case", PRIMITIVES)
def test_sqrt_primitives_match_reference(case):
    """Each primitive at B = 2 against the reference's on each lane."""
    rng = np.random.default_rng(PRIMITIVES.index(case))
    d, n, B = 10, 4, 2
    Ws = np.stack([_factor(d, d, 10 + b) for b in range(B)])
    if case == "qr_factor":
        A = np.stack([_factor(d, d + 7, 20 + b) for b in range(B)])
        W = psqrt.qr_factor(torch.as_tensor(A)).numpy()
        assert np.allclose(np.triu(W, 1), 0.0)
        for b in range(B):
            _close(_gram(W[b]), _gram(rsqrt.qr_factor(jnp.asarray(A[b]))), "W W^T")
    elif case in ("sr_update", "sr_update_masked"):
        H = rng.standard_normal((B, n, d))
        v = rng.standard_normal((B, n))
        r = np.abs(rng.standard_normal((B, n))) + 0.1
        if case == "sr_update_masked":  # zero rows with zero residual are no-ops
            H[:, 2:] = 0.0
            v[:, 2:] = 0.0
        m = rng.standard_normal((B, d))
        pm, pW, pS = psqrt.sr_update(*_lanes(m, Ws, v, H, np.sqrt(r)))
        for b in range(B):
            rm, rW, rS = rsqrt.sr_update(*map(jnp.asarray, (m[b], Ws[b], v[b], H[b],
                                                          np.sqrt(r[b]))))
            _close(pm[b], rm, "m")
            _close(_gram(pW[b]), _gram(rW), "W W^T")
            _close(_gram(pS[b]), _gram(rS), "S_half S_half^T")
    elif case == "sr_add_diag_noise":
        q = np.abs(rng.standard_normal((B, d)))
        q[:, ::3] = 0.0
        W = psqrt.sr_add_diag_noise(*_lanes(Ws, q)).numpy()
        for b in range(B):
            _close(_gram(W[b]), _gram(rsqrt.sr_add_diag_noise(jnp.asarray(Ws[b]),
                                                              jnp.asarray(q[b]))), "W W^T")
    elif case == "sr_innovation_chi2":
        H = rng.standard_normal((B, n, d))
        v = rng.standard_normal((B, n))
        chi2 = psqrt.sr_innovation_chi2(*_lanes(Ws, H, v), 0.3).numpy()
        for b in range(B):
            _close(chi2[b], rsqrt.sr_innovation_chi2(*map(jnp.asarray, (Ws[b], H[b], v[b])), 0.3),
                   "chi2")
        # an innovation covariance that is not positive definite rejects:
        # chi^2 is +inf, or NaN where the residual's signs mix, in both
        for vv in (v[0], np.abs(v[0])):
            bad = psqrt.sr_innovation_chi2(torch.zeros(1, d, d, dtype=torch.float64),
                                           torch.as_tensor(H[:1]), torch.as_tensor(vv[None]),
                                           -1.0).item()
            ref = float(rsqrt.sr_innovation_chi2(jnp.zeros((d, d)), jnp.asarray(H[0]),
                                                 jnp.asarray(vv), -1.0))
            assert not np.isfinite(bad) and (bad == ref or np.isnan(bad) and np.isnan(ref))
    else:
        W = torch.as_tensor(Ws)
        for b in range(B):
            Wr = jnp.asarray(Ws[b])
            _close(psqrt.cov_full(W)[b], rsqrt.cov_full(Wr), "cov_full")
            _close(psqrt.cov_diag(W)[b], rsqrt.cov_diag(Wr), "cov_diag")
            _close(psqrt.cov_block(W, slice(2, 5))[b], rsqrt.cov_block(Wr, slice(2, 5)),
                   "cov_block")


def _with_gram(tree):
    """``tree`` (numpy) with every EKF state's factor replaced by W W^T."""
    ekf = tree.backend.ekf if hasattr(tree, "backend") else tree.ekf
    ekf = ekf._replace(P=_gram(ekf.P))
    if hasattr(tree, "backend"):
        return tree._replace(backend=tree.backend._replace(ekf=ekf))
    return tree._replace(ekf=ekf)


def _valid_mean(bstate):
    """The backend state with the factor left out (compared as W W^T) and
    the trail slots past ``augment_count`` zeroed in the mean: the QR leaves
    rounding noise of ~1e-80 in an unused slot, which the quaternion
    normalization blows up to an arbitrary unit vector in either package;
    no track reads such a slot and the next augmentations overwrite it."""
    ekf = bstate.ekf
    end = CAM + POSE_DIM * int(ekf.augment_count.max())
    m = ekf.m.copy()
    m[:, end:CAM + POSE_DIM * ekf.pose_times.shape[1]] = 0.0
    return bstate._replace(ekf=ekf._replace(m=m, P=np.zeros(1)))


def test_backend_sqrt_matches_reference_frame_by_frame():
    """imu_scan and process_frame in sqrt mode against the reference's, on
    its test_backend_sqrt_matches_dense_f64 set-up, each package on its own
    from the same initial state (the perfect tracker drops the tracks the
    reference blacklists)."""
    p, derived, rcam, seq, tracker = make_setup(
        duration=3.0, pixel_noise=0.2, gyro_noise=1e-3, acc_noise=1e-2, max_vu=10,
        max_tracks=20)
    p.odometry.useSquareRootEkf = True
    T = tracker.T
    rinit, rstep = rb.make_backend(p, derived, (rcam,), max_tracks=T)
    r_scan = jax.jit(jax.vmap(rstep.imu_scan))
    r_frame = jax.jit(jax.vmap(rstep.process_frame))
    rstate = jax.vmap(rinit)(jax.vmap(jax.random.PRNGKey)(jnp.arange(1, dtype=jnp.uint32)))
    backend = Backend(p, PortDerived.from_parameters(p), (convert.camera_from_jax(rcam),),
                      max_tracks=T)
    assert backend.sqrt_mode
    state = convert.from_jax(jax.tree.map(np.asarray, rstate), device="cpu")
    assert not mismatches(convert.to_numpy(backend.init_state(state.rng)),
                          jax.tree.map(np.asarray, rstate), 0.0)
    S = int(np.max(np.diff(np.concatenate([[0], seq.frame_sample_idx + 1]))))
    prev, updated = 0, 0
    tol = lambda path: 1e-6 if path.endswith(".position") else np.inf

    for fi in range(len(seq.frame_sample_idx)):
        k = seq.frame_sample_idx[fi] + 1
        n = k - prev
        imu = (np.pad(seq.times[prev:k], (0, S - n), constant_values=seq.times[k - 1])[None],
               np.pad(seq.gyro[prev:k], ((0, S - n), (0, 0)))[None],
               np.pad(seq.acc[prev:k], ((0, S - n), (0, 0)))[None], (np.arange(S) < n)[None])
        prev = k
        ids, pixels, keyframe = tracker.track(fi)
        tin = (ids[None], pixels[None], np.full(1, bool(keyframe)), np.full((1, T), -1.0))
        rstate = r_scan(rstate, rb.ImuBatch(*map(jnp.asarray, imu)))
        rstate, rout = r_frame(rstate, rb.TrackerInput(*map(jnp.asarray, tin)))
        state = backend.imu_scan(state, ImuBatch(*map(torch.as_tensor, imu)))
        state, out = backend.process_frame(state, TrackerInput(*map(torch.as_tensor, tin)))
        rnp, pnp = jax.tree.map(np.asarray, rstate), convert.to_numpy(state)
        diff = (mismatches(_valid_mean(pnp), _valid_mean(rnp), lambda path: 1e-6,
                           f"frame {fi} state")
                + mismatches(convert.to_numpy(out), jax.tree.map(np.asarray, rout), tol,
                             f"frame {fi} output"))
        assert not diff, diff
        P_ref = _gram(rnp.ekf.P)
        np.testing.assert_allclose(_gram(pnp.ekf.P), P_ref, rtol=0,
                                   atol=1e-6 * max(np.abs(P_ref).max(), 1.0),
                                   err_msg=f"frame {fi} W W^T")
        for name in ("position_cov", "velocity_cov", "bias_cov_diag"):
            ref = np.asarray(getattr(rout, name))
            np.testing.assert_allclose(getattr(out, name).numpy(), ref, rtol=0,
                                       atol=1e-6 * max(np.abs(ref).max(), 1.0), err_msg=name)
        updated += int((np.asarray(rout.point_cloud_status) == 1).sum())
        tracker.delete_tracks(np.asarray(rstate.blacklist_flags)[0],
                              np.asarray(rstate.blacklist_ids)[0])
    assert updated > 0  # not vacuous: visual updates ran through the factor
    W = state.ekf.P[0].numpy()
    eig = np.linalg.eigvalsh(_gram(W))
    assert eig.min() > -1e-9 * eig.max()


def test_batched_stereo_step_sqrt_matches_reference():
    """The whole batched stereo step (B = 2, shared frames, the batched
    visual update) in sqrt mode, 5 frames, against the reference's."""
    p, derived, rcam = tp.tiny_stereo_setup()
    p.odometry.useSquareRootEkf = True
    n = 5
    seq = tp.tiny_sequence(n)
    frames = [tp.stereo_frame(seq, fi) for fi in range(n + 1)]
    tracked = tp.batched_step_parity(p, (rcam, rcam), frames, seq, B=2,
                                     compare=lambda s: tp._comparable(_with_gram(s)))
    assert tracked > 0


def test_cli_square_root_filter_matches_reference(tmp_path):
    """The CLI with -useSquareRootEkf over tests/test_torch_cli.py's mono
    dataset (7 frames), each step from the reference's state: every output
    line equals the reference's (floats to mono_step_tol, the covariances
    formed from the factor)."""
    import contextlib
    import io
    import json

    from hybvio_tpu.cli.main import run as ref_run
    from hybvio_tpu_torch.cli.main import run
    from test_torch_cli import _line_mismatches

    ds = tp.make_api_dataset(str(tmp_path / "mono"), 1.0)
    tol = tp.api_tol(tp.mono_step_tol)
    diffs = []
    argv = lambda out: [f"-i={ds}", f"-o={out}", "-maxFrames=7", "-outputJsonExtras",
                        "-useSquareRootEkf", *tp.API_FLAGS]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYBVIO_NATIVE_SYNC", "0")
        states = tp.lockstep(mp, tol, diffs)
        with contextlib.redirect_stderr(io.StringIO()):
            assert ref_run(argv(tmp_path / "ref.jsonl")) == 0
            assert run(argv(tmp_path / "port.jsonl"), device="cpu") == 0
    ref = [json.loads(l) for l in open(tmp_path / "ref.jsonl")]
    got = [json.loads(l) for l in open(tmp_path / "port.jsonl")]
    assert len(states) == len(got) == len(ref) == 4
    W = states[-1].backend.ekf.P[0]
    assert not np.allclose(W, W.T)  # the reference carried a factor, not a covariance
    assert not diffs, diffs
    for i, (p, r) in enumerate(zip(got, ref)):
        diff = _line_mismatches(p, r, tol, f"line {i}")
        assert not diff, diff


SURGERY = ("lock_biases", "condition_on_last_pose", "transform_to", "initialize_orientation",
           "insert_map_point", "augment_pose", "undo_augmentation")


@pytest.mark.parametrize("op", SURGERY)
def test_state_surgery_in_sqrt_mode_matches_reference(op):
    """Each state operation on a factor (a random W with P's five orders of
    magnitude, a 4-slot trail and a 2-point map) against the reference's in
    sqrt mode: the mean and W W^T to 1e-10 relative to their largest
    entries."""
    from hybvio_tpu import ekf as rekf
    from hybvio_tpu.config import Parameters
    from hybvio_tpu_torch import ekf as pekf

    p = Parameters()
    p.odometry.cameraTrailLength, p.odometry.hybridMapSize = 4, 2
    po = p.odometry
    L, M = 4, 2
    d = rekf.state_dim(L, M)
    rng = np.random.default_rng(SURGERY.index(op))
    m = rng.standard_normal(d)
    for off in [rekf.ORI] + [rekf.CAM + 7 * i + 3 for i in range(L)]:
        m[off:off + 4] /= np.linalg.norm(m[off:off + 4])
    W = _factor(d, d, 30)
    ref = rekf.init_state(po, jnp.float64, sqrt_mode=True)._replace(
        m=jnp.asarray(m), P=jnp.asarray(W), augment_count=jnp.asarray(3, jnp.int32),
        time=jnp.asarray(2.0), first_sample_t=jnp.asarray(10.0))
    port = convert.from_jax(jax.tree.map(lambda a: np.asarray(a)[None], ref), device="cpu")
    ns = po.noiseScale ** 2
    q = np.asarray([0.9, 0.1, -0.2, 0.3])
    q /= np.linalg.norm(q)
    pos, xa, pf = np.asarray([1.0, -2.0, 0.5]), np.asarray([0.3, -0.2, 9.7]), np.asarray([1., 2., 5.])
    t = lambda a: torch.as_tensor(np.asarray(a)[None])
    r_do, p_do = {
        "lock_biases": (lambda s: rekf.lock_biases(s, True), lambda s: pekf.lock_biases(s, True)),
        "condition_on_last_pose": (lambda s: rekf.condition_on_last_pose(s, L, True),
                                   lambda s: pekf.condition_on_last_pose(s, L, True)),
        "transform_to": (lambda s: rekf.transform_to(s, jnp.asarray(pos), jnp.asarray(q), L,
                                                     sqrt_mode=True),
                         lambda s: pekf.transform_to(s, t(pos), t(q), L, sqrt_mode=True)),
        "initialize_orientation": (
            lambda s: rekf.initialize_orientation(s, jnp.asarray(xa), po.noiseInitialOri, ns, True),
            lambda s: pekf.initialize_orientation(s, t(xa), po.noiseInitialOri, ns, True)),
        "insert_map_point": (lambda s: rekf.insert_map_point(s, d - 3, jnp.asarray(pf), True),
                             lambda s: pekf.insert_map_point(s, torch.tensor([d - 3]), t(pf),
                                                             True)),
        "augment_pose": (lambda s: rekf.augment_pose(s, 2, po, True),
                         lambda s: pekf.augment_pose(s, torch.tensor([2]), po, True)),
        "undo_augmentation": (lambda s: rekf.undo_augmentation(s, L, M, True),
                              lambda s: pekf.undo_augmentation(s, L, True)),
    }[op]
    want, got = r_do(ref), p_do(port)
    for name, a, b in (("m", got.m[0].numpy(), np.asarray(want.m)),
                       ("W W^T", _gram(got.P[0].numpy()), _gram(want.P))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10 * np.abs(b).max(), err_msg=f"{op} {name}")
    for name in ("augment_count", "pose_times"):
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(), np.asarray(getattr(want, name)))
