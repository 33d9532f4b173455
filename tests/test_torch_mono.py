"""The port's mono pieces against the reference: the five-point solver, the
RANSAC5 and hybrid RANSAC2/RANSAC5 selection with the same keys, and the
whole mono batched step.

The five-point solver's Durand-Kerner iteration assigns its 10 start points
to the roots by a rounding-sensitive race, so the solutions of a sample are
compared as sets (the same number of valid E, each within the tolerance of
one on the other side), not slot by slot. In float32 the Faddeev-LeVerrier
characteristic polynomial loses all its digits to cancellation (from one
action matrix, two summation orders of the 10x10 products give
coefficients that differ by 100% or more), so which roots pass the gates
depends on the order of the sums: the reference's own jitted and eager forms
disagree in the number of valid E on some of the 12 samples below. The float32
test therefore holds every stage that is stable (coefficient matrix, action
matrix, Durand-Kerner roots) to the reference from identical inputs, and
the whole solver to the true essential matrix, which both find."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybvio_tpu.config import Parameters as RParameters
from hybvio_tpu.frontend import five_point as rfp
from hybvio_tpu.frontend.ransac import hybrid_ransac as r_hybrid_ransac
from hybvio_tpu.frontend.ransac import ransac5 as r_ransac5
from hybvio_tpu.geometry.cameras import build_pinhole as r_build_pinhole
from hybvio_tpu.geometry.cameras import normalize_pixel as r_normalize_pixel
from hybvio_tpu_torch import convert
from hybvio_tpu_torch.config import Parameters
from hybvio_tpu_torch.frontend import five_point as fp
from hybvio_tpu_torch.frontend.ransac import hybrid_ransac, ransac5

from test_five_point import _scene
from torch_parity import (
    batched_step_parity, mono_frame, mono_step_tol, tiny_mono_setup, tiny_sequence,
)

torch.set_num_threads(1)

SAMPLES = [(planar, seed) for planar in (False, True) for seed in range(6)]


def _samples(dtype):
    p1, p2 = zip(*[_scene(5, planar=planar, seed=seed) for planar, seed in SAMPLES])
    return np.stack(p1).astype(dtype), np.stack(p2).astype(dtype)


def _set_distance(Ea, va, Eb, vb):
    """Largest distance from a valid E on either side to the nearest valid
    E on the other (max abs entry); inf when the counts differ."""
    a, b = Ea[va], Eb[vb]
    if len(a) != len(b):
        return np.inf
    if not len(a):
        return 0.0
    d = np.abs(a[:, None] - b[None]).max(axis=(2, 3))
    return max(d.min(axis=1).max(), d.min(axis=0).max())


def test_five_point_float64_matches_reference():
    """Every sample gives as many valid E as the reference's, each within
    1e-7 of one of the reference's; most agree to 1e-10. (The non-planar
    seed-4 sample has a near-double root, where Durand-Kerner converges to
    about the square root of the machine epsilon: 3.5e-8 there.)"""
    p1, p2 = _samples(np.float64)
    rE, rv = map(np.asarray, jax.jit(jax.vmap(rfp.five_point_essential))(
        jnp.asarray(p1), jnp.asarray(p2)))
    E, v = fp.five_point_essential(torch.as_tensor(p1), torch.as_tensor(p2))
    E, v = E.numpy(), v.numpy()
    dists = [_set_distance(E[s], v[s], rE[s], rv[s]) for s in range(len(SAMPLES))]
    assert max(dists) <= 1e-7, dists
    assert np.median(dists) <= 1e-10, dists
    assert v.sum() >= 2 * len(SAMPLES)


def _true_E(th=0.1, t=(0.3, 0.05, 0.1)):
    """The essential matrix of _scene's motion (unit Frobenius norm)."""
    R = np.array([[np.cos(th), 0, -np.sin(th)], [0, 1, 0], [np.sin(th), 0, np.cos(th)]])
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = R.T @ tx
    return E / np.linalg.norm(E)


def test_five_point_float32_stages_match_reference():
    """From identical float32 inputs the coefficient matrix, the action
    matrix and the Durand-Kerner roots agree with the reference's to float32
    rounding, and where the reference's solver finds the true essential
    matrix to 1e-3 (up to sign) the port's finds it to 1e-3 as well."""
    p1, p2 = _samples(np.float32)
    rel = lambda a, b: np.abs(a - b).max() / np.abs(b).max()
    found = 0
    for s in range(len(SAMPLES)):
        h1 = np.concatenate([p1[s], np.ones((5, 1), np.float32)], 1)
        h2 = np.concatenate([p2[s], np.ones((5, 1), np.float32)], 1)
        A = np.einsum("ni,nj->nij", h2, h1).reshape(5, 9)
        Q = np.asarray(jnp.linalg.qr(jnp.asarray(A.T), mode="complete")[0])
        Qp = torch.linalg.qr(torch.as_tensor(A.T), mode="complete")[0].numpy()
        assert np.abs(Qp[:, 5:] - Q[:, 5:]).max() <= 1e-4  # signs agree, not just the span
        null = [Q[:, 5 + i].reshape(3, 3) for i in range(4)]
        M = np.asarray(rfp._coeff_matrix(*map(jnp.asarray, null), jnp.float32))
        assert rel(fp._coeff_matrix(*map(torch.tensor, null)).numpy(), M) <= 1e-5
        Ax = np.asarray(rfp._action_matrix(jnp.asarray(M), jnp.float32))
        assert rel(fp._action_matrix(torch.tensor(M)).numpy(), Ax) <= 1e-3
        c = np.asarray(rfp._charpoly(jnp.asarray(Ax)))
        roots = np.asarray(rfp._roots_durand_kerner(jnp.asarray(c)))
        assert rel(fp._roots_durand_kerner(torch.tensor(c)).numpy(), roots) <= 1e-3
    rE, rv = map(np.asarray, jax.jit(jax.vmap(rfp.five_point_essential))(
        jnp.asarray(p1), jnp.asarray(p2)))
    E, v = fp.five_point_essential(torch.as_tensor(p1), torch.as_tensor(p2))
    E, v = E.numpy(), v.numpy()
    Et = _true_E()
    to_true = lambda Es: min([min(np.abs(e - Et).max(), np.abs(e + Et).max()) for e in Es] or [9.0])
    for s in range(len(SAMPLES)):
        if to_true(rE[s][rv[s]]) <= 1e-3:
            found += 1
            assert to_true(E[s][v[s]]) <= 1e-3, SAMPLES[s]
    assert found >= 6


def _ransac_scene(B, T, planar, seed, n_out):
    """Per lane: T normalized correspondences of _scene, the first n_out
    made gross outliers (the second point moved 0.1-0.3 across its true
    epipolar line, 50-150 times the threshold), some slots invalid."""
    rng = np.random.RandomState(seed)
    Et = _true_E()
    n1, n2, valid = [], [], []
    for b in range(B):
        a, c = _scene(T, planar=planar, seed=seed + b)
        line = np.concatenate([a[:n_out], np.ones((n_out, 1))], 1) @ Et.T  # epipolar lines
        normal = line[:, :2] / np.linalg.norm(line[:, :2], axis=1, keepdims=True)
        c[:n_out] += normal * rng.uniform(0.1, 0.3, (n_out, 1)) * rng.choice([-1, 1], (n_out, 1))
        n1.append(a)
        n2.append(c)
        valid.append(rng.rand(T) > 0.1)
    return np.stack(n1), np.stack(n2), np.stack(valid)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("planar", [False, True])
def test_ransac5_same_keys(planar, dtype):
    B, T = 3, 40
    n1, n2, valid = _ransac_scene(B, T, planar, 11, 12)
    n1, n2 = n1.astype(dtype), n2.astype(dtype)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B, dtype=jnp.uint32) + 3)
    ref = jax.jit(jax.vmap(lambda a, b, v, k: r_ransac5(a, b, v, k, 2e-3, max_iters=75)))(
        jnp.asarray(n1), jnp.asarray(n2), jnp.asarray(valid), keys)
    out = ransac5(torch.as_tensor(n1), torch.as_tensor(n2), torch.as_tensor(valid),
                  convert.from_jax(np.asarray(keys), device="cpu"), 2e-3, max_iters=75,
                  int_bits=64)
    np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_array_equal(out.inlier_count.numpy(), np.asarray(ref.inlier_count))
    np.testing.assert_array_equal(out.ok.numpy(), np.asarray(ref.ok))
    truth = valid.copy()
    truth[:, :12] = False
    assert (out.inliers.numpy() == truth).mean() > 0.95


def _hybrid_inputs(rotation_only, seed, B=3, T=40):
    """Pixel tracks of a 96x64 pinhole camera (f = 80) between two poses:
    a pure rotation (RANSAC2 explains it) or a translation through a near
    scene (RANSAC2 cannot, RANSAC5 can), with gross outliers: 2 in the
    rotation, few enough for RANSAC2 to pass ransac2InliersToSkipRansac5."""
    rng = np.random.RandomState(seed)
    pts1, pts2, valid = [], [], []
    th = 0.03
    R = np.array([[np.cos(th), 0, -np.sin(th)], [0, 1, 0], [np.sin(th), 0, np.cos(th)]])
    t = np.zeros(3) if rotation_only else np.array([0.4, 0.1, 0.2])
    for _ in range(B):
        P = np.stack([rng.uniform(-1.5, 1.5, T), rng.uniform(-1, 1, T), rng.uniform(2.5, 4, T)], 1)
        Q = (P - t) @ R
        px = lambda X: X[:, :2] / X[:, 2:] * 80.0 + [48.0, 32.0]
        a, b = px(P), px(Q)
        n_out = 2 if rotation_only else 6
        b[:n_out] += rng.uniform(15, 25, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
        pts1.append(a)
        pts2.append(b)
        valid.append(rng.rand(T) > 0.1)
    return (np.stack(pts1).astype(np.float32), np.stack(pts2).astype(np.float32),
            np.stack(valid))


@pytest.mark.parametrize("rotation_only, picks_r5", [(True, False), (False, True)])
def test_hybrid_ransac_same_keys(rotation_only, picks_r5):
    """The RANSAC2 / RANSAC5 choice, the inliers and the skip flag equal the
    reference's; the translating scene picks RANSAC5, the rotating one
    RANSAC2."""
    B = 3
    pts1, pts2, valid = _hybrid_inputs(rotation_only, 5, B)
    rcam = r_build_pinhole(80.0, 80.0, 48.0, 32.0, width=96, height=64, dtype=jnp.float32)
    cam = convert.camera_from_jax(rcam)
    rpt, pt = RParameters().tracker, Parameters().tracker
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B, dtype=jnp.uint32) + 21)
    thr2, thr5 = 2.0, 2.0 / 80.0

    def ref_one(a, b, v, k):
        n1, _ = r_normalize_pixel(rcam, a)
        n2, _ = r_normalize_pixel(rcam, b)
        return r_hybrid_ransac(rcam, rcam, a, b, n1, n2, v, k, rpt, thr2, thr5)

    ref = jax.jit(jax.vmap(ref_one))(jnp.asarray(pts1), jnp.asarray(pts2), jnp.asarray(valid),
                                     keys)
    from hybvio_tpu_torch.geometry.cameras import normalize_pixel

    t1, t2 = torch.as_tensor(pts1), torch.as_tensor(pts2)
    out = hybrid_ransac(cam, cam, t1, t2, normalize_pixel(cam, t1)[0], normalize_pixel(cam, t2)[0],
                        torch.as_tensor(valid), convert.from_jax(np.asarray(keys), device="cpu"),
                        pt, thr2, thr5, int_bits=64)
    for name in ("inliers", "used_r5", "skipped"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                      name)
    np.testing.assert_allclose(out.score.numpy(), np.asarray(ref.score), rtol=1e-6)
    assert out.used_r5.numpy().tolist() == [picks_r5] * B
    assert not out.skipped.numpy().any()


def test_batched_mono_step_matches_reference():
    """The whole mono batched step, B=2 lanes over 5 rendered frames, as
    test_torch_slice.py holds the stereo one: integer and boolean fields
    equal, positions to 1e-6 m, the other floats to
    torch_parity.mono_step_tol (step_tol with the covariances and the
    triangulated points held less tightly, for the reason given there)."""
    p, _, rcam = tiny_mono_setup()
    seq = tiny_sequence(5)
    frames = [mono_frame(seq, fi) for fi in range(6)]
    assert batched_step_parity(p, (rcam,), frames, seq, 2, tol=mono_step_tol) > 0
