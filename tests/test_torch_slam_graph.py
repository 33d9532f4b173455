"""The compiled SLAM side: each keyframe-rate program of the port's SLAM
session and its coupling runs as a ``graphs.CapturedStep`` (a CUDA graph
on the card, as the reference jits each), checked on the CPU for what a
graph needs, and on the card for the capture itself.

A graph replays the kernels its capture recorded, so a program must issue
the same operations with the same host arguments whatever the values of
its inputs, read no value back to the host (no 0-d index, no linear algebra
that checks its result there: ``linalg.svd`` does, which is why the
RANSACs take a Jacobi SVD) and make no tensor from host data once its
constants exist. The tests trace two calls of each program with different
values under one signature, hold each program to its eager form on the CPU
(where a call is the eager call), the Jacobi SVD to LAPACK, the session's
RANSAC programs to the reference's, and the counted collector pause under
two threads. The card-only tests (marked ``cuda``) replay each program bit
for bit against its eager run, with no host sync, from graph pools other
than the VIO steps':

    python -m pytest --noconftest tests/test_torch_slam_graph.py -m cuda -q

This file imports the reference package only inside the tests that compare
with it, so that it also runs on a card without it.
"""
import functools
import gc
import threading

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

from test_torch_graph import _check_same_ops, _trace
from hybvio_tpu_torch import graphs
from hybvio_tpu_torch import random as jr
from hybvio_tpu_torch.config import Parameters
from hybvio_tpu_torch.geometry.cameras import build_pinhole
from hybvio_tpu_torch.io.synthetic import SYNTH_IMU_TO_CAMERA
from hybvio_tpu_torch.odometry.slam_coupling import SlamCoupling
from hybvio_tpu_torch.parallel.batched import Mesh, make_mesh
from hybvio_tpu_torch.slam import loopclosure
from hybvio_tpu_torch.slam.ba import BAProblem
from hybvio_tpu_torch.slam.keypoints import make_multiscale_orb
from hybvio_tpu_torch.slam.posegraph import PoseGraphProblem

torch.set_num_threads(1)

# the linear algebra that reads its result's flags back to the host
CHECKED_ON_HOST = {"_linalg_svd", "_linalg_eigh", "linalg_eig", "_linalg_check_errors"}
PROGRAMS = ["ORB descriptors", "multi-scale keypoints", "descriptor matcher", "local BA",
            "pose graph", "similarity RANSAC", "PnP RANSAC", "vocabulary k-means",
            "ray_to_pixel", "uint8 quantizer", "sharded BA"]
H, W = 48, 64  # the keypoint detector's and the ORB sampler's frame


@functools.lru_cache(maxsize=None)
def _coupling(device):
    """A SLAM coupling at small sizes (its session: 4 BA keyframes, 16 map
    points, a 2-shard mesh BA of the device's kind) and the keypoint
    detector made in the session's pools."""
    cam = build_pinhole(50.0, 50.0, W / 2, H / 2, width=W, height=H)
    c = SlamCoupling(Parameters(), np.asarray(SYNTH_IMU_TO_CAMERA), use_thread=False,
                     camera=cam, device=device)
    c.slam.NK, c.slam.MP = 4, 16
    c.slam.set_ba_mesh(make_mesh(2, device) if device == "cpu"
                       else Mesh((torch.device("cuda", 0),) * 2))
    with graphs.capturing_into(c.slam.graph_pools):
        detect, _ = make_multiscale_orb(H, W, n_levels=3, total_kps=64)
    return c, detect


def _ba_problem(rng, dev, NK=4, MP=16):
    poses = np.zeros((NK, 7))
    poses[:, 3] = 1.0
    poses[:, 0] = np.linspace(0.0, 0.6, NK) + 0.01 * rng.randn(NK)
    pts = rng.randn(MP, 3) + np.array([0.0, 0.0, 5.0])
    obs = np.stack([(pts - p[:3])[:, :2] / (pts - p[:3])[:, 2:] for p in poses])
    rel = np.zeros((NK - 1, 7))
    rel[:, 3] = 1.0
    rel[:, 0] = 0.2
    f = lambda a: torch.as_tensor(np.asarray(a)).to(dev)
    return BAProblem(f(poses), f(pts + 0.05 * rng.randn(MP, 3)),
                     f(obs + 1e-3 * rng.randn(*obs.shape)), f(rng.rand(NK, MP) < 0.9),
                     f(np.arange(NK) < NK - 1), f(np.arange(MP) < MP - 2), f(rel),
                     f(np.ones(NK - 1, bool)),
                     f(np.float64(0.5)), f(np.float64(5.0)))


def _inputs(name, seed, device="cpu"):
    """(the program, its positional and keyword arguments) of ``name``, at
    small shapes, with values from ``seed``; one signature whatever the
    seed."""
    c, detect = _coupling(device)
    s = c.slam
    rng = np.random.RandomState(seed)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(device)
    img = f32(np.clip(0.5 + 0.3 * rng.randn(H, W), 0.0, 1.0))
    desc = lambda n: f32(np.sign(rng.randn(n, 256)))
    mask = lambda n, k: torch.as_tensor(np.arange(n) < k).to(device)
    key = jr.prng_key(torch.as_tensor(seed + 1).to(device))
    if name == "ORB descriptors":
        return s._orb_program, (img, f32(rng.rand(256, 2) * [W, H]), mask(256, 200)), {}
    if name == "multi-scale keypoints":
        return detect.program, (img,), {}
    if name == "descriptor matcher":
        return s._match_program, (desc(256), mask(256, 250), desc(256), mask(256, 240)), \
            dict(lowe_ratio=0.7)
    if name in ("local BA", "sharded BA"):
        program = s._ba_program if name == "local BA" else s._ba_sharded.programs[0]
        return program, (_ba_problem(rng, device),), {}
    if name == "pose graph":
        N = E = 8
        poses = np.zeros((N, 7))
        poses[:, 3] = 1.0
        poses[:, 1] = np.arange(N) * 0.5 + 0.05 * rng.randn(N)
        rel = np.zeros((E, 7))
        rel[:, 3] = 1.0
        rel[:, 1] = 0.5
        ei = np.array([0, 1, 2, 3, 4, 0, 0, 0], np.int32)
        ej = np.array([1, 2, 3, 4, 5, 5, 0, 0], np.int32)
        w = (np.arange(E) < 6) * (1.0 + rng.rand(E))
        return s._pose_graph_program, (PoseGraphProblem(
            f64(poses), mask(N, 6), torch.as_tensor(ei).to(device),
            torch.as_tensor(ej).to(device), f64(rel), f64(w), f64(w)), 6), {}
    P, M = 256, 40
    X = rng.randn(P, 3) + np.array([0.0, 0.0, 5.0])
    if name == "similarity RANSAC":
        dst = 1.1 * X + 0.3 + 0.01 * rng.randn(P, 3)
        return s._similarity_program, (f64(X), f64(dst), mask(P, M), key), \
            dict(n_hyp=16, threshold=f64(0.1 + 0.01 * seed), with_scale=True)
    if name == "PnP RANSAC":
        obs = X[:, :2] / X[:, 2:] + 1e-3 * rng.randn(P, 2)
        return s._pnp_program, (f64(X), f64(obs), mask(P, M), key), \
            dict(n_hyp=16, threshold=f64(0.02 + 0.001 * seed))
    if name == "vocabulary k-means":
        return s.vocabulary.kmeans_program, (desc(64), desc(256), mask(256, 200), 2), {}
    if name == "ray_to_pixel":
        rays = np.ones((256, 3), np.float32)
        rays[:, :2] = 0.3 * rng.randn(256, 2)
        return c._ray_to_pixel, (c.camera, f32(rays)), {}
    if name == "uint8 quantizer":
        return c._quantize_u8, (f32(1.2 * rng.rand(H, W) - 0.1),), {}
    raise ValueError(name)


def _equal(a, b):
    """Every leaf of the two trees the same dtype, shape and bits (NaN
    equal to NaN)."""
    xs, ys = tree_flatten(a)[0], tree_flatten(b)[0]
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y) or (x.is_floating_point() and torch.equal(
            torch.nan_to_num(x, nan=7.0), torch.nan_to_num(y, nan=7.0)))


@pytest.mark.parametrize("name", PROGRAMS)
def test_program_issues_a_value_independent_op_sequence(name):
    """After a first call, two calls with other values under the same
    signature issue the same aten operations with the same host arguments,
    read nothing back to the host, make no tensor from host data and call
    no linear algebra that checks its result on the host."""
    program, args, kwargs = _inputs(name, 0)
    program(*args, **kwargs)  # constants go to the device once
    traces = []
    for seed in (1, 2):
        program, args, kwargs = _inputs(name, seed)
        trace, _ = _trace(lambda: program(*args, **kwargs))
        traces.append(trace)
    _check_same_ops(*traces, name)
    called = {op[0].overloadpacket.__name__ for op in traces[0].ops}
    assert not called & CHECKED_ON_HOST, (name, called & CHECKED_ON_HOST)


@pytest.mark.parametrize("name", PROGRAMS)
def test_program_on_the_cpu_is_its_eager_form(name):
    """On the CPU a program's call is its eager call, bit for bit, and
    captures nothing; each program is a CapturedStep named "slam ...", the
    session's in the session's graph pools (never the VIO steps'), the
    quantizer, which runs on the stepping thread, in the steps' pools."""
    program, args, kwargs = _inputs(name, 3)
    _equal(program(*args, **kwargs), program.eager(*args, **kwargs))
    assert isinstance(program, graphs.CapturedStep) and program.name == f"slam {name}"
    assert program.captures == program.keys == 0
    session_pools = _coupling("cpu")[0].slam.graph_pools
    if name == "uint8 quantizer":
        assert program.pools is graphs.STEP_POOLS
    else:
        assert program.pools is session_pools and program in session_pools.programs
        assert program not in graphs.STEP_POOLS.programs


def test_collector_pause_is_counted_across_threads():
    """Two threads pausing at once (two captures): the collector stays off
    until the last one ends, whichever ends first, and is then on again;
    a pause that begins with the collector off leaves it off."""
    assert gc.isenabled()
    inside, release_b = threading.Barrier(2), threading.Event()
    seen = {}

    def capture(name, wait_for):
        with graphs.collector_paused():
            inside.wait(timeout=10)
            if wait_for is not None:
                assert wait_for.wait(timeout=10)
            seen[name] = gc.isenabled()

    a = threading.Thread(target=capture, args=("a", None))
    b = threading.Thread(target=capture, args=("b", release_b))
    a.start()
    b.start()
    a.join(timeout=10)
    assert not a.is_alive() and b.is_alive()
    assert not gc.isenabled()  # a ended first; b still captures
    release_b.set()
    b.join(timeout=10)
    assert seen == {"a": False, "b": False} and gc.isenabled()
    gc.disable()
    try:
        with graphs.collector_paused():
            assert not gc.isenabled()
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_capturing_into_is_per_thread():
    """Programs made inside ``capturing_into`` take its pools; one made in
    another thread meanwhile takes the VIO steps' pools."""
    pools, other = graphs.GraphPools("test"), {}
    with graphs.capturing_into(pools):
        mine = graphs.CapturedStep(lambda x: x + 1, "slam test")
        t = threading.Thread(target=lambda: other.update(p=graphs.CapturedStep(abs, "step")))
        t.start()
        t.join(timeout=10)
    after = graphs.CapturedStep(abs, "after")
    assert mine.pools is pools and pools.programs == [mine]
    assert other["p"].pools is graphs.STEP_POOLS and after.pools is graphs.STEP_POOLS


def _dlt(rng, n, noise):
    X = rng.randn(n, 3) + np.array([0.0, 0.0, 5.0])
    x = X[:, :2] / X[:, 2:] + noise * rng.randn(n, 2)
    Xh = np.concatenate([X, np.ones((n, 1))], axis=1)
    z = np.zeros_like(Xh)
    return np.concatenate([np.concatenate([Xh, z, -x[:, :1] * Xh], axis=1),
                           np.concatenate([z, Xh, -x[:, 1:] * Xh], axis=1)])


@pytest.mark.parametrize("case", ["3x3", "3x3 rank 2", "3x3 rank 1", "DLT 12x12",
                                  "DLT 512x12 weighted"])
def test_jacobi_svd_matches_lapack(case):
    """The RANSACs' one-sided Jacobi SVD against LAPACK's: the singular
    values to 1e-13 of the largest, A = U S V^T, V orthonormal (and U for
    3x3, rank-deficient too, with the proper-rotation product U D V^T
    LAPACK's), the null vector (the last column of V) to rounding up to its
    sign."""
    rng = np.random.RandomState(len(case))
    if case.startswith("3x3"):
        A = rng.randn(64, 3, 3)
        if "rank 2" in case:
            A[..., 2] = A[..., 0] - 0.5 * A[..., 1]
        if "rank 1" in case:
            A = rng.randn(64, 3, 1) * rng.randn(64, 1, 3)
    elif case == "DLT 12x12":
        A = np.stack([_dlt(rng, 6, 1e-3) for _ in range(32)])
    else:
        A = _dlt(rng, 256, 1e-3) * (rng.rand(512, 1) < 0.7)
    U, S, V = (x.numpy() for x in loopclosure._svd(torch.as_tensor(A)))
    Un, Sn, Vtn = np.linalg.svd(A)
    scale = Sn.max(axis=-1, keepdims=True)
    np.testing.assert_allclose(S, Sn, rtol=0, atol=1e-13 * scale.max())
    np.testing.assert_allclose(U @ (S[..., None] * np.swapaxes(V, -1, -2)), A, rtol=0,
                               atol=1e-12 * scale.max())
    eye = np.eye(V.shape[-1])
    np.testing.assert_allclose(np.swapaxes(V, -1, -2) @ V, np.broadcast_to(eye, V.shape),
                               rtol=0, atol=1e-13)
    if case.startswith("3x3"):
        np.testing.assert_allclose(np.swapaxes(U, -1, -2) @ U, np.broadcast_to(eye, U.shape),
                                   rtol=0, atol=1e-12)
        R = loopclosure._proper(torch.as_tensor(U), torch.as_tensor(np.swapaxes(V, -1, -2)),
                                torch.float64)[1].numpy()
        Rn = loopclosure._proper(torch.as_tensor(Un), torch.as_tensor(Vtn), torch.float64)[1]
        if "rank" not in case:  # a rank-deficient A leaves the third axis free
            np.testing.assert_allclose(R, Rn.numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(np.linalg.det(R), 1.0, rtol=0, atol=1e-12)
    else:
        v, vn = V[..., :, -1], Vtn[..., -1, :]
        sign = np.sign(np.sum(v * vn, axis=-1, keepdims=True))
        np.testing.assert_allclose(v * sign, vn, rtol=0, atol=1e-10)


@pytest.mark.parametrize("which", ["similarity", "PnP"])
def test_session_ransac_programs_equal_reference(which):
    """The session's RANSAC programs, run as the session runs them (the
    threshold and the key as tensors, padded to 256), against the
    reference's host wrappers: the same inliers, the models to 1e-9."""
    from hybvio_tpu.slam import loopclosure as r_lc

    s = _coupling("cpu")[0].slam
    rng = np.random.RandomState(7)
    X = rng.randn(40, 3) * 2 + np.array([0.0, 0.0, 6.0])
    a = 0.3
    Rt = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    if which == "similarity":
        dst = 1.1 * X @ Rt.T + np.array([0.3, -0.2, 0.1]) + 0.01 * rng.randn(40, 3)
        dst[:10] += rng.randn(10, 3)
        got = loopclosure.similarity_on_host(s._similarity_program, X, dst, seed=3, n_hyp=100,
                                             threshold=0.1, with_scale=True, pad=256,
                                             device="cpu")
        want = r_lc.ransac_similarity_np(X, dst, seed=3, n_hyp=100, threshold=0.1,
                                         with_scale=True)
        inliers, count, models = 3, 4, 3
    else:
        pc = X @ Rt.T + np.array([0.1, 0.2, 0.3])
        obs = pc[:, :2] / pc[:, 2:] + 0.001 * rng.randn(40, 2)
        obs[:8] += 0.3
        got = loopclosure.pnp_on_host(s._pnp_program, X, obs, seed=4, n_hyp=100,
                                      threshold=0.02, pad=256, device="cpu")
        want = r_lc.ransac_pnp_np(X, obs, seed=4, n_hyp=100, threshold=0.02)
        inliers, count, models = 2, 3, 2
    np.testing.assert_array_equal(got[inliers], np.asarray(want[inliers]))
    assert got[count] == want[count] >= 25
    for x, y in zip(got[:models], want[:models]):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("name", PROGRAMS)
def test_program_replays_bit_equal_on_the_card(name):
    """On the card: the session's programs warm up at the first call of a
    signature and capture at the second (the quantizer, in the VIO steps'
    pools, captures at the first), then replay without a host sync,
    bit-equal with the eager form on the same inputs; the SLAM graphs lie
    in pools other than the VIO steps'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 14 runs it at full size")
    program, args, kwargs = _inputs(name, 5, "cuda")
    want = program.eager(*args, **kwargs)
    program(*args, **kwargs)
    assert program.captures == (name == "uint8 quantizer")
    if not program.captures:
        _equal(program(*args, **kwargs), want)  # the capture, then a replay
    torch.cuda.synchronize()
    replays = program.replays
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = program(*args, **kwargs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert program.replays == replays + 1 and program.captures == program.keys == 1
    _equal(got, want)
    step_pool = graphs.STEP_POOLS.card("cuda:0").handle
    if name == "uint8 quantizer":
        assert program.pools is graphs.STEP_POOLS
    else:
        assert tuple(program.pools.card("cuda:0").handle) != tuple(step_pool)
        assert program.pools.nbytes("cuda:0") > 0
