"""The port's SLAM modules (slam/, frontend/fast.py, the SLAM helpers of
frontend/gftt.py and frontend/pyramid.py) against the reference package's on
the same numpy inputs from a seed, on the CPU.

Tolerances: the image helpers, FAST, the packed block max, the descriptors
of textured patches, the multi-scale detector, the matcher, k-means and the
vocabulary's word lists are exact; the float64 solves (bundle adjustment,
linear triangulation, the pose graph, Kabsch and the two RANSACs, whose
hypotheses come from the bit-exact threefry) agree to 1e-9 with identical
inlier sets. In a flat image region the intensity-centroid angle is the
rounding noise of two sums near 0 and a BRIEF pair's two samples differ by
rounding only: there the reference's float32 bits depend on its reduction
order, and only the bits whose two samples differ by more than 1e-6 are held.
The session over the scenarios of test_slam.py and test_slam_global.py is in
test_torch_slam_session.py."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hybvio_tpu.frontend.fast import fast_score as r_fast_score
from hybvio_tpu.frontend.gftt import block_max_packed as r_block_max_packed
from hybvio_tpu.frontend.pyramid import _sep_conv2d as r_sep_conv2d
from hybvio_tpu.frontend.pyramid import bilinear_sample as r_bilinear_sample
from hybvio_tpu.io.synthetic import SYNTH_IMU_TO_CAMERA, generate_sequence, render_view
from hybvio_tpu.slam import ba as r_ba
from hybvio_tpu.slam import keypoints as r_keypoints
from hybvio_tpu.slam import loopclosure as r_lc
from hybvio_tpu.slam import orb as r_orb
from hybvio_tpu.slam import posegraph as r_pg
from hybvio_tpu.slam import vocabulary as r_vocab
from hybvio_tpu_torch.frontend.fast import fast_score
from hybvio_tpu_torch.frontend.gftt import block_max_packed
from hybvio_tpu_torch.frontend.pyramid import _sep_conv2d, bilinear_sample
from hybvio_tpu_torch.slam import ba, keypoints, loopclosure, orb, posegraph, vocabulary
from hybvio_tpu_torch.slam.host import (np_mat_to_pose, np_pose_to_mat, np_quat_mul,
                                        np_relative_pose)

torch.set_num_threads(1)

SOLVE_TOL = 1e-9


def _t(a):
    return torch.as_tensor(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _textured(H=240, W=320, seed=3):
    """A render_view frame (sky background + landmark blobs): no flat
    region."""
    seq = generate_sequence(duration=1.0, seed=seed)
    f = 260.0 * W / 320
    return render_view(seq.landmarks, seq.pos[0], seq.quat[0], SYNTH_IMU_TO_CAMERA, f, f,
                       W / 2, H / 2, W, H).astype(np.float32)


def _boxes(seed=0, H=240, W=320):
    """test_slam.py's kind of frame: flat 0.3 with 5x5 boxes."""
    rng = np.random.RandomState(seed)
    img = np.zeros((H, W), np.float32) + 0.3
    for u, v in zip(rng.randint(8, W - 8, 40), rng.randint(8, H - 8, 40)):
        img[v - 2:v + 3, u - 2:u + 3] += 0.5 if rng.rand() < 0.5 else -0.2
    return np.clip(img, 0, 1)


# ----------------------------------------------------------- image helpers

@pytest.mark.parametrize("image", ["random", "textured", "boxes"])
def test_image_helpers_equal_reference(image):
    img = {"random": np.random.RandomState(0).rand(120, 160).astype(np.float32),
           "textured": _textured(120, 160), "boxes": _boxes(H=120, W=160)}[image]
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    np.testing.assert_array_equal(_sep_conv2d(_t(img), k, k).numpy(),
                                  np.asarray(r_sep_conv2d(_j(img), k, k)))
    xy = (np.random.RandomState(1).rand(50, 7, 2) * [170, 130] - 5).astype(np.float32)
    np.testing.assert_array_equal(bilinear_sample(_t(img), _t(xy)).numpy(),
                                  np.asarray(r_bilinear_sample(_j(img), _j(xy))))
    for thr in (7.0 / 255, 20.0 / 255):
        resp = fast_score(_t(img), thr).numpy()
        np.testing.assert_array_equal(resp, np.asarray(r_fast_score(_j(img), thr)))
        for cell in (8, 16):
            s, xy = block_max_packed(_t(resp), cell)
            rs, rxy = r_block_max_packed(_j(resp), cell)
            np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
            np.testing.assert_array_equal(xy.numpy(), np.asarray(rxy))
    if image != "random":
        assert (fast_score(_t(img), 7.0 / 255).numpy() > 0).any()


# ---------------------------------------------------------------- ORB

def _orb_inputs(n=64, seed=1):
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n, 2) * [320, 240]).astype(np.float32)
    return pts, rng.rand(n) > 0.1


def _pair_margin(img, pts, desc_ref):
    """|va - vb| of every BRIEF pair at the reference's angle (the port's
    own sampling with the reference's orientation), (T, N_BITS)."""
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    im = _sep_conv2d(_t(img), k, k)
    r = 15
    ax = torch.arange(-r, r + 1, dtype=torch.float32)
    ox, oy = torch.meshgrid(ax, ax, indexing="xy")
    offs = torch.stack([ox, oy], -1).reshape(-1, 2)
    circ = ((ox * ox + oy * oy) <= r * r).reshape(-1).float()
    p = _t(pts)
    patch = bilinear_sample(im, p[:, None] + offs) * circ
    th = torch.atan2((patch * offs[:, 1]).sum(-1), (patch * offs[:, 0]).sum(-1))
    c, s = torch.cos(th), torch.sin(th)
    pa, pb = _t(orb._PAIRS_A).float(), _t(orb._PAIRS_B).float()
    va = bilinear_sample(im, p[:, None] + orb._rotate(pa, c, s))
    vb = bilinear_sample(im, p[:, None] + orb._rotate(pb, c, s))
    return (va - vb).abs().numpy()


def test_brief_pairs_are_the_reference_stream():
    np.testing.assert_array_equal(orb._PAIRS_A, r_orb._PAIRS_A)
    np.testing.assert_array_equal(orb._PAIRS_B, r_orb._PAIRS_B)


def test_orb_descriptors_textured_equal_reference():
    img = _textured()
    pts, valid = _orb_inputs()
    d, ok = orb.orb_descriptors(_t(img), _t(pts), _t(valid))
    rd, rok = r_orb.orb_descriptors(_j(img), _j(pts), _j(valid))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
    assert set(np.unique(d.numpy())) == {-1.0, 1.0}


def test_orb_descriptors_flat_regions_agree_where_the_pairs_differ():
    """On test_slam.py's flat frames the reference's bits are rounding noise
    where a pair's samples are equal up to rounding; every bit whose pair
    differs by more than 1e-6 agrees at points whose angle is defined (the
    reference's moments are not both noise)."""
    img = _boxes(seed=4)
    pts, valid = _orb_inputs(seed=2)
    d, ok = orb.orb_descriptors(_t(img), _t(pts), _t(valid))
    rd, rok = map(np.asarray, r_orb.orb_descriptors(_j(img), _j(pts), _j(valid)))
    np.testing.assert_array_equal(ok.numpy(), rok)
    margin = _pair_margin(img, pts, rd)
    # the angle is defined where the first moments are far above rounding
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    im = r_sep_conv2d(_j(img), k, k)
    ax = np.arange(-15, 16, dtype=np.float32)
    ox, oy = np.meshgrid(ax, ax)
    offs = np.stack([ox, oy], -1).reshape(-1, 2)
    circ = ((ox * ox + oy * oy) <= 225).reshape(-1)
    patch = np.asarray(r_bilinear_sample(im, _j(pts[:, None] + offs))) * circ
    moment = np.hypot((patch * offs[:, 0]).sum(-1), (patch * offs[:, 1]).sum(-1))
    defined = moment > 1e-2
    held = defined[:, None] & (margin > 1e-6)
    assert held.sum() > 0.05 * held.size
    np.testing.assert_array_equal(d.numpy()[held], rd[held])


def test_frame_signature_and_matching_equal_reference():
    img = _textured()
    pts, valid = _orb_inputs(seed=5)
    rd, rok = map(np.asarray, r_orb.orb_descriptors(_j(img), _j(pts), _j(valid)))
    sig = orb.frame_signature(_t(rd), _t(rok)).numpy()
    np.testing.assert_allclose(sig, np.asarray(r_orb.frame_signature(_j(rd), _j(rok))),
                               rtol=0, atol=1e-7)
    assert abs(np.linalg.norm(sig) - 1.0) < 1e-6
    rng = np.random.RandomState(6)
    other = rd[rng.permutation(len(rd))].copy()
    other[:, :40] *= np.where(rng.rand(len(rd), 40) < 0.2, -1.0, 1.0)  # a few flipped bits
    ovalid = rng.rand(len(rd)) > 0.2
    for lowe in (0.7, 0.9):
        m, s = orb.match_descriptors(_t(rd), _t(rok), _t(other), _t(ovalid), lowe_ratio=lowe)
        rm, rs = r_orb.match_descriptors(_j(rd), _j(rok), _j(other), _j(ovalid), lowe_ratio=lowe)
        np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
        assert (m.numpy() >= 0).sum() > 10


# ---------------------------------------------------------- keypoints

@functools.lru_cache(maxsize=None)
def _reference_detector(H, W, **kw):
    """The reference's detector, compiled once for the file."""
    return r_keypoints.make_multiscale_orb(H, W, **kw)


@pytest.mark.parametrize("image", ["textured", "boxes"])
def test_multiscale_orb_equals_reference(image):
    """make_multiscale_orb at 120x160 over 3 levels: the level geometry, and
    on the textured frame the keypoints, their levels, validity and
    descriptors exactly. On the flat box frame the level-0 keypoints are
    exact and the resized levels hold 80% of them: a 0.5-contrast box corner
    scores 0.5, exactly on a tie of the 16-bit quantization (32767.5), and a
    1-ulp difference of the resized level (the port resizes in float64,
    rounded once; the reference in float32, test_resize_...) decides it."""
    img = _textured(120, 160) if image == "textured" else _boxes(seed=7, H=120, W=160)
    kw = dict(n_levels=3, scale_factor=1.2, thr_init=20.0 / 255, thr_min=7.0 / 255)
    assert keypoints._level_geometry(480, 752, 8, 1.2, 256) == r_keypoints._level_geometry(
        480, 752, 8, 1.2, 256)
    det, n = keypoints.make_multiscale_orb(120, 160, **kw)
    rdet, rn = _reference_detector(120, 160, **kw)
    assert n == rn
    pts, lvl, desc, ok = det(_t(img))
    rpts, rlvl, rdesc, rok = rdet(img)
    np.testing.assert_array_equal(lvl, rlvl)
    assert ok.sum() > 20
    if image == "textured":
        np.testing.assert_array_equal(pts, rpts)
        np.testing.assert_array_equal(ok, rok)
        np.testing.assert_array_equal(desc, rdesc)
    else:
        base = lvl == 0
        np.testing.assert_array_equal(pts[base], rpts[base])
        np.testing.assert_array_equal(ok[base], rok[base])
        assert np.all(pts[~base] == rpts[~base], axis=1).mean() >= 0.8


def test_resize_equals_jax_image_resize():
    img = _textured(120, 160)
    for hw in ((100, 133), (83, 111), (60, 80)):
        mh = _t(keypoints.resize_matrix(120, hw[0])).double()
        mw = _t(keypoints.resize_matrix(160, hw[1])).double()
        got = keypoints.resize_bilinear(_t(img), mh, mw).numpy()
        want = np.asarray(jax.image.resize(_j(img), hw, "bilinear"))
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-7)


# ----------------------------------------------------------- vocabulary

def _descs(rng, n, flip=0, base=None):
    if base is None:
        return np.sign(rng.randn(n, 256)).astype(np.float32)
    d = base.copy()
    for i in range(len(d)):
        d[i, rng.choice(256, flip, replace=False)] *= -1
    return d


def test_kmeans_equals_reference():
    rng = np.random.RandomState(0)
    for n, words in ((600, 64), (40, 64)):  # the second tops up with random words
        d = _descs(rng, n)
        np.testing.assert_array_equal(vocabulary._kmeans(d, words, 6, 11, "cpu"),
                                      r_vocab._kmeans(d, words, 6, 11))


def test_vocabulary_equals_reference():
    """test_slam_global.py's recall scenario: two passes over 12 places,
    the second noisy, with online training and retraining; every query's
    results, the word lists and the inverted index equal the reference's,
    scores to 1e-12."""
    rng = np.random.RandomState(7)
    kw = dict(n_words=128, train_size=300, seed=1, retrain_every_docs=8)
    v, rv = vocabulary.Vocabulary(device="cpu", **kw), r_vocab.Vocabulary(**kw)
    bases = [_descs(rng, 30) for _ in range(12)]
    for i, b in enumerate(bases):
        v.add_keyframe(i, b)
        rv.add_keyframe(i, b)
    assert v.trained and rv.trained
    for i, b in enumerate(bases):
        noisy = _descs(rng, 30, flip=10, base=b)
        valid = rng.rand(30) > 0.1
        v.add_keyframe(100 + i, noisy, valid)
        rv.add_keyframe(100 + i, noisy, valid)
        got = v.query(100 + i, exclude=set(range(100, 200)), min_in_common_ratio=0.3)
        want = rv.query(100 + i, exclude=set(range(100, 200)), min_in_common_ratio=0.3)
        assert [k for k, _ in got] == [k for k, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=0, atol=1e-12)
    v.remove_keyframe(3)
    rv.remove_keyframe(3)
    np.testing.assert_array_equal(v.codebook, rv.codebook)
    assert v.inverted == rv.inverted and v.n_docs == rv.n_docs
    assert all(np.array_equal(v.words[k], rv.words[k]) for k in rv.words)
    assert abs(v.score(0, 100) - rv.score(0, 100)) < 1e-12


def test_vocabulary_npy_carries_across_packages(tmp_path):
    """A codebook saved by either package loads, frozen, in the other."""
    rng = np.random.RandomState(2)
    kw = dict(n_words=64, train_size=100, seed=3)
    v, rv = vocabulary.Vocabulary(device="cpu", **kw), r_vocab.Vocabulary(**kw)
    for i in range(5):
        d = _descs(rng, 30)
        v.add_keyframe(i, d)
        rv.add_keyframe(i, d)
    assert v.trained
    v.save(str(tmp_path / "port.npy"))
    rv.save(str(tmp_path / "ref.npy"))
    loaded = r_vocab.Vocabulary(path=str(tmp_path / "port.npy"), **kw)
    ploaded = vocabulary.Vocabulary(path=str(tmp_path / "ref.npy"), device="cpu", **kw)
    assert loaded.frozen and ploaded.frozen
    np.testing.assert_array_equal(loaded.codebook, v.codebook)
    np.testing.assert_array_equal(ploaded.codebook, rv.codebook)


def test_vocabulary_takes_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vocabulary.Vocabulary()


# ------------------------------------------------------------- host math

def test_host_pose_helpers_equal_reference():
    from hybvio_tpu.slam import host as r_host

    rng = np.random.RandomState(0)
    for _ in range(5):
        a = np.concatenate([rng.randn(3), rng.randn(4)])
        b = np.concatenate([rng.randn(3), rng.randn(4)])
        a[3:] /= np.linalg.norm(a[3:])
        b[3:] /= np.linalg.norm(b[3:])
        np.testing.assert_array_equal(np_pose_to_mat(a), r_host.np_pose_to_mat(a))
        np.testing.assert_array_equal(np_mat_to_pose(np_pose_to_mat(a)),
                                      r_host.np_mat_to_pose(r_host.np_pose_to_mat(a)))
        np.testing.assert_array_equal(np_quat_mul(a[3:], b[3:]), r_host.np_quat_mul(a[3:], b[3:]))
        np.testing.assert_array_equal(np_relative_pose(a, b), r_host.np_relative_pose(a, b))
        rel = ba._relative_pose(_t(a), _t(b)).numpy()
        np.testing.assert_allclose(rel, np.asarray(r_ba._relative_pose(_j(a), _j(b))),
                                   rtol=0, atol=1e-14)


# ------------------------------------------------------------------ BA

def _ba_problem(NK=6, MP=30, seed=0, nk_valid=5, mp_valid=27):
    """tests/test_ba.py's scene with noisy observations, padded poses and
    points and perturbed starting values (numpy fields)."""
    import sys
    import os

    sys.path.insert(0, os.path.dirname(__file__))
    from test_ba import make_scene

    poses_gt, points_gt, obs, mask = make_scene(NK, MP, seed)
    rng = np.random.RandomState(seed + 1)
    poses0 = poses_gt.copy()
    poses0[1:, :3] += 0.05 * rng.randn(NK - 1, 3)
    q = poses0[1:, 3:] + 0.01 * rng.randn(NK - 1, 4)
    poses0[1:, 3:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    obs = obs + np.where(mask[..., None], 0.02 * rng.randn(*obs.shape), 0.0)
    rel = np.stack([np_relative_pose(poses_gt[k], poses_gt[k + 1]) for k in range(NK - 1)])
    return dict(poses=poses0, points=points_gt + 0.2 * rng.randn(MP, 3), obs_ip=obs,
                obs_mask=mask, pose_valid=np.arange(NK) < nk_valid,
                point_valid=np.arange(MP) < mp_valid, prior_rel=rel,
                prior_mask=np.arange(NK - 1) < NK - 2, prior_w_pos=np.float64(0.5),
                prior_w_rot=np.float64(5.0))


@pytest.mark.parametrize("fix_first", [True, False])
def test_ba_iterate_equals_reference(fix_first):
    fields = _ba_problem()
    got = ba.ba_iterate(ba.BAProblem(**{k: _t(v) for k, v in fields.items()}), iterations=8,
                        fix_first_pose=fix_first)
    want = r_ba.ba_iterate(r_ba.BAProblem(**{k: _j(v) for k, v in fields.items()}), iterations=8,
                           fix_first_pose=fix_first)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=SOLVE_TOL)
    assert float(got[2]) > 0


def test_triangulate_points_linear_equals_reference():
    f = _ba_problem(seed=3)
    pts, ok = ba.triangulate_points_linear(_t(f["poses"]), _t(f["obs_ip"]), _t(f["obs_mask"]))
    rpts, rok = r_ba.triangulate_points_linear(_j(f["poses"]), _j(f["obs_ip"]),
                                               _j(f["obs_mask"]))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    np.testing.assert_allclose(pts.numpy(), np.asarray(rpts), rtol=0, atol=SOLVE_TOL)


# ------------------------------------------------------------- pose graph

def test_optimize_pose_graph_equals_reference():
    """test_slam_global.py's drifted chain with one loop edge, plus padded
    edges and poses."""
    n = 12
    gt = np.zeros((n, 7))
    gt[:, 3] = 1.0
    gt[:, 1] = np.arange(n) * 0.5
    rng = np.random.RandomState(4)
    est = gt.copy()
    est[:, 0] += np.linspace(0.0, 0.6, n)
    est[:, 3:] += 0.01 * rng.randn(n, 4)
    est[:, 3:] /= np.linalg.norm(est[:, 3:], axis=1, keepdims=True)
    N = posegraph.next_pow2(n)
    assert N == r_pg.next_pow2(n) == 16 and posegraph.next_pow2(3) == 8
    poses = np.zeros((N, 7))
    poses[:, 3] = 1.0
    poses[:n] = est
    edges = [(i, i + 1, np_relative_pose(gt[i], gt[i + 1]), 1.0, 1.0) for i in range(n - 1)]
    edges.append((0, n - 1, np_relative_pose(gt[0], gt[n - 1]), 10.0, 10.0))
    E = posegraph.next_pow2(len(edges))
    ei, ej = np.zeros(E, np.int32), np.zeros(E, np.int32)
    erel = np.zeros((E, 7))
    erel[:, 3] = 1.0
    ewp, ewr = np.zeros(E), np.zeros(E)
    for k, (i, j, rel, wp, wr) in enumerate(edges):
        ei[k], ej[k], erel[k], ewp[k], ewr[k] = i, j, rel, wp, wr
    fields = (poses, np.arange(N) < n, ei, ej, erel, ewp, ewr)
    got = posegraph.optimize_pose_graph(posegraph.PoseGraphProblem(*map(_t, fields)),
                                        iterations=15).numpy()
    want = np.asarray(r_pg.optimize_pose_graph(r_pg.PoseGraphProblem(*map(_j, fields)),
                                               iterations=15))
    np.testing.assert_allclose(got, want, rtol=0, atol=SOLVE_TOL)
    assert np.abs(got[:n, :3] - gt[:, :3]).max() < 0.5 * np.abs(est[:, :3] - gt[:, :3]).max()


# ----------------------------------------------------------- loop closure

def _similarity_data(seed, M=40, outliers=10, scale=1.1):
    rng = np.random.RandomState(seed)
    src = rng.randn(M, 3) * 2
    a = 0.2 + 0.1 * seed
    Rt = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    dst = scale * src @ Rt.T + np.array([0.3, -0.2, 0.1]) + 0.01 * rng.randn(M, 3)
    dst[:outliers] += rng.randn(outliers, 3)
    return src, dst


def test_kabsch_equals_reference():
    src, dst = _similarity_data(0, outliers=0)
    w = np.random.RandomState(1).rand(len(src))
    for with_scale in (False, True):
        got = loopclosure._kabsch(_t(src), _t(dst), _t(w), with_scale)
        want = r_lc._kabsch(_j(src), _j(dst), _j(w), with_scale)
        for a, b in zip(got, want):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=SOLVE_TOL)


@pytest.mark.parametrize("seed, with_scale", [(0, False), (1, True), (2, True)])
def test_ransac_similarity_equals_reference(seed, with_scale):
    """The hypotheses' draws through the port's threefry (seeds as the
    session's _loop_seed feeds them), Kabsch fits and the refit."""
    src, dst = _similarity_data(seed, scale=1.1 if with_scale else 1.0)
    got = loopclosure.ransac_similarity_np(src, dst, seed=seed + 1, n_hyp=100, threshold=0.1,
                                           with_scale=with_scale, device="cpu")
    want = r_lc.ransac_similarity_np(src, dst, seed=seed + 1, n_hyp=100, threshold=0.1,
                                     with_scale=with_scale)
    np.testing.assert_array_equal(got[3], want[3])
    assert got[4] == want[4] >= 25
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=SOLVE_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_pnp_equals_reference(seed):
    rng = np.random.RandomState(seed)
    pts3 = rng.randn(40, 3) + [0, 0, 5]
    a = 0.2 + 0.1 * seed
    Rt = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    pc = pts3 @ Rt.T + np.array([0.1, 0.2, 0.3])
    obs = pc[:, :2] / pc[:, 2:] + 0.001 * rng.randn(40, 2)
    obs[:8] += 0.3
    got = loopclosure.ransac_pnp_np(pts3, obs, seed=seed + 5, n_hyp=100, threshold=0.02,
                                    device="cpu")
    want = r_lc.ransac_pnp_np(pts3, obs, seed=seed + 5, n_hyp=100, threshold=0.02)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3] >= 25
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=SOLVE_TOL)


def test_native_orb_equals_reference_and_honours_the_switch(monkeypatch):
    """The native ORB detector, which raised before it was ported, builds
    and detects the reference's native keypoints (tests/test_torch_native.py
    holds it bit for bit), and HYBVIO_NATIVE_ORB=0 turns it off as the
    reference's switch does."""
    from hybvio_tpu.slam import native_orb as r_native_orb
    from hybvio_tpu_torch.slam import native_orb

    assert native_orb.native_orb_available()
    det, cap = native_orb.make_native_orb(240, 320)
    rdet, rcap = r_native_orb.make_native_orb(240, 320)
    img = np.clip(np.random.RandomState(0).rand(240, 320), 0, 1).astype(np.float32)
    assert cap == rcap
    for a, b in zip(det(img), rdet(img)):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setenv("HYBVIO_NATIVE_ORB", "0")
    assert not native_orb.native_orb_available() and not r_native_orb.native_orb_available()
