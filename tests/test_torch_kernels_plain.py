"""The plain PyTorch versions of the five CUDA kernels equal the reference's
XLA paths on the same inputs: the patch gather and the greedy selection
exactly, the stencils over the whole image to 1e-12 in float64 and 1e-6 in
float32 (f32 sums of up to 81 terms differ in rounding, not in value).

The kernels themselves run only on a card: ``test_cuda_kernels_match_plain``
holds each one against its plain version there and skips elsewhere."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybvio_tpu.frontend.gftt import _greedy_select, corner_response
from hybvio_tpu.frontend.pyramid import pyr_down, scharr_gradients
from hybvio_tpu.ops.patch_gather_pallas import _gather_fallback
from hybvio_tpu_torch import ops

torch.set_num_threads(1)

TOL = {np.float64: 1e-12, np.float32: 1e-6}
SHAPES = [(120, 160), (97, 128), (64, 128)]


def _img(hw, dtype, seed):
    return np.random.RandomState(seed).rand(*hw).astype(dtype)


@pytest.mark.parametrize("ps", [13, 18, 21])
def test_patch_gather_plain_exact(ps):
    H, W, B, N = 128, 256, 2, 37
    rng = np.random.RandomState(3)
    img = rng.rand(B, H, W).astype(np.float32)
    # callers pre-clamp origins to [0, dim - ps]; include both extremes
    y0 = rng.randint(0, H - ps + 1, size=(B, N)).astype(np.int32)
    x0 = rng.randint(0, W - ps + 1, size=(B, N)).astype(np.int32)
    y0[:, 0], y0[:, 1], x0[:, 0], x0[:, 1] = 0, H - ps, 0, W - ps
    ref = np.stack([np.asarray(_gather_fallback(jnp.asarray(img[b]), jnp.asarray(y0[b]),
                                                jnp.asarray(x0[b]), ps)) for b in range(B)])
    (out,) = ops.gather_patches((torch.tensor(img),), torch.tensor(y0), torch.tensor(x0), ps)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_patch_gather_plain_shared_image_stride0():
    H, W, B, N, ps = 64, 96, 3, 11, 15
    rng = np.random.RandomState(5)
    img = rng.rand(H, W).astype(np.float32)
    y0 = rng.randint(0, H - ps + 1, size=(B, N)).astype(np.int32)
    x0 = rng.randint(0, W - ps + 1, size=(B, N)).astype(np.int32)
    ref = np.asarray(jax.vmap(lambda a, b: _gather_fallback(jnp.asarray(img), a, b, ps))(
        jnp.asarray(y0), jnp.asarray(x0)))
    shared = torch.tensor(img).expand(B, H, W)
    assert shared.stride(0) == 0
    # one call gathers several images at the same origins
    outs = ops.gather_patches((shared, 2.0 * shared, shared.contiguous()), torch.tensor(y0),
                              torch.tensor(x0), ps)
    assert len(outs) == 3
    for out, scale in zip(outs, (1.0, 2.0, 1.0)):
        np.testing.assert_array_equal(out.numpy(), scale * ref)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("hw", SHAPES)
def test_pyr_down_plain(hw, dtype):
    img = _img(hw, dtype, 2)
    ref = np.asarray(pyr_down(jnp.asarray(img)))
    out = ops.pyr_down(torch.tensor(img)).numpy()
    assert out.shape == ref.shape == ((hw[0] + 1) // 2, (hw[1] + 1) // 2)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("hw", SHAPES[:2])
def test_scharr_plain(hw, dtype):
    img = _img(hw, dtype, 3)
    rx, ry = scharr_gradients(jnp.asarray(img))
    gx, gy = ops.scharr(torch.tensor(img))
    np.testing.assert_allclose(gx.numpy(), np.asarray(rx), rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(gy.numpy(), np.asarray(ry), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("block", [3, 5])
def test_corner_response_plain(block, dtype):
    img = _img((96, 128), dtype, 1)
    ref = np.asarray(corner_response(jnp.asarray(img), block_size=block))
    out = ops.corner_response(torch.tensor(img), block).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("k", [128, 192])
def test_greedy_nms_plain_exact(k):
    rng = np.random.RandomState(5)
    B = 3
    xy = rng.rand(B, k, 2).astype(np.float32) * 100
    d2 = ((xy[:, :, None] - xy[:, None]) ** 2).sum(-1).astype(np.float32)
    ok = rng.rand(B, k) > 0.2
    min_d2 = 64.0
    ref = np.stack([np.asarray(_greedy_select(jnp.asarray(d2[b]), jnp.asarray(ok[b]), min_d2, k))
                    for b in range(B)])
    out = ops.greedy_min_distance(torch.tensor(d2), torch.tensor(ok), min_d2)
    np.testing.assert_array_equal(out.numpy(), ref)


def _pack_words(bits):
    """(..., K) bools -> (..., ceil(K/32)) uint32 words, bit j % 32 of word
    j // 32 (the last word ragged, zero-padded)."""
    K = bits.shape[-1]
    nw = (K + 31) // 32
    padded = np.zeros(bits.shape[:-1] + (32 * nw,), bool)
    padded[..., :K] = bits
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    words = padded.reshape(bits.shape[:-1] + (nw, 32)).astype(np.uint64) @ weights
    return words.astype(np.uint32)


def _bit(word, lane):
    return bool((int(word) >> lane) & 1)


def greedy_bitmask_model(d2, ok, min_d2):
    """numpy model of csrc/greedy_nms.cu for one lane. Phase 1: row i's
    conflicts d2[i, j] < min_d2, j < i, packed into 32-bit words. Phase 2,
    one word w of 32 candidates at a time: a candidate is out if a conflict
    word k < w meets the final taken word k; the rest of the word is
    resolved in rounds, each lane deciding from the round's start state
    (as one ballot does): taken once none of its earlier conflicting
    candidates is taken or undecided, rejected once one is taken."""
    K = ok.shape[0]
    nw = (K + 31) // 32
    j = np.arange(K)
    conflict = _pack_words((d2 < min_d2) & (j[None, :] < j[:, None]))  # (K, nw)
    ok_words = _pack_words(ok)
    taken = np.zeros(nw, np.uint32)
    for w in range(nw):
        rows = conflict[32 * w:32 * w + 32]  # ragged in the last word
        near = np.any(rows[:, :w] & taken[:w], axis=1)
        undecided = int(_pack_words(~near)[0] & ok_words[w])
        blockers = [int(c) & undecided for c in rows[:, w]]
        tw = 0
        while undecided:
            mine = [_bit(undecided, lane) for lane in range(len(blockers))]
            reject = [m and (b & tw) != 0 for m, b in zip(mine, blockers)]
            take = [m and not r and (b & undecided) == 0
                    for m, r, b in zip(mine, reject, blockers)]
            tw |= sum(1 << lane for lane, t in enumerate(take) if t)
            undecided &= ~sum(1 << lane for lane, (t, r) in enumerate(zip(take, reject)) if t or r)
        taken[w] = tw
    return ((taken[j // 32] >> (j % 32).astype(np.uint32)) & 1).astype(bool)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 31, 32, 33, 128, 192, 200])
def test_greedy_bitmask_model_matches_reference(k, ties):
    """The kernel's algorithm on the CPU against the reference's scan and
    the port's plain version: ragged last words, exact ties d2 == min_d2
    (not conflicts), an all-ineligible and an all-eligible lane."""
    rng = np.random.RandomState(k + 1000 * ties)
    B = 4
    if ties:  # integer grid: squared distances are integers, 100 among them
        xy = rng.randint(0, 30, size=(B, k, 2)).astype(np.float32)
        min_d2 = 100.0
    else:
        xy = rng.rand(B, k, 2).astype(np.float32) * 100
        min_d2 = 64.0
    d2 = ((xy[:, :, None] - xy[:, None]) ** 2).sum(-1).astype(np.float32)
    ok = rng.rand(B, k) > 0.2
    ok[0], ok[1] = False, True
    if ties and k > 1:
        assert (d2 == min_d2).any()
    ref = np.stack([np.asarray(_greedy_select(jnp.asarray(d2[b]), jnp.asarray(ok[b]), min_d2, k))
                    for b in range(B)])
    model = np.stack([greedy_bitmask_model(d2[b], ok[b], min_d2) for b in range(B)])
    plain = ops.greedy_min_distance(torch.tensor(d2), torch.tensor(ok), min_d2).numpy()
    np.testing.assert_array_equal(model, ref)
    np.testing.assert_array_equal(plain, ref)
    assert not model[0].any() and model[1, 0]


def test_wrappers_use_plain_only_for_cpu_tensors():
    """A tensor that is neither on the CPU nor on CUDA is refused, never
    sent to the plain version."""
    meta = torch.empty((32, 48), device="meta")
    with pytest.raises(ValueError):
        ops.pyr_down(meta)
    with pytest.raises(ValueError):
        ops.corner_response(meta)


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; chip_smoke.py runs this on the card")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    img = torch.rand((480, 752), generator=g).to(dev)
    assert torch.equal(ops.pyr_down(img), ops.pyr_down(img))
    assert (ops.pyr_down(img) - ops.pyr_down_plain(img)).abs().max() <= 1e-6
    for a, b in zip(ops.scharr(img), ops.scharr_plain(img)):
        assert (a - b).abs().max() <= 1e-6
    for bs in (3, 5):
        assert (ops.corner_response(img, bs) - ops.corner_response_plain(img, bs)).abs().max() <= 1e-6
    y0 = torch.randint(-3, 480 - 34 + 4, (16, 96), generator=g, dtype=torch.int32).to(dev)
    x0 = torch.randint(-3, 752 - 34 + 4, (16, 96), generator=g, dtype=torch.int32).to(dev)
    shared = img.expand(16, 480, 752)
    for got, im in zip(ops.gather_patches((shared, img.expand(16, 480, 752) * 2), y0, x0, 34),
                       (shared, img.expand(16, 480, 752) * 2)):
        assert torch.equal(got, ops.gather_patches_plain(im, y0, x0, 34))
    xy = torch.rand((16, 192, 2), generator=g).to(dev) * 400
    d2 = torch.sum((xy[:, :, None] - xy[:, None]) ** 2, dim=-1).contiguous()
    ok = (torch.rand((16, 192), generator=g) > 0.2).to(dev)
    assert torch.equal(ops.greedy_min_distance(d2, ok, 544.4),
                       ops.greedy_min_distance_plain(d2, ok, 544.4))
