"""The plain PyTorch versions of the five CUDA kernels equal the reference's
XLA paths on the same inputs: the patch gather and the greedy selection
exactly, the stencils over the whole image to 1e-12 in float64 and 1e-6 in
float32, and the pyramid and the corner response bit for bit in float32.

The kernels themselves run only on a card: ``test_cuda_kernels_match_plain``
holds each one against its plain version there and skips elsewhere. What
the CPU can check of them is their algorithm: numpy models with the
kernels' own index arithmetic (the greedy bitmask walk, the corner-response
tiling, the pyramid tiling with and without the fused Scharr gradients)
equal the reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybvio_tpu.frontend.gftt import _greedy_select, corner_response
from hybvio_tpu.frontend.pyramid import build_pyramid, pyr_down, scharr_gradients
from hybvio_tpu.ops.patch_gather_pallas import _gather_fallback
from hybvio_tpu_torch import ops
from hybvio_tpu_torch.frontend.pyramid import build_pyramids_with_gradients
from hybvio_tpu_torch.ops.pyramid import PYR_K

torch.set_num_threads(1)

TOL = {np.float64: 1e-12, np.float32: 1e-6}
SHAPES = [(120, 160), (97, 128), (64, 128)]
# the frame and level sizes of the main path and odd ones (ragged tiles,
# rows that are not 16-byte aligned)
TILED_SHAPES = [(480, 752), (239, 377), (121, 189), (60, 94)]


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


# the frames of the mono (and stereo) and fisheye paths
FRAMES = [(480, 752), (512, 512)]


@pytest.mark.parametrize("hw", FRAMES)
def test_patch_gather_plain_on_path_frames(hw):
    """The plain gather of one frame shared by 16 lanes equals the
    reference's at every window size the paths use on it (LK template 18,
    search 50 and 34, subpixel 33), origins at both extremes included."""
    H, W = hw
    rng = np.random.RandomState(9)
    img = rng.rand(H, W).astype(np.float32)
    shared = torch.tensor(img).expand(16, H, W)
    for ps in (18, 50, 34, 33):
        y0 = rng.randint(0, H - ps + 1, size=(16, 96)).astype(np.int32)
        x0 = rng.randint(0, W - ps + 1, size=(16, 96)).astype(np.int32)
        y0[:, 0], y0[:, 1], x0[:, 0], x0[:, 1] = 0, H - ps, 0, W - ps
        ref = np.asarray(jax.vmap(lambda a, b: _gather_fallback(jnp.asarray(img), a, b, ps))(
            jnp.asarray(y0), jnp.asarray(x0)))
        (out,) = ops.gather_patches((shared,), torch.tensor(y0), torch.tensor(x0), ps)
        np.testing.assert_array_equal(out.numpy(), ref)


def test_patch_gather_launch_counted_by_image_size(monkeypatch):
    """A launch is counted under (images, B, N, ps, H, W, "shared" or
    "per-lane"): each gather row is charged at the image size it reads, and
    per-lane images apart from one image shared by the lanes. (The launch
    itself is replaced: meta tensors carry the shapes and strides without a
    card.)"""
    from hybvio_tpu_torch.ops import patch_gather

    seen = []
    monkeypatch.setattr(patch_gather, "require_cuda", lambda *t, dtype=None: None)
    monkeypatch.setattr(patch_gather, "launch", lambda *args, shape: seen.append(shape))
    origins = torch.zeros((16, 96), dtype=torch.int32, device="meta")
    for h, w in ((480, 752), (120, 188), (512, 512), (256, 256)):
        img = torch.empty((h, w), device="meta").expand(16, h, w)
        patch_gather.gather_patches((img, img, img), origins, origins, 18)
    lanes = torch.empty((16, 2, 480, 752), device="meta")[:, 0]  # a renderer's camera 0
    patch_gather.gather_patches((lanes,), origins, origins, 34)
    assert seen == [(3, 16, 96, 18, 480, 752, "shared"), (3, 16, 96, 18, 120, 188, "shared"),
                    (3, 16, 96, 18, 512, 512, "shared"), (3, 16, 96, 18, 256, 256, "shared"),
                    (1, 16, 96, 34, 480, 752, "per-lane")]


@pytest.mark.parametrize("hw", FRAMES)
def test_build_pyramid_with_gradients_one_image_matches_reference(hw):
    """The mono and fisheye paths' form: one frame's levels 1-2 and the
    gradients of its levels 0-2 from one build_pyramids_with_gradients call
    equal the reference's build_pyramid and scharr_gradients bit for bit in
    float32 (the CPU runs the plain version)."""
    img = _img(hw, np.float32, 12)
    (pyr,), grads = build_pyramids_with_gradients((torch.tensor(img),), 2)
    ref = build_pyramid(jnp.asarray(img), 2)
    assert len(pyr) == len(ref) == len(grads) == 3
    for got, want, (gx, gy) in zip(pyr, ref, grads):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        rx, ry = scharr_gradients(want)
        np.testing.assert_array_equal(gx.numpy(), np.asarray(rx))
        np.testing.assert_array_equal(gy.numpy(), np.asarray(ry))


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


def corner_tile_model(img, block, th, tw):
    """numpy model of csrc/corner_response.cu in float32: per th x tw tile,
    the input tile at clamped indices, the gradient of each region position
    at its clamped index from the input around it, the products, the box x
    then y pass formed afresh in order, an IEEE division and the root."""
    H, W = img.shape
    R = block // 2
    gh, gw = th + 2 * R, tw + 2 * R
    f = np.float32
    out = np.full((H, W), np.nan, np.float32)
    for r0 in range(0, H, th):
        for c0 in range(0, W, tw):
            ir0, ic0 = r0 - R - 1, c0 - R - 1
            tile = img[np.clip(ir0 + np.arange(gh + 2), 0, H - 1)][
                :, np.clip(ic0 + np.arange(gw + 2), 0, W - 1)]
            rr = np.clip(r0 - R + np.arange(gh), 0, H - 1)
            cc = np.clip(c0 - R + np.arange(gw), 0, W - 1)
            rows = [np.clip(rr + t - 1, 0, H - 1) - ir0 for t in range(3)]
            cols = [np.clip(cc - 1, 0, W - 1) - ic0, cc - ic0, np.clip(cc + 1, 0, W - 1) - ic0]
            for ix, n in [(x, gh + 2) for x in rows] + [(x, gw + 2) for x in cols]:
                assert 0 <= ix.min() and ix.max() < n
            xd, xs = [], []
            for t in range(3):
                a, b, e = (tile[rows[t]][:, c] for c in cols)
                xd.append((-a + f(0) * b) + e)
                xs.append((a + f(2) * b) + e)
            gx = (xd[0] + f(2) * xd[1]) + xd[2]
            gy = (-xs[0] + f(0) * xs[1]) + xs[2]
            means = []
            for p in (gx * gx, gy * gy, gx * gy):
                bx = p[:, 0:tw]
                for d in range(1, 2 * R + 1):
                    bx = bx + p[:, d:d + tw]
                by = bx[0:th]
                for d in range(1, 2 * R + 1):
                    by = by + bx[d:d + th]
                means.append(by / f(block * block))
            sxx, syy, sxy = means
            tr2 = f(0.5) * (sxx + syy)
            det = sxx * syy - sxy * sxy
            resp = tr2 - np.sqrt(np.maximum(tr2 * tr2 - det, f(0)))
            h, w = min(th, H - r0), min(tw, W - c0)
            out[r0:r0 + h, c0:c0 + w] = resp[:h, :w]
    return out


# the kernels' own tiles at every size; a small odd tile at the small sizes
PYRAMID_TILE = lambda levels: (16, 32) if levels == 1 else (8, 16)  # rows x cols of the last level
TILE_CASES = [(hw, "kernel") for hw in TILED_SHAPES] + [(hw, (5, 7)) for hw in TILED_SHAPES[2:]]


@pytest.mark.parametrize("block", [3, 5])
@pytest.mark.parametrize("hw, tile", TILE_CASES)
def test_corner_tile_model_matches_reference(hw, tile, block):
    """The kernel's tiling on the CPU, and the plain version, equal the
    reference's XLA path bit for bit in float32: ragged last tiles, the
    per-stage edge rule at every border."""
    img = _img(hw, np.float32, 4)
    # the kernel's tile: 32 rows, 32 - 2R columns (its gradient region a warp wide)
    th, tw = (32, 32 - 2 * (block // 2)) if tile == "kernel" else tile
    ref = np.asarray(corner_response(jnp.asarray(img), block_size=block))
    np.testing.assert_array_equal(corner_tile_model(img, block, th, tw), ref)
    np.testing.assert_array_equal(ops.corner_response(torch.tensor(img), block).numpy(), ref)


def scharr_share_model(src, ra, ca, shape, r, c):
    """Scharr (Ix, Iy) at rows r x columns c of an H x W level whose rows
    [ra, ...) and columns [ca, ...) are ``src``: each tap at the clamped
    index, in the kernel's order of sums (the 0 taps included), float32."""
    H, W = shape
    f = np.float32
    s0, s1 = f(0.09375), f(0.3125)
    rows = [np.clip(r + t - 1, 0, H - 1) - ra for t in range(3)]
    cols = [np.clip(c - 1, 0, W - 1) - ca, c - ca, np.clip(c + 1, 0, W - 1) - ca]
    for ix, n in [(x, src.shape[0]) for x in rows] + [(x, src.shape[1]) for x in cols]:
        assert 0 <= ix.min() and ix.max() < n
    xd, xs = [], []
    for t in range(3):
        a, b, e = (src[rows[t], cc] for cc in cols)
        xd.append((-a + f(0) * b) + e)
        xs.append((s0 * a + s1 * b) + s0 * e)
    return (s0 * xd[0] + s1 * xd[1]) + s0 * xd[2], (-xs[0] + f(0) * xs[1]) + xs[2]


def pyramid_tile_model(img, levels, th, tw, gradients=False):
    """numpy model of csrc/pyramid.cu in float32: per th x tw tile of the
    last level, the region of each earlier level the tile needs (2 n + 3 for
    n of the next level, its index i at the clamped row a + i), the x pass
    at the kept columns then the y pass at the kept rows, each tap at the
    clamped index of the level below; each tile writes its share of every
    level, and every pixel is written exactly once. With ``gradients`` the
    fused form: the last level's region grows by one on each side (every
    earlier one by two), and each tile also writes the Scharr of its share
    of every level, from its region of that level (level 0: the image);
    returns (levels, gradients of levels 0..levels)."""
    H, W = img.shape
    shapes = [(H, W)]
    for _ in range(levels):
        shapes.append(((shapes[-1][0] + 1) // 2, (shapes[-1][1] + 1) // 2))
    k = PYR_K.astype(np.float32)
    outs = [np.full(s, np.nan, np.float32) for s in shapes[1:]]
    grads = [[np.full(s, np.nan, np.float32) for _ in range(2)] for s in shapes]
    h = 1 if gradients else 0
    rn, cn = [th + 2 * h], [tw + 2 * h]
    for _ in range(levels):
        rn.insert(0, 2 * rn[0] + 3)
        cn.insert(0, 2 * cn[0] + 3)
    HL, WL = shapes[levels]

    def share(l, ty, tx):
        """Rows and columns of level l that the tile writes: its own, scaled
        up by 2^(levels - l)."""
        sh = levels - l
        return (np.arange((ty * th) << sh, min(((ty + 1) * th) << sh, shapes[l][0])),
                np.arange((tx * tw) << sh, min(((tx + 1) * tw) << sh, shapes[l][1])))

    def write(dst, r, c, vals):
        assert np.isnan(dst[np.ix_(r, c)]).all()
        dst[np.ix_(r, c)] = vals

    def write_scharr(l, src, ra_l, ca_l, r, c):
        gx, gy = scharr_share_model(src, ra_l, ca_l, shapes[l], r[:, None], c[None, :])
        write(grads[l][0], r, c, gx)
        write(grads[l][1], r, c, gy)

    for ty in range(-(-HL // th)):
        for tx in range(-(-WL // tw)):
            ra, ca = [ty * th - h], [tx * tw - h]
            for _ in range(levels):
                ra.insert(0, 2 * ra[0] - 2)
                ca.insert(0, 2 * ca[0] - 2)
            if gradients:  # level 0 straight from the image
                write_scharr(0, img, 0, 0, *share(0, ty, tx))
            V = None  # the region of level l - 1 (level 0: the image)
            for l in range(1, levels + 1):
                (Hp, Wp), (Hl, Wl) = shapes[l - 1], shapes[l]
                cols = np.clip(ca[l] + np.arange(cn[l]), 0, Wl - 1)
                taps = [np.clip(2 * cols + s - 2, 0, Wp - 1) for s in range(5)]
                if l == 1:
                    src = img[np.clip(ra[0] + np.arange(rn[0]), 0, H - 1)]
                else:
                    src, taps = V, [t - ca[l - 1] for t in taps]
                    assert all(0 <= t.min() and t.max() < cn[l - 1] for t in taps)
                X = k[0] * src[:, taps[0]]
                for s in range(1, 5):
                    X = X + k[s] * src[:, taps[s]]
                rows = np.clip(ra[l] + np.arange(rn[l]), 0, Hl - 1)
                ytaps = [np.clip(2 * rows + t - 2, 0, Hp - 1) - ra[l - 1] for t in range(5)]
                assert all(0 <= t.min() and t.max() < rn[l - 1] for t in ytaps)
                V = k[0] * X[ytaps[0]]
                for t in range(1, 5):
                    V = V + k[t] * X[ytaps[t]]
                r, c = share(l, ty, tx)
                assert ra[l] <= r[0] and r[-1] < ra[l] + rn[l]
                assert ca[l] <= c[0] and c[-1] < ca[l] + cn[l]
                write(outs[l - 1], r, c, V[np.ix_(r - ra[l], c - ca[l])])
                if gradients:  # index i of the region holds row clamp(ra + i)
                    write_scharr(l, V, ra[l], ca[l], r, c)
    assert not any(np.isnan(o).any() for o in outs)
    if not gradients:
        return outs
    assert not any(np.isnan(g).any() for pair in grads for g in pair)
    return outs, grads


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("hw, tile", TILE_CASES)
def test_pyramid_tile_model_matches_reference(hw, tile, levels):
    """The one-launch pyramid's tiling on the CPU equals the reference's
    build_pyramid bit for bit in float32 at every level: odd sizes, ragged
    tiles, the level-1 halo recomputed per tile."""
    img = _img(hw, np.float32, 5 + levels)
    th, tw = PYRAMID_TILE(levels) if tile == "kernel" else tile
    ref = build_pyramid(jnp.asarray(img), levels)
    for got, want in zip(pyramid_tile_model(img, levels, th, tw), ref[1:]):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("hw, tile", TILE_CASES)
def test_fused_tile_model_matches_reference(hw, tile, levels):
    """The fused launch's tiling on the CPU (the last level's region grown
    by one, Scharr of each level from the block's region at the clamped
    index) equals the reference's build_pyramid and scharr_gradients of
    every level bit for bit in float32, and so does the plain version."""
    img = _img(hw, np.float32, 9 + levels)
    th, tw = PYRAMID_TILE(levels) if tile == "kernel" else tile
    ref = build_pyramid(jnp.asarray(img), levels)
    pyr, grads = pyramid_tile_model(img, levels, th, tw, gradients=True)
    for got, want in zip(pyr, ref[1:]):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert len(grads) == len(ref) == levels + 1
    plain = ops.pyramid_with_gradients_plain((torch.tensor(img),), levels)[1]
    for (gx, gy), level, (px, py) in zip(grads, ref, plain):
        rx, ry = scharr_gradients(level)
        np.testing.assert_array_equal(gx, np.asarray(rx))
        np.testing.assert_array_equal(gy, np.asarray(ry))
        np.testing.assert_array_equal(px.numpy(), gx)
        np.testing.assert_array_equal(py.numpy(), gy)


@pytest.mark.parametrize("levels", [0, 1, 2, 3])
@pytest.mark.parametrize("hw", TILED_SHAPES)
def test_build_pyramids_two_images_match_reference(hw, levels):
    """The levels of a stereo pair from one pyr_down_levels call equal the
    reference's build_pyramid of each image, bit for bit in float32 (the
    CPU runs pyr_down_levels' plain version)."""
    left, right = _img(hw, np.float32, 6), _img(hw, np.float32, 7)
    pyrs = ops.pyr_down_levels((torch.tensor(left), torch.tensor(right)), levels)
    assert len(pyrs) == 2
    for img, pyr in zip((left, right), pyrs):
        ref = build_pyramid(jnp.asarray(img), levels)
        assert len(pyr) + 1 == len(ref) == levels + 1
        for got, want in zip(pyr, ref[1:]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("levels", [0, 1, 2, 3])
@pytest.mark.parametrize("hw", TILED_SHAPES)
def test_build_pyramids_with_gradients_match_reference(hw, levels):
    """build_pyramids_with_gradients of a stereo pair equals the reference's
    build_pyramid of each image and scharr_gradients of each level of the
    left one, bit for bit in float32 (the CPU runs the plain version)."""
    left, right = _img(hw, np.float32, 10), _img(hw, np.float32, 11)
    pyrs, grads = build_pyramids_with_gradients((torch.tensor(left), torch.tensor(right)), levels)
    assert len(pyrs) == 2 and len(grads) == levels + 1
    for img, pyr in zip((left, right), pyrs):
        ref = build_pyramid(jnp.asarray(img), levels)
        assert len(pyr) == len(ref) == levels + 1
        for got, want in zip(pyr, ref):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for (gx, gy), level in zip(grads, build_pyramid(jnp.asarray(left), levels)):
        rx, ry = scharr_gradients(level)
        np.testing.assert_array_equal(gx.numpy(), np.asarray(rx))
        np.testing.assert_array_equal(gy.numpy(), np.asarray(ry))


@pytest.mark.parametrize("levels", [0, 1, 2, 4])
@pytest.mark.parametrize("hw", TILED_SHAPES[1:])
def test_build_pyramid_single_image_matches_reference(hw, levels):
    """The levels of one image from one pyr_down_levels call equal the
    reference's build_pyramid bit for bit in float32."""
    img = _img(hw, np.float32, 8)
    (pyr,) = ops.pyr_down_levels((torch.tensor(img),), levels)
    ref = build_pyramid(jnp.asarray(img), levels)
    assert len(pyr) + 1 == len(ref) == levels + 1
    for got, want in zip(pyr, ref[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_use_plain_only_for_cpu_tensors():
    """A tensor that is neither on the CPU nor on CUDA is refused, never
    sent to the plain version, and so is a CPU tensor beside such a one."""
    meta = torch.empty((32, 48), device="meta")
    cpu = torch.zeros((32, 48))
    with pytest.raises(ValueError):
        ops.pyr_down(meta)
    with pytest.raises(ValueError):
        ops.corner_response(meta)
    with pytest.raises(ValueError):
        ops.pyr_down_levels((meta, meta), 2)
    with pytest.raises(ValueError):
        ops.pyr_down_levels((cpu, meta), 2)
    for images in ((meta,), (meta, meta), (cpu, meta)):
        for levels in (0, 2):
            with pytest.raises(ValueError):
                ops.pyramid_with_gradients(images, levels)
    origins = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.gather_patches((cpu[None], meta[None]), origins, origins, 8)
    with pytest.raises(ValueError):
        ops.greedy_min_distance(torch.zeros((1, 4, 4)), torch.ones((1, 4), dtype=torch.bool,
                                                                   device="meta"), 1.0)


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; chip_smoke.py runs this on the card")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    img = torch.rand((480, 752), generator=g).to(dev)
    right = torch.rand((480, 752), generator=g).to(dev)
    assert torch.equal(ops.pyr_down(img), ops.pyr_down_plain(img))
    for levels in (1, 2, 3, 4):  # 4: two chained launches
        got = ops.pyr_down_levels((img, right), levels)
        for pyr, want in zip(got, ops.pyr_down_levels_plain((img, right), levels)):
            assert all(torch.equal(a, b) for a, b in zip(pyr, want))
    for a, b in zip(ops.scharr(img), ops.scharr_plain(img)):
        assert (a - b).abs().max() <= 1e-6
    for n in (1, 2):
        for levels in (1, 2, 3, 4):  # 4: two chained launches
            pyrs, grads = ops.pyramid_with_gradients((img, right)[:n], levels)
            want_pyrs, want_grads = ops.pyramid_with_gradients_plain((img, right)[:n], levels)
            assert len(grads) == levels + 1
            for pyr, want in zip(pyrs, want_pyrs):
                assert all(torch.equal(a, b) for a, b in zip(pyr, want))
            for got, want in zip(grads, want_grads):
                assert all(torch.equal(a, b) for a, b in zip(got, want))
    for bs in (3, 5):
        assert torch.equal(ops.corner_response(img, bs), ops.corner_response_plain(img, bs))
    fish = torch.rand((512, 512), generator=g).to(dev)  # the fisheye frame
    assert torch.equal(ops.corner_response(fish, 3), ops.corner_response_plain(fish, 3))
    (pyr,), grads = ops.pyramid_with_gradients((fish,), 2)
    (want_pyr,), want_grads = ops.pyramid_with_gradients_plain((fish,), 2)
    assert all(torch.equal(a, b) for a, b in zip(pyr, want_pyr))
    assert all(torch.equal(a, b) for ga, gb in zip(grads, want_grads) for a, b in zip(ga, gb))
    y0 = torch.randint(-3, 480 - 34 + 4, (16, 96), generator=g, dtype=torch.int32).to(dev)
    x0 = torch.randint(-3, 752 - 34 + 4, (16, 96), generator=g, dtype=torch.int32).to(dev)
    shared = img.expand(16, 480, 752)
    for got, im in zip(ops.gather_patches((shared, img.expand(16, 480, 752) * 2), y0, x0, 34),
                       (shared, img.expand(16, 480, 752) * 2)):
        assert torch.equal(got, ops.gather_patches_plain(im, y0, x0, 34))
    lanes = torch.rand((16, 2, 480, 752), generator=g).to(dev)  # per-lane frames, lane stride 2HW
    cams = (lanes[:, 0], lanes[:, 1])
    for n in (1, 2):
        pyrs, grads = ops.pyramid_with_gradients(cams[:n], 2)
        want_pyrs, want_grads = ops.pyramid_with_gradients_plain(cams[:n], 2)
        for pyr, want in zip(pyrs, want_pyrs):
            assert all(torch.equal(a, b) for a, b in zip(pyr, want))
        for got, want in zip(grads, want_grads):
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(ops.corner_response(cams[0], 3), ops.corner_response_plain(cams[0], 3))
    xy = torch.rand((16, 192, 2), generator=g).to(dev) * 400
    d2 = torch.sum((xy[:, :, None] - xy[:, None]) ** 2, dim=-1).contiguous()
    ok = (torch.rand((16, 192), generator=g) > 0.2).to(dev)
    assert torch.equal(ops.greedy_min_distance(d2, ok, 544.4),
                       ops.greedy_min_distance_plain(d2, ok, 544.4))
