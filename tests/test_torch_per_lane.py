"""Per-lane frames (``make_batched_vio(shared_frames=False)``, BASELINE
config 5): B lanes with distinct frames through the port against the
reference's per-lane step, the per-lane path against the shared one on
copies of one frame, and the lane axis of the pyramid and corner-response
kernels' plain versions and wrappers.

Tolerances: every integer and boolean field exactly; floats as
``torch_parity.step_tol`` (the float32 front-end sums its windows in another
order than XLA: a few ulp of the pixels, carried on by LK); the per-lane
path fed copies of one frame equals the shared path to rtol 1e-6 (the same
arithmetic lane by lane); the plain versions equal the reference's XLA path
bit for bit (pyramid, Scharr) or to 1e-6 (corner response, float32 root)."""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybvio_tpu.frontend.gftt import corner_response as r_corner_response
from hybvio_tpu.frontend.pyramid import build_pyramid, scharr_gradients
from hybvio_tpu.io.synthetic import SYNTH_IMU_TO_CAMERA, generate_sequence, render_view
from hybvio_tpu_torch import convert, ops
from hybvio_tpu_torch.config import DerivedParameters as PortDerived
from hybvio_tpu_torch.odometry.backend import ImuBatch
from hybvio_tpu_torch.ops import gftt as ops_gftt
from hybvio_tpu_torch.ops import pyramid as ops_pyramid
from hybvio_tpu_torch.parallel.batched import make_batched_vio

from torch_parity import (
    FX, H, SECOND_IMU_TO_CAMERA, W, batched_step_parity, imu_batches, mismatches, mono_frame,
    stereo_frame, tiny_mono_setup, tiny_sequence, tiny_stereo_setup,
)

torch.set_num_threads(1)

B, FRAMES = 2, 5


def _worlds(n_frames):
    """Two distinct tiny worlds on one time grid, as bench.py's seed-diverse
    leg draws them (seed 1000 + b, radius / angular speed / z-wobble from
    RandomState(7000 + b))."""
    seqs = []
    for b in range(B):
        rng = np.random.RandomState(7000 + b)
        seqs.append(generate_sequence(
            duration=(n_frames + 2) / 20.0, imu_rate=200.0, frame_rate=20.0,
            radius=float(rng.uniform(1.7, 2.3)), angular_speed=float(rng.uniform(0.34, 0.46)),
            z_wobble=float(rng.uniform(0.10, 0.20)), n_landmarks=300, landmark_radius=6.0,
            gyro_noise=5e-4, acc_noise=5e-3, seed=1000 + b))
    return seqs


def _per_lane_imu(seqs, n_frames, S=10):
    """Each lane's own IMU samples, per frame (t, gyro, acc, valid)."""
    idx, times = seqs[0].frame_sample_idx, seqs[0].times
    out, prev = [], idx[0] + 1
    for fi in range(1, n_frames + 1):
        k = idx[fi] + 1
        n = k - prev
        t = np.pad(times[prev:k], (0, S - n), constant_values=times[k - 1])
        g = np.stack([np.pad(s.gyro[prev:k], ((0, S - n), (0, 0))) for s in seqs])
        a = np.stack([np.pad(s.acc[prev:k], ((0, S - n), (0, 0))) for s in seqs])
        out.append((np.tile(t, (len(seqs), 1)), g, a, np.tile(np.arange(S) < n, (len(seqs), 1))))
        prev = k
    return out


def test_per_lane_stereo_step_matches_reference():
    """Two lanes with different rendered frames (two worlds) through the
    port and the reference's make_batched_vio(shared_frames=False)."""
    p, _, rcam = tiny_stereo_setup()
    seqs = _worlds(FRAMES)

    def frame(fi):
        k = seqs[0].frame_sample_idx[fi]
        return tuple(np.stack([render_view(s.landmarks, s.pos[k], s.quat[k], ext, FX, FX, 48.0,
                                           32.0, W, H, blob_sigma=1.4) for s in seqs])
                     for ext in (SYNTH_IMU_TO_CAMERA, SECOND_IMU_TO_CAMERA))

    frames = [frame(fi) for fi in range(FRAMES + 1)]
    assert np.abs(frames[1][0][0] - frames[1][0][1]).max() > 0.1  # the lanes see different worlds
    tracked = batched_step_parity(p, (rcam, rcam), frames, seqs[0], B, shared_frames=False,
                                  imus=_per_lane_imu(seqs, FRAMES))
    assert tracked > 0


@pytest.mark.parametrize("kind", ["stereo", "mono"])
def test_per_lane_path_on_copies_of_one_frame_equals_shared_path(kind):
    """The per-lane path fed B copies of one frame computes what the shared
    path computes once (the reference's tests/test_parallel.py check)."""
    setup, render = {"stereo": (tiny_stereo_setup, stereo_frame),
                     "mono": (tiny_mono_setup, mono_frame)}[kind]
    p, _, rcam = setup()
    seq = tiny_sequence(FRAMES)
    cam = convert.camera_from_jax(rcam)
    runs = []
    for shared in (True, False):
        init, step, _ = make_batched_vio(p, PortDerived.from_parameters(p),
                                         (cam, cam) if kind == "stereo" else (cam,),
                                         batch_size=B, max_tracks=12, dtype=torch.float64,
                                         shared_frames=shared, device="cpu")

        def images(fi):
            def lanes(f):
                f = torch.as_tensor(f)
                return f if shared else f.expand(B, *f.shape).clone()
            frame = render(seq, fi)
            return tuple(map(lanes, frame)) if kind == "stereo" else lanes(frame)

        state = init(images(0), np.full(B, seq.frame_times[0]), np.arange(B))
        outs = []
        for fi, imu in enumerate(imu_batches(seq, FRAMES, B), start=1):
            state, out = step(state, ImuBatch(*map(torch.as_tensor, imu)), images(fi))
            outs.append(convert.to_numpy(out))
        runs.append((convert.to_numpy(state), outs))
    (shared_state, shared_outs), (lane_state, lane_outs) = runs
    for got, want in [(lane_state, shared_state)] + list(zip(lane_outs, shared_outs)):
        diff = mismatches(got, want, float("inf"))  # integers, bools and finite masks
        assert not diff, diff
        for x, y in zip(_leaves(got), _leaves(want)):
            if np.issubdtype(y.dtype, np.floating):
                np.testing.assert_allclose(x, y, rtol=1e-6, atol=0)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [] if tree is None else [np.asarray(tree)]


@pytest.mark.parametrize("levels", [1, 2])
def test_plain_pyramid_with_lane_axis_matches_reference(levels):
    """The plain pyramid + gradients of B lanes x 2 cameras of distinct
    images equal the reference's XLA build_pyramid and scharr_gradients
    lane by lane, bit for bit, and the 2-D plain version of each lane."""
    rng = np.random.RandomState(21)
    frames = rng.rand(3, 2, 60, 94).astype(np.float32)
    cams = tuple(torch.as_tensor(frames)[:, c] for c in range(2))
    pyrs, grads = ops.pyramid_with_gradients(cams, levels)
    assert len(pyrs) == 2 and len(grads) == levels + 1
    for b in range(3):
        for c in range(2):
            ref = build_pyramid(jnp.asarray(frames[b, c]), levels)
            for got, want in zip(pyrs[c], ref[1:]):
                assert got.shape == (3,) + want.shape
                np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
        ref = build_pyramid(jnp.asarray(frames[b, 0]), levels)
        for (gx, gy), level in zip(grads, ref):
            rx, ry = scharr_gradients(level)
            np.testing.assert_array_equal(gx[b].numpy(), np.asarray(rx))
            np.testing.assert_array_equal(gy[b].numpy(), np.asarray(ry))
        one_p, one_g = ops.pyramid_with_gradients((cams[0][b].contiguous(),), levels)
        assert all(torch.equal(a[b], o) for a, o in zip(pyrs[0], one_p[0]))
        assert all(torch.equal(a[b], o) for ga, go in zip(grads, one_g) for a, o in zip(ga, go))


@pytest.mark.parametrize("block", [3, 5])
def test_plain_corner_response_with_lane_axis_matches_reference(block):
    rng = np.random.RandomState(22)
    frames = rng.rand(3, 2, 64, 96).astype(np.float32)
    left = torch.as_tensor(frames)[:, 0]  # lane stride 2 H W, as the renderer lays frames out
    out = ops.corner_response(left, block)
    assert out.shape == (3, 64, 96)
    for b in range(3):
        ref = np.asarray(r_corner_response(jnp.asarray(frames[b, 0]), block_size=block))
        np.testing.assert_allclose(out[b].numpy(), ref, rtol=0, atol=1e-6)
        assert torch.equal(out[b], ops.corner_response(left[b].contiguous(), block))


def _floats(ptr, n):
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_float)), shape=(n,))


def _emulate_pyramid(monkeypatch):
    """Replace the kernel launch with a model of csrc/pyramid.cu's memory
    contract, run on CPU memory through the pointers the wrapper passes:
    camera c of lane b read at img_c + b * lane_stride; levels written per
    (lane, camera), lane-major; gradients of camera 0 per lane, per level,
    Ix then Iy."""
    calls = []

    def launch(kernel, fn, img0, img1, n_cams, lanes, stride, Hh, Ww, levels, out, *rest,
               shape):
        calls.append((kernel, shape))
        shapes = [(Hh, Ww)]
        for _ in range(levels):
            shapes.append(((shapes[-1][0] + 1) // 2, (shapes[-1][1] + 1) // 2))
        per_image = sum(h * w for h, w in shapes[1:])
        grad_base = rest[1] if rest else 0
        gshapes = shapes if grad_base else shapes[1:]
        per_lane = sum(2 * h * w for h, w in gshapes)
        dst = _floats(out, lanes * n_cams * per_image)
        for b in range(lanes):
            for c in range(n_cams):
                src = _floats((img0, img1)[c] + 4 * b * stride, Hh * Ww).reshape(Hh, Ww)
                pyr = [torch.as_tensor(src.copy())]
                for _ in range(levels):
                    pyr.append(ops.pyr_down_plain(pyr[-1]))
                at = (b * n_cams + c) * per_image
                for lv in pyr[1:]:
                    dst[at:at + lv.numel()] = lv.reshape(-1).numpy()
                    at += lv.numel()
                if rest and c == 0:
                    gdst = _floats(rest[0], lanes * per_lane)
                    at = b * per_lane
                    for lv in (pyr if grad_base else pyr[1:]):
                        for gr in ops.scharr_plain(lv):
                            gdst[at:at + gr.numel()] = gr.reshape(-1).numpy()
                            at += gr.numel()

    monkeypatch.setattr(ops_pyramid, "launch", launch)
    return calls


@pytest.mark.parametrize("lanes", [0, 3])
def test_pyramid_wrapper_views_follow_the_kernel_layout(monkeypatch, lanes):
    """The views the wrapper returns read the kernel's output layout right
    (a model of the kernel on CPU memory stands in for the launch): shared
    frames (lanes 0: (H, W) images) and per-lane frames whose cameras are
    views of one (B, 2, H, W) tensor, over a chained launch (4 levels)."""
    calls = _emulate_pyramid(monkeypatch)
    rng = np.random.RandomState(23)
    if lanes:
        frames = torch.as_tensor(rng.rand(lanes, 2, 45, 70).astype(np.float32))
        cams = (frames[:, 0], frames[:, 1])
    else:
        cams = tuple(torch.as_tensor(rng.rand(45, 70).astype(np.float32)) for _ in range(2))
    pyrs, grads = ops_pyramid._chained(cams, 4, gradients=True)
    want_p, want_g = ops.pyramid_with_gradients_plain(cams, 4)
    assert all(torch.equal(a, b) for pa, pb in zip(pyrs, want_p) for a, b in zip(pa, pb))
    assert all(torch.equal(a, b) for ga, gb in zip(grads, want_g) for a, b in zip(ga, gb))
    n = max(lanes, 1)
    assert calls == [("pyramid_scharr", (2, n, 45, 70, 3)), ("pyramid_scharr", (2, n, 6, 9, 1))]
    levels = ops_pyramid._chained(cams[:1], 2, gradients=False)[0]
    assert all(torch.equal(a, b) for a, b in zip(levels[0], ops.pyr_down_levels_plain(cams[:1],
                                                                                      2)[0]))


def test_kernel_wrappers_pass_lanes_and_lane_stride(monkeypatch):
    """The corner response and the fused pyramid take a renderer's
    (B, C, H, W) camera views without a copy: one launch of B lanes at lane
    stride C H W; a shared (H, W) frame is one lane."""
    seen = []
    for mod in (ops_gftt, ops_pyramid):
        monkeypatch.setattr(mod, "require_cuda", lambda *t, dtype=None: None)
        monkeypatch.setattr(mod, "launch", lambda k, fn, *args, shape: seen.append((k, args)))
    frames = torch.empty((16, 2, 480, 752), device="meta")
    ops.corner_response(frames[:, 0], 3)
    ops.corner_response(frames[0, 0], 3)
    ops.pyramid_with_gradients((frames[:, 0], frames[:, 1]), 2)
    assert seen[0] == ("corner_response", (frames[:, 0].data_ptr(), 16, 2 * 480 * 752, 480, 752,
                                           3, seen[0][1][-1]))
    assert seen[1][1][1:3] == (1, 0)
    assert seen[2][0] == "pyramid_scharr" and seen[2][1][2:8] == (2, 16, 2 * 480 * 752, 480, 752, 2)
    with pytest.raises(ValueError):  # cameras of one launch share one lane stride
        ops.pyramid_with_gradients((frames[:, 0], frames[:, 1].contiguous()), 2)
    with pytest.raises(ValueError):  # rows must be contiguous
        ops.corner_response(frames[:, 0].transpose(-1, -2), 3)


def test_make_batched_vio_checks_the_frame_layout():
    p, _, rcam = tiny_stereo_setup()
    cam = convert.camera_from_jax(rcam)
    seq = tiny_sequence(1)
    pair = tuple(torch.as_tensor(f) for f in stereo_frame(seq, 0))
    for shared, frame in ((False, pair), (False, tuple(f.expand(3, H, W) for f in pair)),
                          (True, tuple(f.expand(B, H, W) for f in pair))):
        init, _, _ = make_batched_vio(p, PortDerived.from_parameters(p), (cam, cam),
                                      batch_size=B, max_tracks=12, dtype=torch.float64,
                                      shared_frames=shared, device="cpu")
        with pytest.raises(ValueError, match="shared_frames"):
            init(frame, np.full(B, 10.0), np.arange(B))
