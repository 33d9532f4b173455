"""The textured world and its accuracy probes in the port against the
reference, on the CPU.

Tolerances: the port's numpy renderer (``io/textured.py``) bit-equal with
the reference's; the device renderer (``io/textured_device.py``) against
``io/textured_jax.py`` at 64x48 to 1e-5 in [0, 1] units without pixel
noise (the two float32 programs round the ray directions apart by an ulp,
which the texture's finest octave magnifies to a few 1e-6), and to 5e-5
with it: the noise goes through ``erfinv``, whose float32 approximations in
torch and XLA part by up to 1.8e-5 at 4.2 sigma (2e-7 after the 0.01
scale), and under the KB4 lens the motion blur's two renders near the rim
add up to 2e-5; the threefry normal itself to 2e-5 (its uniform draw bit
for bit). The probes, stereo at width 192 over 2 s with float64 filters,
fed the reference's frames, each step of the port from the reference's
state (run alone, the float32 front-ends part by ~1e-5 m over 20 frames of
the long probe's batched update and by ~5e-3 m under the short probe's
sequential one): positions to 2e-6 m (measured: 1.1e-6 m in one step of
the long probe). On textured frames the float32 LK lands on either side of
its 0.03 px exit test now and then (tracks part by up to 7e-3 px in one
step where blob frames keep 2e-4 px), so in the short probe at most one
of its 19 steps may take another track decision (ids, statuses or the
keyframe; measured: one, 4.5e-3 m in that step), and every other step
holds the position tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from hybvio_tpu.io import textured as rtex
from hybvio_tpu.io.synthetic import SYNTH_IMU_TO_CAMERA, generate_sequence
from hybvio_tpu.io.textured_jax import make_textured_renderer as r_make_renderer
from hybvio_tpu_torch import convert
from hybvio_tpu_torch import random as jr
from hybvio_tpu_torch.io import textured as ptex
from hybvio_tpu_torch.io.textured_device import make_textured_renderer

torch.set_num_threads(1)

KB4 = (0.0035, 0.0007, -0.002, 0.0002)
NOISE_TOL = 5e-5
POS_TOL = 2e-6  # m, one step of a float64 filter behind a float32 front-end


def _seq(duration=1.0):
    return generate_sequence(duration=duration, imu_rate=100.0, frame_rate=10.0,
                             gyro_noise=5e-4, acc_noise=5e-3, seed=8, radius=2.0)


@pytest.mark.parametrize("lens", ["pinhole", "kb4"])
def test_numpy_renderer_bit_equal(lens):
    """value_noise, render_textured_view (blur, exposure, noise) and the
    frame renderer of the port's copy give the reference's bits."""
    u, v = np.meshgrid(np.linspace(-3, 3, 17), np.linspace(0, 2, 11))
    assert np.array_equal(ptex.value_noise(u, v, 5, 5.0, 3), rtex.value_noise(u, v, 5, 5.0, 3))
    seq = _seq()
    coeffs = KB4 if lens == "kb4" else None
    fx = 20.0 if coeffs else 40.0
    args = (SYNTH_IMU_TO_CAMERA, fx, fx, 24.0, 16.0, 48, 32)
    kw = dict(exposure_jitter=0.05, pixel_noise=0.01, motion_blur=True, fisheye_coeffs=coeffs)
    pr = ptex.textured_frame_renderer(ptex.TexturedScene(seed=8), seq, *args, **kw)
    rr = rtex.textured_frame_renderer(rtex.TexturedScene(seed=8), seq, *args, **kw)
    for fi in (0, 3, 9):
        assert np.array_equal(pr(fi), rr(fi)), fi
    k = seq.frame_sample_idx[4]
    one = lambda m: m.render_textured_view(m.TexturedScene(seed=3, n_occluders=8), seq.pos[k],
                                           seq.quat[k], *args, exposure_gain=1.1,
                                           exposure_bias=0.02, pixel_noise=0.02,
                                           blur_pose=(seq.pos[k - 2], seq.quat[k - 2]),
                                           noise_seed=5, fisheye_coeffs=coeffs)
    assert np.array_equal(one(ptex), one(rtex))


DEVICE_CASES = {  # name -> (lens, exposure jitter, pixel noise, motion blur, chunk, tolerance)
    "pinhole_chunked": (None, 0.05, 0.0, True, 4, 1e-5),
    "kb4": (KB4, 0.0, 0.0, False, 32, 1e-5),
    "pinhole_noise": (None, 0.05, 0.01, True, 32, NOISE_TOL),
    "kb4_noise": (KB4, 0.05, 0.01, True, 4, NOISE_TOL),
}


@pytest.mark.parametrize("case", list(DEVICE_CASES))
def test_device_renderer_matches_reference(case):
    """The device renderer against the reference's at 64x48 over 10 frames
    (the chunked cases render 4 frames at a time, the last chunk short)."""
    coeffs, jitter, noise, blur, chunk, tol = DEVICE_CASES[case]
    seq = _seq()
    fx = 20.0 if coeffs else 40.0
    args = (SYNTH_IMU_TO_CAMERA, fx, fx, 32.0, 24.0, 64, 48)
    kw = dict(fisheye_coeffs=coeffs, exposure_jitter=jitter, pixel_noise=noise,
              motion_blur=blur)
    idx = np.arange(len(seq.frame_sample_idx))
    ref = r_make_renderer(rtex.TexturedScene(seed=8), *args, **kw)(seq, idx, chunk=chunk)
    got = make_textured_renderer(ptex.TexturedScene(seed=8), *args, device="cpu",
                                 **kw)(seq, idx, chunk=chunk)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)


def test_threefry_normal_matches_jax():
    """random.normal against jax.random.normal on per-frame keys: the
    uniform draw under it bit for bit, the normal to 2e-5."""
    seeds = np.asarray([8000, 8001, 8009], np.uint32)
    keys = jax.vmap(jax.random.PRNGKey)(seeds)
    pk = jr.prng_key(torch.as_tensor(seeds.astype(np.int64)))
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    ru = jax.vmap(lambda k: jax.random.uniform(k, (48, 64), jnp.float32, lo, 1.0))(keys)
    assert np.array_equal(jr.uniform(pk, (48, 64), torch.float32, lo, 1.0).numpy(),
                          np.asarray(ru))
    rn = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (48, 64), jnp.float32))(keys))
    np.testing.assert_allclose(jr.normal(pk, (48, 64)).numpy(), rn, rtol=0, atol=2e-5)


def _capture_positions(monkeypatch, module):
    """Record the estimated positions each probe hands to its ATE."""
    seen = []
    real = module.ate_rmse

    def recording(est, gt):
        seen.append(np.asarray(est, np.float64))
        return real(est, gt)

    monkeypatch.setattr(module, "ate_rmse", recording)
    return seen


def _step_lockstep(monkeypatch, port_module):
    """Record the reference's state before each of its jitted steps
    (``jax.jit`` of its ``vio_step``, with a lane axis added) and its
    output, and step the port's one-lane step (``make_batched_vio`` in
    ``port_module``) from the recorded state each time. Returns the lists
    of (reference, port) outputs, filled as the two run."""
    states, ref_outs, port_outs = [], [], []
    real_jit = jax.jit

    def jit(fn, *a, **k):
        compiled = real_jit(fn, *a, **k)
        if getattr(fn, "__name__", "") != "vio_step":
            return compiled

        def recorded(state, *args):
            states.append(jax.tree.map(lambda x: np.asarray(x)[None], state))
            state, out = compiled(state, *args)
            ref_outs.append(jax.tree.map(np.asarray, out))
            return state, out
        return recorded

    monkeypatch.setattr(jax, "jit", jit)
    real_make = port_module.make_batched_vio

    def make(*a, **k):
        init, step, vio = real_make(*a, **k)

        def stepped(state, *args):
            state, out = step(convert.from_jax(states[len(port_outs)], device="cpu"), *args)
            port_outs.append(convert.to_numpy(out))
            return state, out
        return init, stepped, vio

    monkeypatch.setattr(port_module, "make_batched_vio", make)
    return ref_outs, port_outs


def _steps_apart(ref_outs, port_outs):
    """(per-step position distance (m), steps whose tracks differ: ids,
    statuses or keyframe decision)."""
    dist = np.array([np.abs(np.asarray(p.position[0], np.float64) - r.position).max()
                     for r, p in zip(ref_outs, port_outs)])
    decided = [i for i, (r, p) in enumerate(zip(ref_outs, port_outs))
               if not (np.array_equal(p.track_ids[0], r.track_ids)
                       and np.array_equal(p.track_status[0], r.track_status)
                       and bool(p.keyframe[0]) == bool(r.keyframe))]
    return dist, decided


def test_textured_probe_matches_reference(monkeypatch):
    """run_textured_probe, stereo at 192x144 over 2 s, float64 filters: the
    port's host frames are the reference's bits, so the two runs see the
    same images."""
    from hybvio_tpu.eval import ate as rate
    from hybvio_tpu.eval.textured_probe import run_textured_probe as r_probe
    from hybvio_tpu_torch.eval import textured_probe as probe

    ref_pos = _capture_positions(monkeypatch, rate)
    port_pos = _capture_positions(monkeypatch, probe)
    ref_outs, port_outs = _step_lockstep(monkeypatch, probe)
    kw = dict(duration=2.0, width=192, height=144, fx=156.0, stereo=True)
    ref = r_probe(dtype=jnp.float64, **kw)
    got = probe.run_textured_probe(dtype=torch.float64, device="cpu", **kw)
    assert got["finite"] and got["frames"] == ref["frames"] == 19
    np.testing.assert_array_equal(port_pos[0], np.stack([o.position[0] for o in port_outs]))
    dist, decided = _steps_apart(ref_outs, port_outs)
    assert len(decided) <= 1, decided
    same = np.setdiff1d(np.arange(19), decided)
    assert dist[same].max() <= POS_TOL, dist


def _reference_frames(monkeypatch):
    """Make the port's long probe render the reference's frames: its world
    builder returns the reference's renderers (io/textured_jax.py), each
    chunk converted to a CPU tensor."""
    from hybvio_tpu.eval import long_probe as rlong
    from hybvio_tpu_torch.eval import long_probe as plong

    def build(family, seq, W, H, fx, coeffs, seed, scene_kwargs=None, device=None):
        renderers, second = rlong._build_world(family, seq, W, H, fx, coeffs, seed,
                                               scene_kwargs)
        wrap = lambda r: (lambda s, idx, chunk: torch.as_tensor(r(s, idx, chunk=chunk)))
        return tuple(wrap(r) for r in renderers), second

    monkeypatch.setattr(plong, "_build_world", build)


@pytest.mark.parametrize("family", ["stereo", "stereo_api"])
def test_long_probe_matches_reference(monkeypatch, family):
    """run_long_probe at width 192 over 2 s, float64 filters, the port fed
    the reference's rendered frames: the one-lane step loop (stereo) and
    the host entry point (stereo_api, VioApi with the Python synchronizer
    in both)."""
    from hybvio_tpu.api import vio as rapi
    from hybvio_tpu.eval import ate as rate
    from hybvio_tpu.eval.long_probe import run_long_probe as r_long
    from hybvio_tpu_torch.eval import long_probe as plong

    monkeypatch.setenv("HYBVIO_NATIVE_SYNC", "0")
    _reference_frames(monkeypatch)
    if family == "stereo_api":
        tp.lockstep(monkeypatch, tp.step_tol, [])
    else:
        _step_lockstep(monkeypatch, plong)
    real_api = rapi.VioApi

    class RefApi64(real_api):  # the reference's API probe hard-codes a float32 filter
        def __init__(self, params, width, height, dtype=None, **kw):
            super().__init__(params, width, height, dtype=jnp.float64, **kw)

    monkeypatch.setattr(rapi, "VioApi", RefApi64)
    ref_pos = _capture_positions(monkeypatch, rate)
    port_pos = _capture_positions(monkeypatch, plong)
    kw = dict(duration=2.0, width=192)
    ref = r_long(family, dtype=jnp.float64, **kw)
    got = plong.run_long_probe(family, dtype=torch.float64, device="cpu", **kw)
    assert got["finite"] and got["frames"] == ref["frames"]
    assert got["resolution"] == ref["resolution"] == "192x123"
    np.testing.assert_allclose(port_pos[0], ref_pos[0], rtol=0, atol=POS_TOL)
