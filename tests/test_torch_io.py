"""The port's own copies of the synthetic world and the ATE give the
reference's arrays and numbers, and its entry points refuse to run without a
card unless the caller asks for the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

from hybvio_tpu.eval.ate import ate_rmse as ref_ate_rmse
from hybvio_tpu.io import synthetic as ref_synthetic
from hybvio_tpu_torch import convert, runtime
from hybvio_tpu_torch.ekf import state
from hybvio_tpu_torch.eval.ate import ate_rmse
from hybvio_tpu_torch.io import synthetic
from hybvio_tpu_torch.models import _finalize, synthetic_bench_params
from hybvio_tpu_torch.parallel.batched import make_batched_vio

torch.set_num_threads(1)


def _sequences(**kw):
    return synthetic.generate_sequence(**kw), ref_synthetic.generate_sequence(**kw)


@pytest.mark.parametrize("seed", [0, 3])
def test_generate_sequence_equals_reference(seed):
    seq, ref = _sequences(duration=0.6, imu_rate=200.0, frame_rate=20.0, n_landmarks=50,
                          gyro_noise=5e-4, acc_noise=5e-3, gyro_bias=1e-3, acc_bias=1e-2,
                          seed=seed)
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(seq, f.name), getattr(ref, f.name), f.name)


def test_render_view_equals_reference():
    seq, _ = _sequences(duration=0.3, n_landmarks=200, seed=0)
    np.testing.assert_array_equal(synthetic.SYNTH_IMU_TO_CAMERA, ref_synthetic.SYNTH_IMU_TO_CAMERA)
    second = synthetic.SYNTH_IMU_TO_CAMERA.copy()
    second[0, 3] = -0.11
    k = seq.frame_sample_idx[2]
    for ext in (synthetic.SYNTH_IMU_TO_CAMERA, second):
        args = (seq.landmarks, seq.pos[k], seq.quat[k], ext, 80.0, 80.0, 48.0, 32.0, 96, 64)
        for kw in ({"blob_sigma": 1.4}, {"pixel_noise": 0.01, "seed": 4}):
            out = synthetic.render_view(*args, **kw)
            assert out.dtype == np.float32 and out.shape == (64, 96)
            np.testing.assert_array_equal(out, ref_synthetic.render_view(*args, **kw))


def test_ate_rmse_equals_reference():
    rng = np.random.RandomState(7)
    gt = np.cumsum(rng.randn(40, 3) * 0.1, axis=0)
    c, s = np.cos(0.3), np.sin(0.3)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    est = gt @ rot.T + np.array([0.5, -0.2, 0.1]) + 0.01 * rng.randn(40, 3)
    got, want = ate_rmse(est, gt), ref_ate_rmse(est, gt)
    assert want > 0.005
    assert abs(got - want) <= 1e-12


def test_default_device_has_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runtime.default_device()


@pytest.mark.parametrize("make", ["from_jax", "init_state", "process_noise_q"])
def test_state_builders_need_a_card_unless_asked_for_the_cpu(make):
    """convert.from_jax and the filter's initial state and process noise
    take the card by default, and the CPU only when asked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    po = synthetic_bench_params("stereo").odometry
    call = {"from_jax": lambda **kw: convert.from_jax((np.zeros(3), np.ones(2, np.uint32)), **kw),
            "init_state": lambda **kw: state.init_state(po, 2, **kw),
            "process_noise_q": lambda **kw: state.process_noise_q(po, **kw)}[make]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    out = call(device="cpu")
    assert all(t.device.type == "cpu" for t in (out if isinstance(out, tuple) else (out,)))


def test_make_batched_vio_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    params, derived, cams = _finalize(synthetic_bench_params("stereo"), 96, 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batched_vio(params, derived, cams, batch_size=2)
    _, _, vio = make_batched_vio(params, derived, cams, batch_size=2, device="cpu")
    assert vio.dtype == torch.float64


@pytest.mark.parametrize("config", ["mono", "fisheye"])
def test_mono_and_fisheye_presets_match_reference(config):
    """The presets equal the reference's field by field, and so do their
    cameras (one each; the fisheye one KB4)."""
    import jax.numpy as jnp

    from hybvio_tpu.models import _finalize as ref_finalize
    from hybvio_tpu.models import synthetic_bench_params as ref_params

    p, r = synthetic_bench_params(config), ref_params(config)
    for group in ("odometry", "tracker", "slam"):
        assert dataclasses.asdict(getattr(p, group)) == dataclasses.asdict(getattr(r, group)), group
    wh = (512, 512) if config == "fisheye" else (752, 480)
    _, _, cams = _finalize(p, *wh)
    _, _, rcams = ref_finalize(r, *wh, dtype=jnp.float64)
    assert len(cams) == len(rcams) == 1
    assert cams[0] == convert.camera_from_jax(rcams[0])
    assert cams[0].kind == ("fisheye" if config == "fisheye" else "pinhole")


@pytest.mark.parametrize("config", ["mono", "fisheye"])
def test_make_batched_vio_mono_and_fisheye_need_a_card_unless_asked_for_the_cpu(config):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    params, derived, cams = _finalize(synthetic_bench_params(config), 96, 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batched_vio(params, derived, cams, batch_size=2)
    _, _, vio = make_batched_vio(params, derived, cams, batch_size=2, device="cpu")
    assert vio.dtype == torch.float64 and vio.backend.n_cams == 1 and not vio.tracker.stereo


@pytest.mark.parametrize("config", ["stereo", "mono", "fisheye"])
@pytest.mark.parametrize("kw", [{}, {"lk_levels": 3}, {"lk_iters": 20, "rcond": 1e-8},
                                {"lk_levels": 1, "lk_iters": 4, "rcond": 1e-6}])
def test_preset_keywords_match_reference(config, kw):
    """synthetic_bench_params' lk_levels, lk_iters and rcond set what the
    reference's set, field by field."""
    from hybvio_tpu.models import synthetic_bench_params as ref_params

    p, r = synthetic_bench_params(config, **kw), ref_params(config, **kw)
    for group in ("odometry", "tracker", "slam"):
        assert dataclasses.asdict(getattr(p, group)) == dataclasses.asdict(getattr(r, group)), group
    if "lk_levels" in kw:
        assert p.tracker.pyrLKMaxLevel == kw["lk_levels"]


KB4 = (0.0035, 0.0007, -0.002, 0.0002)


@pytest.mark.parametrize("lens", ["pinhole stereo", "kb4"])
def test_device_renderer_matches_reference(lens):
    """The port's on-device blob renderer equals the reference's
    (io/synthetic_jax.py) on the CPU for two lanes with distinct worlds, to
    1e-5 abs in float32 (the scatter-add order and the transcendentals'
    last bits differ), and renders a distinct frame per lane."""
    import jax
    import jax.numpy as jnp

    from hybvio_tpu.io.synthetic_jax import make_blob_renderer as ref_renderer
    from hybvio_tpu_torch.io.synthetic_device import make_blob_renderer

    second = synthetic.SYNTH_IMU_TO_CAMERA.copy()
    second[0, 3] = -0.11
    if lens == "kb4":
        args = ([synthetic.SYNTH_IMU_TO_CAMERA], 36.0, 36.0, 48.0, 48.0, 96, 96)
        kw = {"fisheye_coeffs": KB4, "max_fov_deg": 150.0}
    else:
        args = ([synthetic.SYNTH_IMU_TO_CAMERA, second], 80.0, 80.0, 48.0, 32.0, 96, 64)
        kw = {}
    seqs = [synthetic.generate_sequence(duration=0.3, n_landmarks=300, seed=1000 + b,
                                        radius=r, landmark_radius=5.0 if lens == "kb4" else 6.0)
            for b, r in ((0, 2.0), (1, 1.8))]
    k = seqs[0].frame_sample_idx[3]
    world = [np.stack(a) for a in zip(*[(s.landmarks, s.pos[k], s.quat[k]) for s in seqs])]
    got = make_blob_renderer(*args, **kw, device="cpu")(*world).numpy()
    want = np.asarray(jax.vmap(ref_renderer(*args, **kw))(
        *(jnp.asarray(a, jnp.float32) for a in world)))
    assert got.shape == want.shape == (2, len(args[0]), args[6], args[5])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got[0] - got[1]).max() > 0.1
