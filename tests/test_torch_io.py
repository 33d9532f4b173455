"""The port's own copies of the synthetic world and the ATE give the
reference's arrays and numbers, and its entry points refuse to run without a
card unless the caller asks for the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

from hybvio_tpu.eval.ate import ate_rmse as ref_ate_rmse
from hybvio_tpu.io import synthetic as ref_synthetic
from hybvio_tpu_torch import runtime
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


def test_make_batched_vio_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    params, derived, cams = _finalize(synthetic_bench_params("stereo"), 96, 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batched_vio(params, derived, cams, batch_size=2)
    _, _, vio = make_batched_vio(params, derived, cams, batch_size=2, device="cpu")
    assert vio.dtype == torch.float64
