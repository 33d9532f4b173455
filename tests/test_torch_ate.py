"""The port's trajectory metrics (``eval/ate.py``) against the reference's
on seeded trajectories: the umeyama alignment with and without a scale,
and the ATE with and without the alignment."""
import numpy as np
import pytest

from hybvio_tpu.eval import ate as ref
from hybvio_tpu_torch.eval import ate


def _trajectories(seed=0, n=50):
    """A ground-truth lap and an estimate of it rotated, shifted, scaled by
    1.3 and noisy."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0.0, 2 * np.pi, n)
    gt = np.stack([2 * np.cos(t), 1.5 * np.sin(t), 0.2 * np.sin(3 * t)], axis=1)
    a = 0.4
    R = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]])
    est = 1.3 * gt @ R.T + np.array([0.5, -0.2, 0.1]) + 0.01 * rng.randn(n, 3)
    return est, gt


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("with_scale", [True, False])
def test_ate_and_alignment_match_the_reference(align, with_scale):
    est, gt = _trajectories()
    assert abs(ate.ate_rmse(est, gt, align=align, with_scale=with_scale)
               - ref.ate_rmse(est, gt, align=align, with_scale=with_scale)) <= 1e-12
    R, t, s = ate.umeyama_alignment(est, gt, with_scale)
    R_ref, t_ref, s_ref = ref.umeyama_alignment(est, gt, with_scale)
    np.testing.assert_allclose(R, R_ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(t, t_ref, rtol=0, atol=1e-12)
    assert abs(s - s_ref) <= 1e-12
    if with_scale:  # the scale the estimate was made with, back
        assert abs(1.0 / s - 1.3) < 0.01
    else:
        assert s == 1.0
