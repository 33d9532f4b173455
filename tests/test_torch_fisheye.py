"""The port's KB4 fisheye against the reference: the camera model (pixel to
ray and back, normalization, validity, past the field of view too), the
fisheye renderer, and the whole fisheye batched step (the mono path with the
KB4 lens)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybvio_tpu.geometry import cameras as rcameras
from hybvio_tpu.io import synthetic as ref_synthetic
from hybvio_tpu_torch import convert
from hybvio_tpu_torch.geometry import cameras
from hybvio_tpu_torch.io import synthetic

from torch_parity import (
    FISHEYE_FOV, KB4, batched_step_parity, fisheye_frame, mono_step_tol, tiny_fisheye_setup,
    tiny_sequence,
)

torch.set_num_threads(1)

TOL = {np.float64: 1e-6, np.float32: 1e-5}


def _ref_camera(dtype, coeffs=KB4):
    return rcameras.build_fisheye(190.0, 188.0, 256.0, 250.0, coeffs=coeffs,
                                  max_valid_fov_deg=FISHEYE_FOV, width=512, height=512,
                                  dtype=jnp.dtype(dtype))


def _pixels(dtype):
    """Pixels over the whole frame and beyond it: radii up to 1.45x the
    valid one, so some lie past validCameraFov."""
    rng = np.random.RandomState(0)
    px = np.stack([rng.uniform(-150, 660, 400), rng.uniform(-150, 660, 400)], 1)
    return np.concatenate([px, [[256.0, 250.0]]]).astype(dtype)  # and the principal point


def _rays(dtype):
    """Unit rays in every direction: behind the camera, past the field of
    view, on the axis."""
    rng = np.random.RandomState(1)
    r = rng.randn(400, 3)
    r = np.concatenate([r, [[0.0, 0.0, 1.0], [0.3, -0.2, 0.0]]])
    return (r / np.linalg.norm(r, axis=1, keepdims=True)).astype(dtype)


@pytest.mark.parametrize("coeffs", [KB4, ()])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kb4_camera_matches_reference(dtype, coeffs):
    rcam = _ref_camera(dtype, coeffs)
    cam = convert.camera_from_jax(rcam)
    assert cam.kind == cameras.FISHEYE and cam.has_distortion == bool(coeffs)
    tol = TOL[dtype]
    px = _pixels(dtype)
    ray, ok = cameras.pixel_to_ray(cam, torch.as_tensor(px))
    rray, rok = rcameras.pixel_to_ray(rcam, jnp.asarray(px))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    assert 0 < int(ok.sum()) < len(px)  # some pixels lie past the field of view
    np.testing.assert_allclose(ray.numpy(), np.asarray(rray), rtol=0, atol=tol)
    norm, nok = cameras.normalize_pixel(cam, torch.as_tensor(px))
    rnorm, rnok = rcameras.normalize_pixel(rcam, jnp.asarray(px))
    np.testing.assert_array_equal(nok.numpy(), np.asarray(rnok))
    np.testing.assert_allclose(norm.numpy()[nok.numpy()], np.asarray(rnorm)[np.asarray(rnok)],
                               rtol=tol, atol=tol)
    np.testing.assert_array_equal(cameras.is_valid_pixel(cam, torch.as_tensor(px)).numpy(),
                                  np.asarray(rcameras.is_valid_pixel(rcam, jnp.asarray(px))))
    rays = _rays(dtype)
    pix, pok = cameras.ray_to_pixel(cam, torch.as_tensor(rays))
    rpix, rpok = rcameras.ray_to_pixel(rcam, jnp.asarray(rays))
    np.testing.assert_array_equal(pok.numpy(), np.asarray(rpok))
    assert 0 < int(pok.sum()) < len(rays)
    # in units of the focal length, the pixels' scale: one float32 ulp of
    # theta (arccos differs by one between the libraries) is 2.3e-5 px
    np.testing.assert_allclose(pix.numpy(), np.asarray(rpix), rtol=0, atol=tol * cam.fx)
    # and the round trip inside the field of view
    back, _ = cameras.ray_to_pixel(cam, ray[ok])
    np.testing.assert_allclose(back.numpy(), px[ok.numpy()], rtol=0, atol=1e3 * tol)


def test_build_fisheye_from_params_matches_reference():
    from hybvio_tpu.models import synthetic_bench_params as ref_params
    from hybvio_tpu_torch.models import _finalize, synthetic_bench_params

    _, _, (cam,) = _finalize(synthetic_bench_params("fisheye"), 512, 512)
    rcam = rcameras.build_camera_from_params(ref_params("fisheye").tracker, 512, 512,
                                             dtype=jnp.float64)
    assert cam == convert.camera_from_jax(rcam)


def test_render_view_fisheye_equals_reference():
    seq = synthetic.generate_sequence(duration=0.3, n_landmarks=200, landmark_radius=5.0,
                                      seed=0)
    k = seq.frame_sample_idx[2]
    args = (seq.landmarks, seq.pos[k], seq.quat[k], synthetic.SYNTH_IMU_TO_CAMERA, 36.0, 36.0,
            48.0, 48.0, 96, 96, KB4)
    out = synthetic.render_view_fisheye(*args, max_fov_deg=FISHEYE_FOV, blob_sigma=1.4)
    assert out.dtype == np.float32 and out.shape == (96, 96)
    np.testing.assert_array_equal(
        out, ref_synthetic.render_view_fisheye(*args, max_fov_deg=FISHEYE_FOV, blob_sigma=1.4))


def test_batched_fisheye_step_matches_reference():
    """The whole fisheye batched step, B=2 lanes over 5 rendered 96x96 KB4
    frames of the fisheye world (landmarks 5 m out): integer and boolean
    fields equal, positions to 1e-6 m, the other floats to
    torch_parity.mono_step_tol."""
    p, _, rcam = tiny_fisheye_setup()
    seq = tiny_sequence(5, landmark_radius=5.0)
    frames = [fisheye_frame(seq, fi) for fi in range(6)]
    assert batched_step_parity(p, (rcam,), frames, seq, 2, tol=mono_step_tol) > 0
