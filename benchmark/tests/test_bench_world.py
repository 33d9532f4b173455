"""The benchmark's frozen copies of the world give the port's sequences
and images (at the commit the benchmark was written against), at a tiny
size on the CPU. The test imports both; the harness loads only its
copies."""
import numpy as np
import pytest
import torch

from benchmark import world

KW = dict(n_landmarks=40, gyro_noise=5e-4, acc_noise=5e-3, seed=123, radius=1.9,
          angular_speed=0.41, z_wobble=0.12)


def test_sequence_matches_the_ports():
    from hybvio_tpu_torch.io.synthetic import SYNTH_IMU_TO_CAMERA, generate_sequence

    ours = world.generate_sequence(duration=3.0, **KW)
    port = generate_sequence(duration=3.0, **KW)
    for field in ("times", "gyro", "acc", "pos", "quat", "vel", "frame_times",
                  "frame_sample_idx", "landmarks"):
        a, b = getattr(ours, field), getattr(port, field)
        # one pass of half-angle sums against the port's loop of updates:
        # float64 rounding apart, the same float32 values the step is fed
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=field)
        assert np.array_equal(a.astype(np.float32), b.astype(np.float32)), field
    assert np.array_equal(world.IMU_TO_CAMERA, SYNTH_IMU_TO_CAMERA)


@pytest.mark.parametrize("camera", [
    {"width": 96, "height": 64, "focal": 60.0, "baseline": 0.11, "kb4": None, "fov_deg": None},
    {"width": 80, "height": 80, "focal": 30.0, "baseline": None,
     "kb4": [0.0035, 0.0007, -0.002, 0.0002], "fov_deg": 150.0},
])
def test_renderer_matches_the_ports(camera):
    from hybvio_tpu_torch.io.synthetic_device import make_blob_renderer

    seq = world.generate_sequence(duration=1.0, **dict(KW, n_landmarks=200, landmark_radius=4.0))
    cams = world.camera_extrinsics(camera)
    W, H, f = camera["width"], camera["height"], camera["focal"]
    port = make_blob_renderer(cams, f, f, W / 2, H / 2, W, H, fisheye_coeffs=camera["kb4"],
                              max_fov_deg=camera["fov_deg"] or 160.0, device="cpu")
    ours = world.make_renderer(camera, "cpu")
    k = seq.frame_sample_idx[[0, 7, 15]]
    args = (np.stack([seq.landmarks] * 3), seq.pos[k], seq.quat[k])
    a, b = ours(*args), port(*args)
    assert a.shape == (3, len(cams), H, W)
    assert torch.equal(a, b)
    assert torch.equal(world.to_u8(a), world.to_u8(b))


def test_lanes_differ_and_repeat():
    wcfg = {"n_landmarks": 30, "landmark_radius_m": 6.0, "radius_m": [1.7, 2.3],
            "angular_speed_rad_s": [0.34, 0.46], "z_wobble_m": [0.1, 0.2],
            "gyro_noise": 5e-4, "acc_noise": 5e-3}
    a = world.lane_worlds(2**31 + 5, 3, wcfg, 20, 20.0, 200.0)
    b = world.lane_worlds(2**31 + 5, 3, wcfg, 20, 20.0, 200.0)
    c = world.lane_worlds(2**31 + 6, 3, wcfg, 20, 20.0, 200.0)
    assert all(np.array_equal(x.gyro, y.gyro) for x, y in zip(a, b))
    assert not np.array_equal(a[0].pos, a[1].pos)
    assert not np.array_equal(a[0].pos, c[0].pos)
    assert all(len(x.frame_sample_idx) == 20 for x in a + c)
