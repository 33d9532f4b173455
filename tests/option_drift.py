"""One world's drift under a stereo option: the port against the reference,
each running on its own (not stepped from the other's state), on the CPU.

The world is lane ``--lane`` of ``chip_smoke.py``'s stereo_per_lane set
(seed 1000 + lane; radius, angular speed and z-wobble drawn from
RandomState(7000 + lane)), rendered by the reference's ``render_view`` at
half the card's size (376x240; focal length and principal point halved,
the rest of ``synthetic_bench_params("stereo")`` as it is). Both packages
run ``make_batched_vio`` at B=1 with a float64 filter for ``--steps``
steps, with no option and with ``--option``, and the script prints each
run's ATE against the ground truth (``eval.ate.ate_rmse``, aligned). The
``rectify_distorted`` option records the frames through EuRoC cam0's
radial lens (the port's ``build_remap`` / ``remap``, float64), as phase 9a
does.

    JAX_PLATFORMS=cpu python tests/option_drift.py --lane 1 --option no_flow_prediction
"""
import argparse
import copy
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]  # the repository and its tests

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from hybvio_tpu.config import DerivedParameters as RDerived  # noqa: E402
from hybvio_tpu.eval.ate import ate_rmse  # noqa: E402
from hybvio_tpu.geometry.cameras import build_pinhole as r_build_pinhole  # noqa: E402
from hybvio_tpu.io.synthetic import (  # noqa: E402
    SYNTH_IMU_TO_CAMERA, generate_sequence, render_view,
)
from hybvio_tpu.models import synthetic_bench_params  # noqa: E402
from hybvio_tpu.odometry.backend import ImuBatch as RImuBatch  # noqa: E402
from hybvio_tpu.parallel.batched import make_batched_vio as r_make_batched_vio  # noqa: E402
from hybvio_tpu_torch import convert  # noqa: E402
from hybvio_tpu_torch.config import DerivedParameters as PortDerived  # noqa: E402
from hybvio_tpu_torch.frontend.rectify import build_remap, remap  # noqa: E402
from hybvio_tpu_torch.geometry.cameras import build_pinhole  # noqa: E402
from hybvio_tpu_torch.odometry.backend import ImuBatch  # noqa: E402
from hybvio_tpu_torch.parallel.batched import make_batched_vio  # noqa: E402

from test_torch_stereo_options_step import EUROC_K, OPTIONS  # noqa: E402

W, H = 376, 240


def world(lane, frames):
    rng = np.random.RandomState(7000 + lane)
    return generate_sequence(
        duration=frames / 20.0 + 0.25, imu_rate=200.0, frame_rate=20.0,
        radius=float(rng.uniform(1.7, 2.3)), angular_speed=float(rng.uniform(0.34, 0.46)),
        z_wobble=float(rng.uniform(0.10, 0.20)), n_landmarks=500, landmark_radius=6.0,
        gyro_noise=5e-4, acc_noise=5e-3, seed=1000 + lane)


def inputs(seq, p, frames, warp):
    """(frames as (left, right) (1, H, W) arrays, IMU batches, ground truth)."""
    pt = p.tracker
    f, cx, cy = pt.focalLength, pt.principalPointX, pt.principalPointY
    exts = (SYNTH_IMU_TO_CAMERA, np.asarray(p.odometry.secondImuToCameraMatrix).reshape(4, 4).T)
    idx = seq.frame_sample_idx[:frames + 1]
    images = []
    for k in idx:
        pair = []
        for ext in exts:
            img = render_view(seq.landmarks, seq.pos[k], seq.quat[k], ext, f, f, cx, cy, W, H,
                              blob_sigma=1.4)
            if warp is not None:
                img = remap(torch.as_tensor(img), warp).numpy()
            pair.append(np.asarray(img, np.float32)[None])
        images.append(tuple(pair))
    imus, prev, S = [], idx[0] + 1, 10
    for fi in range(1, frames + 1):
        k = idx[fi] + 1
        n = k - prev
        t = np.pad(seq.times[prev:k], (0, S - n), constant_values=seq.times[k - 1])
        g = np.pad(seq.gyro[prev:k], ((0, S - n), (0, 0)))[None]
        a = np.pad(seq.acc[prev:k], ((0, S - n), (0, 0)))[None]
        imus.append((t[None], g, a, (np.arange(S) < n)[None]))
        prev = k
    return images, imus, seq.pos[idx[1:]] - seq.pos[0]


def run_both(p, warp, seq, steps):
    images, imus, gt = inputs(seq, p, steps, warp)
    coeffs = tuple(p.tracker.distortionCoeffs)
    rcam = r_build_pinhole(p.tracker.focalLength, p.tracker.focalLength,
                           p.tracker.principalPointX, p.tracker.principalPointY, coeffs,
                           width=W, height=H, dtype=jnp.float64)
    t0 = np.full(1, seq.frame_times[0])
    rinit, rstep = r_make_batched_vio(p, RDerived.from_parameters(p), (rcam, rcam), batch_size=1,
                                      dtype=jnp.float64, shared_frames=False)
    cams = (convert.camera_from_jax(rcam),) * 2
    tinit, tstep, _ = make_batched_vio(p, PortDerived.from_parameters(p), cams, batch_size=1,
                                       dtype=torch.float64, shared_frames=False, device="cpu")
    rstate = rinit(tuple(map(jnp.asarray, images[0])), t0, np.arange(1))
    tstate = tinit(tuple(map(torch.as_tensor, images[0])), t0, np.arange(1))
    rpos, tpos = [], []
    for fi in range(1, steps + 1):
        rstate, rout = rstep(rstate, RImuBatch(*map(jnp.asarray, imus[fi - 1])),
                             tuple(map(jnp.asarray, images[fi])))
        tstate, tout = tstep(tstate, ImuBatch(*map(torch.as_tensor, imus[fi - 1])),
                             tuple(map(torch.as_tensor, images[fi])))
        rpos.append(np.asarray(rout.position)[0])
        tpos.append(tout.position[0].numpy())
    return (float(ate_rmse(np.array(rpos), gt[:steps])),
            float(ate_rmse(np.array(tpos), gt[:steps])))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lane", type=int, default=1)
    ap.add_argument("--option", choices=sorted(OPTIONS), default="no_flow_prediction")
    ap.add_argument("--steps", type=int, default=7)
    args = ap.parse_args()
    torch.set_num_threads(1)
    base = synthetic_bench_params("stereo")
    base.tracker.focalLength /= 2
    base.tracker.principalPointX, base.tracker.principalPointY = W / 2, H / 2
    seq = world(args.lane, args.steps + 1)
    out = {"lane": args.lane, "option": args.option, "steps": args.steps, "size": f"{W}x{H}"}
    for name, settings in (("no option", {}), (args.option, OPTIONS[args.option])):
        p = copy.deepcopy(base)
        for key, value in settings.items():
            group, field = key.split(".")
            p.set_parameter(group, field, value)
        warp = None
        if args.option == "rectify_distorted" and settings:
            p.tracker.distortionCoeffs = EUROC_K + (0.0,)
            f = p.tracker.focalLength
            pin = build_pinhole(f, f, W / 2, H / 2, width=W, height=H)
            lens = build_pinhole(f, f, W / 2, H / 2, coeffs=EUROC_K + (0.0,), width=W, height=H)
            warp = build_remap(pin, lens, W, H, torch.float64, device="cpu")
        ref, port = run_both(p, warp, seq, args.steps)
        out[name] = {"reference_ate_m": ref, "port_ate_m": port}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
