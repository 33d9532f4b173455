"""The port imports no jax, its preset equals the reference's field by
field, and state round-trips through convert."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hybvio_tpu.config import DerivedParameters
from hybvio_tpu.models import _finalize as ref_finalize
from hybvio_tpu.models import synthetic_bench_params as ref_params
from hybvio_tpu_torch import convert
from hybvio_tpu_torch.models import _finalize, derived_parameters, synthetic_bench_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SLICE_MODULES = [
    "hybvio_tpu_torch", "hybvio_tpu_torch.runtime", "hybvio_tpu_torch.random",
    "hybvio_tpu_torch.lanes", "hybvio_tpu_torch.convert", "hybvio_tpu_torch.models",
    "hybvio_tpu_torch.geometry.quaternion", "hybvio_tpu_torch.geometry.poses",
    "hybvio_tpu_torch.geometry.cameras", "hybvio_tpu_torch.ekf",
    "hybvio_tpu_torch.ekf.state", "hybvio_tpu_torch.ekf.chi2", "hybvio_tpu_torch.ekf.predict",
    "hybvio_tpu_torch.ekf.update", "hybvio_tpu_torch.ekf.augment",
    "hybvio_tpu_torch.ekf.transforms", "hybvio_tpu_torch.odometry.trail",
    "hybvio_tpu_torch.odometry.triangulation", "hybvio_tpu_torch.odometry.visual_update",
    "hybvio_tpu_torch.odometry.batched_update", "hybvio_tpu_torch.odometry.backend",
    "hybvio_tpu_torch.odometry.vio", "hybvio_tpu_torch.frontend.pyramid",
    "hybvio_tpu_torch.frontend.lk", "hybvio_tpu_torch.frontend.gftt",
    "hybvio_tpu_torch.frontend.stereo", "hybvio_tpu_torch.frontend.ransac",
    "hybvio_tpu_torch.frontend.tracker", "hybvio_tpu_torch.ops",
    "hybvio_tpu_torch.ops.patch_gather", "hybvio_tpu_torch.ops.pyramid",
    "hybvio_tpu_torch.ops.gftt", "hybvio_tpu_torch.ops.nms",
    "hybvio_tpu_torch.parallel.batched",
]


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def _fields(group):
    return {f.name: getattr(group, f.name) for f in dataclasses.fields(group)}


def test_preset_matches_reference_field_by_field():
    p, r = synthetic_bench_params("stereo"), ref_params("stereo")
    for group in ("odometry", "tracker", "slam"):
        assert _fields(getattr(p, group)) == _fields(getattr(r, group)), group


def test_derived_and_cameras_match_reference():
    p = synthetic_bench_params("stereo")
    d, dr = derived_parameters(p), DerivedParameters.from_parameters(p)
    for name in ("imu_to_camera", "second_imu_to_camera", "imu_to_output"):
        np.testing.assert_array_equal(getattr(d, name), getattr(dr, name))
    _, _, cams = _finalize(p, 752, 480)
    _, _, rcams = ref_finalize(ref_params("stereo"), 752, 480, dtype=jnp.float64)
    for c, rc in zip(cams, rcams):
        assert c == convert.camera_from_jax(rc)


def test_convert_round_trips_vio_state():
    from hybvio_tpu.parallel.batched import make_batched_vio
    from torch_parity import tiny_stereo_setup

    p, derived, cam = tiny_stereo_setup()
    binit, _ = make_batched_vio(p, derived, (cam, cam), batch_size=2, max_tracks=12,
                                dtype=jnp.float64, shared_frames=True)
    rng = np.random.RandomState(0)
    imgs = tuple(jnp.asarray(rng.rand(64, 96), jnp.float32) for _ in range(2))
    st = jax.tree.map(np.asarray, binit(imgs, np.full(2, 10.0), np.arange(2)))
    back = convert.to_numpy(convert.from_jax(st))
    flat_a, flat_b = jax.tree.leaves(st), jax.tree.leaves(tuple(back))
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a).astype(b.dtype), b)
