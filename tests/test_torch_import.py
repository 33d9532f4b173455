"""The port imports neither jax nor anything of the reference package, its
parameter surface and preset equal the reference's field by field, and
state round-trips through convert."""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybvio_tpu.config import DerivedParameters, Parameters, parameter_names
from hybvio_tpu.models import _finalize as ref_finalize
from hybvio_tpu.models import synthetic_bench_params as ref_params
from hybvio_tpu_torch import config as port_config
from hybvio_tpu_torch import convert
from hybvio_tpu_torch.models import _finalize, synthetic_bench_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "hybvio_tpu_torch").rglob("*.py"))
PORT_MODULES = [".".join(f.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
                for f in PORT_FILES]


def _is_reference(name):
    return name is not None and any(name == top or name.startswith(top + ".")
                                    for top in ("hybvio_tpu", "jax"))


def test_port_imports_no_jax():
    """Importing every module of the port loads neither jax nor any module
    of hybvio_tpu."""
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'hybvio_tpu')\n"
            "             or m.startswith(('jax.', 'hybvio_tpu.')))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_port_and_smoke_run_never_import_the_reference():
    """No import statement of the port or of chip_smoke.py names jax or
    hybvio_tpu, not even inside a function."""
    found = []
    for path in PORT_FILES + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                      for n in names if _is_reference(n)]
    assert len(PORT_FILES) > 40
    assert not found, found


def _fields(group):
    return {f.name: getattr(group, f.name) for f in dataclasses.fields(group)}


@pytest.mark.parametrize("group", ["odometry", "tracker", "slam"])
def test_port_parameters_equal_reference_defaults(group):
    assert (_fields(getattr(port_config.Parameters(), group))
            == _fields(getattr(Parameters(), group)))


def test_port_parameter_names_equal_reference():
    assert port_config.parameter_names() == parameter_names()


def test_preset_matches_reference_field_by_field():
    p, r = synthetic_bench_params("stereo"), ref_params("stereo")
    for group in ("odometry", "tracker", "slam"):
        assert _fields(getattr(p, group)) == _fields(getattr(r, group)), group


def test_derived_and_cameras_match_reference():
    p = synthetic_bench_params("stereo")
    d = port_config.DerivedParameters.from_parameters(p)
    dr = DerivedParameters.from_parameters(p)
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
