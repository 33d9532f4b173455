"""The batched step's device policy: no host sync (so the step can be
captured in a CUDA graph and the host stays ahead of the card), and full
float32 products ("highest", TF32 off) whatever the caller set.

A sync shows only on the card (``torch.cuda.set_sync_debug_mode``); on the
CPU the tests look for the calls that make one there: a tensor built from
host data, a Python scalar written into one element, a value read back to
the host, a boolean-mask index, a checked factorization."""
import collections
import traceback

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from hybvio_tpu_torch.config import Parameters
from hybvio_tpu_torch.io.synthetic import (
    SYNTH_IMU_TO_CAMERA, generate_sequence, render_view, render_view_fisheye,
)
from hybvio_tpu_torch.models import _finalize
from hybvio_tpu_torch.odometry.backend import ImuBatch
from hybvio_tpu_torch.parallel.batched import make_batched_vio

torch.set_num_threads(1)

B = 2
PATHS = ["stereo", "mono", "fisheye", "stereo_per_lane", "stereo_sequential_hybrid",
         "stereo_sqrt"]
KB4 = (0.0035, 0.0007, -0.002, 0.0002)


def _tiny(config, sequential_hybrid=False, sqrt=False):
    """(params, derived, cameras, W, H) of torch_parity's tiny set-ups,
    built from the port alone (this file also runs on a card, where the
    reference package is not installed: pytest --noconftest); with
    ``sequential_hybrid`` the reference's default sequential visual update
    and a hybrid map of 4 points; with ``sqrt`` the square-root filter."""
    p = Parameters()
    p.odometry.cameraTrailLength = 4
    p.tracker.maxTracks = 12
    p.odometry.maxVisualUpdates = 4
    p.tracker.pyrLKWindowSize = 9
    p.tracker.pyrLKMaxLevel = 1
    p.tracker.gfttMinDistance = 20.0
    p.odometry.imuToCameraMatrix = tuple(SYNTH_IMU_TO_CAMERA.T.flatten())
    p.odometry.batchVisualUpdate = not sequential_hybrid
    p.odometry.hybridMapSize = 4 if sequential_hybrid else 0
    p.odometry.useSquareRootEkf = sqrt
    if config == "fisheye":
        W = H = 96
        p.tracker.fisheyeCamera = True
        p.tracker.validCameraFov = 150.0
        p.tracker.focalLength = 36.0
        p.tracker.principalPointX = p.tracker.principalPointY = 48.0
        p.tracker.distortionCoeffs = KB4
        p.odometry.visualR = 0.4
    else:
        W, H = 96, 64
        p.tracker.focalLength = 80.0
        p.tracker.principalPointX, p.tracker.principalPointY = 48.0, 32.0
    if config == "stereo":
        second = SYNTH_IMU_TO_CAMERA.copy()
        second[0, 3] = -0.11
        p.tracker.useStereo = True
        p.odometry.secondImuToCameraMatrix = tuple(second.T.flatten())
    return (*_finalize(p, W, H), W, H)


def _path(kind, device):
    """(state, step, frames (4), IMU batches (3)) of a tiny path on
    ``device``: B lanes sharing each frame, or with ``_per_lane`` (and in
    ``stereo_sequential_hybrid``, the sequential update with the hybrid
    map; in ``stereo_sqrt``, the square-root filter) B copies of it, one per
    lane."""
    config = kind.split("_")[0]
    params, derived, cams, W, H = _tiny(config, kind == "stereo_sequential_hybrid",
                                        kind == "stereo_sqrt")
    pt = params.tracker
    seq = generate_sequence(duration=5 / 20.0, imu_rate=200.0, frame_rate=20.0, n_landmarks=300,
                            landmark_radius=5.0 if config == "fisheye" else 6.0,
                            gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    shared = kind == config
    dtype = torch.float64 if torch.device(device).type == "cpu" else torch.float32
    init, step, _ = make_batched_vio(params, derived, cams, batch_size=B, max_tracks=12,
                                     dtype=dtype, shared_frames=shared, device=device)

    def frame(fi):
        k = seq.frame_sample_idx[fi]
        f, cx, cy = pt.focalLength, pt.principalPointX, pt.principalPointY
        if config == "fisheye":
            views = [render_view_fisheye(seq.landmarks, seq.pos[k], seq.quat[k],
                                         SYNTH_IMU_TO_CAMERA, f, f, cx, cy, W, H, KB4,
                                         max_fov_deg=pt.validCameraFov, blob_sigma=1.4)]
        else:
            exts = [SYNTH_IMU_TO_CAMERA] + ([np.asarray(derived.second_imu_to_camera)]
                                           if pt.useStereo else [])
            views = [render_view(seq.landmarks, seq.pos[k], seq.quat[k], e, f, f, cx, cy, W, H,
                                 blob_sigma=1.4) for e in exts]
        views = [torch.as_tensor(v).to(device) for v in views]
        views = [v if shared else v.expand(B, H, W).contiguous() for v in views]
        return tuple(views) if pt.useStereo else views[0]

    imus, prev, S = [], seq.frame_sample_idx[0] + 1, 10
    for fi in range(1, 4):
        k = seq.frame_sample_idx[fi] + 1
        n = k - prev
        pad = lambda a: np.pad(a, ((0, S - n), (0, 0)))
        t = np.pad(seq.times[prev:k], (0, S - n), constant_values=seq.times[k - 1])
        as_t = lambda a: torch.as_tensor(np.stack([a] * B), dtype=dtype, device=device)
        imus.append(ImuBatch(as_t(t), as_t(pad(seq.gyro[prev:k])), as_t(pad(seq.acc[prev:k])),
                             torch.as_tensor(np.stack([np.arange(S) < n] * B), device=device)))
        prev = k
    state = init(frame(0), np.full(B, seq.frame_times[0]), np.arange(B))
    return state, step, [frame(fi) for fi in range(4)], imus


# what makes a host sync on the card
_SYNCING = {torch.tensor, torch.as_tensor, torch.linalg.svd, torch.linalg.inv,
            torch.linalg.cholesky, torch.linalg.solve, torch.linalg.lu_factor, torch.linalg.eigh,
            torch.linalg.eigvalsh, torch.linalg.eig, torch.linalg.det, torch.nonzero,
            torch.masked_select, torch.unique, torch.repeat_interleave, torch.Tensor.item,
            torch.Tensor.tolist, torch.Tensor.__bool__, torch.Tensor.__int__,
            torch.Tensor.__float__, torch.Tensor.__index__, torch.Tensor.nonzero,
            torch.Tensor.cpu, torch.Tensor.numpy}


class _SyncLint(TorchFunctionMode):
    """Counts, by the port's source line, the calls that sync on the card."""

    def __init__(self):
        super().__init__()
        self.hits = collections.Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        bad = func in _SYNCING
        if func in (torch.tensor, torch.as_tensor) and isinstance(args[0], torch.Tensor):
            bad = False  # a tensor already on the device
        if func is torch.Tensor.__setitem__:
            idx = args[1] if isinstance(args[1], tuple) else (args[1],)
            # a scalar into one element is a copy from the host; into a slice, a fill
            bad = (isinstance(args[2], (int, float, bool)) and all(isinstance(i, int) for i in idx)
                   or any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in idx))
        if func is torch.Tensor.__getitem__:
            idx = args[1] if isinstance(args[1], tuple) else (args[1],)
            bad = any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in idx)
        if bad:
            frames = [f for f in traceback.extract_stack()[:-1] if "hybvio_tpu_torch" in f.filename]
            where = (f"{frames[-1].filename.rsplit('hybvio_tpu_torch', 1)[-1]}:{frames[-1].lineno}"
                     if frames else "outside the port")
            self.hits[f"{getattr(func, '__name__', func)} at {where}"] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", PATHS)
def test_step_calls_nothing_that_syncs_on_the_card(kind):
    """One step after the first (constants are copied to a device once, at
    their first use) makes none of the calls that sync on the card."""
    state, step, frames, imus = _path(kind, "cpu")
    state, _ = step(state, imus[0], frames[1])
    lint = _SyncLint()
    with lint:
        step(state, imus[1], frames[2])
    assert not lint.hits, dict(lint.hits)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", PATHS)
def test_step_makes_no_host_sync_on_the_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; chip_smoke.py counts the syncs on the card")
    state, step, frames, imus = _path(kind, "cuda")
    state, _ = step(state, imus[0], frames[1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, out = step(state, imus[1], frames[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out.position).all()


class _Products(TorchFunctionMode):
    """Records the precision flags in force at every matrix product."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.matmul, torch.Tensor.__matmul__, torch.bmm, torch.einsum):
            self.seen.add((torch.get_float32_matmul_precision(),
                           torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["stereo", "mono"])
def test_step_runs_its_products_at_full_precision(kind):
    """A caller's "high" (TF32) setting does not reach the step's products,
    and is the caller's again after the step."""
    state, step, frames, imus = _path(kind, "cpu")
    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        rec = _Products()
        with rec:
            step(state, imus[0], frames[1])
        assert rec.seen == {("highest", False, False)}
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
