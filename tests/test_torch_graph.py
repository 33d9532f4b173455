"""The compiled step (``graphs.CapturedStep``, the port's counterpart of
``jax.jit``): what a CUDA graph of the step needs from it, checked on the
CPU, and the capture itself on the card.

A graph replays the kernels its capture recorded, so the step must issue
the same operations with the same host arguments whatever the values of its
inputs, read no value back to the host and make no tensor from host data
once its constants exist. The tests trace two steps (and the three
``-timer`` stages) from different states with a ``TorchDispatchMode`` and
compare them. Beside that: the bucketed IMU count gives the same state as
the exact one, the launch counts add a capture's launches once a replay,
the signature and layout helpers, and the public signatures against the
reference's. The card-only test (marked ``cuda``) holds the captured step
to the eager one bit for bit and checks that a replay leaves the outputs
of the step before it alone:

    python -m pytest --noconftest tests/test_torch_graph.py -m cuda -q

This file imports the reference package only inside the tests that
compare with it, so that it also runs on a card without it.
"""
import gc
import inspect
import sys
import threading
import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from hybvio_tpu_torch import graphs
from hybvio_tpu_torch.config import Parameters
from hybvio_tpu_torch.geometry.cameras import build_pinhole, with_intrinsics
from hybvio_tpu_torch.io.synthetic import (
    SYNTH_IMU_TO_CAMERA, generate_sequence, render_view, render_view_fisheye,
)
from hybvio_tpu_torch.models import _finalize
from hybvio_tpu_torch.odometry.backend import ImuBatch, bucket_n_valid
from hybvio_tpu_torch.ops import _lib
from hybvio_tpu_torch.parallel.batched import make_batched_vio

torch.set_num_threads(1)

B = 2
S = 10  # IMU columns a frame (200 Hz at 20 frames/s)
KINDS = ["stereo", "mono", "fisheye", "stereo_sequential_hybrid", "stereo_sqrt"]
KB4 = (0.0035, 0.0007, -0.002, 0.0002)
# the operations that read a value back to the host
HOST_READS = {"_local_scalar_dense", "nonzero", "is_nonzero", "equal", "item"}


def _params(kind):
    """(params, derived, cameras, W, H): a small set-up of the preset
    ``kind`` (frames of 160x120, 128x128 fisheye)."""
    config = kind.split("_")[0]
    p = Parameters()
    p.odometry.cameraTrailLength = 4
    p.tracker.maxTracks = 12
    p.odometry.maxVisualUpdates = 4
    p.tracker.pyrLKWindowSize = 9
    p.tracker.pyrLKMaxLevel = 1
    p.tracker.gfttMinDistance = 20.0
    p.odometry.imuToCameraMatrix = tuple(SYNTH_IMU_TO_CAMERA.T.flatten())
    sequential = kind == "stereo_sequential_hybrid"
    p.odometry.batchVisualUpdate = not sequential
    p.odometry.hybridMapSize = 4 if kind.endswith("_hybrid") else 0
    p.odometry.useSquareRootEkf = kind == "stereo_sqrt"
    if config == "fisheye":
        W = H = 128
        p.tracker.fisheyeCamera = True
        p.tracker.validCameraFov = 150.0
        p.tracker.focalLength = 48.0
        p.tracker.principalPointX = p.tracker.principalPointY = 64.0
        p.tracker.distortionCoeffs = KB4
        p.odometry.visualR = 0.4
    else:
        W, H = 160, 120
        p.tracker.focalLength = 130.0
        p.tracker.principalPointX, p.tracker.principalPointY = 80.0, 60.0
    if config == "stereo":
        second = SYNTH_IMU_TO_CAMERA.copy()
        second[0, 3] = -0.11
        p.tracker.useStereo = True
        p.odometry.secondImuToCameraMatrix = tuple(second.T.flatten())
    return (*_finalize(p, W, H), W, H)


def _path(kind, device="cpu", frames=5, n_valid=None):
    """(init state, batched step, vio, frames, IMU batches) of ``kind`` at B
    lanes: shared frames, or per-lane frames (lane b's the frame shifted by
    b pixels) for the sequential path; IMU batches of S columns, the first
    ``n_valid`` valid (all by default) and the rest garbage."""
    params, derived, cams, W, H = _params(kind)
    pt = params.tracker
    config = kind.split("_")[0]
    seq = generate_sequence(duration=(frames + 1) / 20.0, imu_rate=200.0, frame_rate=20.0,
                            n_landmarks=300, landmark_radius=5.0 if config == "fisheye" else 6.0,
                            gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    shared = kind != "stereo_sequential_hybrid"
    dtype = torch.float64 if torch.device(device).type == "cpu" else torch.float32
    init, step, vio = make_batched_vio(params, derived, cams, batch_size=B, max_tracks=12,
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
        if not shared:
            views = [np.stack([np.roll(v, b, axis=1) for b in range(B)]) for v in views]
        views = [torch.as_tensor(v).to(device) for v in views]
        return tuple(views) if pt.useStereo else views[0]

    rng = np.random.RandomState(5)
    imus, prev = [], seq.frame_sample_idx[0] + 1
    for fi in range(1, frames):
        k = seq.frame_sample_idx[fi] + 1
        n = min(k - prev, S) if n_valid is None else n_valid
        cols = lambda a: np.concatenate([a[prev:prev + n], 50.0 * rng.randn(S - n, *a.shape[1:])])
        lanes = lambda a: torch.as_tensor(np.stack([a + 1e-4 * b for b in range(B)]),
                                          dtype=dtype, device=device)
        imus.append(ImuBatch(lanes(cols(seq.times)), lanes(cols(seq.gyro)),
                             lanes(cols(seq.acc)),
                             torch.as_tensor(np.stack([np.arange(S) < n] * B), device=device)))
        prev = k
    state = init(frame(0), np.full(B, seq.frame_times[0]), np.arange(B))
    return state, step, vio, [frame(fi) for fi in range(frames)], imus


def _tensors(xs):
    """The tensors of nested lists and tuples."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)) or type(x).__name__ == "dict_values":
            yield from _tensors(x)


def _sig(x):
    """An operation argument as the trace compares it: a tensor by dtype and
    shape, anything else by value."""
    if isinstance(x, torch.Tensor):
        return ("T", x.dtype, tuple(x.shape))
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _sig(v)) for k, v in sorted(x.items()))
    return repr(x)


def _in_functorch():
    """Whether a ``torch.func`` transform runs (its batching and dual
    tensors reach the mode as new objects of the tensors it wraps)."""
    f = sys._getframe(1)
    while f is not None:
        if "_functorch" in f.f_code.co_filename:
            return True
        f = f.f_back
    return False


def _port_line():
    """The innermost line of the port on the stack."""
    frames = [f for f in traceback.extract_stack() if "hybvio_tpu_torch" in f.filename]
    return (f"{frames[-1].filename.rsplit('hybvio_tpu_torch', 1)[-1]}:{frames[-1].lineno}"
            if frames else "outside the port")


class _OpTrace(TorchDispatchMode):
    """The aten operations of a block with their host arguments; the ones
    that read a value back to the host; and the tensor arguments that were
    neither alive before the block nor made by an operation in it: made
    from host data (a wrapped Python number, 0-d, is compared by value;
    inside a ``torch.func`` transform only the host reads are checked)."""

    def __init__(self):
        super().__init__()
        self.ops, self.host_reads, self.from_host, self._made = [], [], [], []
        self._known = {id(o) for o in gc.get_objects() if isinstance(o, torch.Tensor)}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket.__name__ in HOST_READS:
            self.host_reads.append(str(func))
        scalars = []
        for t in _tensors((args, kwargs.values())):
            if id(t) not in self._known:
                if t.dim() == 0:  # a Python number wrapped: compared by value
                    scalars.append(t.item())
                elif not _in_functorch():
                    self.from_host.append(f"{func} {tuple(t.shape)} at {_port_line()}")
        out = func(*args, **kwargs)
        for t in _tensors((out,)):
            self._made.append(t)  # alive until the trace ends: ids stay unique
            self._known.add(id(t))
        self.ops.append((func, _sig(args), _sig(kwargs), tuple(scalars)))
        return out


def _trace(fn):
    trace = _OpTrace()
    with trace:
        result = fn()
    return trace, result


def _check_same_ops(a, b, what):
    assert not a.host_reads and not b.host_reads, (what, a.host_reads + b.host_reads)
    assert not a.from_host and not b.from_host, (what, sorted(set(a.from_host + b.from_host)))
    assert len(a.ops) == len(b.ops), (what, len(a.ops), len(b.ops))
    for i, (x, y) in enumerate(zip(a.ops, b.ops)):
        assert x == y, (what, i, x, y)


@pytest.mark.parametrize("kind", KINDS)
def test_step_issues_a_value_independent_op_sequence(kind):
    """After a first step, two steps from different states and inputs with
    one signature issue the same aten operations with the same host
    arguments, read nothing back to the host and make no tensor from host
    data; so do the three ``-timer`` stages (imu_only with a valid count,
    track_stage, backend_stage; not traced again on the sequential path)."""
    state, step, vio, frames, imus = _path(kind, frames=6)
    state, _ = step(state, imus[0], frames[1])  # constants go to the device once

    traces = []
    for fi in (2, 3):
        trace, (state, _) = _trace(lambda: step(state, imus[fi - 1], frames[fi]))
        traces.append(trace)
    _check_same_ops(*traces, f"{kind} step")

    if kind == "stereo_sequential_hybrid":
        return  # its stages run the code of the others' (its step alone traces 100k operations)
    stage_traces = []
    for fi in (4, 5):
        imu = imus[fi - 1]
        left, right = frames[fi] if vio.pt.useStereo else (frames[fi], None)

        def stages():
            st = vio.imu_only(state, imu, bucket_n_valid(S, S))
            st, tin = vio.track_stage(st, imu.t[:, -1], left, right)
            return vio.backend_stage(st, tin)

        trace, (state, _) = _trace(stages)
        stage_traces.append(trace)
    _check_same_ops(*stage_traces, f"{kind} stages")


@pytest.mark.parametrize("kind", KINDS + ["stereo_batched_hybrid"])
def test_stepped_state_keeps_the_init_states_signature(kind):
    """The state a step returns has the init state's signature, layouts
    included, so the first step's capture serves every later step (the
    batched update with the map once returned its map-point ids as a
    strided view: a second capture, whose synchronization fell in a counted
    step)."""
    state, step, _, frames, imus = _path(kind, frames=3)
    s1, _ = step(state, imus[0], frames[1])
    s2, _ = step(s1, imus[1], frames[2])
    assert graphs._flatten(s1, []) == graphs._flatten(state, []) == graphs._flatten(s2, [])


def test_bucketed_imu_count_gives_the_same_state():
    """A step over the bucketed valid count (the next power of two) equals,
    bit for bit, the step over the exact count: the columns between are
    invalid and leave each lane's state as it was, whatever they hold."""
    n = 5
    assert bucket_n_valid(n, S) == 8
    state, _, vio, frames, imus = _path("stereo", frames=4, n_valid=n)
    a = b = state
    for fi in range(1, 4):
        a, out_a = vio.step(a, imus[fi - 1], *frames[fi], n_valid=n)
        b, out_b = vio.step(b, imus[fi - 1], *frames[fi], n_valid=bucket_n_valid(n, S))
    for x, y in zip(tree_flatten((a, out_a))[0], tree_flatten((b, out_b))[0]):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y) or (x.is_floating_point() and torch.equal(
            torch.nan_to_num(x, nan=7.0), torch.nan_to_num(y, nan=7.0)))
    assert [bucket_n_valid(k, 64) for k in (0, 1, 3, 10, 16, 17, 40, 64, 80)] == \
        [0, 1, 4, 16, 16, 32, 64, 64, 64]


@pytest.fixture
def no_kernel_library(monkeypatch):
    """``_lib.launch`` without the library: the call is a no-op, the
    accounting runs, and the counts start from 0 and are left as found."""
    saved = dict(_lib.LAUNCHES), dict(_lib.SHAPE_LAUNCHES)
    monkeypatch.setattr(_lib, "_call", lambda *a: None)
    _lib.reset_launch_counts()
    yield
    _lib.LAUNCHES.update(saved[0])
    _lib.SHAPE_LAUNCHES.clear()
    _lib.SHAPE_LAUNCHES.update(saved[1])


def test_capture_launches_are_counted_once_a_replay(no_kernel_library):
    """Launches made while capturing are recorded, not counted; each replay
    adds the record once; launches outside a capture count at once."""
    _lib.launch("greedy_nms", "hv_greedy_nms", shape=(2, 192, "shared"))
    with _lib.recording_launches() as record:
        for _ in range(3):
            _lib.launch("patch_gather", "hv_patch_gather", shape=(3, 2, 12, 18, 120, 160))
        _lib.launch("corner_response", "hv_corner_response", shape=(1, 120, 160, 3))
    assert _lib.LAUNCHES["patch_gather"] == 0 and _lib.LAUNCHES["greedy_nms"] == 1
    assert record == {("patch_gather", (3, 2, 12, 18, 120, 160)): 3,
                      ("corner_response", (1, 120, 160, 3)): 1}
    for _ in range(4):  # four replays
        _lib.add_launches(record)
    assert _lib.LAUNCHES["patch_gather"] == 12 and _lib.LAUNCHES["corner_response"] == 4
    assert _lib.SHAPE_LAUNCHES[("patch_gather", (3, 2, 12, 18, 120, 160))] == 12
    assert _lib.SHAPE_LAUNCHES[("greedy_nms", (2, 192, "shared"))] == 1


def test_capture_records_only_its_own_thread(no_kernel_library):
    """A capture in one thread records that thread's launches; another
    thread's (the SLAM worker's) count as they happen."""
    started, done = threading.Event(), threading.Event()

    def other():
        started.wait(timeout=10)
        _lib.launch("corner_response", "hv_corner_response", shape=(1, 64, 64, 3))
        done.set()

    worker = threading.Thread(target=other)
    worker.start()
    with _lib.recording_launches() as record:
        _lib.launch("greedy_nms", "hv_greedy_nms", shape=(1, 128, "shared"))
        started.set()
        assert done.wait(timeout=10)
    worker.join(timeout=10)
    assert not worker.is_alive()
    assert record == {("greedy_nms", (1, 128, "shared")): 1}
    assert _lib.LAUNCHES["corner_response"] == 1 and _lib.LAUNCHES["greedy_nms"] == 0


def test_signature_round_trip():
    """The signature keys what the graph must repeat (layouts, None, host
    ints, a per-frame camera's floats) and rebuilds the argument tree."""
    cam = build_pinhole(100.0, 100.0, 80.0, 60.0, width=160, height=120)
    cam0 = with_intrinsics(cam, torch.tensor(110.0, dtype=torch.float64),
                           torch.tensor(111.0, dtype=torch.float64), device="cpu")
    imu = ImuBatch(torch.zeros(2, 10), torch.zeros(2, 10, 3), torch.zeros(2, 10, 3),
                   torch.ones(2, 10, dtype=torch.bool))
    img = torch.zeros(2, 2, 120, 160)[:, 0]
    tree = ((imu, img, None), {"n_valid": 8, "camera0": cam0})
    leaves = []
    spec = graphs._flatten(tree, leaves)
    assert len(leaves) == 4 + 1 + 4  # the batch, the image, the camera's fx, fy, cx, cy
    rebuilt = graphs._unflatten(spec, iter(leaves))
    assert isinstance(rebuilt[0][0], ImuBatch) and rebuilt[0][2] is None
    assert rebuilt[1]["n_valid"] == 8 and type(rebuilt[1]["camera0"]) is type(cam0)
    assert rebuilt[1]["camera0"].fx is cam0.fx and rebuilt[1]["camera0"].width == 160
    again = []
    assert graphs._flatten(tree, again) == spec and hash(spec) == hash(graphs._flatten(tree, []))
    others = [((imu, img, None), {"n_valid": 16, "camera0": cam0}),
              ((imu, img.contiguous(), None), {"n_valid": 8, "camera0": cam0}),
              ((imu, img, img), {"n_valid": 8, "camera0": cam0}),
              ((imu, img, None), {"n_valid": 8, "camera0": None}),
              ((imu, img, None), {"n_valid": 8.0, "camera0": cam0})]
    assert all(graphs._flatten(o, []) != spec for o in others)
    assert "n_valid=8" in graphs.describe(spec) and "float32[2, 120, 160]" in graphs.describe(spec)
    with pytest.raises(TypeError):
        graphs._flatten((np.zeros(3),), [])


@pytest.mark.parametrize("make", [
    lambda: torch.arange(24.0).reshape(2, 3, 4),
    lambda: torch.arange(48.0).reshape(2, 2, 3, 4)[:, 1],  # a camera of a (B, C, H, W) frame
    lambda: torch.arange(12.0).reshape(3, 4).expand(5, 3, 4),  # a frame shared by 5 lanes
    lambda: torch.arange(20.0, dtype=torch.float64)[3:9:2],  # offset 3, stride 2
    lambda: torch.arange(60).reshape(3, 4, 5).transpose(0, 2),
    lambda: torch.tensor(2.5, dtype=torch.float64),
    lambda: torch.zeros(0, 3),
])
def test_static_buffers_repeat_the_layout(make):
    """A static buffer has its input's shape, strides, broadcast
    dimensions and storage offset modulo 16 bytes; the compact copy carries
    every value."""
    x = make()
    y = graphs._empty_like(x)
    assert y.shape == x.shape and y.stride() == x.stride() and y.dtype == x.dtype
    align = 16 // x.element_size()
    assert y.storage_offset() % align == x.storage_offset() % align
    graphs._copy([graphs._compact(y)], [graphs._compact(x)])
    assert torch.equal(y, x)
    with pytest.raises(ValueError):
        graphs._empty_like(torch.arange(10.0).as_strided((4, 3), (2, 1)))


def test_captured_step_on_the_cpu_is_the_eager_step():
    """On the CPU a CapturedStep calls the eager function and captures
    nothing; make_batched_vio's step there is its eager step."""
    calls = []
    fn = lambda x, n=1: calls.append(n) or (x * n,)
    step = graphs.CapturedStep(fn, "double")
    out = step(torch.ones(3), n=2)
    assert calls == [2] and torch.equal(out[0], torch.full((3,), 2.0))
    assert step.captures == step.replays == step.keys == 0 and step.eager is fn
    state, bstep, _, frames, imus = _path("mono", frames=2)
    a = bstep(state, imus[0], frames[1])
    b = bstep.eager(state, imus[0], frames[1])
    assert all(torch.equal(x, y) for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]))
    assert bstep.graphs[0].captures == 0


def _reference(name):
    """The reference's counterpart of the port's public function ``name``."""
    if name == "VioApi":
        from hybvio_tpu.api.vio import VioApi
        return VioApi.__init__
    if name in ("make_batched_vio", "make_batched_scan"):
        from hybvio_tpu.parallel import batched
        return getattr(batched, name)
    from hybvio_tpu.eval import ate
    return getattr(ate, name)


def _port(name):
    if name == "VioApi":
        from hybvio_tpu_torch.api.vio import VioApi
        return VioApi.__init__
    if name in ("make_batched_vio", "make_batched_scan"):
        from hybvio_tpu_torch.parallel import batched
        return getattr(batched, name)
    from hybvio_tpu_torch.eval import ate
    return getattr(ate, name)


@pytest.mark.parametrize("name", ["VioApi", "make_batched_vio", "make_batched_scan",
                                  "ate_rmse", "umeyama_alignment"])
def test_port_accepts_every_reference_parameter(name):
    """Each public function takes every parameter of the reference's, by the
    same name and kind, with the same default (the port may add
    ``device``)."""
    ref = inspect.signature(_reference(name)).parameters
    port = inspect.signature(_port(name)).parameters
    assert set(port) - set(ref) <= {"device"}, set(port) - set(ref)
    for p in ref.values():
        assert p.name in port, f"{name} lacks {p.name}"
        q = port[p.name]
        assert q.kind == p.kind or (p.kind, q.kind) == (
            inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.KEYWORD_ONLY), p.name
        if p.default is not inspect.Parameter.empty and p.name != "dtype":
            assert q.default == p.default, (name, p.name, q.default, p.default)


def _leaves_equal(a, b):
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            same = (x == y) | (torch.isnan(x) & torch.isnan(y)) if x.is_floating_point() \
                else x == y
            assert bool(same.all()), "captured and eager differ"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_captured_step_equals_the_eager_step_on_the_card(kind):
    """On the card: the captured step (the first call captures, the rest
    replay) equals the eager step bit for bit over 4 steps; a replay makes
    no host sync, counts the path's kernels and leaves the state and
    output the step before it returned unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; chip_smoke.py phase 13 runs it at full size")
    state, step, _, frames, imus = _path(kind, "cuda")
    eager = captured = state
    kept = []
    for fi in range(1, 5):
        eager, out_e = step.eager(eager, imus[fi - 1], frames[fi])
        if fi >= 3:
            _lib.reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            captured, out_c = step(captured, imus[fi - 1], frames[fi])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if fi >= 3:
            assert all(_lib.LAUNCHES[k] for k in ("pyramid_scharr", "patch_gather",
                                                  "corner_response", "greedy_nms"))
        _leaves_equal((eager, out_e), (captured, out_c))
        kept.append(((captured, out_c), [t.clone() for t in tree_flatten((captured, out_c))[0]]))
    for tree, copies in kept:  # no later replay wrote into what a step returned
        for t, c in zip(tree_flatten(tree)[0], copies):
            assert torch.equal(torch.nan_to_num(t, nan=7.0), torch.nan_to_num(c, nan=7.0)) \
                if t.is_floating_point() else torch.equal(t, c)
    assert step.graphs[0].captures >= 1 and step.graphs[0].replays >= 2
