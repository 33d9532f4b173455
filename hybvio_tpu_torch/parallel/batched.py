"""Batched multi-sequence VIO, on one device or over a device mesh (port of
the reference's ``parallel/batched.py``).

Every state tensor has a leading lane axis of size B, and the IMU batch is
per lane, so lane states diverge normally. With ``shared_frames=False``
(the default, as in the reference) every lane has its own frames: B
distinct sequences on one card (BASELINE config 5), each frame a (B, H, W)
tensor with lane b's image at index b. With ``shared_frames=True`` one
unbatched (H, W) frame per step is shared by all lanes: its pyramid is
computed once and read by every lane through stride-0 views.

The mesh (``Mesh``, ``make_mesh``) is data parallelism over independent
sequences, as the reference's ``jax.sharding.Mesh``: one process drives
every device. The B lanes split into ``mesh.size`` contiguous shards, each
stepped by its own replica of the step on its device, with no
communication between shards. A mesh may list one device more than once
(several shards on one device). ``make_batched_scan`` folds a staged
sequence of frames through the step (the reference's ``lax.scan`` mode) as
a Python loop over the frames.

On the card the step is compiled, as the reference jits it: a CUDA graph of
``Vio.step`` captured once for each input signature and replayed
(``graphs.CapturedStep``), each shard's replica with a graph of its own;
``batched_step.eager`` is the step without the graph (the reference's
``batched_step.vstep``).
"""
from __future__ import annotations

import copy
import dataclasses

import torch

from .. import random as jr
from ..graphs import CapturedStep
from ..odometry.backend import ImuBatch
from ..odometry.vio import Vio
from ..runtime import default_device, device_scope, filter_dtype


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a one-axis mesh: an axis of length n splits into
    ``size`` contiguous shards of n / size, shard s on ``devices[s]``."""
    devices: tuple
    axis: str = "data"

    def __post_init__(self):
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if any(d.type == "cuda" and d.index is None for d in self.devices):
            raise ValueError("a mesh names each card by its index (cuda:N), not the current one")

    @property
    def size(self) -> int:
        return len(self.devices)

    def shards(self, n: int, what: str) -> list:
        """The slices of an axis of ``n`` by shard; raises unless the mesh
        divides ``n`` (the reference's sharding requires it too)."""
        if n % self.size:
            raise ValueError(f"{what} of {n} does not split evenly over a mesh of {self.size}")
        m = n // self.size
        return [slice(s * m, (s + 1) * m) for s in range(self.size)]


def make_mesh(n_devices=None, device="cuda") -> Mesh:
    """The first ``n_devices`` cards (all of them by default). Raises
    without a card, or with fewer cards than asked: no card is repeated and
    nothing falls to the CPU. ``device="cpu"`` gives ``n_devices`` (default
    1) shards on the CPU."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh of {n_devices} devices")
    if torch.device(device).type == "cpu":
        return Mesh((torch.device("cpu"),) * (n_devices or 1))
    default_device()  # raises without a card
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n > count:
        raise RuntimeError(f"a mesh of {n} cards asked for, {count} present")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def gather_lanes(parts, device):
    """Per-shard trees (NamedTuples and tuples of lane-first tensors) as one
    lane-ordered tree on ``device``: each tensor concatenated along its
    lane axis."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device, non_blocking=True) for p in parts])
    fields = [gather_lanes(list(xs), device) for xs in zip(*parts)]
    return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)


def make_batched_vio(params, derived, cameras, batch_size: int, max_tracks=None,
                     dtype=None, shared_frames: bool = False, device="cuda", mesh=None):
    """(batched_init, batched_step, vio), on the card unless ``device`` is
    "cpu"; ``dtype`` (the filter's) defaults to ``runtime.filter_dtype``.

    batched_init(frame, t0s (B,), seeds (B,)) -> state
    batched_step(state, imu, frame) -> (state, FrameOutput)

    On the card ``batched_step`` replays a CUDA graph of the step, captured
    at the first call with each input signature (that call runs the step
    eagerly, then captures it: a host sync); the state and output it
    returns are the caller's, unchanged by later steps.
    ``batched_step.eager`` is the same step without the graph, and
    ``batched_step.graphs`` the ``CapturedStep`` of each replica (their
    capture counts). On the CPU both are the eager step.

    A frame is a (left, right) pair of images in stereo and one image in
    mono; an image is (B, H, W), one per lane, or with ``shared_frames``
    one (H, W) image for every lane. Integer (e.g. uint8) images are
    normalized to [0, 1] on the device.

    With a ``mesh`` (``device`` is then the mesh's) the B lanes split into
    ``mesh.size`` contiguous shards; B must divide evenly. Each shard has a
    replica of the step on its device (``vio`` is the tuple of replicas)
    and its part of the state there: the state is a tuple of per-shard
    ``VioState``s (``gather_lanes`` joins them). A step takes the whole
    batch's IMU and frames, wherever they lie, copies each shard's lanes
    (a shared frame whole) to its device and steps the shards in order,
    each with its device current, with no host sync. The FrameOutput is
    lane-ordered: the shards' outputs concatenated on ``mesh.devices[0]``.
    """
    if mesh is not None:
        device = mesh.devices[0]
        lanes = mesh.shards(batch_size, "a batch")
    device = torch.device(device)
    if device.type == "cuda":
        default_device()  # raises without a card
    if dtype is None:
        dtype = filter_dtype(device)
    vio = Vio(params, derived, cameras, max_tracks=max_tracks, dtype=dtype)
    stereo = vio.pt.useStereo
    want = (2,) if shared_frames else (3,)

    def frame(images):
        images = tuple(images) if stereo else (images,)
        for img in images:
            if img.dim() not in want or (not shared_frames and img.shape[0] != batch_size):
                raise ValueError(
                    f"expected {'(H, W)' if shared_frames else f'({batch_size}, H, W)'} images "
                    f"(shared_frames={shared_frames}), got {tuple(img.shape)}")
        return images if stereo else (images[0], None)

    def init_lanes(vio, left, right, t0s, seeds, n):
        keys = jr.prng_key(torch.as_tensor(seeds, dtype=torch.int64, device=left.device))
        t0 = torch.as_tensor(t0s, dtype=dtype, device=left.device)
        if t0.shape[0] != n:
            raise ValueError(f"{t0.shape[0]} start times for batch {n}")
        return vio.init_state(left, t0, keys, right)

    if mesh is None:
        vio = vio.to(device)
        captured = CapturedStep(vio.step, "batched step")

        def batched_init(first_images, t0s, seeds):
            return init_lanes(vio, *frame(first_images), t0s, seeds, batch_size)

        def batched_step(states, imu, frames):
            return captured(states, imu, *frame(frames))

        def eager(states, imu, frames):
            return vio.step(states, imu, *frame(frames))

        batched_step.eager, batched_step.graphs = eager, (captured,)
        return batched_init, batched_step, vio

    # one replica a shard, built on the host once and copied to its device
    vios = tuple(copy.deepcopy(vio).to(d) for d in mesh.devices)

    def take(img, s):
        """Shard s's lanes of an image (the whole of a shared one) on its
        device."""
        if img is None:
            return None
        return (img if shared_frames else img[lanes[s]]).to(mesh.devices[s], non_blocking=True)

    def batched_init(first_images, t0s, seeds):
        left, right = frame(first_images)
        t0s, seeds = torch.as_tensor(t0s), torch.as_tensor(seeds)
        if t0s.shape[0] != batch_size:
            raise ValueError(f"{t0s.shape[0]} start times for batch {batch_size}")
        states = []
        for s, d in enumerate(mesh.devices):
            with device_scope(d):
                states.append(init_lanes(vios[s], take(left, s), take(right, s),
                                         t0s[lanes[s]], seeds[lanes[s]], batch_size // mesh.size))
        return tuple(states)

    captured = tuple(CapturedStep(v.step, f"batched step, shard {s}") for s, v in enumerate(vios))

    def stepper(steps):
        def batched_step(states, imu, frames):
            left, right = frame(frames)
            new, outs = [], []
            for s, d in enumerate(mesh.devices):
                with device_scope(d):
                    shard_imu = ImuBatch(*(x[lanes[s]].to(d, non_blocking=True) for x in imu))
                    st, out = steps[s](states[s], shard_imu, take(left, s), take(right, s))
                new.append(st)
                outs.append(out)
            return tuple(new), gather_lanes(outs, device)
        return batched_step

    batched_step = stepper(captured)
    batched_step.eager, batched_step.graphs = stepper(tuple(v.step for v in vios)), captured
    return batched_init, batched_step, vios


def make_batched_scan(params, derived, cameras, batch_size: int, max_tracks=None,
                      dtype=None, shared_frames: bool = True, device="cuda"):
    """(batched_init, scan_run): the reference's offline mode, a whole
    staged frame sequence folded through the step of ``make_batched_vio``
    (the same arguments; shared frames by default, as the reference's).

    scan_run(states, imu_stack, frames_stack) -> (states, positions):
      imu_stack     ImuBatch with a leading frame axis: t (F, B, S), ...
      frames_stack  per camera (F, H, W) with shared frames, else (F, B, H, W)
                    (stereo: a (left, right) pair of them)
      positions     (F, B, 3), in a tensor allocated on the IMU's device
                    before the loop

    The fold is a Python loop over the frames of the step of
    ``make_batched_vio``: on the card it replays that step's CUDA graph once
    a frame (captured at the first frame, a host sync), the card's
    counterpart of the reference's one program; the replays make no host
    sync. The same step, so the same trajectories as the eager steps.
    ``scan_run.step`` is that batched step.
    """
    batched_init, batched_step, vio = make_batched_vio(
        params, derived, cameras, batch_size, max_tracks=max_tracks, dtype=dtype,
        shared_frames=shared_frames, device=device)

    def scan_run(states, imu_stack, frames_stack):
        F = imu_stack.t.shape[0]
        positions = torch.empty((F, batch_size, 3), dtype=vio.dtype, device=imu_stack.t.device)
        for f in range(F):
            frames = (tuple(x[f] for x in frames_stack) if vio.pt.useStereo
                      else frames_stack[f])
            states, out = batched_step(states, ImuBatch(*(x[f] for x in imu_stack)), frames)
            positions[f] = out.position
        return states, positions

    scan_run.step = batched_step
    return batched_init, scan_run
