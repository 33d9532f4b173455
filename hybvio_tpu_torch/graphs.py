"""The compiled programs: a function captured in a CUDA graph once for each
input signature and replayed, the card's counterpart of ``jax.jit``, which
the JAX package applies to its batched step and scan, to VioApi's step and
its three ``-timer`` stages, to the probes' steps and to every
keyframe-rate program of its SLAM side (local and sharded BA, the pose
graph, the loop-closure RANSACs, ORB descriptors, matching, the keypoint
detector, the vocabulary's k-means and the coupling's helpers; ``jax.jit``
lives in JAX itself: the JAX package has no file for it).

``CapturedStep(fn)`` is called as ``fn`` is. On the card, the first call
with a signature

1. runs ``fn`` eagerly on its pools' capture stream for the device (the
   warm-up). That fills the first-use caches (``runtime.constant``, the
   five-point solver's constants, the kernel library, the cuBLAS and
   cuSOLVER workspaces). Its result is the call's result: no input is
   stepped twice;
2. captures ``fn`` on static copies of the inputs into a graph of its
   pools' memory pool for the device, with
   ``capture_error_mode="thread_local"``, so that another thread's work on
   its own stream does not break the capture, and with Python's cyclic
   collector paused (``collector_paused``, counted across threads): CUDA
   refuses to destroy a graph (a dead program's, freed by the collector)
   in a capturing thread. A capture synchronizes its stream; ``captures``
   and ``capture_s`` count them. The kernels launched while capturing are
   recorded, not counted, and every replay adds them to the ``ops`` launch
   counts.

Programs whose pools say so (``GraphPools(eager_calls=1)``: the SLAM
session's, whose signatures are often called once, such as the pose graph
of a map size or the end of a session) capture at the second call of a
signature instead: the first runs the warm-up alone and returns its
result, the second captures and replays, so a signature called once costs
its eager call only.

A later call with the signature copies its inputs into the static buffers,
replays the graph on the current stream (the same kernels in the same
order as the eager run, so the same bits) and returns copies of the
outputs that the caller owns: no later replay writes into them. A replay
makes no host sync. A capture or a replay that fails raises, naming the
signature; nothing falls back to the eager function, which stays reachable
as ``.eager``. On the CPU a call is the eager call.

Pools (``GraphPools``): graphs that share a memory pool share their
scratch memory, so they must never replay at once. A pool orders them
itself: a replay (its copies in and out included) waits on the card for
the pool's previous replay, whatever stream either ran on, and the
pool's captures run one at a time (they share its capture stream). So two
``VioApi``s stepped from two threads on two streams, whose step graphs
all share ``STEP_POOLS``, replay one after the other on the card and give
the bits each gives alone. The SLAM session's programs replay on its
worker's stream beside the steps, so each session captures into pools of
its own (``Slam.graph_pools``), with capture streams of their own, and the
two overlap. A program takes the pools of the ``capturing_into`` block it
is made in, else ``STEP_POOLS``.

The signature is the tree of the arguments (tuples, lists, NamedTuples,
dicts, dataclasses such as a per-frame ``Camera``), each tensor's shape,
dtype, strides, broadcast dimensions, storage offset modulo 16 bytes and
device (a static buffer repeats the layout, so that the captured kernels
read what the eager ones read), and the value of every other leaf: a host
int such as ``n_valid``, a camera's floats, ``None`` for an absent second
image or camera.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import time
import weakref
from typing import NamedTuple

import torch

from .ops import _lib
from .utils import timer

MAX_KEYS = 32  # signatures one program may capture before a new one raises
_ALIGN_BYTES = 16  # the widest vector load of a kernel

_GC_LOCK = threading.Lock()
_gc_pause = [0, False]  # blocks under way, whether the collector ran before the first


@contextlib.contextmanager
def collector_paused():
    """Python's cyclic collector off inside the block, counted across
    threads: the first block to begin turns it off, the last to end turns
    it back on if it was on before the first. (Each capture saving and
    restoring ``gc.isenabled()`` for itself would let the first of two
    captures in two threads re-enable it while the other still captures.)"""
    with _GC_LOCK:
        if _gc_pause[0] == 0:
            _gc_pause[1] = gc.isenabled()
            gc.disable()
        _gc_pause[0] += 1
    try:
        yield
    finally:
        with _GC_LOCK:
            _gc_pause[0] -= 1
            if _gc_pause[0] == 0 and _gc_pause[1]:
                gc.enable()


def _card_index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


class _CardPool(NamedTuple):
    handle: tuple  # the graph memory pool
    keep: torch.cuda.CUDAGraph  # a one-kernel graph that keeps the pool alive
    stream: torch.cuda.Stream  # the warm-ups and captures
    capturing: threading.Lock  # held by the capture under way
    replaying: threading.Lock  # held while a replay is queued
    last: list  # [the event after the last replay queued, or None]


class GraphPools:
    """CUDA graph memory pools, one a card, made at first use, each with
    the stream its programs' warm-ups and captures run on; ``programs``
    lists the live CapturedSteps made for them, ``eager_calls`` the calls
    of a signature that run the warm-up alone before one captures (0: the
    first call warms up and captures). A one-kernel graph captured into
    each pool at once keeps it alive: PyTorch frees a pool (and refuses its
    id) once no graph that uses it is left."""

    def __init__(self, name: str, eager_calls: int = 0):
        self.name = name
        self.eager_calls = eager_calls
        self._cards = {}
        self._lock = threading.Lock()
        self._programs = []  # weak references, in the order made

    def card(self, device) -> _CardPool:
        index = _card_index(device)
        with self._lock:
            if index not in self._cards:
                with torch.cuda.device(index):
                    handle, keep = torch.cuda.graph_pool_handle(), torch.cuda.CUDAGraph()
                    stream = torch.cuda.Stream()
                    stream.wait_stream(torch.cuda.current_stream())
                    with collector_paused(), torch.cuda.stream(stream):
                        keep.capture_begin(pool=handle, capture_error_mode="thread_local")
                        torch.zeros(1, device=torch.device("cuda", index))
                        keep.capture_end()
                    torch.cuda.current_stream().wait_stream(stream)
                self._cards[index] = _CardPool(handle, keep, stream, threading.Lock(),
                                               threading.Lock(), [None])
            return self._cards[index]

    @contextlib.contextmanager
    def replaying(self, device):
        """A block that queues one replay of a graph of the pool on the
        current stream: it starts on the card after the pool's previous
        replay, on any stream, has ended (no host sync), and the next one
        waits for it."""
        card = self.card(device)
        with card.replaying:
            stream = torch.cuda.current_stream(device)
            if card.last[0] is not None:
                stream.wait_event(card.last[0])
            yield
            done = torch.cuda.Event()
            done.record(stream)
            card.last[0] = done

    def add(self, program) -> None:
        self._programs = [r for r in self._programs if r() is not None] + [weakref.ref(program)]

    @property
    def programs(self) -> list:
        live = [r() for r in self._programs]
        self._programs = [r for r, p in zip(self._programs, live) if p is not None]
        return [p for p in live if p is not None]

    def nbytes(self, device=None) -> int:
        """The device memory the pools hold (their segments in the caching
        allocator's snapshot), on ``device`` or on every card used."""
        cards = dict(self._cards)
        if device is not None:
            index = _card_index(device)
            cards = {index: cards[index]} if index in cards else {}
        pools = {(i, tuple(c.handle)) for i, c in cards.items()}
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if (seg["device"], tuple(seg.get("segment_pool_id", ()))) in pools)


STEP_POOLS = GraphPools("step")  # the VIO steps' pools, shared by every step of a card
_SCOPE = threading.local()


@contextlib.contextmanager
def capturing_into(pools: GraphPools):
    """CapturedSteps made inside the block, in this thread, capture into
    ``pools``."""
    saved = getattr(_SCOPE, "pools", None)
    _SCOPE.pools = pools
    try:
        yield pools
    finally:
        _SCOPE.pools = saved


def graph_pool_bytes(device) -> int:
    """The device memory the VIO steps' graph pool of ``device`` holds."""
    return STEP_POOLS.nbytes(device)


def _layout(t: torch.Tensor):
    """A tensor's part of the signature; the stride of a dimension of size 1
    addresses nothing and is left out."""
    align = max(_ALIGN_BYTES // t.element_size(), 1)
    strides = tuple(st if n != 1 else 0 for n, st in zip(t.shape, t.stride()))
    return tuple(t.shape), t.dtype, strides, t.storage_offset() % align, t.device


def _flatten(tree, leaves: list):
    """The hashable signature of ``tree``; its tensors appended to
    ``leaves`` in order."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("T", _layout(tree))
    if tree is None or isinstance(tree, (bool, int, float, str, torch.dtype, torch.device)):
        return ("V", type(tree), tree)
    if isinstance(tree, (tuple, list)):
        return ("S", type(tree), tuple(_flatten(x, leaves) for x in tree))
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return ("D", keys, tuple(_flatten(tree[k], leaves) for k in keys))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = tuple(f.name for f in dataclasses.fields(tree))
        return ("C", type(tree), names, tuple(_flatten(getattr(tree, n), leaves) for n in names))
    raise TypeError(f"a captured step takes tensors, containers of them and host values, "
                    f"not {type(tree).__name__}")


def _unflatten(spec, leaves):
    """The tree of ``spec`` with its tensors taken from the iterator
    ``leaves``."""
    kind = spec[0]
    if kind == "T":
        return next(leaves)
    if kind == "V":
        return spec[2]
    if kind == "S":
        items = [_unflatten(s, leaves) for s in spec[2]]
        return spec[1](items) if spec[1] in (tuple, list) else spec[1](*items)
    if kind == "D":
        return {k: _unflatten(s, leaves) for k, s in zip(spec[1], spec[2])}
    return spec[1](**{n: _unflatten(s, leaves) for n, s in zip(spec[2], spec[3])})


def describe(spec) -> str:
    """A signature in words: its tensors' shapes and dtypes and its host
    values, in order."""
    kind = spec[0]
    if kind == "T":
        shape, dtype = spec[1][:2]
        return f"{str(dtype).replace('torch.', '')}{list(shape)}"
    if kind == "V":
        return repr(spec[2])
    if kind == "S":
        return "(" + ", ".join(describe(s) for s in spec[2]) + ")"
    if kind == "D":
        return "{" + ", ".join(f"{k}={describe(s)}" for k, s in zip(spec[1], spec[2])) + "}"
    return (f"{spec[1].__name__}("
            + ", ".join(f"{n}={describe(s)}" for n, s in zip(spec[2], spec[3])) + ")")


def _compact(t: torch.Tensor) -> torch.Tensor:
    """``t`` with each broadcast dimension (stride 0) cut to its index 0."""
    for d, (n, st) in enumerate(zip(t.shape, t.stride())):
        if st == 0 and n > 1:
            t = t.narrow(d, 0, 1)
    return t


def _overlaps(t: torch.Tensor) -> bool:
    """Whether two elements of ``t`` share memory."""
    reach = 0
    for st, n in sorted((st, n) for n, st in zip(t.shape, t.stride()) if n > 1):
        if st <= reach:
            return True
        reach += (n - 1) * st
    return False


def _empty_like(t: torch.Tensor) -> torch.Tensor:
    """A new tensor of ``t``'s layout: shape, strides, broadcast dimensions
    and storage offset modulo 16 bytes."""
    c = _compact(t)
    if _overlaps(c):
        raise ValueError(f"a captured step cannot copy a tensor whose elements overlap "
                         f"(shape {tuple(t.shape)}, strides {t.stride()})")
    offset = t.storage_offset() % max(_ALIGN_BYTES // t.element_size(), 1)
    span = 1 + sum((n - 1) * st for n, st in zip(c.shape, c.stride())) if c.numel() else 0
    base = torch.empty(offset + span, dtype=t.dtype, device=t.device)
    return base.as_strided(c.shape, c.stride(), offset).expand(t.shape)


def _copy(dsts, srcs) -> None:
    """dst.copy_(src) for each pair, one multi-tensor copy a dtype."""
    groups = {}
    for d, s in zip(dsts, srcs):
        pair = groups.setdefault(d.dtype, ([], []))
        pair[0].append(d)
        pair[1].append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def _abandon_capture(graph, device, pool) -> None:
    """End a capture that failed: the stream leaves capture mode and the
    allocator stops routing its allocations to the graph pool (which an
    invalidated capture's ``capture_end`` skips), so a later capture starts
    clean. The program's own error is raised after."""
    try:
        graph.capture_end()
    except RuntimeError:
        end = getattr(torch._C, "_cuda_endAllocateToPool", None)
        if end is not None:
            end(torch.device(device).index, pool)


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: list  # the static input buffers, compact
    out_spec: tuple
    outputs: list  # the static outputs
    launches: dict  # (kernel, shape) -> launches a replay
    copy_bytes: int  # the bytes a replay copies in and out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in map(_compact, tensors))


class CapturedStep:
    """``fn`` captured in a CUDA graph once for each input signature and
    replayed (the module docstring); ``eager`` is ``fn`` itself, ``pools``
    the GraphPools it captures into."""

    def __init__(self, fn, name: str = None):
        self.eager = fn
        self.name = name or getattr(fn, "__qualname__", "step")
        self.pools = getattr(_SCOPE, "pools", None) or STEP_POOLS
        self.pools.add(self)
        self._graphs = {}
        self._warmed = {}  # signature -> its warm-ups so far (pools with eager_calls)
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0

    def __call__(self, *args, **kwargs):
        """The span recorder's ``graph.call``, with the children
        ``graph.flatten`` (the signature), and on a replay ``graph.copy_in``,
        ``graph.replay`` and ``graph.copy_out``."""
        with timer.span("graph.call"):
            return self._call(args, kwargs)

    def _call(self, args, kwargs):
        with timer.span("graph.flatten"):
            leaves = []
            key = _flatten((args, kwargs), leaves)
        devices = {t.device for t in leaves}
        if all(d.type == "cpu" for d in devices):
            return self.eager(*args, **kwargs)
        if len(devices) != 1:
            raise ValueError(f"{self.name}: inputs on {sorted(map(str, devices))}; a captured "
                             f"program takes the tensors of one card")
        entry = self._graphs.get(key)
        with torch.cuda.device(leaves[0].device):
            if entry is not None:
                return self._replay(key, entry, leaves)
            warmed = self._warmed.get(key, 0)
            if warmed < self.pools.eager_calls:
                self._warmed[key] = warmed + 1
                return self._warm_up(leaves[0].device, args, kwargs)
            if not warmed:  # the warm-up, then the capture: the warm-up is the result
                result = self._warm_up(leaves[0].device, args, kwargs)
                self._capture(key, leaves)
                return result
            del self._warmed[key]
            return self._replay(key, self._capture(key, leaves), leaves)

    def _warm_up(self, device, args, kwargs):
        """``fn`` run eagerly on the pools' capture stream (filling the
        first-use caches there): this call's result."""
        stream, current = self.pools.card(device).stream, torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            result = self.eager(*args, **kwargs)
        current.wait_stream(stream)
        return result

    def _capture(self, key, leaves) -> _Graph:
        """Capture ``fn`` on static copies of ``leaves`` (their values are
        not read: a replay copies the inputs in first)."""
        if len(self._graphs) >= MAX_KEYS:
            raise RuntimeError(f"{self.name}: a signature beyond the {MAX_KEYS} captured: "
                               f"{describe(key)}")
        device = leaves[0].device
        card = self.pools.card(device)
        with card.capturing:
            return self._capture_locked(key, leaves, device, card)

    def _capture_locked(self, key, leaves, device, card) -> _Graph:
        stream, current = card.stream, torch.cuda.current_stream(device)
        t0 = time.perf_counter()
        static_in = [_empty_like(x) for x in leaves]
        s_args, s_kwargs = _unflatten(key, iter(static_in))
        graph = torch.cuda.CUDAGraph()
        stream.wait_stream(current)
        stream.synchronize()  # the stream only: a device-wide sync would wait on other captures
        try:
            with collector_paused(), _lib.recording_launches() as launches, \
                    torch.cuda.stream(stream):
                graph.capture_begin(pool=card.handle, capture_error_mode="thread_local")
                try:
                    out = self.eager(*s_args, **s_kwargs)
                except BaseException:
                    _abandon_capture(graph, device, card.handle)
                    raise
                graph.capture_end()
        except Exception as e:
            raise RuntimeError(f"{self.name}: the capture of {describe(key)} failed: {e}") from e
        out_leaves = []
        out_spec = _flatten(out, out_leaves)
        entry = self._graphs[key] = _Graph(graph, [_compact(s) for s in static_in], out_spec,
                                           out_leaves, dict(launches),
                                           _nbytes(static_in) + _nbytes(out_leaves))
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return entry

    def _replay(self, key, entry: _Graph, leaves):
        with self.pools.replaying(leaves[0].device):
            with timer.span("graph.copy_in"):
                _copy(entry.inputs, [_compact(x) for x in leaves])
            try:
                with timer.span("graph.replay"):
                    entry.graph.replay()
            except RuntimeError as e:
                raise RuntimeError(f"{self.name}: the replay of {describe(key)} failed: {e}") from e
            with timer.span("graph.copy_out"):
                outs = [_empty_like(t) for t in entry.outputs]
                _copy([_compact(o) for o in outs], [_compact(t) for t in entry.outputs])
        _lib.add_launches(entry.launches)
        self.replays += 1
        timer.count("graph.copy_bytes", entry.copy_bytes)
        timer.count("graph.copy_tensors", len(entry.inputs) + len(entry.outputs))
        return _unflatten(entry.out_spec, iter(outs))

    @property
    def keys(self) -> int:
        """The signatures captured."""
        return len(self._graphs)

    def launches_per_replay(self) -> dict:
        """kernel -> launches a replay adds, summed over the signatures
        captured."""
        out = {}
        for entry in self._graphs.values():
            for (kernel, _), n in entry.launches.items():
                out[kernel] = out.get(kernel, 0) + n
        return out
