"""The compiled step: a step function captured in a CUDA graph once for
each input signature and replayed, the card's counterpart of ``jax.jit``,
which the JAX package applies to its batched step and scan, to VioApi's
step and its three ``-timer`` stages and to the probes' steps (``jax.jit``
lives in JAX itself: the JAX package has no file for it).

``CapturedStep(fn)`` is called as ``fn`` is. On the card, the first call
with a signature

1. runs ``fn`` eagerly on the device's capture stream (the warm-up). That
   fills the first-use caches (``runtime.constant``, the five-point
   solver's constants, the kernel library, the cuBLAS and cuSOLVER
   workspaces). Its result is the call's result: no input is stepped twice;
2. captures ``fn`` on static copies of the inputs into a graph of the
   device's shared pool (``runtime.graph_pool``), with
   ``capture_error_mode="thread_local"``, so that another thread's work on
   its own stream (the SLAM worker's) does not break the capture, and with
   Python's cyclic collector paused: CUDA refuses to destroy a graph (a
   dead step's, freed by the collector) in the capturing thread. A capture
   synchronizes the device; ``captures`` and ``capture_s`` count them. The
   kernels launched while capturing are recorded, not counted, and every
   replay adds them to the ``ops`` launch counts.

A later call with the signature copies its inputs into the static buffers,
replays the graph on the current stream (the same kernels in the same
order as the eager step, so the same bits) and returns copies of the
outputs that the caller owns: no later replay writes into them. A replay
makes no host sync. A capture or a replay that fails raises, naming the
signature; nothing falls back to the eager step, which stays reachable as
``.eager``. On the CPU a call is the eager step.

The signature is the tree of the arguments (tuples, lists, NamedTuples,
dicts, dataclasses such as a per-frame ``Camera``), each tensor's shape,
dtype, strides, broadcast dimensions, storage offset modulo 16 bytes and
device (a static buffer repeats the layout, so that the captured kernels
read what the eager ones read), and the value of every other leaf: a host
int such as ``n_valid``, a camera's floats, ``None`` for an absent second
image or camera.
"""
from __future__ import annotations

import dataclasses
import gc
import threading
import time
from typing import NamedTuple

import torch

from .ops import _lib
from .runtime import graph_pool

MAX_KEYS = 32  # signatures one step may capture before a new one raises
_ALIGN_BYTES = 16  # the widest vector load of a kernel

_STREAMS = {}  # card index -> its capture stream
_STREAMS_LOCK = threading.Lock()


def _capture_stream(device) -> torch.cuda.Stream:
    """The stream the warm-ups and captures of ``device`` run on."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    with _STREAMS_LOCK:
        if index not in _STREAMS:
            _STREAMS[index] = torch.cuda.Stream(device=index)
        return _STREAMS[index]


def graph_pool_bytes(device) -> int:
    """The device memory the graph pool of ``device`` holds (its segments
    in the caching allocator's snapshot)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    pool = tuple(graph_pool(index))
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == index and tuple(seg.get("segment_pool_id", ())) == pool)


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


def _abandon_capture(graph, device) -> None:
    """End a capture that failed: the stream leaves capture mode and the
    allocator stops routing its allocations to the graph pool (which an
    invalidated capture's ``capture_end`` skips), so a later capture starts
    clean. The step's own error is raised after."""
    try:
        graph.capture_end()
    except RuntimeError:
        end = getattr(torch._C, "_cuda_endAllocateToPool", None)
        if end is not None:
            end(torch.device(device).index, graph_pool(device))


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: list  # the static input buffers, compact
    out_spec: tuple
    outputs: list  # the static outputs
    launches: dict  # (kernel, shape) -> launches a replay


class CapturedStep:
    """``fn`` captured in a CUDA graph once for each input signature and
    replayed (the module docstring); ``eager`` is ``fn`` itself."""

    def __init__(self, fn, name: str = None):
        self.eager = fn
        self.name = name or getattr(fn, "__qualname__", "step")
        self._graphs = {}
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0

    def __call__(self, *args, **kwargs):
        leaves = []
        key = _flatten((args, kwargs), leaves)
        devices = {t.device for t in leaves}
        if all(d.type == "cpu" for d in devices):
            return self.eager(*args, **kwargs)
        if len(devices) != 1:
            raise ValueError(f"{self.name}: inputs on {sorted(map(str, devices))}; a captured "
                             f"step takes the tensors of one card")
        entry = self._graphs.get(key)
        with torch.cuda.device(leaves[0].device):
            if entry is None:
                return self._capture(key, leaves, args, kwargs)
            return self._replay(key, entry, leaves)

    def _capture(self, key, leaves, args, kwargs):
        if len(self._graphs) >= MAX_KEYS:
            raise RuntimeError(f"{self.name}: a signature beyond the {MAX_KEYS} captured: "
                               f"{describe(key)}")
        device = leaves[0].device
        stream = _capture_stream(device)
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            result = self.eager(*args, **kwargs)  # the warm-up: this call's result
        current.wait_stream(stream)

        t0 = time.perf_counter()
        static_in = [_empty_like(x) for x in leaves]
        s_args, s_kwargs = _unflatten(key, iter(static_in))
        graph, pool = torch.cuda.CUDAGraph(), graph_pool(device)
        torch.cuda.synchronize(device)
        collecting = gc.isenabled()
        gc.disable()  # a dead step's graph freed inside the capture would invalidate it
        try:
            with _lib.recording_launches() as launches, torch.cuda.stream(stream):
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    out = self.eager(*s_args, **s_kwargs)
                except BaseException:
                    _abandon_capture(graph, device)
                    raise
                graph.capture_end()
        except Exception as e:
            raise RuntimeError(f"{self.name}: the capture of {describe(key)} failed: {e}") from e
        finally:
            if collecting:
                gc.enable()
        out_leaves = []
        out_spec = _flatten(out, out_leaves)
        self._graphs[key] = _Graph(graph, [_compact(s) for s in static_in], out_spec, out_leaves,
                                   dict(launches))
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return result

    def _replay(self, key, entry: _Graph, leaves):
        _copy(entry.inputs, [_compact(x) for x in leaves])
        try:
            entry.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"{self.name}: the replay of {describe(key)} failed: {e}") from e
        _lib.add_launches(entry.launches)
        outs = [_empty_like(t) for t in entry.outputs]
        _copy([_compact(o) for o in outs], [_compact(t) for t in entry.outputs])
        self.replays += 1
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
