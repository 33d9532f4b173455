"""Object pool allocator (reference: src/util/allocator.hpp): reusable buffer
slots where a free slot is one nobody else references. In Python, host-side
numpy frame buffers benefit from pooling to avoid per-frame allocation in the
IO path (a copy of the reference package's ``utils/allocator.py``); device
tensors are managed by PyTorch's caching allocator and need no pool."""
from __future__ import annotations

import sys
from typing import Callable, List, TypeVar

T = TypeVar("T")

GROW_STEP = 5  # (reference: allocator.hpp lazy growth in steps of 5)
DEFAULT_MAX = 100


class Allocator:
    def __init__(self, factory: Callable[[], T], max_size: int = DEFAULT_MAX):
        self.factory = factory
        self.max_size = max_size
        self.pool: List[T] = []

    def next(self) -> T:
        """Return a free object (refcount == pool's own reference) or grow."""
        for obj in self.pool:
            # 2 = the pool list + the getrefcount argument
            if sys.getrefcount(obj) <= 3:
                return obj
        if len(self.pool) >= self.max_size:
            raise RuntimeError("allocator pool exhausted")
        first_new = len(self.pool)
        for _ in range(min(GROW_STEP, self.max_size - len(self.pool))):
            self.pool.append(self.factory())
        # return the first buffer appended THIS grow (pool[-GROW_STEP] could
        # be a still-referenced older buffer when fewer than GROW_STEP slots
        # remained before max_size)
        return self.pool[first_new]
