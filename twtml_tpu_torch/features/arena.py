"""Pooled host buffers for the packed wire (counterpart of
``twtml_tpu/features/arena.py``).

The one-pass featurize fill and the packer write into a LEASED uint8
buffer instead of a fresh one each batch. When the model is on ``cuda`` the
arena's buffers are page-locked (``use_device``), so the native pack writes
straight into pinned memory and the step's H2D copy runs asynchronously
from it; on the CPU they are plain memory. The arena takes the device it is
given: pinned memory on a machine without CUDA raises, it never falls back.

A lease retires back to the pool once nothing can read the buffer any more:
after the fetch pipeline delivered the batch's results (apps/common.py),
which the device produced after the H2D copy that read the buffer, on the
same stream. ``discard`` closes a lease without recycling its buffer: the
abort path, and the backstop of a batch that is never stepped.

The pool is keyed by exact byte size (a stream repeats a few wire sizes)
and capped by ``max_pool_bytes``; a lease never retired is simply a fresh
buffer the garbage collector reclaims. Ownership only: the bytes are the
ones a fresh buffer would hold.
"""

from __future__ import annotations

import threading

import numpy as np
import torch


class Lease:
    """One leased buffer: write into ``buf``; ``retire()`` when nothing can
    read it any more, ``discard()`` on abort paths. Both are idempotent."""

    __slots__ = ("_arena", "buf", "_done")

    def __init__(self, arena: "WireArena", buf: np.ndarray):
        self._arena = arena
        self.buf = buf
        self._done = False

    def retire(self) -> None:
        if not self._done:
            self._done = True
            self._arena._retire(self.buf, recycle=True)

    def discard(self) -> None:
        """Close the lease but never reuse the buffer."""
        if not self._done:
            self._done = True
            self._arena._retire(self.buf, recycle=False)


class LeaseChain:
    """Several leases retiring or discarding as one: the handle of a
    dispatch whose wire buffer and featurize-stage arrays are both
    leased."""

    __slots__ = ("leases",)

    def __init__(self, *leases):
        self.leases = [le for le in leases if le is not None]

    def retire(self) -> None:
        for le in self.leases:
            le.retire()

    def discard(self) -> None:
        for le in self.leases:
            le.discard()


def chain_leases(*leases):
    """None-safe, identity-deduplicating combinator: the one lease when
    only one distinct lease is given, a ``LeaseChain`` of several, None of
    none."""
    seen: list = []
    for le in leases:
        if le is not None and not any(le is s for s in seen):
            seen.append(le)
    if not seen:
        return None
    if len(seen) == 1:
        return seen[0]
    return LeaseChain(*seen)


class WireArena:
    """Size-keyed pool of wire buffers (module docstring)."""

    def __init__(self, max_pool_bytes: int = 256 << 20):
        self.max_pool_bytes = int(max_pool_bytes)
        self.pinned = False  # use_device
        self._lock = threading.Lock()
        self._free: dict[int, list[np.ndarray]] = {}
        self._free_bytes = 0
        self._in_use = 0
        self._recycled = 0
        self._misses = 0

    def use_device(self, device) -> None:
        """Serve page-locked buffers for a ``cuda`` model, plain ones for a
        ``cpu`` model. A change drops the free pool, so no buffer of the
        other kind is handed out."""
        pinned = torch.device(device).type == "cuda"
        with self._lock:
            if pinned != self.pinned:
                self._free.clear()
                self._free_bytes = 0
            self.pinned = pinned

    def _allocate(self, nbytes: int) -> np.ndarray:
        if not self.pinned:
            return np.empty((nbytes,), np.uint8)
        # the numpy view keeps the pinned tensor (and its pages) alive
        return torch.empty((nbytes,), dtype=torch.uint8, pin_memory=True).numpy()

    def lease(self, nbytes: int) -> Lease:
        """A uint8 buffer of exactly ``nbytes``: a pooled one when there is
        one, else fresh (a counted miss)."""
        nbytes = int(nbytes)
        with self._lock:
            bucket = self._free.get(nbytes)
            if bucket:
                buf = bucket.pop()
                self._free_bytes -= nbytes
                self._recycled += 1
            else:
                buf = self._allocate(nbytes)
                self._misses += 1
            self._in_use += 1
        return Lease(self, buf)

    def _retire(self, buf: np.ndarray, recycle: bool) -> None:
        with self._lock:
            self._in_use -= 1
            if recycle and self._free_bytes + buf.nbytes <= self.max_pool_bytes:
                self._free.setdefault(int(buf.nbytes), []).append(buf)
                self._free_bytes += int(buf.nbytes)

    def stats(self) -> dict:
        with self._lock:
            return {
                "in_use": self._in_use,
                "free_buffers": sum(len(v) for v in self._free.values()),
                "free_bytes": self._free_bytes,
                "recycled": self._recycled,
                "misses": self._misses,
            }


_arena = WireArena()


def get_arena() -> WireArena:
    """The process-wide arena every wire buffer leases from."""
    return _arena


def lease_wire(nbytes: int) -> Lease:
    return _arena.lease(nbytes)
