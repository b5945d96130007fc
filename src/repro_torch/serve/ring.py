"""Bounded thread-safe ring buffer — the ingress queue of the aggregation
server; a copy of the JAX package's ``serve/ring.py`` (pure Python).

Producers (worker clients) ``put`` update messages; a full ring blocks the
producer up to its timeout — that IS the backpressure mechanism, there is no
silent drop path. The single consumer (the server loop) ``get``s them out.
``close()`` wakes every waiter so shutdown never deadlocks on a blocked
producer or consumer.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, Optional


class RingBuffer:
    """FIFO with a hard capacity. ``put`` returns False instead of enqueuing
    when the ring stays full past the timeout (or the ring is closed) —
    callers count that as a backpressure rejection. Stats are monotonic
    counters plus a high-water mark, all read under the same lock."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"ring capacity must be positive, got {capacity}")
        self._capacity = capacity
        self._buf: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        self._pushed = 0
        self._rejected = 0
        self._high_water = 0

    @property
    def capacity(self) -> int:
        return self._capacity

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def put(self, item: Any, timeout: Optional[float] = None) -> bool:
        """Enqueue; block while full. False = rejected (timeout while full,
        or ring closed) — the producer-visible backpressure signal."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._not_full:
            while len(self._buf) >= self._capacity and not self._closed:
                wait = (None if deadline is None
                        else deadline - time.monotonic())
                if wait is not None and wait <= 0:
                    self._rejected += 1
                    return False
                self._not_full.wait(wait)
            if self._closed:
                self._rejected += 1
                return False
            self._buf.append(item)
            self._pushed += 1
            self._high_water = max(self._high_water, len(self._buf))
            self._not_empty.notify()
            return True

    def get(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Dequeue; block while empty. None = nothing arrived within the
        timeout, or the ring is closed and drained."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._not_empty:
            while not self._buf:
                if self._closed:
                    return None
                wait = (None if deadline is None
                        else deadline - time.monotonic())
                if wait is not None and wait <= 0:
                    return None
                self._not_empty.wait(wait)
            item = self._buf.popleft()
            self._not_full.notify()
            return item

    def close(self) -> None:
        """Stop accepting puts and wake every blocked producer/consumer;
        already-queued items remain drainable via ``get``."""
        with self._lock:
            self._closed = True
            self._not_full.notify_all()
            self._not_empty.notify_all()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "ring_depth": len(self._buf),
                "ring_capacity": self._capacity,
                "ring_pushed": self._pushed,
                "ring_rejected": self._rejected,
                "ring_high_water": self._high_water,
            }
