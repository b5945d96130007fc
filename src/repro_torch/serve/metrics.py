"""Serve-side metrics: thread-safe counters/gauges, a sliding-window
updates/sec throughput estimate, staleness observation, and a structured
JSONL metrics log; a copy of the JAX package's ``serve/metrics.py``
(pure Python)."""
from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Dict, Optional


class ServeMetrics:
    """Counters + gauges + derived rates behind one lock.

    ``mark_updates(n)`` feeds the throughput window (accepted updates,
    stamped with the monotonic clock); ``updates_per_sec()`` is the rate over
    the last ``window_s`` seconds. ``observe_staleness`` tracks message age
    (submit -> ingest) as a running mean plus max."""

    def __init__(self, window_s: float = 10.0):
        self._lock = threading.Lock()
        self._window_s = window_s
        self._counts: Dict[str, int] = collections.defaultdict(int)
        self._gauges: Dict[str, Any] = {}
        self._events: collections.deque = collections.deque()  # (t, n)
        self._stale_sum = 0.0
        self._stale_n = 0
        self._stale_max = 0.0
        self._t0 = time.monotonic()

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] += n

    def set(self, name: str, value: Any) -> None:
        with self._lock:
            self._gauges[name] = value

    def mark_updates(self, n: int) -> None:
        now = time.monotonic()
        with self._lock:
            self._events.append((now, n))
            self._trim(now)

    def observe_staleness(self, age_s: float) -> None:
        with self._lock:
            self._stale_sum += age_s
            self._stale_n += 1
            self._stale_max = max(self._stale_max, age_s)

    def _trim(self, now: float) -> None:
        cutoff = now - self._window_s
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()

    def updates_per_sec(self) -> float:
        now = time.monotonic()
        with self._lock:
            self._trim(now)
            total = sum(n for _, n in self._events)
            # early on, the window hasn't filled yet — rate over elapsed time
            span = min(self._window_s, max(now - self._t0, 1e-9))
            return total / span

    def snapshot(self) -> Dict[str, Any]:
        ups = self.updates_per_sec()
        with self._lock:
            out: Dict[str, Any] = dict(self._counts)
            out.update(self._gauges)
            out["updates_per_sec"] = round(ups, 3)
            out["staleness_mean_s"] = (
                round(self._stale_sum / self._stale_n, 6)
                if self._stale_n else 0.0)
            out["staleness_max_s"] = round(self._stale_max, 6)
            return out


class MetricsLog:
    """Append-only JSONL structured metrics log: one record per event
    (round processed, checkpoint written, drain, ...), each stamped with
    wall-clock time. Thread-safe; ``None``-path constructs a no-op."""

    def __init__(self, path: Optional[str]):
        self._path = path
        self._lock = threading.Lock()
        self._f = open(path, "a") if path else None

    def write(self, record: Dict[str, Any]) -> None:
        if self._f is None:
            return
        record = {"ts": time.time(), **record}
        with self._lock:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None
