"""Simulated worker clients for the aggregation server, the port of the JAX
package's ``serve/client.py``.

``worker_payloads`` slices the session's own round schedule into per-worker
messages: exactly the (n_max-padded) batch slice worker ``i`` would have
drawn locally, so a fully-delivered stream reassembles (``torch.stack`` over
workers is the inverse of the slicing) into bit-for-bit the offline driver's
batch tree. The payloads are host tensors: they are cut before the server
starts, and only the server's round loop moves a round to the card.
``SimulatedWorkers`` runs one producer thread per worker pushing those
messages through ``AggregationServer.submit``, with optional per-message
jitter (out-of-order arrival across rounds within the lookahead window) and
a drop set (the straggler-timeout path). The producer threads issue no CUDA
work.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Iterable, List, Optional, Sequence, Tuple

from torch.utils._pytree import tree_map


def worker_payloads(session, T: int, start: int = 0) -> List[List[Any]]:
    """``rounds[t - start][i]`` = worker ``i``'s payload for round ``t``,
    sliced from ``session.round_inputs`` (leading worker axis dropped) and
    held on the host. The list is what a replay after checkpoint-resume
    feeds from ``start``."""
    sched = session.schedule(T)
    if session.m is None:
        raise ValueError("worker payloads need the session's worker count; "
                         "build it with switcher= or m=")
    rounds = []
    for t in range(start, T):
        batches = tree_map(lambda l: l.cpu(),
                           session.round_inputs(sched, t).batches)
        rounds.append([tree_map(lambda l, i=i: l[i], batches)
                       for i in range(session.m)])
    return rounds


class SimulatedWorkers:
    """One daemon producer thread per worker, each submitting its payload
    stream in round order (the server tolerates cross-worker reordering up
    to its lookahead window). ``drop`` is a set of ``(worker_id, round)``
    pairs to silently skip — those workers become stragglers and get masked
    once the round deadline fires. Failed submits (backpressure timeout or
    server shutdown) are collected in ``failures``."""

    def __init__(self, server, payloads: Sequence[Sequence[Any]], *,
                 start_round: int = 0,
                 drop: Optional[Iterable[Tuple[int, int]]] = None,
                 jitter_s: float = 0.0, seed: int = 0,
                 submit_timeout: Optional[float] = 60.0):
        self.server = server
        self.payloads = payloads
        self.start_round = start_round
        self.drop = frozenset(drop or ())
        self.jitter_s = jitter_s
        self.seed = seed
        self.submit_timeout = submit_timeout
        self.failures: List[Tuple[int, int]] = []
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []

    def _run_worker(self, wid: int) -> None:
        rng = random.Random(self.seed * 1_000 + wid)
        for off, per_worker in enumerate(self.payloads):
            t = self.start_round + off
            if (wid, t) in self.drop:
                continue
            if self.jitter_s:
                time.sleep(rng.uniform(0.0, self.jitter_s))
            ok = self.server.submit(wid, t, per_worker[wid],
                                    timeout=self.submit_timeout)
            if not ok:
                with self._lock:
                    self.failures.append((wid, t))

    def start(self) -> "SimulatedWorkers":
        m = self.server.m
        self._threads = [
            threading.Thread(target=self._run_worker, args=(i,),
                             name=f"serve-worker-{i}", daemon=True)
            for i in range(m)
        ]
        for th in self._threads:
            th.start()
        return self

    def join(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        for th in self._threads:
            th.join(None if deadline is None
                    else max(deadline - time.monotonic(), 0.0))
        return not any(th.is_alive() for th in self._threads)
