"""The aggregation server, the port of the JAX package's
``serve/server.py``: drain worker updates from the ring buffer through the
session's per-round step.

One consumer thread, the serve thread, owns the round loop: it pops
``(worker_id, round, payload)`` messages off the ring, files them into a
per-round pending table, and when round ``r`` is ready — every worker
present, or the round deadline passed with at least ``min_workers``
present — assembles the (m, n_max, ...) batch, ORs timed-out workers into
the round's Byzantine mask (a straggler is just a dynamically-Byzantine
worker: the aggregator's robustness bound already covers it, so no special
recovery path exists), and advances the carry with ``Session.step``.
Because ``step`` replays the level graph the offline compiled driver
replays (``ScanFn.run_round``), a fully-delivered stream is bitwise
identical to ``Session.run`` on the same schedule.

The serve thread is the only thread that issues CUDA work while a server
runs: payloads stay on the host until the serve thread stacks a round and
moves it to the session's device, and the level graphs are captured (on a
level's first round), replayed and checkpointed from that thread. Worker
threads, the HTTP thread and the caller only touch Python state.

Flow control is two-layer: ``submit`` blocks messages more than
``lookahead_rounds`` ahead of the server's current round (so a fast worker
cannot flood memory with far-future rounds), and the bounded ring blocks
once full. The carry checkpoints every ``checkpoint_every`` rounds through
``repro_torch.checkpoint``; a graceful drain writes a final checkpoint at an
exact round boundary, so a restarted server resumes bitwise.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.api.session import RoundInputs, Session
from repro_torch.checkpoint import (
    latest_checkpoint, load_checkpoint, save_checkpoint,
)
from repro_torch.core.mlmc import round_cost
from repro_torch.core.robust_train import RoundLog
from repro_torch.serve.health import HealthEndpoint
from repro_torch.serve.metrics import MetricsLog, ServeMetrics
from repro_torch.serve.ring import RingBuffer


class Update(NamedTuple):
    """One worker->server message. ``payload`` is the worker's padded
    per-round batch slice (host tensors with a leading (n_max,) unit axis) —
    the Mode-A simulation analog of a gradient update: gradients are
    computed inside the server's worker-vmapped step so the parity contract
    stays bitwise (a per-worker gradient outside the round's graph could
    differ in its last bits)."""

    worker_id: int
    round: int
    payload: Any
    sent_at: float  # time.monotonic() at submit, for staleness metrics


@dataclasses.dataclass
class ServeConfig:
    """Server knobs. ``round_timeout_s=None`` waits forever for every worker
    (no straggler masking); with a timeout, a round is processed once at
    least ``min_workers`` arrived and the deadline (measured from the round's
    first arrival) passed. ``health_port`` None disables the HTTP endpoint;
    0 binds an ephemeral port (see ``AggregationServer.health``)."""

    capacity: int = 1024
    round_timeout_s: Optional[float] = None
    min_workers: int = 1
    lookahead_rounds: int = 8
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    metrics_log: Optional[str] = None
    health_port: Optional[int] = None
    poll_s: float = 0.02


class AggregationServer:
    """See the module docstring. Lifecycle: ``start()`` → clients
    ``submit(...)`` → ``stop(drain=True)`` (graceful) or ``stop(drain=False)``
    (kill: in-flight round finishes, nothing past the last checkpoint
    survives) → ``close()``. ``AggregationServer.resume(...)`` rebuilds from
    the newest checkpoint in ``cfg.checkpoint_dir``."""

    def __init__(self, session: Session, T: int,
                 cfg: Optional[ServeConfig] = None, *,
                 start_round: int = 0, carry=None):
        if session.m is None:
            raise ValueError("serve needs the session's worker count; build "
                             "it with switcher= or m=")
        self.session = session
        self.T = T
        self.cfg = cfg or ServeConfig()
        self.m = session.m
        self.sched = session.schedule(T)
        self.device = tree_leaves(session.params0)[0].device
        self.start_round = start_round
        self.carry = carry if carry is not None else session.init_carry()
        self.ring = RingBuffer(self.cfg.capacity)
        self.metrics = ServeMetrics()
        self.logs: List[RoundLog] = []
        self.error: Optional[BaseException] = None
        self.health: Optional[HealthEndpoint] = None
        self._log = MetricsLog(self.cfg.metrics_log)
        self._round = start_round
        self._pending: Dict[int, Dict[int, Any]] = {}
        self._deadline: Optional[float] = None
        self._last_ckpt = start_round
        self._admit = threading.Condition()
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def resume(cls, session: Session, T: int,
               cfg: ServeConfig) -> "AggregationServer":
        """Rebuild from the newest complete checkpoint in
        ``cfg.checkpoint_dir`` (fresh server at round 0 if there is none).
        The restored carry re-enters the same level graphs, so the resumed
        stream continues bitwise from the checkpointed round boundary."""
        if not cfg.checkpoint_dir:
            raise ValueError("resume needs cfg.checkpoint_dir")
        found = latest_checkpoint(cfg.checkpoint_dir, prefix="carry_")
        if found is None:
            return cls(session, T, cfg)
        path, step = found
        carry = load_checkpoint(path, session.init_carry())
        return cls(session, T, cfg, start_round=step, carry=carry)

    # ------------------------------------------------------------ ingress

    def submit(self, worker_id: int, round: int, payload: Any,
               timeout: Optional[float] = None) -> bool:
        """Client-side entrypoint (thread-safe). Blocks under backpressure —
        the round is beyond the lookahead window, or the ring is full — up
        to ``timeout``; False means the update was NOT accepted (timed out,
        stale, invalid, or the server is stopping)."""
        if not (0 <= worker_id < self.m) or not (0 <= round < self.T):
            self.metrics.inc("updates_invalid")
            return False
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._admit:
            while (round >= self._round + self.cfg.lookahead_rounds
                   and not self._stop.is_set()
                   and not self._draining.is_set()
                   and not self._done.is_set()):
                wait = (None if deadline is None
                        else deadline - time.monotonic())
                if wait is not None and wait <= 0:
                    self.metrics.inc("updates_backpressured")
                    return False
                self._admit.wait(wait)
            if (self._stop.is_set() or self._draining.is_set()
                    or self._done.is_set()):
                self.metrics.inc("updates_rejected_shutdown")
                return False
            if round < self._round:
                self.metrics.inc("updates_stale_dropped")
                return False
        remaining = (None if deadline is None
                     else max(deadline - time.monotonic(), 0.0))
        ok = self.ring.put(Update(worker_id, round, payload, time.monotonic()),
                           timeout=remaining)
        if not ok:
            self.metrics.inc("updates_backpressured")
        return ok

    # ------------------------------------------------------------- loop

    def start(self) -> None:
        if self.cfg.health_port is not None and self.health is None:
            self.health = HealthEndpoint(self.snapshot,
                                         port=self.cfg.health_port)
            self.health.start()
        self._thread = threading.Thread(target=self._run, name="serve-loop",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            self._loop()
        except Exception as e:  # surfaced via .error / /health status
            self.error = e
            self._log.write({"event": "error", "error": repr(e),
                             "round": self._round})
        finally:
            self._done.set()
            self.ring.close()
            with self._admit:
                self._admit.notify_all()
            self._log.write({"event": "stopped", "round": self._round,
                             **self.metrics.snapshot()})

    def _loop(self) -> None:
        while not self._stop.is_set() and self._round < self.T:
            msg = self.ring.get(timeout=self.cfg.poll_s)
            if self._stop.is_set():
                break
            if msg is not None:
                self._ingest(msg)
            progressed = self._maybe_process()
            if (self._draining.is_set() and msg is None and not progressed
                    and len(self.ring) == 0):
                # quiescent drain: nothing queued, current round not
                # complete-able. With a round timeout, a partial round will
                # still trip its deadline — keep looping; without one, a
                # partial final round is abandoned (nothing more can arrive).
                if (not self._pending.get(self._round)
                        or self.cfg.round_timeout_s is None):
                    break
        if not self._stop.is_set() and self.cfg.checkpoint_dir:
            # graceful exit (drain or natural completion): final checkpoint
            # at the exact round boundary -> bitwise resume
            self._checkpoint()

    def _ingest(self, msg: Update) -> None:
        self.metrics.observe_staleness(time.monotonic() - msg.sent_at)
        if msg.round < self._round:
            self.metrics.inc("updates_stale_dropped")
            return
        slot = self._pending.setdefault(msg.round, {})
        if msg.worker_id in slot:
            self.metrics.inc("updates_duplicate")
        slot[msg.worker_id] = msg.payload
        self.metrics.inc("updates_accepted")

    def _maybe_process(self) -> bool:
        r = self._round
        got = self._pending.get(r)
        if not got:
            self._deadline = None
            return False
        if self.cfg.round_timeout_s is not None and self._deadline is None:
            self._deadline = time.monotonic() + self.cfg.round_timeout_s
        full = len(got) == self.m
        timed_out = (self._deadline is not None
                     and time.monotonic() >= self._deadline
                     and len(got) >= self.cfg.min_workers)
        if not (full or timed_out):
            return False
        self._process_round(r, self._pending.pop(r))
        return True

    def _process_round(self, r: int, got: Dict[int, Any]) -> None:
        t0 = time.perf_counter()
        stragglers = [i for i in range(self.m) if i not in got]
        if stragglers:
            # a timed-out worker is a dynamically-Byzantine one: zero-fill
            # its batch slot (inert — the mask makes the aggregator discard
            # whatever that slot produces) and OR it into the round's mask
            zeros = tree_map(torch.zeros_like, next(iter(got.values())))
            masks = np.array(self.sched.masks[r])
            masks[..., stragglers] = True
            self.metrics.inc("stragglers_masked", len(stragglers))
        else:
            masks = self.sched.masks[r]
        payloads = [got.get(i, zeros if stragglers else None)
                    for i in range(self.m)]
        # stacked on the host, then moved to the card from this thread
        batches = tree_map(lambda *ls: torch.stack(ls).to(self.device),
                           *payloads)
        inputs = RoundInputs(r, int(self.sched.levels[r]), batches, masks,
                             self.sched.keys[r])
        self.carry, info = self.session.step(self.carry, inputs)
        j = int(self.sched.levels[r])
        self.logs.append(RoundLog(j, info.failsafe_ok,
                                  int(np.asarray(masks)[0].sum()),
                                  round_cost(j, self.session.cfg.mlmc.j_max)))
        if not info.failsafe_ok and j >= 1:
            self.metrics.inc("failsafe_trips")
        self.metrics.inc("rounds_completed")
        self.metrics.mark_updates(len(got))
        self.metrics.set("last_round_s", round(time.perf_counter() - t0, 6))
        with self._admit:
            self._round = r + 1
            self._admit.notify_all()
        self._deadline = None
        self._log.write({"event": "round", "round": r, "level": j,
                         "workers": len(got), "stragglers": len(stragglers),
                         "failsafe_ok": info.failsafe_ok,
                         "step_s": round(time.perf_counter() - t0, 6)})
        if (self.cfg.checkpoint_every and self.cfg.checkpoint_dir
                and (r + 1) % self.cfg.checkpoint_every == 0):
            self._checkpoint()

    def _checkpoint(self) -> None:
        step = self._round
        if step == self._last_ckpt:
            return
        path = os.path.join(self.cfg.checkpoint_dir, f"carry_{step:06d}")
        save_checkpoint(path, self.carry, step=step)
        self._last_ckpt = step
        self.metrics.inc("checkpoints_written")
        self._log.write({"event": "checkpoint", "round": step, "path": path})

    # ---------------------------------------------------------- lifecycle

    def stop(self, drain: bool = True, timeout: Optional[float] = 60.0) -> bool:
        """Stop the loop. ``drain=True``: process everything already
        submitted, then write a final checkpoint (graceful, bitwise-
        resumable). ``drain=False``: kill — the in-flight round finishes,
        queued messages are dropped, NO final checkpoint (resume replays
        from the last periodic one). Returns True if the loop exited within
        ``timeout``."""
        if drain:
            self._draining.set()
        else:
            self._stop.set()
            self.ring.close()
        with self._admit:
            self._admit.notify_all()
        if self._thread is None:  # never started: no loop to wait out
            self._done.set()
            self.ring.close()
        done = self._done.wait(timeout)
        self._log.write({"event": "drained" if drain else "killed",
                         "round": self._round})
        return done

    def join(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def close(self) -> None:
        """Tear down everything (idempotent): loop, health endpoint, log."""
        if not self._done.is_set():
            self.stop(drain=False)
        if self.health is not None:
            self.health.stop()
            self.health = None
        self._log.close()

    # ------------------------------------------------------------ status

    def _status(self) -> str:
        if self.error is not None:
            return "error"
        if self._done.is_set():
            return "stopped" if self._round < self.T else "completed"
        if self._draining.is_set():
            return "draining"
        return "live"

    @property
    def round(self) -> int:
        with self._admit:
            return self._round

    def snapshot(self) -> Dict[str, Any]:
        """The health/metrics view (thread-safe; served over HTTP)."""
        snap = self.metrics.snapshot()
        snap.update(self.ring.stats())
        r = self.round
        snap.update(status=self._status(), round=r, rounds_total=self.T,
                    rounds_completed=r - self.start_round,
                    pending_rounds=len(self._pending), workers=self.m,
                    start_round=self.start_round)
        return snap

    @property
    def params(self):
        return self.carry[0]
