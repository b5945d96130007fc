"""Serve smoke test — ``PYTHONPATH=src python -m repro_torch.serve.smoke``,
the port of the JAX package's ``repro.serve.smoke``.

Launches the aggregation server on App. E's 2D quadratic testbed with 16
simulated workers (CWMed, sign_flip under Periodic(5), adagrad_norm(2e-2),
T=32), pushes 512 updates through the ring, polls the HTTP health endpoint
until the stream completes, asserts the served carry is bitwise identical
to the offline compiled driver (``Session.run``), and shuts down cleanly.
It runs on the card by default and raises without one; ``--device cpu``
runs it on the CPU. Exit code 0 on success.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
import urllib.request

import torch

from repro_torch.api import build_session
from repro_torch.core.mlmc import MLMCConfig
from repro_torch.core.robust_train import DynaBROConfig
from repro_torch.core.scenarios import make_quadratic_task
from repro_torch.core.switching import get_switcher
from repro_torch.optim.optimizers import adagrad_norm
from repro_torch.serve import AggregationServer, ServeConfig, SimulatedWorkers
from repro_torch.serve.client import worker_payloads

M, T, SEED = 16, 32, 7


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: cuda)")
    args = ap.parse_args(argv)
    task = make_quadratic_task(device=args.device)
    cfg = DynaBROConfig(mlmc=MLMCConfig(T=T, m=M, V=3.0, kappa=1.0, j_cap=2),
                        aggregator="cwmed", delta=0.4, attack="sign_flip")
    switcher = get_switcher("periodic", M, n_byz=4, K=5, seed=SEED)

    def session():
        return build_session(cfg, task, switcher=switcher,
                             opt=adagrad_norm(2e-2), seed=SEED)

    # offline reference: the whole-T compiled driver on the same session
    params_ref, logs_ref, _ = session().run(T)

    sess = session()
    with tempfile.NamedTemporaryFile(mode="r", suffix=".jsonl") as logf:
        server = AggregationServer(sess, T, ServeConfig(
            capacity=256, lookahead_rounds=4, health_port=0,
            metrics_log=logf.name))
        payloads = worker_payloads(sess, T)
        server.start()
        workers = SimulatedWorkers(server, payloads, jitter_s=0.002).start()
        url = server.health.url

        deadline = time.monotonic() + 120.0
        health = {}
        while time.monotonic() < deadline:
            with urllib.request.urlopen(url + "/health", timeout=5) as r:
                health = json.load(r)
            assert health["status"] in ("live", "draining", "completed"), health
            if health["round"] >= T:
                break
            time.sleep(0.05)
        assert health.get("round") == T, f"stream stalled: {health}"
        assert health["rounds_completed"] == T, health
        assert health["updates_accepted"] == M * T, health

        if not workers.join(timeout=30.0) or workers.failures:
            print(f"worker failures: {workers.failures}", file=sys.stderr)
            return 1
        server.stop(drain=True)
        snap = server.snapshot()
        events = [json.loads(ln) for ln in logf.readlines() if ln.strip()]
        server.close()

    if server.error is not None:
        print(f"server error: {server.error!r}", file=sys.stderr)
        return 1
    assert torch.equal(server.params["x"], params_ref["x"]), \
        (server.params, params_ref)
    assert [(lg.level, lg.failsafe_ok) for lg in server.logs] == \
           [(lg.level, lg.failsafe_ok) for lg in logs_ref]
    assert sum(1 for e in events if e.get("event") == "round") == T
    print(f"serve smoke OK on {server.device}: {T} rounds x {M} workers "
          f"bitwise == offline driver; {snap['updates_per_sec']:.0f} "
          f"updates/s, ring high-water {snap['ring_high_water']}/"
          f"{snap['ring_capacity']}, staleness mean "
          f"{snap['staleness_mean_s'] * 1e3:.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
