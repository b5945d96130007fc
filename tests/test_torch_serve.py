"""The port's aggregation service (``repro_torch.serve``) on the CPU: the
ring, metrics and health units case for case against the JAX package's
``tests/test_serve.py``; a served stream bitwise equal to the port's
``Session.run``; straggler masking bitwise equal to an offline
``Session.step`` replay with the same zero-fill and mask OR; a kill and a
resume from the last periodic checkpoint bitwise equal to ``run`` (sign_flip
and ``random``, whose generator state rides in the carry); 64 worker
threads under fast thread switching; an error on the serve thread; and the
JAX package's server beside the port's on the paired softmax tasks (round
logs equal, params within 1e-6). Every join and HTTP call has a timeout."""
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from _torch_tasks import jax_softmax, logs_of, to_numpy, torch_softmax
from repro.api import build_session as j_build_session
from repro.core import mlmc as j_mlmc
from repro.core import robust_train as j_rt
from repro.core import switching as j_switching
from repro.optim import optimizers as j_optim
from repro.serve import AggregationServer as JAggregationServer
from repro.serve import ServeConfig as JServeConfig
from repro.serve import SimulatedWorkers as JSimulatedWorkers
from repro.serve import worker_payloads as j_worker_payloads
from repro_torch.api import build_session
from repro_torch.checkpoint import latest_checkpoint
from repro_torch.core.mlmc import MLMCConfig
from repro_torch.core.robust_train import DynaBROConfig
from repro_torch.core.scenarios import make_quadratic_task
from repro_torch.core.switching import get_switcher
from repro_torch.optim.optimizers import adagrad_norm, sgd
from repro_torch.serve import (
    AggregationServer, HealthEndpoint, MetricsLog, RingBuffer, ServeConfig,
    ServeMetrics, SimulatedWorkers, worker_payloads,
)

TASK = make_quadratic_task(device="cpu")
M, T, SEED = 16, 12, 11
JOIN_S = 30.0  # every join and wait below: no test relies on a plugin timeout


def _session(attack="sign_flip", kwargs=None, m=M, T_=T, seed=SEED):
    cfg = DynaBROConfig(mlmc=MLMCConfig(T=T_, m=m, V=3.0, kappa=1.0, j_cap=2),
                        aggregator="cwmed", delta=0.4, attack=attack,
                        attack_kwargs=kwargs)
    switcher = get_switcher("periodic", m, n_byz=m // 4, K=4, seed=seed)
    return build_session(cfg, TASK, switcher=switcher,
                         opt=adagrad_norm(2e-2), seed=seed)


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _serve(server, workers):
    """Start ``server`` and ``workers``; wait for both to finish."""
    server.start()
    workers.start()
    assert workers.join(timeout=JOIN_S) and not workers.failures
    assert server.join(timeout=JOIN_S), server.snapshot()


# --------------------------------------------------------------- ring


def test_ring_fifo_and_high_water():
    ring = RingBuffer(4)
    for i in range(3):
        assert ring.put(i)
    assert [ring.get() for _ in range(3)] == [0, 1, 2]
    st = ring.stats()
    assert st["ring_pushed"] == 3 and st["ring_high_water"] == 3
    assert st["ring_depth"] == 0 and st["ring_rejected"] == 0


def test_ring_overflow_backpressure():
    """A full ring blocks the producer; past the timeout the put is rejected
    (False + counted), never silently dropped or overwritten."""
    ring = RingBuffer(2)
    assert ring.put("a") and ring.put("b")
    t0 = time.monotonic()
    assert ring.put("c", timeout=0.1) is False
    assert time.monotonic() - t0 >= 0.09
    assert ring.stats()["ring_rejected"] == 1
    unblocked = []
    th = threading.Thread(
        target=lambda: unblocked.append(ring.put("c", timeout=5.0)))
    th.start()
    assert ring.get() == "a"
    th.join(5.0)
    assert unblocked == [True]
    assert ring.get() == "b" and ring.get() == "c"


def test_ring_close_wakes_waiters_and_drains():
    ring = RingBuffer(1)
    assert ring.put("x")
    results = []
    producer = threading.Thread(
        target=lambda: results.append(ring.put("y", timeout=10.0)))
    producer.start()
    time.sleep(0.05)
    ring.close()
    producer.join(5.0)
    assert results == [False]
    assert ring.get() == "x"
    assert ring.get(timeout=0.01) is None
    assert ring.put("z") is False
    with pytest.raises(ValueError, match="capacity"):
        RingBuffer(0)


# ----------------------------------------------------- metrics / health


def test_metrics_counters_window_and_log(tmp_path):
    m = ServeMetrics(window_s=60.0)
    m.inc("updates_accepted", 3)
    m.mark_updates(3)
    m.observe_staleness(0.2)
    m.observe_staleness(0.4)
    snap = m.snapshot()
    assert snap["updates_accepted"] == 3
    assert snap["updates_per_sec"] > 0
    assert snap["staleness_mean_s"] == pytest.approx(0.3)
    assert snap["staleness_max_s"] == pytest.approx(0.4)

    path = tmp_path / "metrics.jsonl"
    log = MetricsLog(str(path))
    log.write({"event": "round", "round": 0})
    log.close()
    [rec] = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert rec["event"] == "round" and "ts" in rec
    MetricsLog(None).write({"noop": True})


def test_health_endpoint_routes():
    ep = HealthEndpoint(lambda: {"status": "live", "round": 4,
                                 "rounds_total": 8, "extra": 1.5})
    assert ep.host == "127.0.0.1" and ep.port > 0
    ep.start()
    try:
        with urllib.request.urlopen(ep.url + "/health", timeout=5) as r:
            health = json.load(r)
        assert health == {"status": "live", "round": 4, "rounds_total": 8}
        with urllib.request.urlopen(ep.url + "/metrics", timeout=5) as r:
            assert json.load(r)["extra"] == 1.5
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(ep.url + "/nope", timeout=5)
        assert ei.value.code == 404
    finally:
        ep.stop()


def test_health_endpoint_reports_a_failing_snapshot():
    def boom():
        raise RuntimeError("no snapshot")

    ep = HealthEndpoint(boom)
    ep.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(ep.url + "/health", timeout=5)
        assert ei.value.code == 500
        assert json.load(ei.value)["status"] == "error"
    finally:
        ep.stop()


# ------------------------------------------------------------- server


def test_submit_validation_and_lookahead_backpressure():
    """Far-future rounds block in admission and time out as backpressure;
    invalid ids are rejected outright. No loop runs, so the round stays 0."""
    sess = _session()
    server = AggregationServer(sess, T, ServeConfig(lookahead_rounds=2))
    payload = worker_payloads(sess, T)[0][0]
    assert payload.device.type == "cpu"
    assert server.submit(-1, 0, payload) is False
    assert server.submit(0, T, payload) is False
    assert server.submit(0, 0, payload, timeout=1.0) is True
    t0 = time.monotonic()
    assert server.submit(0, 2, payload, timeout=0.15) is False
    assert time.monotonic() - t0 >= 0.1
    snap = server.snapshot()
    assert snap["updates_invalid"] == 2
    assert snap["updates_backpressured"] == 1
    assert snap["status"] == "live" and snap["round"] == 0
    server.close()
    assert server.submit(0, 0, payload) is False


def test_worker_payloads_reassemble_the_round_inputs():
    sess = _session()
    sched = sess.schedule(T)
    rounds = worker_payloads(sess, T, start=3)
    assert len(rounds) == T - 3 and all(len(r) == M for r in rounds)
    for off, per_worker in enumerate(rounds):
        want = sess.round_inputs(sched, 3 + off).batches
        assert torch.equal(torch.stack(per_worker), want)


def test_stream_matches_offline_driver_bitwise(tmp_path):
    """A 16-worker stream with submission jitter (cross-round reordering)
    gives params bitwise equal to ``Session.run``, its round logs, the
    health progress over HTTP and a metrics trail."""
    params_ref, logs_ref, _ = _session().run(T)

    sess = _session()
    log_path = tmp_path / "serve.jsonl"
    server = AggregationServer(sess, T, ServeConfig(
        capacity=64, lookahead_rounds=4, health_port=0,
        metrics_log=str(log_path)))
    _serve(server, SimulatedWorkers(server, worker_payloads(sess, T),
                                    jitter_s=0.002))
    with urllib.request.urlopen(server.health.url + "/health",
                                timeout=5) as r:
        health = json.load(r)
    server.close()
    assert server.error is None
    assert health["status"] == "completed"
    assert health["round"] == T and health["rounds_completed"] == T
    assert health["updates_accepted"] == M * T

    _equal(server.params, params_ref)
    assert server.logs == logs_ref
    events = [json.loads(ln) for ln in log_path.read_text().splitlines()]
    rounds = [e for e in events if e["event"] == "round"]
    assert [e["round"] for e in rounds] == list(range(T))
    assert all(e["workers"] == M and e["stragglers"] == 0 for e in rounds)


def test_straggler_timeout_masks_as_byzantine():
    """Workers that miss the round deadline are ORed into that round's
    Byzantine mask with a zero-filled batch slot: bitwise equal to an
    offline ``Session.step`` replay of the same masking."""
    drop = {(2, 3), (9, 3), (5, 7)}
    sess = _session()
    sched = sess.schedule(T)

    carry = sess.init_carry()
    for t in range(T):
        inp = sess.round_inputs(sched, t)
        dropped = [w for w, r in drop if r == t]
        if dropped:
            masks = np.array(inp.masks)
            masks[..., dropped] = True
            inp.masks = masks
            keep = torch.tensor([w not in dropped for w in range(M)])
            inp.batches = torch.where(
                keep.reshape((-1,) + (1,) * (inp.batches.ndim - 1)),
                inp.batches, torch.zeros_like(inp.batches))
        carry, _ = sess.step(carry, inp)

    server = AggregationServer(_session(), T, ServeConfig(
        round_timeout_s=0.25, min_workers=1))
    _serve(server, SimulatedWorkers(server, worker_payloads(sess, T),
                                    drop=drop))
    snap = server.snapshot()
    server.close()
    assert server.error is None
    assert snap["stragglers_masked"] == len(drop)
    assert snap["updates_accepted"] == M * T - len(drop)
    _equal(server.params, carry[0])
    for t, dropped in ((3, [2, 9]), (7, [5])):
        expected = np.logical_or(sched.masks[t][0],
                                 np.isin(np.arange(M), dropped))
        assert server.logs[t].n_byz == int(expected.sum())


@pytest.mark.parametrize("attack,kwargs", [("sign_flip", None),
                                           ("random", {"scale": 2.0})])
def test_kill_resume_is_bitwise(tmp_path, attack, kwargs):
    """Periodic checkpoints every 4 rounds, a kill after round 6, a resume
    from round 4: bitwise equal to ``run``; a graceful drain then leaves a
    final checkpoint at T."""
    params_ref, _, _ = _session(attack, kwargs).run(T)
    ckpt_dir = str(tmp_path / "ckpts")
    cfg = ServeConfig(checkpoint_every=4, checkpoint_dir=ckpt_dir)

    sess = _session(attack, kwargs)
    payloads = worker_payloads(sess, T)
    server = AggregationServer(sess, T, cfg)
    server.start()
    assert SimulatedWorkers(server, payloads[:6]).start().join(timeout=JOIN_S)
    deadline = time.monotonic() + JOIN_S
    while server.round < 6 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert server.round == 6, server.snapshot()
    assert server.stop(drain=False, timeout=JOIN_S)
    assert server.snapshot()["status"] == "stopped"
    server.close()
    found = latest_checkpoint(ckpt_dir, prefix="carry_")
    assert found is not None and found[1] == 4

    sess2 = _session(attack, kwargs)
    resumed = AggregationServer.resume(sess2, T, cfg)
    assert resumed.start_round == 4
    _serve(resumed, SimulatedWorkers(resumed, worker_payloads(sess2, T, start=4),
                                     start_round=4))
    assert resumed.stop(drain=True, timeout=JOIN_S)
    resumed.close()
    assert resumed.error is None

    _equal(resumed.params, params_ref)
    assert latest_checkpoint(ckpt_dir, prefix="carry_")[1] == T
    assert AggregationServer.resume(_session(attack, kwargs), T,
                                    cfg).start_round == T
    with pytest.raises(ValueError, match="checkpoint_dir"):
        AggregationServer.resume(sess2, T, ServeConfig())


def test_many_workers_under_fast_thread_switching():
    """64 worker threads (more than the cores) into a 16-slot ring with a
    2-round lookahead, the interpreter switching threads every 10 µs: every
    update counted once, none lost or duplicated, and the params bitwise
    equal to ``run``."""
    m, T_ = 64, 4
    params_ref, _, _ = _session(m=m, T_=T_).run(T_)
    sess = _session(m=m, T_=T_)
    server = AggregationServer(sess, T_, ServeConfig(capacity=16,
                                                     lookahead_rounds=2))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        _serve(server, SimulatedWorkers(server, worker_payloads(sess, T_)))
    finally:
        sys.setswitchinterval(interval)
    snap = server.snapshot()
    server.close()
    assert server.error is None
    assert snap["updates_accepted"] == snap["ring_pushed"] == m * T_, snap
    assert "updates_duplicate" not in snap and snap["ring_high_water"] <= 16
    _equal(server.params, params_ref)


def test_an_error_on_the_serve_thread_sets_error_status():
    """A round that raises stops the loop: ``error`` holds the exception and
    the status reads "error"."""
    sess = _session()
    server = AggregationServer(sess, T, ServeConfig())
    bad = [[torch.zeros(3)] * M]  # the wrong shape for the round's batch
    server.start()
    SimulatedWorkers(server, bad).start().join(timeout=JOIN_S)
    assert server.join(timeout=JOIN_S)
    assert server.error is not None
    assert server.snapshot()["status"] == "error"
    server.close()
    with pytest.raises(ValueError, match="worker count"):
        AggregationServer(build_session(sess.cfg, TASK, opt=sgd(0.1)), T)


# ------------------------------------------------------- against JAX

JM, JT, JSEED = 7, 8, 5


def _softmax_sessions():
    kw = dict(aggregator="cwtm", delta=3 / JM + 1e-3, attack="sign_flip")
    mlmc = dict(T=JT, m=JM, V=2.0, j_cap=2)
    sw = dict(n_byz=3, K=3, seed=JSEED)
    ts = build_session(DynaBROConfig(mlmc=MLMCConfig(**mlmc), **kw),
                       torch_softmax(), opt=sgd(0.1), seed=JSEED,
                       switcher=get_switcher("periodic", JM, **sw))
    js = j_build_session(j_rt.DynaBROConfig(mlmc=j_mlmc.MLMCConfig(**mlmc), **kw),
                         jax_softmax(), opt=j_optim.sgd(0.1), seed=JSEED,
                         switcher=j_switching.get_switcher("periodic", JM, **sw))
    return ts, js


def test_server_equals_jax_server():
    """The JAX package's server and the port's, fed the same numpy index
    units: equal round logs, params within 1e-6."""
    ts, js = _softmax_sessions()
    t_server = AggregationServer(ts, JT, ServeConfig(lookahead_rounds=3))
    _serve(t_server, SimulatedWorkers(t_server, worker_payloads(ts, JT),
                                      jitter_s=0.001))
    j_server = JAggregationServer(js, JT, JServeConfig(lookahead_rounds=3))
    j_server.start()
    j_workers = JSimulatedWorkers(j_server, j_worker_payloads(js, JT),
                                  jitter_s=0.001).start()
    assert j_workers.join(timeout=JOIN_S) and not j_workers.failures
    assert j_server.join(timeout=JOIN_S), j_server.snapshot()
    t_server.close()
    j_server.close()
    assert t_server.error is None and j_server.error is None
    assert logs_of(t_server.logs) == logs_of(j_server.logs)
    want = to_numpy(j_server.params)
    for k in want:
        np.testing.assert_allclose(t_server.params[k].numpy(), want[k],
                                   rtol=0, atol=1e-6, err_msg=k)
    assert t_server.snapshot()["updates_accepted"] == \
        j_server.snapshot()["updates_accepted"] == JM * JT
