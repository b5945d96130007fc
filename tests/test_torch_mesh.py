"""Mode A's multi-device drivers of the port (``mesh=``, ``sweep_mesh=``,
``lane_mesh=``; ``repro_torch.launch.mesh``, ``core/sharded.py``) on the
CPU, and the ``Aggregator`` surface they brought (``coordinate_wise``,
``leaf``, ``__call__``) against the JAX package.

- In process: a mesh of one device (``make_worker_mesh(1)``, a ``(1, 1)``
  lane mesh) is bitwise ``mesh=None`` on every path, and every rejection of
  the JAX package's mesh tests raises the JAX package's error type.
- Gloo ranks: the cases of ``tests/_torch_mesh_ranks.py`` run as 2 and 4
  ranks of a gloo group (subprocesses with a timeout, a ``file://``
  rendezvous under ``tmp_path``); every rank returns the same result, bitwise
  the unsharded run's in this process: on the CPU the per-worker gradients
  of a block of workers carry the bits of the whole stack's.
- One sharded run against the JAX package's unsharded ``run_dynabro_scan``
  on the same numpy noise: round logs equal, params within atol 1e-6 (the
  tolerance of ``tests/test_torch_scan_driver.py``).
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from _torch_tasks import jax_quadratic
from repro.core import aggregators as j_agg  # noqa: F401  (registers rules)
from repro.core import agg_engine as j_engine
from repro.core import mlmc as j_mlmc
from repro.core import robust_train as j_rt
from repro.core import switching as j_switching
from repro.optim import optimizers as j_optim
from repro_torch.api import (
    SweepSpec, build_session, get_switcher, make_dynabro_scan_fn,
    make_lane_mesh, make_quadratic_task, make_worker_mesh, run_dynabro_scan,
    run_dynabro_scan_sweep,
)
from repro_torch.core import agg_engine as t_engine
from repro_torch.core import aggregators as t_agg  # noqa: F401
from repro_torch.core import robust_train as t_rt
from repro_torch.launch.mesh import Mesh
from repro_torch.optim import optimizers as t_optim

RANKS_TIMEOUT_S = 120
TOL = dict(rtol=1e-5, atol=1e-6)


def _equal(a, b) -> bool:
    """Bitwise equality of nested results (arrays by dtype and bits)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


# ------------------------------------------------- one device, in process

ONE_DEVICE = {
    **{f"{agg} {atk}": (lambda mesh, agg=agg, atk=atk: ranks.dynabro(
        mesh, agg, atk), lambda: make_worker_mesh(1))
       for agg in ("cwtm", "geomed") for atk in ("sign_flip", "ipm", "alie")},
    "microbatch": (lambda mesh: ranks.dynabro(mesh, microbatch=True),
                   lambda: make_worker_mesh(1)),
    "momentum": (ranks.momentum, lambda: make_worker_mesh(1)),
    "run_scenario": (ranks.scenario, lambda: make_worker_mesh(1)),
    "Session.run and step": (ranks.session, lambda: make_worker_mesh(1)),
    "Session.sweep": (ranks.sweep, lambda: make_lane_mesh(1, 1)),
    "run_dynabro_scan_sweep": (ranks.sweep_driver,
                               lambda: make_lane_mesh(1, 1)),
    "Session.sweep_halving": (ranks.halving, lambda: make_lane_mesh(1, 1)),
    "run_matrix": (ranks.matrix, lambda: make_lane_mesh(1, 1)),
}


@pytest.mark.parametrize("case", sorted(ONE_DEVICE))
def test_one_device_mesh_is_bitwise(case):
    fn, mesh = ONE_DEVICE[case]
    got = fn(mesh())
    assert _equal(got, fn(None)), case
    if isinstance(got, dict) and "gathers" in got:
        assert got["gathers"] == 0  # a block of one device is the stack


def test_meshes_of_one_process():
    """Without a process group there is one rank: one-device meshes only,
    refused larger as the JAX package refuses more devices than it has."""
    assert make_worker_mesh() == make_worker_mesh(1) == Mesh(("workers",), (1,))
    assert make_lane_mesh(1, 1).shape == {"lanes": 1, "workers": 1}
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_worker_mesh(2)
    with pytest.raises(ValueError, match="requested 2x1 devices, have 1"):
        make_lane_mesh(2, 1)
    with pytest.raises(ValueError, match="n_workers"):
        make_lane_mesh(1, 0)
    assert make_worker_mesh(1, model=1) == Mesh(("workers", "model"), (1, 1))
    with pytest.raises(ValueError, match="requested 1x2 devices, have 1"):
        make_worker_mesh(model=2)


# --------------------------------------------------------------- rejections

def _quad_args(m=ranks.M):
    task = make_quadratic_task(device="cpu")
    return task.grad_fn, task.params0, task.make_sampler(m)


def _run(mesh, m=ranks.M, **kw):
    grad_fn, params0, sampler = _quad_args(m)
    return run_dynabro_scan(
        grad_fn, params0, t_optim.sgd(2e-2), ranks.cfg("cwmed"),
        get_switcher("static", m, n_byz=2), sampler, 8, mesh=mesh, **kw)


def _jax_run(mesh, **kw):
    task = jax_quadratic()
    cfg = j_rt.DynaBROConfig(
        mlmc=j_mlmc.MLMCConfig(T=ranks.T, m=ranks.M, V=3.0, kappa=1.0),
        aggregator="cwmed", delta=0.3)
    return j_rt.run_dynabro_scan(
        task.grad_fn, task.params0, j_optim.sgd(2e-2), cfg,
        j_switching.get_switcher("static", ranks.M, n_byz=2),
        task.make_sampler(ranks.M), 8, mesh=mesh, **kw)


def _raises(call):
    try:
        call()
    except Exception as e:  # noqa: BLE001  (the type is what is compared)
        return type(e), str(e)
    return None, None


def test_rejections_match_the_jax_package():
    """``test_sharded_rejects_bad_meshes``, ``test_lane_mesh_validation``,
    ``test_lane_mesh_rejects_indivisible_lane_count`` and
    ``test_scan_driver_rejects_mesh_mismatched_scan_fn``: each rejection
    raises the JAX package's error type, here beside the JAX package's own
    where one process can make its mesh."""
    def jax_sess():
        from repro.api.session import Session
        task = jax_quadratic()
        cfg = j_rt.DynaBROConfig(
            mlmc=j_mlmc.MLMCConfig(T=ranks.T, m=ranks.M, V=3.0, kappa=1.0),
            aggregator="cwmed", delta=0.45)
        return Session(cfg, grad_fn=task.grad_fn, params0=task.params0,
                       opt=j_optim.sgd(2e-2), m=ranks.M,
                       sample_batches=task.make_sampler(ranks.M), seed=0)

    spec = SweepSpec(switchers=ranks.SWEEP_SWITCHERS)
    from repro.api.specs import SweepSpec as JSweepSpec
    jspec = JSweepSpec(switchers=ranks.SWEEP_SWITCHERS)
    pairs = [  # (the port's call, the JAX package's call)
        (lambda: _run(Mesh(("data", "model"), (1, 1))),
         lambda: _jax_run(jax.make_mesh((1, 1), ("data", "model")))),
        (lambda: ranks.sweep_session().sweep(spec, ranks.SWEEP_T,
                                             lane_mesh=Mesh(("data",), (1,))),
         lambda: jax_sess().sweep(jspec, ranks.SWEEP_T,
                                  lane_mesh=jax.make_mesh((1,), ("data",)))),
    ]
    for port, ref in pairs:
        (got, msg), (want, _) = _raises(port), _raises(ref)
        assert want is not None and got is want, (got, want, msg)
    # meshes one process cannot make, built by hand (no group is needed to
    # refuse them): m=9 on a 2-way worker axis, 4 cells on a 3-way lane axis
    with pytest.raises(ValueError, match="not divisible"):
        _run(Mesh(("workers",), (2,)), m=9)
    with pytest.raises(ValueError, match="divisible"):
        ranks.sweep_session().sweep(spec, ranks.SWEEP_T,
                                    lane_mesh=Mesh(("lanes", "workers"), (3, 1)))
    with pytest.raises(ValueError, match="divisible"):
        ranks.sweep_session().sweep_halving(
            spec, ranks.SWEEP_T, objective=lambda p: 0.0,
            lane_mesh=Mesh(("lanes", "workers"), (3, 1)))


def test_scan_fn_mesh_mismatch_is_refused():
    """An unsharded prebuilt scan_fn passed with mesh= (or a sharded one
    without) would silently run the other way; the exclusive keywords."""
    grad_fn, params0, sampler = _quad_args()
    cfg, opt = ranks.cfg("cwmed"), t_optim.sgd(2e-2)
    mesh = make_worker_mesh(1)
    plain_fn = make_dynabro_scan_fn(grad_fn, cfg, opt)
    shard_fn = make_dynabro_scan_fn(grad_fn, cfg, opt, mesh=mesh)
    assert shard_fn.worker_mesh == mesh and plain_fn.worker_mesh is None
    with pytest.raises(ValueError, match="mesh"):
        _run(mesh, scan_fn=plain_fn)
    with pytest.raises(ValueError, match="mesh"):
        _run(None, scan_fn=shard_fn)
    sw = get_switcher("static", ranks.M, n_byz=2)
    with pytest.raises(ValueError, match="unsharded"):
        run_dynabro_scan_sweep(grad_fn, params0, opt, cfg, [sw], sampler, 8,
                               scan_fn=shard_fn)
    lanes = make_lane_mesh(1, 1)
    with pytest.raises(ValueError, match="exclusive"):
        make_dynabro_scan_fn(grad_fn, cfg, opt, mesh=mesh, sweep_mesh=lanes)
    with pytest.raises(ValueError, match="microbatch"):
        make_dynabro_scan_fn(grad_fn, cfg, opt, sweep_mesh=lanes,
                             microbatch=True)
    with pytest.raises(ValueError, match="drop mesh="):
        make_dynabro_scan_fn(grad_fn, cfg, opt, mesh=mesh,
                             lane_attacks=("sign_flip",))
    # a sweep scan_fn of another lane mesh than the sweep's
    sweep_fn = make_dynabro_scan_fn(
        grad_fn, cfg, opt, sweep_mesh=Mesh(("lanes", "workers"), (2, 1)))
    with pytest.raises(ValueError, match="sweep_mesh"):
        ranks.sweep_session().sweep(
            SweepSpec(switchers=ranks.SWEEP_SWITCHERS, scan_fn=sweep_fn),
            ranks.SWEEP_T)
    sess = build_session(cfg, make_quadratic_task(device="cpu"),
                               m=ranks.M, opt=opt, switcher=sw, mesh=mesh)
    with pytest.raises(ValueError, match="legacy"):
        sess.run(4, driver="legacy")
    # param_specs= is the (workers, 'model') mesh's: the JAX package's error
    with pytest.raises(ValueError, match="param_specs"):
        _run(mesh, param_specs={})


def test_schedule_rows_are_narrowed_as_drawn():
    """``_batch_schedule(row_fn=)``, as a rank draws its schedule: each
    round narrowed before it is written gives the full schedule's block of
    workers, the padding and a nested leaf included."""
    def sample(t, n):
        gen = torch.Generator().manual_seed(t)
        return {"x": torch.randn(ranks.M, n, 3, generator=gen),
                "extra": {"y": torch.randn(ranks.M, n, generator=gen)}}

    def block(row):
        return {"x": row["x"][4:], "extra": {"y": row["extra"]["y"][4:]}}

    tn = [(0, 1), (1, 4), (2, 2)]
    full = t_rt._batch_schedule(sample, tn, 4)
    part = t_rt._batch_schedule(sample, tn, 4, row_fn=block)
    assert part["x"].shape == (3, ranks.M - 4, 4, 3)
    assert torch.equal(part["x"], full["x"][:, 4:])
    assert torch.equal(part["extra"]["y"], full["extra"]["y"][:, 4:])


# ------------------------------------------------------ Aggregator surface

def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("rule", ["mean", "cwmed", "cwtm"])
def test_coordinate_wise_leaf_matches_jax(rule):
    x = _normal(1, (9, 3, 5))
    j = j_engine.get_aggregator(rule, delta=0.3, backend="ref")
    t = t_engine.get_aggregator(rule, delta=0.3)
    assert j.coordinate_wise and t.coordinate_wise
    got = t.leaf(torch.from_numpy(x))
    assert got.shape == (3, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(j.leaf(jnp.asarray(x))),
                               **TOL)


@pytest.mark.parametrize("rule", ["mean", "cwmed", "cwtm", "krum", "geomed",
                                  "nnm+cwtm"])
def test_call_on_a_matrix_matches_jax(rule):
    x = _normal(2, (9, 40))
    j = j_engine.get_aggregator(rule, delta=0.3, backend="ref")
    t = t_engine.get_aggregator(rule, delta=0.3)
    got = t(torch.from_numpy(x).double())  # cast to float32, as JAX's is
    assert got.dtype == torch.float32 and got.shape == (40,)
    np.testing.assert_allclose(got.numpy(), np.asarray(j(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rule", ["krum", "geomed", "nnm+cwtm", "mfm"])
def test_geometry_rules_refuse_leaf(rule):
    j = j_engine.get_aggregator(rule, delta=0.3, backend="ref")
    t = t_engine.get_aggregator(rule, delta=0.3)
    assert not j.coordinate_wise and not t.coordinate_wise
    x = _normal(3, (9, 4))
    with pytest.raises(NotImplementedError) as want:
        j.leaf(jnp.asarray(x))
    with pytest.raises(NotImplementedError) as got:
        t.leaf(torch.from_numpy(x))
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------- gloo ranks

_RESULTS = {}


def _spawn(world: int, tmp: Path) -> list:
    """Run ``GROUPS[world]`` as ``world`` gloo ranks; each rank's results.
    A rank that fails or outlasts the timeout fails the test, and every
    rank is ended."""
    script = Path(ranks.__file__)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(world), str(r),
         str(tmp / "rendezvous"), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=RANKS_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world}:\n{log[-4000:]}"
    return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def _ranks(world, tmp_path_factory):
    if world not in _RESULTS:
        _RESULTS[world] = _spawn(world, tmp_path_factory.mktemp(f"gloo{world}"))
    return _RESULTS[world]


GLOO_CASES = [(w, name) for w in sorted(ranks.GROUPS)
              for name in ranks.GROUPS[w]]


@pytest.mark.parametrize("world,case", GLOO_CASES)
def test_gloo_ranks_equal_each_other_and_unsharded(world, case,
                                                   tmp_path_factory):
    outs = [o[case] for o in _ranks(world, tmp_path_factory)]
    for r, out in enumerate(outs[1:], 1):
        assert _equal(out, outs[0]), f"rank {r} differs from rank 0"
    got = outs[0]
    fn, _ = ranks.GROUPS[world][case]
    if case == "rejects m=9":
        assert got is not None and "not divisible" in got, got
        return
    want = fn(None)
    if isinstance(got, dict) and "gathers" in got:
        # one worker gather a round, or a unit on the streamed path
        j_max = ranks.cfg().mlmc.j_max
        n = (sum(2 ** lv if 1 <= lv <= j_max else 1 for lv, *_ in got["logs"])
             if case == "microbatch" else ranks.T)
        assert (got.pop("gathers"), want.pop("gathers")) == (n, 0), case
        # a rank's schedules hold its block of workers only
        assert (got.pop("schedule_workers"), want.pop("schedule_workers")) \
            == ([ranks.M // world], [ranks.M]), case
    assert _equal(got, want), case


def test_sharded_run_matches_the_jax_driver(tmp_path_factory):
    """The 2-rank CWTM run under sign_flip (rank 0's) against the JAX
    package's unsharded ``run_dynabro_scan`` on the same numpy noise."""
    got = _ranks(2, tmp_path_factory)[0]["cwtm sign_flip"]
    task = jax_quadratic()
    cfg = j_rt.DynaBROConfig(
        mlmc=j_mlmc.MLMCConfig(T=ranks.T, m=ranks.M, V=3.0, kappa=1.0),
        aggregator="cwtm", delta=0.3, attack="sign_flip", agg_backend="ref")
    p, logs, _ = j_rt.run_dynabro_scan(
        task.grad_fn, task.params0, j_optim.sgd(2e-2), cfg,
        j_switching.get_switcher("periodic", ranks.M, n_byz=2, K=7),
        task.make_sampler(ranks.M), ranks.T, seed=ranks.SEED,
        vectorize_batches=False)
    assert got["logs"] == ranks.logs_of(logs)
    np.testing.assert_allclose(got["params"]["x"], np.asarray(p["x"]),
                               rtol=0, atol=1e-6)
