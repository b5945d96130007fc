"""The model zoo's GSPMD path of the port (``run_dynabro_scan`` and
``Session`` on a ``(workers, 'model')`` mesh with ``param_specs=``;
``core/sharded.ShardPlan``, ``launch/sharding.py``) on the CPU.

- In process: the (1, 1) mesh is bitwise ``mesh=None``, streamed and
  stacked, for smollm-360m and qwen2-moe-a2.7b reduced (the JAX package's
  ``tests/test_zoo_driver.py:47``, ``:63``); the port's (1, 1) run against
  the JAX package's (1, 1) run on the same numpy weights and batches (the
  port's, ``jax_run``; round logs equal, params within atol 1e-6); every
  rejection raises the JAX package's error type.
- Gloo ranks: the cases of ``tests/_torch_gspmd_ranks.py`` as 2 ranks on
  (1, 2) and (2, 1) meshes and 4 ranks on a (2, 2) mesh (subprocesses with
  a timeout, one process group a world size, a ``file://`` rendezvous under
  ``tmp_path``). Every rank returns the same params and logs, bitwise;
  round logs equal the port's ``mesh=None`` run's; params within rtol
  1e-5, atol 1e-6 of it. On the CPU every case comes out bitwise
  ``mesh=None`` but those that sum partial distances or norms in another
  order than the unsharded sum (``NOT_BITWISE``: GeoMed's Weiszfeld
  distances, AdaGrad-Norm's norm; 3e-8 to 1.2e-7 apart): the coordinate
  -wise rules, Krum's, NNM's and MFM's discrete choices and the
  elementwise optimizers see the unsharded bits, a rank's block of
  workers' gradients carrying the whole stack's bits on the CPU.
- One sharded run (4 ranks, (2, 2), ``plan_params``'s specs, streamed)
  against the JAX package's unsharded microbatched ``run_dynabro_scan`` on
  the port's weights and batches (``jax_run``: on a (1, 1) mesh the JAX
  package skips every sharding constraint, so its program is the unsharded
  one, bitwise by its own ``test_zoo_transformer_microbatch_parity_mesh11``):
  logs equal, params within rtol 1e-5, atol 1e-6.
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

import _torch_gspmd_ranks as ranks
from repro.api import session as j_session
from repro.core import mlmc as j_mlmc
from repro.core import robust_train as j_rt
from repro.core import switching as j_switching
from repro.launch import mesh as j_mesh
from repro.launch import sharding as j_sharding
from repro.models import zoo as j_zoo
from repro.optim import optimizers as j_optim
from repro_torch.api import Session, get_switcher, make_worker_mesh
from repro_torch.convert import zoo_params_from_numpy, zoo_params_to_numpy
from repro_torch.core import robust_train as t_rt
from repro_torch.core import sharded as t_sharded
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import sharding as t_sharding
from repro_torch.launch.mesh import Mesh
from repro_torch.models import make_zoo_task
from repro_torch.optim import optimizers as t_optim

RANKS_TIMEOUT_S = 120
TOL = dict(rtol=1e-5, atol=1e-6)
NOT_BITWISE = {"(1, 2) geomed stacked", "(2, 1) geomed streamed",
               "(2, 1) adagrad_norm", "(2, 2) geomed stacked",
               "(2, 2) geomed streamed"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's in-process runs on one thread, as the ranks run
    (``OMP_NUM_THREADS=1``): the models are small, and on a loaded machine
    a thread pool's workers wait on each other many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _equal(a, b) -> bool:
    """Bitwise equality of nested results (arrays by dtype and bits)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


# ------------------------------------------------- the (1, 1) mesh, in process


def _zoo_run(arch, microbatch, **kw):
    task, cfg = make_zoo_task(arch, seq_len=ranks.SEQ, d_model=ranks.D,
                              device="cpu")
    mesh = kw.pop("mesh", None)
    if mesh is not None:
        kw = dict(mesh=mesh, param_specs=t_sharding.plan_params(
            cfg, mesh, fsdp=True, dtype=torch.float32)[0])
    return t_rt.run_dynabro_scan(
        task.grad_fn, task.params0, t_optim.sgd(0.05), ranks.cfg(),
        ranks.switcher(), task.make_sampler(ranks.M), ranks.T, seed=ranks.SEED,
        microbatch=microbatch, **kw)


@pytest.mark.parametrize("microbatch", [True, False])
@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2-moe-a2.7b"])
def test_mesh_11_is_bitwise_mesh_none(arch, microbatch):
    p_u, l_u, _ = _zoo_run(arch, microbatch)
    p_s, l_s, _ = _zoo_run(arch, microbatch, mesh=make_worker_mesh(1, model=1))
    assert [vars(x) for x in l_u] == [vars(x) for x in l_s]
    assert all(torch.equal(p_u[k], p_s[k]) for k in p_u)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's microbatched ``run_dynabro_scan`` on a (1, 1)
    ``(workers, 'model')`` mesh with ``plan_params``'s specs, on the port's
    weights and batches through numpy: (round logs, params as numpy keyed
    like the port's)."""
    task, _ = ranks.zoo()
    jtask, jcfg = j_zoo.make_zoo_task(ranks.ARCH, seq_len=ranks.SEQ,
                                      d_model=ranks.D)
    jmesh = j_mesh.make_worker_mesh(1, model=1)
    jspecs, _ = j_sharding.plan_params(jcfg, jmesh, fsdp=True,
                                       dtype=jnp.float32)
    sampler = task.make_sampler(ranks.M)

    def sample(t, n):
        return {k: jnp.asarray(v.numpy()) for k, v in sampler(t, n).items()}

    cfg = j_rt.DynaBROConfig(
        mlmc=j_mlmc.MLMCConfig(T=ranks.T, m=ranks.M, V=3.0, kappa=1.0, j_cap=2),
        aggregator="cwtm", delta=0.3, attack="sign_flip")
    p, logs, _ = j_rt.run_dynabro_scan(
        jtask.grad_fn, jax.tree.map(jnp.asarray,
                                    zoo_params_to_numpy(task.params0)),
        j_optim.sgd(0.05), cfg,
        j_switching.get_switcher("periodic", ranks.M, n_byz=1, K=2), sample,
        ranks.T, seed=ranks.SEED, microbatch=True, vectorize_batches=False,
        mesh=jmesh, param_specs=jspecs)
    return ranks.logs_of(logs), {k: v.numpy() for k, v in zoo_params_from_numpy(
        jax.tree.map(np.array, p), "cpu").items()}


def test_mesh_11_matches_the_jax_mesh_11(jax_run):
    task, cfg = ranks.zoo()
    mesh = make_worker_mesh(1, model=1)
    p, logs, _ = t_rt.run_dynabro_scan(
        task.grad_fn, task.params0, t_optim.sgd(0.05), ranks.cfg(),
        ranks.switcher(), task.make_sampler(ranks.M), ranks.T,
        seed=ranks.SEED, microbatch=True, mesh=mesh,
        param_specs=t_sharding.plan_params(cfg, mesh, fsdp=True,
                                           dtype=torch.float32)[0])
    want_logs, want = jax_run
    assert ranks.logs_of(logs) == want_logs
    for k in want:
        np.testing.assert_allclose(p[k].numpy(), want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


# --------------------------------------------------------------- rejections


def _raises(call):
    try:
        call()
    except Exception as e:  # noqa: BLE001  (the type is what is compared)
        return type(e), str(e)
    return None, None


def test_rejections_match_the_jax_package():
    """Each rejection of the GSPMD path raises the JAX package's error type,
    beside the JAX package's own where one process can make its mesh."""
    task, cfg = ranks.zoo()
    jtask, jcfg = j_zoo.make_zoo_task(ranks.ARCH, seq_len=ranks.SEQ,
                                      d_model=ranks.D)
    jdcfg = j_rt.DynaBROConfig(
        mlmc=j_mlmc.MLMCConfig(T=ranks.T, m=ranks.M, V=3.0, kappa=1.0),
        aggregator="cwtm", delta=0.3)
    opt, jopt = t_optim.sgd(0.05), j_optim.sgd(0.05)
    sw = ranks.switcher()
    jsw = j_switching.get_switcher("periodic", ranks.M, n_byz=1, K=2)
    mesh11, jmesh11 = (make_worker_mesh(1, model=1),
                       j_mesh.make_worker_mesh(1, model=1))
    mesh1, jmesh1 = make_worker_mesh(1), j_mesh.make_worker_mesh(1)

    def port_run(**kw):
        return t_rt.run_dynabro_scan(task.grad_fn, task.params0, opt,
                                     ranks.cfg(), sw, task.make_sampler(ranks.M),
                                     2, **kw)

    def jax_run(**kw):
        return j_rt.run_dynabro_scan(jtask.grad_fn, jtask.params0, jopt, jdcfg,
                                     jsw, jtask.make_sampler(ranks.M), 2, **kw)

    pairs = [  # (the port's call, the JAX package's call)
        (lambda: port_run(param_specs={}), lambda: jax_run(param_specs={})),
        (lambda: port_run(mesh=mesh1, param_specs={}),
         lambda: jax_run(mesh=jmesh1, param_specs={})),
        (lambda: t_rt.run_momentum_scan(
            task.grad_fn, task.params0, ranks.cfg(), sw,
            task.make_sampler(ranks.M), 2, lr=0.1, beta=0.9, mesh=mesh11),
         lambda: j_rt.run_momentum_scan(
            jtask.grad_fn, jtask.params0, jdcfg, jsw,
            jtask.make_sampler(ranks.M), 2, lr=0.1, beta=0.9, mesh=jmesh11)),
        (lambda: t_rt.make_momentum_scan_fn(task.grad_fn, ranks.cfg(), 0.1, 0.9,
                                            mesh=mesh11),
         lambda: j_rt.make_momentum_scan_fn(jtask.grad_fn, jdcfg, 0.1, 0.9,
                                            mesh=jmesh11)),
        (lambda: Session(ranks.cfg(), grad_fn=task.grad_fn,
                         params0=task.params0, mode="momentum", lr=0.1,
                         beta=0.9, m=ranks.M, mesh=mesh11),
         lambda: j_session.Session(jdcfg, grad_fn=jtask.grad_fn,
                                   params0=jtask.params0, mode="momentum",
                                   lr=0.1, beta=0.9, m=ranks.M, mesh=jmesh11)),
        (lambda: t_rt.make_dynabro_scan_fn(task.grad_fn, ranks.cfg(), opt,
                                           mesh=mesh11,
                                           lane_attacks=("sign_flip",)),
         lambda: j_rt.make_dynabro_scan_fn(jtask.grad_fn, jdcfg, jopt,
                                           mesh=jmesh11,
                                           lane_attacks=("sign_flip",))),
        (lambda: make_worker_mesh(2, model=1),
         lambda: j_mesh.make_worker_mesh(2, model=1)),
        (lambda: t_mesh.make_test_mesh((2, 2)),
         lambda: j_mesh.make_test_mesh((2, 2))),
        (lambda: t_mesh.make_production_mesh(multi_pod=True),
         lambda: j_mesh.make_production_mesh(multi_pod=True)),
        (lambda: port_run(mesh=Mesh(("model", "workers"), (1, 1))),
         lambda: jax_run(mesh=jax.make_mesh((1, 1), ("model", "workers")))),
    ]
    for port, ref in pairs:
        (got, msg), (want, _) = _raises(port), _raises(ref)
        assert want is not None and got is want, (got, want, msg)
    # meshes one process cannot make, built by hand: m=9 on a 2-way worker
    # axis; specs that do not fit the leaves
    with pytest.raises(ValueError, match="not divisible"):
        t_rt.run_dynabro_scan(task.grad_fn, task.params0, opt, ranks.cfg(),
                              get_switcher("static", 9, n_byz=2),
                              task.make_sampler(9), 2,
                              mesh=Mesh(("workers", "model"), (2, 1)))
    plan = t_sharded.ShardPlan(Mesh(("workers", "model"), (2, 2)), "workers",
                               {"a": ("workers", "model"), "b": ("data",),
                                "c": (None, None)})
    assert plan.dims("a", 2) == (0, 1) and plan.dims("c") == (None, None)
    assert plan.full_shape("a", (5, 3, 4), 1) == (5, 6, 8)
    for key, ndim, match in (("b", 1, "not None, 'model'"),
                             ("c", 3, "entries"), ("d", 1, "no entry")):
        with pytest.raises(ValueError, match=match):
            plan.dims(key, ndim)


def test_meshes_of_one_process():
    assert make_worker_mesh(model=1) == Mesh(("workers", "model"), (1, 1))
    assert make_worker_mesh(1, axis="w", model=1).axis_names == ("w", "model")
    assert t_mesh.make_test_mesh((1, 1)).shape == {"data": 1, "model": 1}
    assert t_mesh.worker_spec(("data",)) == j_mesh.worker_spec(("data",))
    assert t_mesh.worker_spec(("pod", "data")) == j_mesh.worker_spec(
        ("pod", "data"))
    np.testing.assert_array_equal(
        t_mesh.worker_iota(5, device="cpu").numpy(),
        np.asarray(j_mesh.worker_iota(5)))


# ------------------------------------------------------------- gloo ranks

class _Group:
    """``GROUPS[world]`` run as ``world`` gloo ranks, started by the first
    ``results()``, which waits for them (a rank that fails or outlasts the
    timeout fails the test) and gives each rank's results. ``end()`` ends
    every rank still running."""

    def __init__(self, world: int, tmp: Path):
        self.world, self.tmp, self._results, self.procs = world, tmp, None, []

    def results(self) -> list:
        if self._results is None:
            env = dict(os.environ, OMP_NUM_THREADS="1")
            self.procs = [subprocess.Popen(
                [sys.executable, str(Path(ranks.__file__)), str(self.world),
                 str(r), str(self.tmp / "rendezvous"), str(self.tmp)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env) for r in range(self.world)]
            try:
                logs = [p.communicate(timeout=RANKS_TIMEOUT_S)[0]
                        for p in self.procs]
            finally:
                self.end()
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0, \
                    f"rank {r} of {self.world}:\n{log[-4000:]}"
            self._results = [pickle.loads(
                (self.tmp / f"rank{r}.pkl").read_bytes())
                for r in range(self.world)]
        return self._results

    def end(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def gloo_groups(tmp_path_factory):
    """One process group a world size, each run once, when a test first
    reads it (alone: the ranks and the in-process runs on a loaded machine
    slow each other down many times over)."""
    groups = {w: _Group(w, tmp_path_factory.mktemp(f"gspmd{w}"))
              for w in sorted(ranks.GROUPS)}
    yield groups
    for g in groups.values():
        g.end()


GLOO_CASES = [(w, name) for w in sorted(ranks.GROUPS)
              for name in ranks.GROUPS[w]]


@pytest.mark.parametrize("world,case", GLOO_CASES)
def test_gloo_ranks_equal_each_other_and_unsharded(world, case, gloo_groups):
    outs = [o[case] for o in gloo_groups[world].results()]
    for r, out in enumerate(outs[1:], 1):
        assert _equal(out, outs[0]), f"rank {r} differs from rank 0"
    got = dict(outs[0])
    fn, _ = ranks.GROUPS[world][case]
    want = fn(None)
    assert got["logs"] == want["logs"], case
    if "collectives" in got:
        counts, none = got.pop("collectives"), want.pop("collectives")
        assert none == {"param_gathers": 0, "exchanges": 0, "sums": 0}
        # a gather a round and one of the result, where a leaf is split
        split = not case.endswith("replicated")
        assert counts["param_gathers"] == (ranks.T + 1 if split else 0), counts
        workers_split = not case.startswith("(1, 2)")
        if "stacked" in case:
            units = ranks.T
        else:  # one exchange a unit
            j_max = ranks.cfg().mlmc.j_max
            units = sum(2 ** lv if 1 <= lv <= j_max else 1
                        for lv, *_ in got["logs"])
        assert counts["exchanges"] == (units if workers_split else 0), counts
    if case.endswith("session"):
        # init_carry placed the rank's blocks: half the embedding, at least
        assert got.pop("placed_numel") < want.pop("placed_numel")
        _close(got.pop("step_params"), want.pop("step_params"))
    _close(got["params"], want["params"])
    assert _equal(got, want) == (case not in NOT_BITWISE), case


def test_sharded_run_matches_the_jax_driver(gloo_groups, jax_run):
    """The 4-rank (2, 2) run on ``plan_params``'s specs (rank 0's) against
    the JAX package's unsharded microbatched run on the port's weights and
    batches."""
    got = gloo_groups[4].results()[0]["(2, 2) plan specs"]
    want_logs, want = jax_run
    assert got["logs"] == want_logs
    _close(got["params"], want)
