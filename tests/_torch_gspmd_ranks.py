"""The cases of ``tests/test_torch_gspmd.py``: the port's GSPMD path
(``run_dynabro_scan`` on a ``(workers, 'model')`` mesh with
``param_specs=``, ``Session``) on the JAX package's
``tests/test_zoo_driver.py`` setting: SmolLM-360M reduced to d_model 32
and 2 layers, seq_len 8, m=4, T=8, CWTM at delta 0.3 under sign_flip and
``periodic(n_byz=1, K=2)``, seed 3, sgd(0.05), ``j_cap=2``; each case a
function of the mesh it runs on (None: unsharded).

Specs: ``"plan"`` is ``launch.sharding.plan_params(fsdp=True)``'s (at this
width it splits the embedding over 'model' only: its size thresholds keep
the rest whole); ``"every"`` (``every_leaf``) splits every leaf it can over
both axes, so each path of ``core/sharded.ShardPlan`` runs at this size;
None replicates the params.

Run as a script, it is one rank of a gloo group:

    python tests/_torch_gspmd_ranks.py <world> <rank> <init file> <out dir>

It runs every case of ``GROUPS[world]`` and pickles ``{case: result}`` to
``<out dir>/rank<rank>.pkl``. It imports the port only, never JAX.
"""
import os
import pickle
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.api import (  # noqa: E402
    DynaBROConfig, MLMCConfig, Session, get_switcher, make_worker_mesh,
    run_dynabro_scan,
)
from repro_torch.core import sharded  # noqa: E402
from repro_torch.launch.sharding import abstract_params, plan_params  # noqa: E402
from repro_torch.models import make_zoo_task  # noqa: E402
from repro_torch.optim.optimizers import get_optimizer  # noqa: E402

ARCH, M, T, SEQ, D, SEED = "smollm-360m", 4, 8, 8, 32, 3
LR = {"sgd": 0.05, "momentum": 0.05, "adam": 1e-3, "adagrad_norm": 0.05}


def zoo():
    return make_zoo_task(ARCH, seq_len=SEQ, d_model=D, device="cpu")


def cfg(aggregator="cwtm", attack="sign_flip"):
    return DynaBROConfig(mlmc=MLMCConfig(T=T, m=M, V=3.0, kappa=1.0, j_cap=2),
                         aggregator=aggregator, delta=0.3, attack=attack)


def switcher():
    return get_switcher("periodic", M, n_byz=1, K=2)


def every_leaf(model_cfg, mesh):
    """Specs splitting each leaf over the worker axis on its first dim
    (after a block's group dim) that the axis divides, and over 'model' on
    its last other dim that 'model' divides."""
    n_w, n_m = mesh.shape["workers"], mesh.shape["model"]
    specs = {}
    for name, leaf in abstract_params(model_cfg, torch.float32).items():
        dims = range(1 if name.startswith("blocks/") else 0, leaf.dim())
        spec = [None] * leaf.dim()
        f = next((d for d in dims if leaf.shape[d] % n_w == 0), None)
        if f is not None:
            spec[f] = "workers"
        mo = next((d for d in reversed(dims)
                   if d != f and leaf.shape[d] % n_m == 0), None)
        if mo is not None:
            spec[mo] = "model"
        specs[name] = tuple(spec)
    return specs


def specs_for(which, model_cfg, mesh):
    if mesh is None or which is None:
        return None
    if which == "plan":
        return plan_params(model_cfg, mesh, fsdp=True, dtype=torch.float32)[0]
    return every_leaf(model_cfg, mesh)


def params_np(params):
    return {k: v.detach().cpu().numpy() for k, v in sorted(params.items())}


def logs_of(logs):
    return [(l.level, bool(l.failsafe_ok), l.n_byz, l.cost) for l in logs]


def _counted(run):
    before = dict(sharded.COLLECTIVES)
    out = run()
    return out, {k: sharded.COLLECTIVES[k] - before[k]
                 for k in ("param_gathers", "exchanges", "sums")}


def dynabro(mesh, specs="every", aggregator="cwtm", attack="sign_flip",
            microbatch=True, opt="sgd"):
    task, model_cfg = zoo()
    kw = {}
    if mesh is not None:
        kw = dict(mesh=mesh, param_specs=specs_for(specs, model_cfg, mesh))
    (p, logs, _), counts = _counted(lambda: run_dynabro_scan(
        task.grad_fn, task.params0, get_optimizer(opt, LR[opt]),
        cfg(aggregator, attack), switcher(), task.make_sampler(M), T,
        seed=SEED, microbatch=microbatch, **kw))
    return {"params": params_np(p), "logs": logs_of(logs),
            "collectives": counts}


def session(mesh):
    """``Session.run``, and 8 ``Session.step`` rounds from ``init_carry``
    (whose params are the rank's blocks on the GSPMD path), under
    ``random``."""
    task, model_cfg = zoo()
    sess = Session(cfg(attack="random"), grad_fn=task.grad_fn,
                   params0=task.params0, opt=get_optimizer("sgd", LR["sgd"]),
                   switcher=switcher(), sample_batches=task.make_sampler(M),
                   seed=SEED, microbatch=True, mesh=mesh,
                   param_specs=specs_for("every", model_cfg, mesh))
    p, logs, _ = sess.run(T)
    carry, sched = sess.init_carry(), sess.schedule(T)
    placed = sum(v.numel() for v in carry[0].values())
    for t in range(T):
        carry, _ = sess.step(carry, sess.round_inputs(sched, t))
    return {"params": params_np(p), "logs": logs_of(logs),
            "step_params": params_np(sess.scan_fn.full(carry[0])),
            "placed_numel": placed}


def _mesh(workers, model):
    return lambda: make_worker_mesh(workers, model=model)


# world -> {case: (function, the mesh it runs on: a factory every rank calls
# in order)}; the unsharded reference of a case is function(None)
GROUPS = {
    2: {
        "(1, 2) cwtm streamed": (dynabro, _mesh(1, 2)),
        "(1, 2) cwtm stacked": (lambda mesh: dynabro(mesh, microbatch=False),
                                _mesh(1, 2)),
        "(1, 2) geomed stacked": (lambda mesh: dynabro(
            mesh, aggregator="geomed", microbatch=False), _mesh(1, 2)),
        "(1, 2) plan specs": (lambda mesh: dynabro(mesh, "plan"), _mesh(1, 2)),
        "(1, 2) random": (lambda mesh: dynabro(mesh, attack="random"),
                          _mesh(1, 2)),
        "(1, 2) session": (session, _mesh(1, 2)),
        "(2, 1) cwtm streamed": (dynabro, _mesh(2, 1)),
        "(2, 1) geomed streamed": (lambda mesh: dynabro(
            mesh, aggregator="geomed"), _mesh(2, 1)),
        "(2, 1) random stacked": (lambda mesh: dynabro(
            mesh, attack="random", microbatch=False), _mesh(2, 1)),
        "(2, 1) adagrad_norm": (lambda mesh: dynabro(mesh, opt="adagrad_norm"),
                                _mesh(2, 1)),
        "(2, 1) momentum alie": (lambda mesh: dynabro(
            mesh, attack="alie", opt="momentum"), _mesh(2, 1)),
        "(2, 1) replicated": (lambda mesh: dynabro(mesh, None), _mesh(2, 1)),
    },
    4: {
        "(2, 2) cwtm streamed": (dynabro, _mesh(2, 2)),
        "(2, 2) cwtm stacked": (lambda mesh: dynabro(mesh, microbatch=False),
                                _mesh(2, 2)),
        "(2, 2) geomed stacked": (lambda mesh: dynabro(
            mesh, aggregator="geomed", microbatch=False), _mesh(2, 2)),
        "(2, 2) geomed streamed": (lambda mesh: dynabro(
            mesh, aggregator="geomed"), _mesh(2, 2)),
        "(2, 2) nnm+cwtm stacked": (lambda mesh: dynabro(
            mesh, aggregator="nnm+cwtm", microbatch=False), _mesh(2, 2)),
        "(2, 2) krum streamed": (lambda mesh: dynabro(mesh, aggregator="krum"),
                                 _mesh(2, 2)),
        "(2, 2) mfm streamed": (lambda mesh: dynabro(mesh, aggregator="mfm"),
                                _mesh(2, 2)),
        "(2, 2) adam ipm": (lambda mesh: dynabro(mesh, attack="ipm",
                                                 opt="adam"), _mesh(2, 2)),
        "(2, 2) plan specs": (lambda mesh: dynabro(mesh, "plan"), _mesh(2, 2)),
    },
}


def main(world: int, rank: int, init_file: str, out_dir: str) -> None:
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world)
    try:
        results = {name: fn(mesh()) for name, (fn, mesh)
                   in GROUPS[world].items()}
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
