"""End-to-end DynaBRO training in Mode B, the port of the JAX package's
``launch/train.py``.

Runs Algorithm 2 on a mesh of ranks: per round, draw J ~ Geom(1/2) on the
host, run the level's step (built once a level, ``launch/steps.py``) on the
global synthetic LM batch, the Byzantine mask from the switching strategy,
and checkpoint every ``--ckpt-every`` rounds. ``--devices N`` (N > 1) starts
N ranks of this module, a gloo process group over a ``file://`` rendezvous
in a temporary directory, and waits for them; a rank uses the card (rank r
card r modulo the cards there are) unless ``--device cpu`` is given. Rank 0
prints the reference's lines. Example (four ranks on the CPU):

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --devices 4 --mesh 2x2 --steps 20 --reduced --attack sign_flip \\
      --aggregator cwtm --switch periodic --switch-k 10
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

RANK_ENV = "REPRO_TORCH_RANK"  # a rank's place, world size and rendezvous


def _args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks to start (0 or 1: this process alone)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--mesh", default="", help="e.g. 4x2 (data x model)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "momentum", "adam", "adagrad_norm"])
    ap.add_argument("--aggregator", default="cwmed")
    ap.add_argument("--attack", default="none")
    ap.add_argument("--delta", type=float, default=0.25)
    ap.add_argument("--switch", default="static",
                    choices=["static", "periodic", "bernoulli", "momentum_tailored"])
    ap.add_argument("--switch-k", type=int, default=10)
    ap.add_argument("--n-byz", type=int, default=1)
    ap.add_argument("--mlmc", action="store_true", help="full MLMC levels")
    ap.add_argument("--V", type=float, default=8.0)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _spawn(n: int, argv) -> int:
    """Run ``n`` ranks of this module with ``argv``; the first failing
    rank's exit code (the others are ended), else 0."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *argv],
            env=dict(os.environ, **{RANK_ENV: f"{r},{n},{tmp}/rendezvous"}))
            for r in range(n)]
        try:
            while True:
                codes = [p.poll() for p in procs]
                bad = [c for c in codes if c not in (None, 0)]
                if bad:
                    return bad[0]
                if all(c == 0 for c in codes):
                    return 0
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _args(argv)
    if args.devices > 1 and RANK_ENV not in os.environ:
        return _spawn(args.devices, argv)
    rank, world = 0, 1
    if RANK_ENV in os.environ:
        r, n, init = os.environ[RANK_ENV].split(",", 2)
        rank, world = int(r), int(n)

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.mlmc import MLMCConfig, sample_level
    from repro_torch.core.switching import get_switcher
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.mesh import make_test_mesh, n_workers
    from repro_torch.launch.steps import build_mlmc_train_step, build_train_step
    from repro_torch.models import init_params
    from repro_torch.optim.optimizers import get_optimizer

    dev = torch.device("cpu")
    if args.device == "cuda":
        dev = torch.device("cuda", rank % max(1, torch.cuda.device_count()))
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if world > 1:
        dist.init_process_group("gloo", init_method=f"file://{init}",
                                rank=rank, world_size=world)
    say = print if rank == 0 else (lambda *a, **k: None)
    try:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduced(cfg)
        if args.mesh:
            dims = tuple(int(x) for x in args.mesh.split("x"))
            mesh = make_test_mesh(dims, ("pod", "data", "model")[-len(dims):])
        else:
            mesh = make_test_mesh((world, 1))
        m = n_workers(mesh)
        say(f"mesh={dict(mesh.shape)} workers(m)={m} arch={cfg.arch_id} "
            f"params={cfg.param_count()/1e6:.1f}M")

        shape = ShapeConfig("cli", args.seq_len, args.global_batch, "train")
        opt = get_optimizer(args.optimizer, args.lr)
        mlmc_cfg = MLMCConfig(T=args.steps, m=m, V=args.V, option=1,
                              kappa=1.0, j_cap=3)
        sw_kw = {"static": {"n_byz": args.n_byz},
                 "periodic": {"n_byz": args.n_byz, "K": args.switch_k},
                 "bernoulli": {"p": 0.02, "D": args.switch_k, "delta_max": 0.45},
                 "momentum_tailored": {"alpha": 0.1}}[args.switch]
        switcher = get_switcher(args.switch, m, seed=args.seed, **sw_kw)
        data = SyntheticLMData(cfg.vocab_size, args.seq_len, args.global_batch,
                               seed=args.seed, device=dev)
        dtype = torch.float32 if args.reduced else torch.bfloat16
        steps = {}

        def get_step(j):
            if j not in steps:
                kw = dict(aggregator=args.aggregator, attack=args.attack,
                          delta=args.delta, opt=opt, dtype=dtype)
                if j == 0 or not args.mlmc:
                    steps[j] = build_train_step(cfg, mesh, shape, lr=args.lr,
                                                **kw)
                else:
                    steps[j] = build_mlmc_train_step(cfg, mesh, shape,
                                                     mlmc_cfg, j, **kw)
            return steps[j]

        first = get_step(0)  # the rules and the batch are checked here
        params = init_params(cfg, args.seed, dtype=dtype, device=dev)
        opt_state = first.place(opt.init(params))
        params = first.place(params)
        rng = np.random.default_rng(args.seed)
        t_start = time.time()
        for t in range(args.steps):
            j = sample_level(rng, mlmc_cfg.j_max) if args.mlmc else 0
            j = min(j, mlmc_cfg.j_max)
            step = get_step(j)
            mult = 2 ** j if (args.mlmc and j > 0) else 1
            batch = data.batch(t, args.global_batch * mult)
            maskf = torch.as_tensor(switcher.mask(t), dtype=torch.float32,
                                    device=dev)
            params, opt_state, out = step.fn(params, opt_state, batch, maskf)
            if args.mlmc and j > 0:
                ok, dn = out
                msg = (f"J={j} failsafe_ok={float(ok):.0f} "
                       f"|ĝJ-ĝJ-1|={float(dn):.3f}")
            else:
                msg = f"loss={float(out):.4f}"
            if t % max(1, args.steps // 20) == 0 or t == args.steps - 1:
                say(f"step {t:5d} byz={int(maskf.sum())}/{m} {msg} "
                    f"({time.time()-t_start:.1f}s)")
            if args.ckpt_every and (t + 1) % args.ckpt_every == 0:
                full = step.gather(params)  # every rank gathers
                if rank == 0:
                    save_checkpoint(os.path.join(
                        args.ckpt_dir, f"{cfg.arch_id}_step{t+1}"), full,
                        step=t + 1)
        say("done in", round(time.time() - t_start, 1), "s")
    finally:
        if world > 1:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
