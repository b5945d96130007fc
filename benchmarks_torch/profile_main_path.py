#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one CUDA card.

    python3 benchmarks_torch/profile_main_path.py [--T 150] [--aggregator cwtm]
        [--driver round|scan] [--attack sign_flip] [--task mlp|zoo]
        [--arch smollm-360m]

``--task mlp`` (the default) runs the Figure-1 setting of chip_smoke.py
(m=17, 8 Byzantine, Periodic(10), δ = 8/17 + 1e-3, the 64-128-10 MLP) under
one attack (default ``sign_flip``) with one of its rules (``cwtm``,
``nnm+cwtm``, ``krum``, ``geomed`` with sgd(0.1), or ``mfm`` with Option 2
and adagrad_norm(0.5)) through one driver: ``round`` is ``run_dynabro``,
``scan`` is ``run_dynabro_scan`` replaying one CUDA graph per MLMC level
(its graphs captured in the warm-up run and kept).

``--task zoo`` runs chip_smoke.py's ``zoo_path`` setting instead: DynaBRO
over SmolLM-360M at its published width, 8 of its 32 layers, seq_len 128,
m=17 with 8 Byzantine under Periodic(4), ``MLMCConfig(T, V=5, kappa=1,
j_cap=3)``, sgd(0.05), through ``run_dynabro_scan(microbatch=True)`` (the
scan driver; ``--T`` defaults to 16 there). ``--arch`` picks the model
(``zoo_families_path``'s): whisper-base at its published width and depth,
or another arch id at ``get_reduced_config(arch, d_model=512)``.

Each aggregation backend in turn (``auto`` = the CUDA kernels, ``ref`` =
the plain PyTorch versions) gets a warm-up run, a timed run without the
profiler, then a run under ``torch.profiler``. Prints one JSON line per
backend with the rounds/s, the device's busy and idle share of the profiled
run's wall time (busy = the union of the card's kernel intervals), the
kernels launched per round, the ``cw_reduce`` kernel's device time and its
share of the busy time, and the kernels that take the most device time.
"""
import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import (  # noqa: E402
    DynaBROConfig, MLMCConfig, adagrad_norm, get_switcher,
    make_dynabro_scan_fn, make_task, run_dynabro, run_dynabro_scan, sgd,
)
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.core.attacks import ATTACKS  # noqa: E402
from repro_torch.models import task_for_config  # noqa: E402

M, N_BYZ = 17, 8
ZOO_ARCH, ZOO_LAYERS, ZOO_SEQ = "smollm-360m", 8, 128
FULL_WIDTH = ("whisper-base",)  # archs the zoo runs at published size
K1_KERNEL = "cw_reduce_kernel"


def busy_us(intervals):
    """Length of the union of [start, end) intervals, in µs."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def setting(args):
    """(grad_fn, params0, sampler, cfg, make_opt, switcher factory,
    microbatch) of the task."""
    option = 2 if args.aggregator == "mfm" else 1
    if args.task == "zoo":
        if args.arch == ZOO_ARCH:
            cfg_model = dataclasses.replace(get_config(ZOO_ARCH),
                                            n_layers=ZOO_LAYERS)
        elif args.arch in FULL_WIDTH:
            cfg_model = get_config(args.arch)
        else:
            cfg_model = get_reduced_config(args.arch, d_model=512)
        task = task_for_config(cfg_model, seq_len=ZOO_SEQ, seed=0, device="cuda")
        cfg = DynaBROConfig(
            mlmc=MLMCConfig(T=args.T, m=M, V=5.0, option=option, kappa=1.0,
                            j_cap=3),
            aggregator=args.aggregator, delta=N_BYZ / M + 1e-3,
            attack=args.attack)
        return (task.grad_fn, task.params0, task.make_sampler(M), cfg,
                lambda: sgd(0.05),
                lambda: get_switcher("periodic", M, n_byz=N_BYZ, K=4), True)
    params0, grad_fn, sampler, _ = make_task(M, seed=0, device="cuda")
    cfg = DynaBROConfig(
        mlmc=MLMCConfig(T=args.T, m=M, V=5.0, option=option, kappa=1.0,
                        j_cap=5),
        aggregator=args.aggregator, delta=N_BYZ / M + 1e-3, attack=args.attack)
    return (grad_fn, params0, sampler, cfg,
            lambda: adagrad_norm(0.5) if option == 2 else sgd(0.1),
            lambda: get_switcher("periodic", M, n_byz=N_BYZ, K=10), False)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="mlp", choices=["mlp", "zoo"])
    ap.add_argument("--T", type=int, default=None,
                    help="rounds (default 150; 16 with --task zoo)")
    ap.add_argument("--aggregator", default="cwtm",
                    choices=["cwtm", "nnm+cwtm", "krum", "geomed", "mfm"])
    ap.add_argument("--driver", default="round", choices=["round", "scan"])
    ap.add_argument("--attack", default="sign_flip", choices=sorted(ATTACKS))
    ap.add_argument("--arch", default=ZOO_ARCH,
                    help="with --task zoo: the model (default smollm-360m, "
                         "8 of its 32 layers)")
    args = ap.parse_args()
    if args.T is None:
        args.T = 16 if args.task == "zoo" else 150
    if args.task == "zoo":
        args.driver = "scan"  # the zoo streams its units: the compiled driver
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    grad_fn, params0, sampler, cfg, make_opt, switcher, microbatch = setting(args)

    for backend in ("auto", "ref"):
        cfg_b = dataclasses.replace(cfg, agg_backend=backend)
        if args.driver == "scan":  # graphs captured in the warm-up, kept
            scan_fn = make_dynabro_scan_fn(grad_fn, cfg_b, make_opt(),
                                           microbatch=microbatch)
            driver = run_dynabro_scan
            kw = dict(scan_fn=scan_fn, microbatch=microbatch)
        else:
            scan_fn, driver, kw = None, run_dynabro, {}

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            driver(grad_fn, params0, make_opt(), cfg_b, switcher(), sampler,
                   args.T, seed=0, **kw)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        run()  # warm-up
        wall = run()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_prof = run()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        per_name = defaultdict(lambda: [0, 0.0])
        for e in kernels:
            per_name[e.name][0] += 1
            per_name[e.name][1] += e.time_range.elapsed_us()
        busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
        k1 = [(c, us) for n, (c, us) in per_name.items() if K1_KERNEL in n]
        k1_us = sum(us for _, us in k1)
        top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:12]
        print(json.dumps({
            "phase": "profile", "task": args.task,
            "arch": args.arch if args.task == "zoo" else None,
            "aggregator": args.aggregator,
            "attack": args.attack, "driver": args.driver,
            "microbatch": microbatch, "backend": backend, "T": args.T,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "capture_s": ({str(j): c for j, c in scan_fn.capture_seconds.items()}
                          if scan_fn else None),
            "wall_s": wall, "rounds_per_s": args.T / wall,
            "profiled_wall_s": wall_prof,
            "device_busy_s": busy / 1e6,
            "device_busy_share": busy / 1e6 / wall_prof,
            "device_idle_share": 1.0 - busy / 1e6 / wall_prof,
            "kernels": len(kernels), "kernels_per_round": len(kernels) / args.T,
            "cw_reduce_launches": sum(c for c, _ in k1),
            "cw_reduce_device_us": k1_us,
            "cw_reduce_share_of_busy": k1_us / busy if busy else None,
            "top": [{"name": n[:90], "count": c, "device_us": us}
                    for n, (c, us) in top]}), flush=True)
        # the graphs' memory goes before the next backend's warm-up
        scan_fn = kw = prof = kernels = None
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
