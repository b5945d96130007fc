#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one CUDA card.

    python3 benchmarks_torch/profile_main_path.py [--T 150] [--aggregator cwtm]

Runs the Figure-1 setting of chip_smoke.py (m=17, 8 Byzantine, sign_flip
under Periodic(10), δ = 8/17 + 1e-3, the 64-128-10 MLP) with one of its
rules (``cwtm``, ``nnm+cwtm``, ``krum``, ``geomed`` with sgd(0.1), or ``mfm``
with Option 2 and adagrad_norm(0.5)) through ``run_dynabro`` on each
aggregation backend (``auto`` = the CUDA kernels, and ``ref`` = the plain
PyTorch versions): a warm-up run, a timed run without the profiler, then a
run under ``torch.profiler``. Prints one JSON line per
backend with the rounds/s, the device's busy and idle share of the profiled
run's wall time (busy = the union of the card's kernel intervals), the
kernels launched per round, and the kernels that take the most device time.
"""
import argparse
import dataclasses
import json
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
    DynaBROConfig, MLMCConfig, adagrad_norm, get_switcher, make_task,
    run_dynabro, sgd,
)

M, N_BYZ = 17, 8


def busy_us(intervals):
    """Length of the union of [start, end) intervals, in µs."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--T", type=int, default=150)
    ap.add_argument("--aggregator", default="cwtm",
                    choices=["cwtm", "nnm+cwtm", "krum", "geomed", "mfm"])
    args = ap.parse_args()
    option = 2 if args.aggregator == "mfm" else 1
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    params0, grad_fn, sampler, _ = make_task(M, seed=0, device="cuda")
    cfg = DynaBROConfig(
        mlmc=MLMCConfig(T=args.T, m=M, V=5.0, option=option, kappa=1.0,
                        j_cap=5),
        aggregator=args.aggregator, delta=N_BYZ / M + 1e-3, attack="sign_flip")

    for backend in ("auto", "ref"):
        cfg_b = dataclasses.replace(cfg, agg_backend=backend)

        def run():
            sw = get_switcher("periodic", M, n_byz=N_BYZ, K=10)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt = adagrad_norm(0.5) if option == 2 else sgd(0.1)
            run_dynabro(grad_fn, params0, opt, cfg_b, sw, sampler, args.T,
                        seed=0)
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
        top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:12]
        print(json.dumps({
            "phase": "profile", "aggregator": args.aggregator,
            "backend": backend, "T": args.T,
            "device": torch.cuda.get_device_name(0),
            "wall_s": wall, "rounds_per_s": args.T / wall,
            "profiled_wall_s": wall_prof,
            "device_busy_s": busy / 1e6,
            "device_busy_share": busy / 1e6 / wall_prof,
            "device_idle_share": 1.0 - busy / 1e6 / wall_prof,
            "kernels": len(kernels), "kernels_per_round": len(kernels) / args.T,
            "top": [{"name": n[:90], "count": c, "device_us": us}
                    for n, (c, us) in top]}), flush=True)


if __name__ == "__main__":
    main()
