#!/usr/bin/env python3
"""Time the port's kernels on one CUDA card at the main path's shapes: the
distance kernels of ``sqdist.cu`` (K3 ``pairwise_sqdist``, K6 ``cross_sqdist``
at k = 1) at every leaf shape, beside them the other kernels (K1 ``cwtm`` at
trim 8, K2 ``cwtm_masked`` where the tree reads its trim on the card, K4
``weighted_combine`` at k = 1, K5 ``combine_reduce`` at k = m, trim 8) at
17 x 8192, K1 also at 64 x 8192 and 17 x 2^20 (float32 and
bfloat16), and the tree forms over the main path's four leaves as the rules
call them (``agg_engine.tree_weighted_combine`` at k = 1 and k = m,
``agg_engine.tree_combine_reduce`` at trim 8, and the coordinate-wise rules'
``tree``: CWTM at trim 8, CWMed, Mean).

    python3 benchmarks_torch/time_kernels.py [--src DIR] [--label NAME]
        [--sweep [sqdist,combine,cw_reduce]] [--units LIST] [--cols LIST]
        [--reps N]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so that an older tree unpacked beside this one is timed by
the same code in turns, in one process each. Without ``--sweep`` it prints
one JSON line per kernel and shape: device µs per call (CUDA graph replay)
and µs per call issued back to back from Python (CUDA events), and for K3,
K6 and K4 the same two for the PyTorch call that computes the same function
(``torch.cdist(...).square_()``, ``torch.mm``, one per leaf for the tree
forms); the host-bound per-call time also as the least of the repeats; the
tree forms also with a digest of their results' bits, to compare two trees.
``--sweep sqdist`` instead times this checkout's K3 and K6 at every plan of
``--units`` 64-column units per block: the measurement that chose
``SQDIST_MAX_UNITS`` (the table in ``sqdist.cu``'s header). ``--sweep
combine`` times K4 (k = 1 and k = 17) and K5 (k = 17) over the main path's
tree and over its widest leaf at every plan of ``combine.cu`` (rows a thread
in ``COMBINE_ROWS``, ``--cols`` columns a block) and checks each against
the default plan's bits: the measurement that chose ``combine_plan`` (the
table in ``combine.cu``'s header). ``--sweep cw_reduce`` times K1 (trim 8)
over the main path's tree, 17 x 8192, 64 x 8192 and 17 x 2^20 at every plan
of ``cw_reduce.cu`` (lanes a column in ``CW_REDUCE_LANES``, ``--cols``
columns a block) and checks each against the default plan's bits: the
measurement that chose ``cw_reduce_plan`` (the table in ``cw_reduce.cu``'s
header). ``--sweep`` alone runs all three. Float32 inputs unless a row says
otherwise; each time is the median of ``--reps`` repeats.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(17, 8192), (17, 1280), (17, 128), (17, 10), (17, 9610)]


def time_calls_us(fn, iters=1000, warmup=50):
    """Per-call time of ``fn`` issued back to back from Python."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 1e3 / iters


def time_graph_us(fn, iters=200):
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 1e3 / iters


def median_of(reps, fn, timer):
    return statistics.median(timer(fn) for _ in range(reps))


def repeats(reps, fn, timer):
    return [timer(fn) for _ in range(reps)]


def leaf_tree(gen, dev):
    """The main path's stacked parameter tree (17 workers; b1, b2, w1, w2 as
    ``make_task`` shapes them), and its leaves as (17, d) matrices."""
    import torch
    shapes = {"b1": (128,), "b2": (10,), "w1": (64, 128), "w2": (128, 10)}
    stacked = {k: (torch.randn((17,) + s, generator=gen) * 1e-2).to(dev)
               for k, s in shapes.items()}
    return stacked, [stacked[k].reshape(17, -1) for k in sorted(stacked)]


def digest(outs):
    """A hash of the outputs' bits, to compare two trees' results."""
    import hashlib
    h = hashlib.sha256()
    for o in outs:
        h.update(o.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def sweep_sqdist(args, fused, kref, dev, smi, gen):
    """K3 and K6 at every plan of ``--units`` 64-column units a block."""
    import torch
    for m, d in SHAPES:
        x = (torch.randn(m, d, generator=gen) * 1e-2).to(dev)
        z = (torch.randn(1, d, generator=gen) * 1e-2).to(dev)
        n_units = -(-d // fused.SQDIST_UNIT)
        for name, y, n_pairs, want in [
                ("pairwise_sqdist", None, m * (m + 1) // 2,
                 kref.pairwise_sqdist_ref(x)),
                ("cross_sqdist", z, m, kref.cross_sqdist_ref(x, z))]:
            done = set()
            for cpb in (int(c) for c in args.units.split(",")):
                cpb = min(cpb, n_units)
                blocks = -(-n_units // cpb)
                if blocks > fused.SQDIST_MAX_BLOCKS or cpb in done:
                    continue
                done.add(cpb)
                plan = fused.SqdistPlan(blocks, cpb)
                out = torch.empty((m, 1 if y is not None else m),
                                  dtype=torch.float32, device=dev)

                def kern(y=y, n_pairs=n_pairs, out=out, plan=plan):
                    return fused._sqdist(x, y, n_pairs, out, plan)
                err = float((kern() - want).abs().max())
                print(json.dumps({
                    "phase": "sweep", "kernel": name, "m": m, "d": d,
                    "blocks": blocks, "units_per_block": cpb,
                    "default_plan": list(fused.sqdist_plan(n_pairs, d)),
                    "max_abs_err": err,
                    "kernel_us": median_of(args.reps, kern, time_graph_us),
                    "nvidia_smi": smi}), flush=True)


def sweep_combine(args, fused, kref, dev, smi, gen):
    """K4 (k = 1 and k = 17) and K5 (k = 17, trim 8) at every plan that
    ``combine.cu`` takes, over the main path's four-leaf tree and over its
    widest leaf alone; each plan checked bitwise against the default."""
    import torch
    _, leaves = leaf_tree(gen, dev)
    m = 17
    w1 = torch.full((1, m), 1.0 / m, device=dev)
    wm = torch.rand(m, m, generator=gen).to(dev)
    wm /= wm.sum(1, keepdim=True)
    for name, w, mode in [("weighted_combine", w1, None),
                          ("weighted_combine", wm, None),
                          ("combine_reduce", wm, "tm")]:
        k = w.shape[0]
        for tree, xs in [("tree", leaves), ("17x8192", [leaves[2]])]:
            want = fused._combine(xs, w, mode, 8, mode is None, "sweep")
            for r in fused.COMBINE_ROWS:
                for cols in (int(c) for c in args.cols.split(",")):
                    plan = fused.CombinePlan(r, cols)
                    if not fused.combine_plan_fits(plan, m, k):
                        continue

                    def kern(xs=xs, w=w, mode=mode, plan=plan):
                        return fused._combine(xs, w, mode, 8, mode is None,
                                              "sweep", plan=plan)
                    got = kern()
                    same = all(torch.equal(a, b)
                               for a, b in zip(got[0] or got[1], want[0] or want[1]))
                    print(json.dumps({
                        "phase": "sweep", "kernel": name, "k": k, "m": m,
                        "leaves": tree, "d": sum(x.shape[1] for x in xs),
                        "rows_per_thread": r, "cols_per_block": cols,
                        "default_plan": list(fused.combine_plan(k)),
                        "bitwise_equal_default": same,
                        "kernel_us": median_of(args.reps, kern, time_graph_us),
                        "nvidia_smi": smi}), flush=True)


def sweep_cw_reduce(args, fused, kref, dev, smi, gen):
    """K1 (trim 8) at every plan that ``cw_reduce.cu`` takes, over the main
    path's four-leaf tree, 17 x 8192, 64 x 8192, and 17 x 2^16, 2^17, 2^18
    and 2^20 in float32 and bfloat16; each plan checked bitwise against the
    default."""
    import torch
    _, leaves = leaf_tree(gen, dev)
    shapes = [(17, 8192, torch.float32), (64, 8192, torch.float32)] + [
        (17, 1 << e, dtype) for e in (16, 17, 18, 20)
        for dtype in (torch.float32, torch.bfloat16)]
    cases = [("tree", leaves)] + [
        (f"{m}x{d} {str(dtype).removeprefix('torch.')}",
         [(torch.randn(m, d, generator=gen) * 1e-2).to(dtype).to(dev)])
        for m, d, dtype in shapes]
    for name, xs in cases:
        m = xs[0].shape[0]
        want = fused.tree_cw_reduce(xs, "tm", 8)
        for lanes in fused.CW_REDUCE_LANES:
            for cols in (int(c) for c in args.cols.split(",")):
                plan = fused.CwReducePlan(lanes, cols)
                if not fused.cw_reduce_plan_fits(plan, m):
                    continue

                def kern(xs=xs, plan=plan):
                    return fused.tree_cw_reduce(xs, "tm", 8, plan=plan)
                same = all(torch.equal(a, b) for a, b in zip(kern(), want))
                blocks = sum(l.blocks for l in fused.tree_launches(
                    tuple(x.shape[1] for x in xs), cols))
                print(json.dumps({
                    "phase": "sweep", "kernel": "cw_reduce", "m": m,
                    "leaves": name, "d": sum(x.shape[1] for x in xs),
                    "lanes": lanes, "cols_per_block": cols, "blocks": blocks,
                    "default_plan": list(fused.cw_reduce_plan(m)),
                    "bitwise_equal_default": same,
                    "kernel_us": median_of(args.reps, kern, time_graph_us),
                    "nvidia_smi": smi}), flush=True)


def tree_rows(args, dev, smi, gen):
    """The main path's tree forms of K4 (k = 1, k = m) and K5 (k = m, trim
    8) through ``agg_engine`` on the kernel backend, as the rules call them,
    beside one ``torch.mm`` per leaf, and of K1 through the coordinate-wise
    rules' ``tree`` (CWTM at trim 8 beside one ``torch.median`` per leaf,
    CWMed, Mean); a digest of each result's bits."""
    import torch
    from repro_torch.core import agg_engine
    stacked, leaves = leaf_tree(gen, dev)
    m = 17
    w1 = torch.full((m,), 1.0 / m, device=dev)
    wm = torch.rand(m, m, generator=gen).to(dev)
    wm /= wm.sum(1, keepdim=True)
    cases = [
        ("weighted_combine", "k=1",
         lambda: agg_engine.tree_weighted_combine(stacked, w1, backend="kernel"),
         lambda: [torch.mm(w1[None], x) for x in leaves]),
        ("weighted_combine", "k=m",
         lambda: agg_engine.tree_weighted_combine(stacked, wm, backend="kernel"),
         lambda: [torch.mm(wm, x) for x in leaves]),
        ("combine_reduce", "k=m tm",
         lambda: agg_engine.tree_combine_reduce(stacked, wm, mode="tm", trim=8,
                                                backend="kernel"),
         None)]
    for rule, library in [("cwtm", lambda: [torch.median(x, 0).values
                                            for x in leaves]),
                          ("cwmed", None), ("mean", None)]:
        agg = agg_engine.get_aggregator(rule, delta=8 / 17 + 1e-3,
                                        backend="kernel")
        cases.append(("cw_reduce", rule, lambda agg=agg: agg.tree(stacked),
                      library))
    for name, case, kern, library in cases:
        calls = repeats(args.reps, kern, time_calls_us)
        print(json.dumps({
            "phase": "tree", "label": args.label, "kernel": name, "case": case,
            "m": m, "d": sum(x.shape[1] for x in leaves), "leaves": len(leaves),
            "digest": digest(kern()[k] for k in sorted(stacked)),
            "kernel_us": median_of(args.reps, kern, time_graph_us),
            "kernel_call_us": statistics.median(calls),
            "kernel_call_us_min": min(calls),
            "library_us": (median_of(args.reps, library, time_graph_us)
                           if library else None),
            "library_call_us": (median_of(args.reps, library, time_calls_us)
                                if library else None),
            "nvidia_smi": smi}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--sweep", nargs="?", const="sqdist,combine,cw_reduce",
                    default="")
    ap.add_argument("--units", default="1,2,3,4,6,8,10,15,20,32,64,128")
    ap.add_argument("--cols", default="32,64,128,256")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    from repro_torch.kernels import fused
    from repro_torch.kernels import ref as kref

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    if args.sweep:
        sweeps = {"sqdist": sweep_sqdist, "combine": sweep_combine,
                  "cw_reduce": sweep_cw_reduce}
        for which in args.sweep.split(","):
            sweeps[which](args, fused, kref, dev, smi, gen)
        return
    for m, d in SHAPES:
        x = (torch.randn(m, d, generator=gen) * 1e-2).to(dev)
        z = (torch.randn(1, d, generator=gen) * 1e-2).to(dev)
        cases = [("pairwise_sqdist", lambda: fused.pairwise_sqdist(x),
                  lambda: torch.cdist(x, x).square_()),
                 ("cross_sqdist", lambda: fused.cross_sqdist(x, z),
                  lambda: torch.cdist(x, z).square_())]
        if d == 8192:
            t_dev = torch.tensor(8, dtype=torch.int32, device=dev)
            w1 = torch.full((1, m), 1.0 / m, device=dev)
            wm = torch.rand(m, m, generator=gen).to(dev)
            wm /= wm.sum(1, keepdim=True)
            cases += [("cw_reduce", lambda: fused.cwtm(x, 8), None),
                      ("weighted_combine", lambda: fused.weighted_combine(x, w1),
                       lambda: torch.mm(w1, x)),
                      ("combine_reduce",
                       lambda: fused.combine_reduce(x, wm, "tm", 8), None)]
            if hasattr(fused, "tree_cw_reduce"):  # the trim read on the card
                cases.append(("cw_reduce masked",
                              lambda: fused.cwtm_masked(x, t_dev), None))
        for name, kern, library in cases:
            calls = repeats(args.reps, kern, time_calls_us)
            print(json.dumps({
                "phase": "calls", "label": args.label, "kernel": name,
                "m": m, "d": d,
                "kernel_us": median_of(args.reps, kern, time_graph_us),
                "kernel_call_us": statistics.median(calls),
                "kernel_call_us_min": min(calls),
                "library_us": (median_of(args.reps, library, time_graph_us)
                               if library else None),
                "library_call_us": (median_of(args.reps, library, time_calls_us)
                                    if library else None),
                "nvidia_smi": smi}), flush=True)
    for m, d, dtype in [(64, 8192, torch.float32), (17, 1 << 20, torch.float32),
                        (17, 1 << 20, torch.bfloat16)]:
        x = (torch.randn(m, d, generator=gen) * 1e-2).to(dtype).to(dev)
        print(json.dumps({
            "phase": "calls", "label": args.label, "kernel": "cw_reduce",
            "m": m, "d": d, "dtype": str(dtype).removeprefix("torch."),
            "kernel_us": median_of(args.reps, lambda: fused.cwtm(x, 8),
                                   time_graph_us),
            "library_us": median_of(args.reps, lambda: torch.median(x, 0),
                                    time_graph_us),
            "nvidia_smi": smi}), flush=True)
    tree_rows(args, dev, smi, gen)


if __name__ == "__main__":
    main()
