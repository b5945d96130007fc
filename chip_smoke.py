#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout: it builds the port's CUDA kernels from the
sources there (``nvcc``, into ``build/repro_torch/``), then

  1. prints the card (nvidia-smi name and power limit), the torch and CUDA
     versions and the build time;
  2. holds every kernel against its plain PyTorch version on the card
     (rtol = atol = 1e-5) over a sweep of shapes, dtypes and modes, a 1e30
     outlier row and a NaN column;
  3. trains the main path, DynaBRO Algorithm 2 on the paper's Figure-1
     setting (m=17, 8 Byzantine, sign_flip under Periodic(10), CWTM at trim
     8, T=150, sgd(0.1), the 64-128-10 Gaussian-mixture MLP at full width)
     through ``make_task`` / ``run_dynabro`` with the default backend, and
     checks the test accuracy, the kernel's launch count, and a second run on
     the plain backend;
  4. times each kernel at the main path's shapes beside its plain version,
     one PyTorch library call where one computes the same function, and the
     card's bound;
  5. prints the ``{"kernels": [...]}`` summary, then
     ``{"ok": true, "device": {...}}`` as the last line.

One JSON object per line, apart from the nvidia-smi line. Any failure raises
and the exit code is non-zero; so is it without a CUDA card.
"""
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import (  # noqa: E402
    LAUNCHES, DynaBROConfig, MLMCConfig, get_switcher, make_task, run_dynabro,
    sgd,
)
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import fused  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM rate, and float32 rate outside the tensor
# cores (the sort network's min/max and the sums are plain f32 instructions)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TOL = dict(rtol=1e-5, atol=1e-5)

M, N_BYZ, T, TRIM = 17, 8, 150, 8
LEAF_SHAPES = [(M, 8192), (M, 1280), (M, 128), (M, 10)]  # w1, w2, b1, b2
CHECK_M = (3, 8, 16, 17, 25, 32, 64)
CHECK_D = (10, 50, 777, 2048, 8192, 9610)


def emit(obj):
    print(json.dumps(obj), flush=True)


def max_abs_err(got, want):
    finite = torch.isfinite(want)
    if not bool(finite.any()):
        return 0.0
    return float((got[finite] - want[finite]).abs().max())


def check(got, want, what):
    torch.testing.assert_close(got, want, equal_nan=True, msg=lambda s: f"{what}: {s}",
                               **TOL)
    return max_abs_err(got, want)


# ------------------------------------------------------------- 2. kernels


def check_kernels(dev):
    """cw_reduce against kref on the card. Returns the largest |error| seen
    on normal-scale inputs and the number of comparisons."""
    gen = torch.Generator().manual_seed(0)
    worst, n = 0.0, 0
    for m in CHECK_M:
        for d in CHECK_D:
            x32 = torch.randn(m, d, generator=gen) * 3.0
            for dtype in (torch.float32, torch.bfloat16):
                x = x32.to(dtype).to(dev)
                tag = f"m={m} d={d} {dtype}"
                worst = max(worst, check(fused.cwmed(x), kref.cwmed_ref(x),
                                         f"med {tag}"))
                worst = max(worst, check(fused.cw_reduce(x, "mean"),
                                         kref.cw_mean_ref(x), f"mean {tag}"))
                n += 2
                for trim in sorted({0, 2, 5, 8, (m - 1) // 2}):
                    want = kref.cwtm_ref(x, min(trim, (m - 1) // 2))
                    worst = max(worst, check(fused.cwtm(x, trim), want,
                                             f"tm trim={trim} {tag}"))
                    t_dev = torch.tensor(trim, dtype=torch.int32, device=dev)
                    worst = max(worst, check(fused.cwtm_masked(x, t_dev), want,
                                             f"tm_masked trim={trim} {tag}"))
                    n += 2
    # edge inputs: a 1e30 row, and a NaN that must turn its column to NaN
    x = (torch.randn(M, 9610, generator=gen) * 3.0).to(dev)
    x[0] = 1e30
    med = fused.cwmed(x)
    check(med, kref.cwmed_ref(x), "med 1e30 outlier")
    assert float(med.abs().max()) < 100.0, "median moved by the 1e30 row"
    for trim in (0, 2, TRIM):
        check(fused.cwtm(x, trim), kref.cwtm_ref(x, trim), f"tm 1e30 trim={trim}")
    check(fused.cw_reduce(x, "mean"), kref.cw_mean_ref(x), "mean 1e30")
    x = (torch.randn(M, 9610, generator=gen) * 3.0).to(dev)
    x[5, 3] = float("nan")
    for name, got, want in [
            ("med", fused.cwmed(x), kref.cwmed_ref(x)),
            ("tm", fused.cwtm(x, 2), kref.cwtm_ref(x, 2)),
            ("tm8", fused.cwtm(x, TRIM), kref.cwtm_ref(x, TRIM)),
            ("mean", fused.cw_reduce(x, "mean"), kref.cw_mean_ref(x))]:
        assert bool(torch.isnan(got[3])), f"{name}: NaN column not NaN"
        check(got, want, f"{name} NaN column")
        n += 1
    torch.cuda.synchronize()
    return worst, n


# ------------------------------------------------------------- 3. main path


def main_path(dev):
    params0, grad_fn, sampler, eval_fn = make_task(M, seed=0, device=dev)
    cfg = DynaBROConfig(
        mlmc=MLMCConfig(T=T, m=M, V=5.0, option=1, kappa=1.0, j_cap=5),
        aggregator="cwtm", delta=N_BYZ / M + 1e-3, attack="sign_flip")

    def run(backend):
        sw = get_switcher("periodic", M, n_byz=N_BYZ, K=10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_dynabro(grad_fn, params0, sgd(0.1),
                          dataclasses.replace(cfg, agg_backend=backend), sw,
                          sampler, T, seed=0, eval_fn=eval_fn, eval_every=30)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (ref_params, ref_logs, _), _ = run("ref")  # also warms cuBLAS and vmap

    LAUNCHES["cw_reduce"] = 0
    (params, logs, evals), secs = run("auto")  # the main path: the kernel
    launches = LAUNCHES["cw_reduce"]

    LAUNCHES["cw_reduce"] = 0
    (ref_params2, ref_logs2, _), ref_secs = run("ref")
    ref_launches = LAUNCHES["cw_reduce"]

    j_max = cfg.mlmc.j_max
    levels = [l.level for l in logs]
    expected = sum(12 if 1 <= j <= j_max else 4 for j in levels)
    acc = evals[-1][1]["test_acc"]
    diff = max(float((params[k] - ref_params[k]).abs().max()) for k in params)
    rerun = max(float((ref_params2[k] - ref_params[k]).abs().max())
                for k in params)
    for k in params:
        assert params[k].shape == params0[k].shape, k
        assert bool(torch.isfinite(params[k]).all()), f"non-finite {k}"
    assert launches == expected == 1760, (launches, expected)
    assert ref_launches == 0, ref_launches
    assert [vars(l) for l in logs] == [vars(l) for l in ref_logs], "logs differ"
    assert [vars(l) for l in ref_logs2] == [vars(l) for l in ref_logs]
    assert diff <= 1e-6, f"kernel vs plain params differ by {diff}"
    assert acc > 0.8, f"final test_acc {acc} <= 0.8"
    emit({"phase": "main_path", "T": T, "m": M, "n_byz": N_BYZ, "trim": TRIM,
          "d": sum(p.numel() for p in params.values()),
          "levels": {j: levels.count(j) for j in sorted(set(levels))},
          "failsafe_ok": sum(l.failsafe_ok for l in logs),
          "evals": [[t, e["test_acc"]] for t, e in evals], "test_acc": acc,
          "cw_reduce_launches": launches, "expected_launches": expected,
          "ref_launches": ref_launches, "max_param_diff_vs_ref": diff,
          "ref_rerun_max_param_diff": rerun,
          "seconds": secs, "rounds_per_s": T / secs,
          "ref_seconds": ref_secs, "ref_rounds_per_s": T / ref_secs})
    return launches


# ------------------------------------------------------------- 4. timing


def time_calls_us(fn, iters=1000, warmup=50):
    """Per-call time of ``fn`` issued back to back from Python, by CUDA
    events: what a caller pays per call, launch overhead included."""
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
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed, so no host launch gap sits between them."""
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


def bound_us(m, d, itemsize):
    """Least time for one call: the larger of its bytes over the HBM rate
    and its float32 operations over the f32 rate."""
    np2 = 1 << (m - 1).bit_length()
    log2 = np2.bit_length() - 1
    ops = d * (np2 * log2 * (log2 + 1) // 2 + m)  # min+max per comparator, sum
    nbytes = m * d * itemsize + 4 * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e6, "bytes" if t_bytes >= t_ops else "operations"


def timing(dev):
    """Each kernel at the main path's shapes, beside its plain version and,
    where one exists, a PyTorch call computing the same function. ``*_us``
    is device time per call (CUDA graph replay); ``*_call_us`` is the time
    per call issued back to back from Python."""
    gen = torch.Generator().manual_seed(1)
    t_host = torch.tensor(TRIM, dtype=torch.int32)
    t_dev = t_host.to(dev)
    rows = {}
    for m, d in LEAF_SHAPES + [(M, 9610)]:
        x = (torch.randn(m, d, generator=gen) * 1e-2).to(dev)
        b_us, b_by = bound_us(m, d, 4)
        # mode: (kernel under graph capture, kernel per call, plain, library);
        # a trim tensor on the card is read back per call, which a capture
        # cannot do, so the captured masked call gets it from the host
        cases = {
            "tm": (lambda: fused.cwtm(x, TRIM), lambda: fused.cwtm(x, TRIM),
                   lambda: kref.cwtm_ref(x, TRIM), None),
            "tm_masked": (lambda: fused.cwtm_masked(x, t_host),
                          lambda: fused.cwtm_masked(x, t_dev),
                          lambda: kref.cwtm_ref(x, t_dev), None),
            "med": (lambda: fused.cwmed(x), lambda: fused.cwmed(x),
                    lambda: kref.cwmed_ref(x),
                    lambda: torch.median(x, 0).values),
        }
        for mode, (kern, kern_call, plain, library) in cases.items():
            row = {"phase": "timing", "kernel": "cw_reduce", "mode": mode,
                   "trim": None if mode == "med" else TRIM, "m": m, "d": d,
                   "dtype": "float32",
                   "max_abs_err": max_abs_err(kern_call(), plain()),
                   "kernel_us": time_graph_us(kern),
                   "kernel_call_us": time_calls_us(kern_call),
                   "plain_us": time_graph_us(plain),
                   "plain_call_us": time_calls_us(plain),
                   # no single PyTorch call computes a trimmed mean
                   "library_us": time_graph_us(library) if library else None,
                   "library_call_us": time_calls_us(library) if library else None,
                   "bound_us": b_us, "bound_by": b_by}
            emit(row)
            rows[(mode, m, d)] = row
    return rows


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    build_s = kbuild.build(["cw_reduce"])
    ptxas = [ln.strip() for ln in kbuild.build_log("cw_reduce").splitlines()
             if "registers" in ln or "spill" in ln or "stack frame" in ln]
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_seconds": build_s, "ptxas": ptxas})

    worst, n_checks = check_kernels(dev)
    emit({"phase": "kernel_check", "kernel": "cw_reduce", "comparisons": n_checks,
          "max_abs_err": worst, "rtol": TOL["rtol"], "atol": TOL["atol"]})

    launches = main_path(dev)
    rows = timing(dev)

    main_row = rows[("tm", M, 8192)]
    med_row = rows[("med", M, 8192)]
    emit({"kernels": [{
        "name": "cw_reduce", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cw_reduce.cu",
        "replaces": "src/repro/kernels/fused.py:156",
        "launches": launches,
        "max_abs_err": max([worst] + [r["max_abs_err"] for r in rows.values()]),
        "ms": main_row["kernel_us"] / 1e3,
        "call_ms": main_row["kernel_call_us"] / 1e3,
        "plain_ms": main_row["plain_us"] / 1e3,
        "plain_call_ms": main_row["plain_call_us"] / 1e3,
        "bound_ms": main_row["bound_us"] / 1e3,
        "bound_by": main_row["bound_by"],
        # at trim (m-1)/2 of odd m the trimmed mean keeps only the middle
        # row, so torch.median computes the same function
        "library_ms": med_row["library_us"] / 1e3,
        "library_call_ms": med_row["library_call_us"] / 1e3,
        "shape": [M, 8192], "mode": "tm", "trim": TRIM}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
