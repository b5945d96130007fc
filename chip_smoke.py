#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout: it builds the port's CUDA kernels from the
sources there (``nvcc``, one process per source, all started together, into
``build/repro_torch/``), then

  1. prints the card (nvidia-smi name and power limit), the torch and CUDA
     versions, the build time and every kernel instance's registers and
     spills; runs the port's static pass, ``python -m repro_torch.lint
     --check``, in a subprocess, which must exit 0;
  2. holds every kernel against its plain PyTorch version on the card over a
     sweep of shapes, dtypes and modes, a 1e30 outlier row and a NaN entry:
     ``cw_reduce``, ``weighted_combine`` and ``combine_reduce`` at
     rtol = atol = 1e-5, ``pairwise_sqdist`` and ``cross_sqdist`` at atol
     2e-6 after dividing by the larger of the largest distance and the
     largest squared row norm;
     Then holds the tree launches of ``combine.cu`` (``tree_weighted_combine``,
     ``tree_combine_reduce``) and of ``cw_reduce.cu`` (``tree_cw_reduce``,
     with the trim a value and an int32 on the card) against the plain
     version of every leaf at 1e-5 and bitwise against one launch per leaf:
     k in {1, 17, 64} and m in {2, 17, 33, 64}, every reduce mode, both
     dtypes, the main path's four-leaf tree, one leaf, more leaves than a
     launch takes, and widths of 1 and not a multiple of 4; and every plan
     of ``cw_reduce.cu`` against the default plan's bits; and
     ``tree_cw_reduce`` over the model zoo's 11-leaf gradient tree at
     SmolLM-360M's widths (17 x 125.8M float32) and over whisper-base's
     33-leaf tree (17 x 114.0M, two launches a call) against the plain
     version leaf by leaf and bitwise against one launch per leaf;
  3. runs one ``pairwise_sqdist`` and one ``cross_sqdist`` call at 17 x 8192
     and at 17 x 10, and one call of each tree form of ``combine.cu`` and of
     ``tree_cw_reduce`` over the main path's four leaves, under
     ``torch.profiler`` and fails unless each call is exactly one CUDA
     kernel on the card; then calls ``cwtm_masked`` with the trim on the
     card under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync)
     and replays a captured CUDA graph of it after changing the trim in
     place; then the sweep's forms: ``tree_cw_reduce_lanes`` (one launch
     for every leaf of C in {1, 3, 8, 17} lanes, m in {2, 17, 33, 64}, both
     dtypes, a trim a lane on the card, out-of-range ones included) against
     the plain version at 1e-5 and bitwise against one ``tree_cw_reduce``
     a lane, ``tree_combine_reduce`` with its trim on the card bitwise equal
     to the int trim, each one CUDA kernel a call, and a graph of both
     that replays with the trims changed in place;
  4. trains the main path, DynaBRO Algorithm 2 on the paper's Figure-1
     setting (m=17, 8 Byzantine, sign_flip under Periodic(10), CWTM at trim
     8, T=150, sgd(0.1), the 64-128-10 Gaussian-mixture MLP at full width)
     through ``make_task`` / ``run_dynabro`` with the default backend, and
     checks the test accuracy, the kernel's launch count (one tree call an
     aggregation), and a second run on the plain backend;
  5. trains the same setting with each geometry rule: NNM+CWTM, MFM
     (Option 2, adagrad_norm(0.5)), Krum and GeoMed (8 Weiszfeld steps), on
     the default backend and on the plain one, and checks every kernel's
     launch count, the round logs and params against the plain backend, and
     that no discrete choice of the rule (Krum's pick, NNM's neighbours,
     MFM's filter) differs between the two;
  6. trains the same setting through the compiled driver
     (``run_dynabro_scan``, one captured CUDA graph per MLMC level) with
     CWTM, NNM+CWTM, MFM, Krum and GeoMed beside ``run_dynabro``: equal round
     logs and evals, params within 1e-6 (CWTM) or 1e-5, the per-round
     driver's exact launch counts, every round a graph replay under
     ``torch.cuda.set_sync_debug_mode("error")`` (no host sync between
     evaluation points, no eager fallback), and rounds/s of the two drivers
     in turns on CWTM and GeoMed, with each level's capture time; CWTM under
     the shift, ipm, alie (z = 1.22 and z from the Byzantine count) and
     random attacks through both drivers, and the random attack's
     statistics on one stack; and the App. E comparison at full width:
     worker momentum (``run_momentum``, ``run_momentum_scan``) under the
     momentum-tailored switcher and shift, beside DynaBRO's compiled driver;
  7. drives the ``repro_torch.api`` facade at full width: ``build_session``
     with CWTM under sign_flip and random, guarded (``guard_recompiles=
     True``), ``Session.run(150)`` bitwise equal to ``run_dynabro_scan``
     and capturing each level once, a second ``run(150)`` under the
     recompile guard with no capture, 150 ``Session.step`` calls bitwise
     equal to ``run`` (no capture; a level's first step is warmup, the
     rest guarded), a checkpoint at t = 75 resumed bitwise
     (``session_path``); then, its graphs dropped, a guarded ``run(150)``
     raising ``RecompileError`` with its captures counted, a
     ``recompile_guard(action="count")`` counting them without raising,
     and an exception inside a guarded block coming through unmasked
     (``forced_recapture``); two lane-batched sweeps through
     ``Session.sweep`` (``sweep_path``): grid 1, 8 CWTM lanes of {sign_flip,
     ipm} x Periodic K in {10, 25} x trim {8, 6} with one ``cw_reduce``
     launch an aggregation for all of them, again with the deltas swapped
     and no capture; grid 2, 10 lanes of {CWTM, NNM+CWTM, Krum, GeoMed,
     MFM (Option 2)} x K in {10, 25}; every round a graph replay under the
     sync check, each lane against a lone ``run_dynabro_scan`` (equal logs,
     params within 1e-6 for CWTM or 1e-5), lanes·rounds/s of each sweep and
     of its lone runs in turns; and ``run_matrix`` on App. E's quadratic
     (the README's grid, m=16, T=200) with ``driver="vmap"`` and seeds
     (0, 1, 2), each seed's rows against ``driver="scan"``
     (``matrix_path``);
  8. drives the aggregation service ``repro_torch.serve`` on the Figure-1
     setting (``serve_path``): (a) 17 ``SimulatedWorkers`` threads stream
     2,550 updates into an ``AggregationServer`` over ``build_session``,
     the session built with ``REPRO_RECOMPILE_GUARD=1`` (every round after
     a level's first guarded, no ``RecompileError``, no capture in the
     timed pairs), the health polled over HTTP until "completed": params
     bitwise equal to a fresh session's ``Session.run(150)``, its logs,
     440 ``cw_reduce`` launches, every round a graph replay under the sync check, each level
     captured once, on the serve thread, with the worker threads alive;
     rounds/s, updates/s, staleness, ring high-water and the last round's
     seconds, beside 150 ``Session.step`` calls in turns; (b) under the
     random attack, checkpoints every 25 rounds, a kill after round 80 and
     ``AggregationServer.resume`` from 75, bitwise equal to ``run``, with a
     final checkpoint at 150; (c) three stragglers on two rounds masked
     after a 0.25 s deadline, bitwise equal to an offline ``Session.step``
     replay of the same zero-fill and mask OR; (d) ``repro_torch.serve.
     smoke.main()`` on the card; then ``Session.sweep_halving`` over both
     sweep grids, rungs at 50 and 100, keep 0.5, the held-out loss as the
     objective (``halving_path``): every survivor bitwise equal to a
     ``Session.sweep`` of the surviving subset, each pruned cell to the
     sweep of the cells alive in its last segment stopped at its rung,
     every round a replay under the sync check; the captures at each rung
     and lanes·rounds/s beside the full sweep's, in turns; then the
     sharded drivers (``mesh_path``): ``make_worker_mesh(1)`` with CWTM and
     GeoMed bitwise ``mesh=None`` with the same launches, and two gloo
     ranks on the one card (this script with ``--mesh-rank``): CWTM,
     GeoMed, NNM+CWTM and worker momentum on a 2-rank worker mesh at m=16
     (7 Byzantine, trim 7), every round two graph replays under the sync
     check with the worker gather between them, each rank's launches the
     unsharded run's, the ranks' params bitwise equal, rank 0's logs equal
     to the unsharded run's and its params within 32 units in the last
     place of each leaf's largest value; grid 1's sweep on a (2, 1) lane
     mesh, each lane bitwise; the m=16 CWTM, GeoMed and NNM+CWTM runs
     through ``run_dynabro`` on the kernels and on the plain backend (equal
     logs, params within 1e-6/1e-5); rounds/s of each beside the unsharded run's, and
     the gathers and gather ms a run;
  9. trains DynaBRO over SmolLM-360M at its published width, 8 of its 32
     layers (``task_for_config``, ``run_dynabro_scan(microbatch=True)``:
     m=17, 8 Byzantine, sign_flip under Periodic(4), CWTM at trim 8, T=16,
     seq_len 128), with the kernel path's graph replays under the sync
     check, one ``cw_reduce`` launch an aggregation, a bitwise rerun, a
     falling held-out loss and the plain backend's logs and params; prints
     its rounds/s, capture seconds a level and peak memory (``zoo_path``);
     and (e) of ``serve_path``: 4 rounds of that model served from 17
     worker threads, the session sharing the path's scan_fn (no capture),
     bitwise equal to ``Session.run(4)``, with rounds/s and peak memory;
     then the GSPMD path (``gspmd_path``, ``run_dynabro_scan(mesh=,
     param_specs=plan_params(...))``): a (1, 1) ``(workers, 'model')``
     mesh on that setting bitwise the zoo run with its launches; two gloo
     ranks on the one card (this script with ``--gspmd-rank``) on a (1, 2)
     mesh, the same setting, each rank holding half of most parameters,
     the ranks bitwise equal, their logs the zoo run's, params within rtol
     1e-5, atol 1e-6 of it, 44 ``cw_reduce`` launches a rank, every round
     eager; four gloo ranks on a (2, 2) mesh, qwen3-0.6b at d_model 512,
     m=16 (7 Byzantine), T=8, CWTM streamed and GeoMed stacked, each
     against its unsharded run on rank 0; each rank's peak memory,
     rounds/s, collectives and their ms; then Mode B's robust step
     (``modeb_path``, ``launch.steps.build_train_step`` /
     ``build_mlmc_train_step``): eight gloo ranks on the one card (this
     script with ``--modeb-rank``, started before ``gspmd_path``) on a
     (4, 2) ``('data', 'model')`` mesh, SmolLM-360M at its published width
     (8 layers), one worker a position of 'data', 8 steps of CWTM at delta
     0.25 under sign_flip on worker 0 (sgd(0.05), seq 128, global batch
     8) and one MLMC step at J=1 (CWMed), against the unsharded
     computation of the same steps in this process (each worker's
     gradient, the attack, K1's tree, held to the plain version's on the
     same stacks, sgd): the ranks' full params bitwise each other, within
     rtol 1e-5, atol 1e-6 of the unsharded ones (ulps printed),
     their losses within rtol 1e-6 of the unsharded losses, finite (and
     falling, a weak check), failsafe_ok 1, 90 ``cw_reduce`` launches a
     rank (one a hooked scope a gradient; the MLMC step at J=1 takes two
     gradients) and no other kernel; each rank's steps/s (its one run),
     gloo seconds of gathers, exchanges and sums, and peak memory; K1 is
     also held to the plain version at the ranks' m=4 block widths
     (``check_modeb_kernels``);
     then the zoo's other families in the same setting
     (``zoo_families_path``): whisper-base at its published width and depth
     (6 + 6 layers, d_model 512, 1500 encoder frames, 113,959,936
     parameters, flash attention), with two ``cw_reduce`` launches an
     aggregation, a bitwise rerun, the Mean rule's unattacked held-out loss
     falling and the plain backend's logs and params; and llama-3.2-vision,
     qwen2-moe, arctic, rwkv6 and jamba at ``get_reduced_config(arch,
     d_model=512)`` with their launches (1, 2 or 4 an aggregation), a
     bitwise rerun and the plain backend, the MoE ones with every round's
     top-k routing equal in both backends; each prints rounds/s, capture
     seconds a level, peak memory and the batch schedule's bytes (every zoo
     path at ``forward``'s default ``remat=True``: each layer group, and
     each Mamba chunk, recomputed in the backward; whisper-base and jamba
     also at ``remat=False``, a capture run and a timed rerun after the
     default's, replays under the sync check, params and logs bitwise the
     default's, with rounds/s and peak memory); then the recomputing
     forward against ``remat=False`` (``remat_path``): one unit's
     ``vmap(grad)`` over the 17 workers of SmolLM-360M (8 layers),
     whisper-base and the five reduced archs, remat=False, True, True,
     False, every gradient bitwise the first's, with each run's ms and
     peak memory; then the zoo's decode entry points (``decode_path``):
     greedy decoding at batch 4 through ``prefill`` (pad_to = prompt +
     steps + 1) and ``decode_step`` with a device ``pos``, of SmolLM-360M
     at its published width and full depth (32 layers; prompt 128, 32
     steps), whisper-base (1500 frames;
     prompt 64, 32 steps) and rwkv6-1.6b (24 layers, d_model 2048; prompt
     64, 16 steps) at theirs, and llama-3.2-vision, qwen2-moe, arctic and
     jamba at ``get_reduced_config(arch, d_model=512)`` (prompt 32, 8
     steps): every step's logits against a full forward over the same
     prefix (within 1e-3 of the largest |logit|), the tokens the forward's
     argmax wherever its top-2 margin allows, a bitwise rerun, one step
     under the sync check, the MoE layers' experts equal to the forward's;
     each prints prefill ms, decode ms a token, tokens/s, peak memory, the
     largest logit error and the least top-2 margin;
 10. times each kernel at the main path's shapes beside its plain version,
     one PyTorch library call where one computes the same function, and the
     card's bound; the tree kernels also over the main path's four-leaf
     tree (``cw_reduce`` beside one launch per leaf, and its lane form over
     8 lanes beside one tree call a lane; K5 with its trim on the card), and
     ``cw_reduce`` also at 64 x 8192 and at 17 x 2^20 in float32 and
     bfloat16, and over the zoo's 11-leaf tree beside ``torch.median`` and
     its 2.70 ms bytes bound, and over whisper-base's 33-leaf tree (two
     launches) beside its 2.449 ms bound;
 11. prints the ``{"lint": {...}}`` line (the static pass; each guarded
     path's warmup captures and steady-state compiles; the forced counts),
     the ``{"kernels": [...]}`` summary (each kernel's launches by
     path, the served and halving paths among them), then
     ``{"ok": true, "device": {...}}`` as the last line.

One JSON object per line, apart from the nvidia-smi line. Any failure raises
and the exit code is non-zero; so is it without a CUDA card.
"""
import contextlib
import dataclasses
import gc
import hashlib
import inspect
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from torch.utils._pytree import tree_map  # noqa: E402

from repro_torch import (  # noqa: E402
    LAUNCHES, AggregationServer, AggSpec, AttackSpec, DynaBROConfig,
    MLMCConfig, ServeConfig, SimulatedWorkers, SweepSpec, Task, adagrad_norm,
    build_session, checkpoint_step, format_table, get_attack, get_switcher,
    latest_checkpoint, load_checkpoint, make_dynabro_scan_fn,
    make_lane_mesh, make_momentum_scan_fn, make_quadratic_task, make_task,
    make_worker_mesh, run_dynabro,
    run_dynabro_scan, run_matrix, run_momentum, run_momentum_scan,
    save_checkpoint, scenario_grid, sgd, worker_payloads,
)
from repro_torch.api.session import GUARD_ENV  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import aggregators  # noqa: E402
from repro_torch.core.agg_engine import get_aggregator  # noqa: E402
from repro_torch.core import robust_train as rt  # noqa: E402
from repro_torch.core.sharded import COLLECTIVES, GATHERS, scope_plans  # noqa: E402
from repro_torch.data import classification as clf  # noqa: E402
from repro_torch.serve import smoke as serve_smoke  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import fused  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.lint import (  # noqa: E402
    RecompileError, compile_count, recompile_guard,
)
from repro_torch.core.mlmc import mlmc_combine  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_test_mesh  # noqa: E402
from repro_torch.launch.sharding import abstract_params, plan_params  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    build_mlmc_train_step, build_train_step,
)
from repro_torch.optim.optimizers import apply_updates  # noqa: E402
from repro_torch.models import init_params, task_for_config  # noqa: E402
from repro_torch.models import moe as zoo_moe  # noqa: E402
from repro_torch.models import transformer as zoo_tf  # noqa: E402
from repro_torch.models.transformer import loss_fn as zoo_loss  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM rate, and float32 rate outside the tensor
# cores (the sort network's min/max and the sums are plain f32 instructions)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TOL = dict(rtol=1e-5, atol=1e-5)

M, N_BYZ, T, TRIM = 17, 8, 150, 8
DELTA = N_BYZ / M + 1e-3
LEAF_SHAPES = [(M, 8192), (M, 1280), (M, 128), (M, 10)]  # w1, w2, b1, b2
CHECK_M = (3, 8, 16, 17, 25, 32, 64)
CHECK_D = (10, 50, 777, 2048, 8192, 9610)
GEO_CHECK_M = (1, 2, 3, 16, 17, 32, 64)  # 16: mesh_path's m
GEO_CHECK_D = (10, 777, 8192, 9610)
DIST_ATOL = 2e-6  # of max(largest distance, largest squared row norm)
LIBRARIES = ("cw_reduce", "sqdist", "combine")
KERNELS = ("cw_reduce", "pairwise_sqdist", "cross_sqdist", "weighted_combine",
           "combine_reduce")


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


def check_dist(got, want, what, *rows):
    """Squared distances: equal where not finite; elsewhere within
    DIST_ATOL after dividing both by the larger of the largest distance and
    the largest squared row norm (the Gram expansion cancels relative to the
    row norms). Returns that scaled error."""
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite), f"{what}: inf/NaN differ"
    torch.testing.assert_close(got[~finite], want[~finite], equal_nan=True,
                               rtol=0, atol=0, msg=lambda s: f"{what}: {s}")
    norms = torch.cat([r.float().square().sum(1) for r in rows])
    norms = norms[torch.isfinite(norms)]
    scale = max(float(want[finite].max()) if bool(finite.any()) else 0.0,
                float(norms.max()) if norms.numel() else 0.0, 1e-30)
    err = (float((got[finite] - want[finite]).abs().max()) / scale
           if bool(finite.any()) else 0.0)
    assert err <= DIST_ATOL, f"{what}: scaled error {err} > {DIST_ATOL}"
    return err


def check_geometry_kernels(dev):
    """pairwise_sqdist, cross_sqdist, weighted_combine and combine_reduce
    (and fused_pass over them) against kref on the card. Returns the largest
    error per kernel (scaled for the distances, absolute for the combines)
    and the number of comparisons."""
    gen = torch.Generator().manual_seed(2)
    worst = dict.fromkeys(KERNELS[1:], 0.0)
    n = 0

    def note(name, err):
        nonlocal n
        worst[name] = max(worst[name], err)
        n += 1

    for m in GEO_CHECK_M:
        for d in GEO_CHECK_D:
            x32 = torch.randn(m, d, generator=gen) * 3.0
            y32 = torch.randn(2, d, generator=gen) * 3.0
            ws = [torch.rand(1, m, generator=gen), torch.rand(m, m, generator=gen)]
            for dtype in (torch.float32, torch.bfloat16):
                x, y = x32.to(dtype).to(dev), y32.to(dtype).to(dev)
                tag = f"m={m} d={d} {dtype}"
                pw = fused.pairwise_sqdist(x)
                assert torch.equal(pw, pw.T), f"pairwise not symmetric {tag}"
                assert torch.equal(pw, fused.pairwise_sqdist(x)), f"rerun {tag}"
                note("pairwise_sqdist", check_dist(
                    pw, kref.pairwise_sqdist_ref(x), f"pairwise {tag}", x))
                for k in (1, 2):
                    note("cross_sqdist", check_dist(
                        fused.cross_sqdist(x, y[:k]),
                        kref.cross_sqdist_ref(x, y[:k]), f"cross k={k} {tag}",
                        x, y))
                for w in ws:
                    wd, k = w.to(dev), w.shape[0]
                    mixed = kref.weighted_combine_ref(x, wd)
                    note("weighted_combine", check(
                        fused.weighted_combine(x, wd), mixed,
                        f"combine k={k} {tag}"))
                    for mode in fused.REDUCE_MODES:
                        trims = sorted({0, 2, 5, (k - 1) // 2}) if mode == "tm" else [0]
                        for trim in trims:
                            trim = min(trim, (k - 1) // 2)
                            note("combine_reduce", check(
                                fused.combine_reduce(x, wd, mode, trim),
                                kref.combine_reduce_ref(x, wd, mode, trim),
                                f"combine_reduce {mode} trim={trim} k={k} {tag}"))
                    both = fused.fused_pass(x, w=wd, reduce="tm", trim=TRIM,
                                            combine=True)
                    note("combine_reduce", check(
                        both["reduce"], kref.combine_reduce_ref(
                            x, wd, "tm", min(TRIM, (k - 1) // 2)),
                        f"fused reduce+combine k={k} {tag}"))
                    note("combine_reduce", check(both["combine"], mixed,
                                                 f"fused combine k={k} {tag}"))
    # edge inputs: a 1e30 row, and a NaN that must reach every output it
    # touches (distances of its row, its column of every combine)
    x = (torch.randn(M, 9610, generator=gen) * 3.0).to(dev)
    x[0] = 1e30
    x[5, 3] = float("nan")
    z = x[1:2].clone()
    w = (torch.rand(M, M, generator=gen) / M).to(dev)
    note("pairwise_sqdist", check_dist(fused.pairwise_sqdist(x),
                                       kref.pairwise_sqdist_ref(x),
                                       "pairwise 1e30/NaN", x))
    note("cross_sqdist", check_dist(fused.cross_sqdist(x, z),
                                    kref.cross_sqdist_ref(x, z),
                                    "cross 1e30/NaN", x, z))
    got = fused.weighted_combine(x, w)
    assert bool(torch.isnan(got[:, 3]).all()), "combine: NaN column not NaN"
    check(got, kref.weighted_combine_ref(x, w), "combine 1e30/NaN")
    for mode in fused.REDUCE_MODES:
        got = fused.combine_reduce(x, w, mode, TRIM)
        assert bool(torch.isnan(got[3])), f"combine_reduce {mode}: NaN column"
        check(got, kref.combine_reduce_ref(x, w, mode, TRIM),
              f"combine_reduce {mode} 1e30/NaN")
    n += 4
    torch.cuda.synchronize()
    return worst, n


# leaf widths of the trees the tree launches are held on: the main path's,
# one leaf, more leaves than one launch takes, narrow and odd widths
TREE_CHECKS = {
    "main": [d for _, d in LEAF_SHAPES],
    "one": [9610],
    "many": [1 + (37 * i) % 97 for i in range(fused.MAX_LEAVES + 9)],
    "odd": [1, 3, 5, 7, 13, 130, 6, 1282],
}


def check_tree_kernels(dev):
    """tree_weighted_combine and tree_combine_reduce against the plain
    version of every leaf (within TOL) and against one launch per leaf (bit
    for bit), with their launch counts. Returns the largest error of each
    and the number of comparisons."""
    gen = torch.Generator().manual_seed(5)
    worst = {"weighted_combine": 0.0, "combine_reduce": 0.0}
    n = 0
    for tree, widths in TREE_CHECKS.items():
        per_call = -(-len(widths) // fused.MAX_LEAVES)
        for k, m in [(1, M), (M, M), (16, 16), (64, 64)]:  # 16: mesh_path's
            x32 = [torch.randn(m, d, generator=gen) * 3.0 for d in widths]
            w = torch.rand(k, m, generator=gen).to(dev)
            for dtype in (torch.float32, torch.bfloat16):
                xs = [x.to(dtype).to(dev) for x in x32]
                tag = f"tree={tree} k={k} m={m} {dtype}"
                before = dict(LAUNCHES)
                ys = fused.tree_weighted_combine(xs, w)
                assert LAUNCHES["weighted_combine"] == before["weighted_combine"] + per_call, tag
                for x, y in zip(xs, ys):
                    one = fused.weighted_combine(x, w)
                    assert torch.equal(y.reshape(one.shape), one), f"tree vs leaf {tag}"
                    worst["weighted_combine"] = max(worst["weighted_combine"], check(
                        y.reshape(one.shape), kref.weighted_combine_ref(x, w),
                        f"tree combine {tag}"))
                    n += 1
                for mode in fused.REDUCE_MODES:
                    for trim in (sorted({0, 2, TRIM, (k - 1) // 2}) if mode == "tm" else [0]):
                        trim = min(trim, (k - 1) // 2)
                        before = LAUNCHES["combine_reduce"]
                        reds = fused.tree_combine_reduce(xs, w, mode, trim)
                        assert LAUNCHES["combine_reduce"] == before + per_call, tag
                        for x, red in zip(xs, reds):
                            assert torch.equal(red, fused.combine_reduce(x, w, mode, trim)), \
                                f"tree vs leaf {mode} trim={trim} {tag}"
                            worst["combine_reduce"] = max(worst["combine_reduce"], check(
                                red, kref.combine_reduce_ref(x, w, mode, trim),
                                f"tree combine_reduce {mode} trim={trim} {tag}"))
                            n += 1
    torch.cuda.synchronize()
    return worst, n


CW_TREE_M = (2, 4, 17, 33, 64)  # 4: Mode B's m


def check_cw_tree_kernels(dev):
    """tree_cw_reduce against the plain version of every leaf (within TOL)
    and against one launch per leaf (bit for bit), in every mode, with the
    trim a value and an int32 on the card, with its launch counts; then
    every plan of ``cw_reduce.cu`` against the default plan's bits. Returns
    the largest error and the number of comparisons."""
    gen = torch.Generator().manual_seed(6)
    worst, n = 0.0, 0
    for tree, widths in TREE_CHECKS.items():
        per_call = -(-len(widths) // fused.MAX_LEAVES)
        for m in CW_TREE_M:
            x32 = [torch.randn(m, d, generator=gen) * 3.0 for d in widths]
            t_dev = torch.tensor(TRIM, dtype=torch.int32, device=dev)
            cases = ([("med", 0), ("mean", 0)]
                     + [("tm", t) for t in sorted({0, 2, TRIM, (m - 1) // 2})]
                     + [("tm", t_dev)])
            for dtype in (torch.float32, torch.bfloat16):
                xs = [x.to(dtype).to(dev) for x in x32]
                for mode, trim in cases:
                    tag = (f"tree={tree} m={m} {dtype} {mode} trim={int(trim)}"
                           f"{' on the card' if torch.is_tensor(trim) else ''}")
                    before = LAUNCHES["cw_reduce"]
                    outs = fused.tree_cw_reduce(xs, mode, trim)
                    assert LAUNCHES["cw_reduce"] == before + per_call, tag
                    for x, out in zip(xs, outs):
                        assert torch.equal(out, fused.cw_reduce(x, mode, trim)), \
                            f"tree vs leaf {tag}"
                        worst = max(worst, check(out, kref.cw_reduce_ref(x, mode, trim),
                                                 f"tree cw_reduce {tag}"))
                        n += 1
    for m in (M, 64):
        xs = [(torch.randn(m, d, generator=gen) * 3.0).to(dev)
              for d in TREE_CHECKS["odd"] + TREE_CHECKS["main"]]
        for mode in fused.REDUCE_MODES:
            want = fused.tree_cw_reduce(xs, mode, TRIM)
            for lanes in fused.CW_REDUCE_LANES:
                for cols in (16, 32, 64, 128, 256):
                    plan = fused.CwReducePlan(lanes, cols)
                    if not fused.cw_reduce_plan_fits(plan, m):
                        continue
                    got = fused.tree_cw_reduce(xs, mode, TRIM, plan=plan)
                    assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                        f"plan {plan} m={m} {mode}"
                    n += 1
    torch.cuda.synchronize()
    return worst, n


def check_device_trim(dev):
    """``cwtm_masked`` with the trim an int32 on the card: no host sync
    (``set_sync_debug_mode("error")`` raises on one), and a captured CUDA
    graph of tree calls that replays with the trim changed in place."""
    gen = torch.Generator().manual_seed(7)
    x = (torch.randn(M, 9610, generator=gen) * 3.0).to(dev)
    xs = [(torch.randn(m, d, generator=gen) * 3.0).to(dev) for m, d in LEAF_SHAPES]
    t_dev = torch.tensor(TRIM, dtype=torch.int32, device=dev)
    fused.cwtm_masked(x, t_dev)  # warm: the library is loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fused.cwtm_masked(x, t_dev)
        tree = fused.tree_cw_reduce(xs, "tm", t_dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, fused.cwtm(x, TRIM)), "device trim vs value"
    for a, b in zip(tree, fused.tree_cw_reduce(xs, "tm", TRIM)):
        assert torch.equal(a, b), "device trim vs value, tree"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused.tree_cw_reduce(xs, "tm", t_dev)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fused.tree_cw_reduce(xs, "tm", t_dev)
    replays = 0
    for trim in (TRIM, 0, 3, 100, -2, TRIM):
        t_dev.fill_(trim)
        graph.replay()
        torch.cuda.synchronize()
        for got, x in zip(captured, xs):
            assert torch.equal(got, fused.cwtm(x, trim)), f"replay at trim {trim}"
        replays += 1
    emit({"phase": "device_trim", "sync_free": True, "graph_replays": replays,
          "trims": [TRIM, 0, 3, 100, -2, TRIM], "bitwise_equal_value_trim": True})


# ------------------------------------------------- the model zoo's widths

ZOO_ARCH, ZOO_LAYERS, ZOO_SEQ, ZOO_T = "smollm-360m", 8, 128, 16


def zoo_config(layers=ZOO_LAYERS):
    """SmolLM-360M at its published width (d_model 960, 15 heads of 64, 5 KV
    heads, d_ff 2560, vocab 49152, tied embeddings), ``layers`` of its 32
    layers."""
    return dataclasses.replace(get_config(ZOO_ARCH), n_layers=layers)


def zoo_stack(dev, seed, cfg=None):
    """The zoo's worker stack: one (17, d_l) float32 leaf per leaf of the
    gradient tree of ``cfg`` (default: the 8-layer SmolLM-360M, 11 leaves,
    125,845,440 columns, the embedding's 47,185,920 the widest), drawn on
    the card."""
    shapes = [(k, v.numel()) for k, v in sorted(
        init_params(cfg or zoo_config(), 0, device="cpu").items())]
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(k, torch.randn(M, d, generator=gen, device=dev) * 1e-2)
            for k, d in shapes]


def check_zoo_tree_kernels(dev, cfg=None, what="zoo widths"):
    """``tree_cw_reduce`` over the zoo's 11-leaf stack at model widths (17 x
    125.8M float32, 802M values in the embedding's leaf, 1.97M blocks), or
    over the tree of ``cfg`` (whisper-base's 33 leaves: two launches):
    against the plain version leaf by leaf (within TOL) and bit for bit
    against one launch per leaf, the trimmed mean with the trim a value and
    an int32 on the card, and the median; one launch a tree call for each
    ``MAX_LEAVES`` leaves."""
    leaves = zoo_stack(dev, 7, cfg)
    xs = [x for _, x in leaves]
    per_call = -(-len(xs) // fused.MAX_LEAVES)
    t_dev = torch.tensor(TRIM, dtype=torch.int32, device=dev)
    worst, n = 0.0, 0
    for mode, trim in (("tm", TRIM), ("tm", t_dev), ("med", 0)):
        tag = f"{what} tree {mode} trim={int(trim)}"
        before = LAUNCHES["cw_reduce"]
        outs = fused.tree_cw_reduce(xs, mode, trim)
        assert LAUNCHES["cw_reduce"] == before + per_call, tag
        for (name, x), out in zip(leaves, outs):
            assert torch.equal(out, fused.cw_reduce(x, mode, trim)), \
                f"tree vs leaf {tag} {name}"
            worst = max(worst, check(out, kref.cw_reduce_ref(x, mode, trim),
                                     f"{tag} {name}"))
            n += 1
        del outs
    torch.cuda.synchronize()
    emit({"phase": "kernel_check", "kernel": f"tree_cw_reduce ({what})",
          "leaves": {name: x.shape[1] for name, x in leaves}, "m": M,
          "launches_a_call": per_call,
          "columns": sum(x.shape[1] for x in xs), "comparisons": n,
          "max_abs_err": worst, "bitwise_equal_per_leaf_launches": True,
          "tolerance": TOL})
    del leaves, xs
    torch.cuda.empty_cache()
    return worst


def modeb_block_widths(cfg):
    """The columns of the (m, block) stacks a rank of ``modeb_path`` reduces,
    by hook scope ("top"; "blocks", one layer group's): each leaf's block
    on the (4, 2) ``('data', 'model')`` mesh, its FSDP dim split over the 4
    workers and its model dim over 'model' (``plan_params(fsdp=True)``'s
    specs, as ``build_train_step`` plans them)."""
    mesh = Mesh(("data", "model"), MODEB_MESH)
    specs, _ = plan_params(cfg, mesh, fsdp=True, dtype=torch.float32)
    shapes = {k: tuple(v.shape)
              for k, v in abstract_params(cfg, torch.float32).items()}
    widths = {}
    for scope, plan in scope_plans(mesh, specs).items():
        widths[scope] = []
        for k in sorted(plan.specs):
            shape = shapes[k] if scope == "top" else shapes["blocks/" + k][1:]
            cols = math.prod(shape)
            for d, n in zip(plan.dims(k, len(shape)), (plan.n_w, plan.n_m)):
                cols //= 1 if d is None else n
            widths[scope].append((k, cols))
    return widths


def check_modeb_kernels(dev):
    """``tree_cw_reduce`` at ``modeb_path``'s shapes: m=4 stacks of a rank's
    blocks of each hook scope of the 8-layer SmolLM-360M on the (4, 2)
    mesh (the embedding's block 5,898,240 columns), under Mode B's rules:
    the trimmed mean at trim 1 (CWTM at delta 0.25), the median (CWMed;
    at even m the mean of the two middle rows) and the mean; against the
    plain version leaf by leaf (within TOL) and bit for bit against one
    launch per leaf, one launch a scope."""
    m = MODEB_MESH[0]
    gen = torch.Generator(device=dev).manual_seed(8)
    worst, n = 0.0, 0
    widths = modeb_block_widths(zoo_config(GSPMD_LAYERS))
    for scope, leaves in widths.items():
        xs = [torch.randn(m, d, generator=gen, device=dev) * 1e-2
              for _, d in leaves]
        # ties: a leaf's rows 1 and 2 equal in every other column
        xs[0][2, ::2] = xs[0][1, ::2]
        per_call = -(-len(xs) // fused.MAX_LEAVES)
        for mode, trim in (("tm", 1), ("med", 0), ("mean", 0)):
            tag = f"modeb {scope} m={m} {mode} trim={trim}"
            before = LAUNCHES["cw_reduce"]
            outs = fused.tree_cw_reduce(xs, mode, trim)
            assert LAUNCHES["cw_reduce"] == before + per_call, tag
            for (name, _), x, out in zip(leaves, xs, outs):
                assert torch.equal(out, fused.cw_reduce(x, mode, trim)), \
                    f"tree vs leaf {tag} {name}"
                worst = max(worst, check(out, kref.cw_reduce_ref(x, mode, trim),
                                         f"{tag} {name}"))
                n += 1
        del xs, outs
    torch.cuda.synchronize()
    emit({"phase": "kernel_check", "kernel": "tree_cw_reduce (Mode B blocks)",
          "m": m, "leaves": {s: dict(v) for s, v in widths.items()},
          "modes": ["tm trim=1", "med", "mean"], "comparisons": n,
          "max_abs_err": worst, "bitwise_equal_per_leaf_launches": True,
          "tolerance": TOL})
    torch.cuda.empty_cache()
    return worst


LANE_C = (1, 3, 8, 17)


def check_lane_kernels(dev):
    """The sweep's forms of K1/K2 and K5: ``tree_cw_reduce_lanes`` over the
    main path's four leaves against the plain version of every lane (within
    TOL) and bitwise against one ``tree_cw_reduce`` launch a lane, one
    launch a call, for C lanes and m rows, both dtypes, every mode, a trim
    for all lanes and an int32 a lane on the card (out-of-range ones
    included); ``tree_combine_reduce`` with its trim an int32 on the card
    bitwise equal to the int trim; and a captured CUDA graph of each that
    replays with the trims changed in place. Returns the largest error and
    the number of comparisons."""
    gen = torch.Generator().manual_seed(8)
    widths = [d for _, d in LEAF_SHAPES]
    worst, n = 0.0, 0
    for lanes in LANE_C:
        for m in CW_TREE_M:
            x32 = [torch.randn(lanes, m, d, generator=gen) * 3.0 for d in widths]
            trims = [(-2, 0, 3, 100, (m - 1) // 2, TRIM, 1)[c % 7] for c in range(lanes)]
            t_dev = torch.tensor(trims, dtype=torch.int32, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                xs = [x.to(dtype).to(dev) for x in x32]
                for mode, trim in [("med", 0), ("mean", 0), ("tm", TRIM),
                                   ("tm", t_dev)]:
                    tag = f"lanes C={lanes} m={m} {dtype} {mode} {trims if torch.is_tensor(trim) else trim}"
                    before = LAUNCHES["cw_reduce"]
                    outs = fused.tree_cw_reduce_lanes(xs, mode, trim)
                    assert LAUNCHES["cw_reduce"] == before + 1, tag
                    for c in range(lanes):
                        t_c = trims[c] if torch.is_tensor(trim) else trim
                        one = fused.tree_cw_reduce([x[c] for x in xs], mode, t_c)
                        for out, o in zip(outs, one):
                            assert torch.equal(out[c], o), f"lane {c} vs one lane {tag}"
                    for x, out in zip(xs, outs):
                        worst = max(worst, check(out, kref.cw_reduce_lanes_ref(x, mode, trim),
                                                 f"lanes cw_reduce {tag}"))
                        n += 1
    # K5 with its trim an int32 on the card: the int trim's bits
    leaves = [(torch.randn(M, d, generator=gen) * 3.0).to(dev) for d in widths]
    for k in (M, 64):
        w = torch.rand(k, M, generator=gen).to(dev)
        for trim in (-3, 0, 2, TRIM, (k - 1) // 2, 100):
            t_dev = torch.tensor(trim, dtype=torch.int32, device=dev)
            got = fused.tree_combine_reduce(leaves, w, "tm", t_dev)
            want = fused.tree_combine_reduce(leaves, w, "tm", min(max(trim, 0), (k - 1) // 2))
            for a, b in zip(got, want):
                assert torch.equal(a, b), f"K5 trim {trim} on the card, k={k}"
                n += 1
    # graphs that replay with the trims changed in place
    xs = [(torch.randn(8, M, d, generator=gen) * 3.0).to(dev) for d in widths]
    t_lanes = torch.full((8,), TRIM, dtype=torch.int32, device=dev)
    t_k5 = torch.tensor(TRIM, dtype=torch.int32, device=dev)
    wm = torch.rand(M, M, generator=gen).to(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused.tree_cw_reduce_lanes(xs, "tm", t_lanes)
        fused.tree_combine_reduce(leaves, wm, "tm", t_k5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cap_lanes = fused.tree_cw_reduce_lanes(xs, "tm", t_lanes)
        cap_k5 = fused.tree_combine_reduce(leaves, wm, "tm", t_k5)
    replays = 0
    for step in range(5):
        trims = [(c * 3 + step * 5) % 11 - 2 for c in range(8)]
        t_lanes.copy_(torch.tensor(trims, dtype=torch.int32))
        t_k5.fill_(trims[0])
        graph.replay()
        torch.cuda.synchronize()
        for c in range(8):
            one = fused.tree_cw_reduce([x[c] for x in xs], "tm", trims[c])
            for out, o in zip(cap_lanes, one):
                assert torch.equal(out[c], o), f"lanes replay {trims}"
        for a, b in zip(cap_k5, fused.tree_combine_reduce(
                leaves, wm, "tm", min(max(trims[0], 0), (M - 1) // 2))):
            assert torch.equal(a, b), f"K5 replay trim {trims[0]}"
        replays += 1
    torch.cuda.synchronize()
    emit({"phase": "lane_kernels", "lanes": LANE_C, "m": CW_TREE_M,
          "comparisons": n, "max_abs_err": worst, "tolerance": TOL,
          "bitwise_equal_one_lane_launches": True,
          "k5_trim_on_card_bitwise_equal_int_trim": True,
          "graph_replays_trims_changed_in_place": replays})
    return worst, n


PROFILER_WINDOWS = 3


def device_kernels_per_call(dev):
    """How many CUDA kernels one call of each distance kernel puts on the
    card, by ``torch.profiler``, at the main path's widest and narrowest
    leaves (a many-block and a one-block plan), and one call of each tree
    form of ``combine.cu`` and of ``tree_cw_reduce`` over the main path's
    four leaves. Fails unless each is 1. A profiler window that comes back
    with no event at all is opened again, up to three times (the profiler
    has lost a window's events on this card before; ROADMAP.md queue 3)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator().manual_seed(4)
    counts, calls = {}, {}
    for d in (8192, 10):
        x = torch.randn(M, d, generator=gen).to(dev)
        z = torch.randn(1, d, generator=gen).to(dev)
        calls[f"pairwise_sqdist {M}x{d}"] = lambda x=x: fused.pairwise_sqdist(x)
        calls[f"cross_sqdist {M}x{d}"] = lambda x=x, z=z: fused.cross_sqdist(x, z)
    leaves = [torch.randn(m, d, generator=gen).to(dev) for m, d in LEAF_SHAPES]
    w1 = torch.full((1, M), 1.0 / M, device=dev)
    wm = torch.rand(M, M, generator=gen).to(dev)
    calls["tree_weighted_combine k=1"] = lambda: fused.tree_weighted_combine(leaves, w1)
    calls["tree_weighted_combine k=m"] = lambda: fused.tree_weighted_combine(leaves, wm)
    calls["tree_combine_reduce k=m tm"] = lambda: fused.tree_combine_reduce(
        leaves, wm, "tm", TRIM)
    t_dev = torch.tensor(TRIM, dtype=torch.int32, device=dev)
    calls["tree_cw_reduce tm"] = lambda: fused.tree_cw_reduce(leaves, "tm", TRIM)
    calls["tree_cw_reduce tm, trim on the card"] = lambda: fused.tree_cw_reduce(
        leaves, "tm", t_dev)
    lane_leaves = [torch.randn(8, m, d, generator=gen).to(dev) for m, d in LEAF_SHAPES]
    t_lanes = torch.arange(8, dtype=torch.int32, device=dev)
    calls["tree_cw_reduce_lanes C=8 tm, trims on the card"] = (
        lambda: fused.tree_cw_reduce_lanes(lane_leaves, "tm", t_lanes))
    calls["tree_combine_reduce k=m tm, trim on the card"] = (
        lambda: fused.tree_combine_reduce(leaves, wm, "tm", t_dev))
    for key, call in calls.items():
        call()  # warm: the library and the counters exist before the window
        torch.cuda.synchronize()
        # a window whose event list comes back empty lost its events (the
        # call launched: LAUNCHES counts it); open another, at most three
        for window in range(1, PROFILER_WINDOWS + 1):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
            if names:
                break
        counts[key] = {"kernels": len(names), "names": names,
                       "windows": window}
    emit({"phase": "device_kernels_per_call", "counts": counts})
    for key, c in counts.items():
        assert c["kernels"] == 1, f"{key}: {c['kernels']} CUDA kernels a call"
    return counts


# ------------------------------------------------------------- 4. main path


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
    # one tree call an aggregation: 3 a round in the cap, 1 beyond it
    expected = sum(3 if 1 <= j <= j_max else 1 for j in levels)
    acc = evals[-1][1]["test_acc"]
    diff = max(float((params[k] - ref_params[k]).abs().max()) for k in params)
    rerun = max(float((ref_params2[k] - ref_params[k]).abs().max())
                for k in params)
    for k in params:
        assert params[k].shape == params0[k].shape, k
        assert bool(torch.isfinite(params[k]).all()), f"non-finite {k}"
    assert launches == expected == 440, (launches, expected)
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


# ------------------------------------------------------ 5. geometry paths

# rule: (MLMC option, optimizer, launches of each kernel per aggregation of
# the 4-leaf tree: the distance kernels one per leaf, the combines one per
# tree)
GEOMETRY_PATHS = {
    "nnm+cwtm": (1, lambda: sgd(0.1), {"pairwise_sqdist": 4, "combine_reduce": 1}),
    "mfm": (2, lambda: adagrad_norm(0.5),
            {"pairwise_sqdist": 4, "weighted_combine": 1}),
    "krum": (1, lambda: sgd(0.1), {"pairwise_sqdist": 4, "weighted_combine": 1}),
    "geomed": (1, lambda: sgd(0.1), {"weighted_combine": 9, "cross_sqdist": 32}),
}
# what the level draws of seed 0 give: 145 in-cap rounds of 3 aggregations
# and 5 beyond the cap of 1, 440 aggregations of 4 leaves
EXPECTED_LAUNCHES = {
    "nnm+cwtm": {"pairwise_sqdist": 1760, "combine_reduce": 440},
    "mfm": {"pairwise_sqdist": 1760, "weighted_combine": 440},
    "krum": {"pairwise_sqdist": 1760, "weighted_combine": 440},
    "geomed": {"weighted_combine": 3960, "cross_sqdist": 14080},
}
# the weight core of each rule that makes a discrete choice
DECISION_CORES = {"nnm+cwtm": "_nnm_weights", "mfm": "_mfm_weights",
                  "krum": "_krum_weights"}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def record_decisions(core):
    """Keep (d2, arguments, weights) of every call of ``aggregators.<core>``
    while the block runs."""
    calls, orig = [], getattr(aggregators, core)

    def recorded(d2, *args):
        w = orig(d2, *args)
        calls.append((d2.clone(), args, w.clone()))
        return w

    setattr(aggregators, core, recorded)
    try:
        yield calls
    finally:
        setattr(aggregators, core, orig)


def decision_margin(rule, d2, args):
    """How near one aggregation's choice is to flipping, relative: Krum's
    gap between the last picked and the first passed-over score, NNM's
    smallest gap between a row's last kept and first dropped neighbour, and
    MFM's smallest distance to either threshold (tau/2, tau), over tau."""
    if rule == "krum":
        k, multi = args
        s = torch.sort(aggregators._krum_scores(d2, k)).values
        return float((s[multi] - s[multi - 1]) / s[multi])
    if rule == "nnm+cwtm":
        (k,) = args
        srt = torch.sort(d2, dim=1).values
        return float(((srt[:, k] - srt[:, k - 1]) / srt[:, k]).min())
    (tau,) = args
    d = torch.sqrt(d2)
    return float(torch.minimum((d - tau / 2).abs(), (d - tau).abs()).min() / tau)


def round_of_call(logs, call, j_max):
    """The round of the ``call``-th aggregation of a run (3 a round in the
    cap, 1 beyond it)."""
    seen = 0
    for t, log in enumerate(logs):
        seen += 3 if 1 <= log.level <= j_max else 1
        if call < seen:
            return t
    return None


def geometry_path(task, rule):
    """Train the Figure-1 setting with ``rule`` on the default backend (the
    kernels) and the plain one, and check them against each other."""
    params0, grad_fn, sampler, eval_fn = task
    option, make_opt, per_agg = GEOMETRY_PATHS[rule]
    cfg = DynaBROConfig(
        mlmc=MLMCConfig(T=T, m=M, V=5.0, option=option, kappa=1.0, j_cap=5),
        aggregator=rule, delta=DELTA, attack="sign_flip")

    def run(backend):
        sw = get_switcher("periodic", M, n_byz=N_BYZ, K=10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_dynabro(grad_fn, params0, make_opt(),
                          dataclasses.replace(cfg, agg_backend=backend), sw,
                          sampler, T, seed=0, eval_fn=eval_fn, eval_every=30)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    reset_launches()
    (params, logs, evals), secs = run("auto")  # this path: the kernels
    launches = dict(LAUNCHES)
    reset_launches()
    (ref_params, ref_logs, ref_evals), ref_secs = run("ref")
    ref_launches = dict(LAUNCHES)

    j_max = cfg.mlmc.j_max
    aggs = sum(3 if 1 <= l.level <= j_max else 1 for l in logs)
    assert len(params0) == 4, sorted(params0)
    expected = {k: aggs * per_agg.get(k, 0) for k in KERNELS}
    diff = max(float((params[k] - ref_params[k]).abs().max()) for k in params)
    row = {"phase": "geometry_path", "rule": rule, "option": option,
           "optimizer": "adagrad_norm(0.5)" if option == 2 else "sgd(0.1)",
           "T": T, "m": M, "n_byz": N_BYZ, "aggregations": aggs,
           "failsafe_ok": sum(l.failsafe_ok for l in logs),
           "evals": [[t, e["test_acc"]] for t, e in evals],
           "ref_evals": [[t, e["test_acc"]] for t, e in ref_evals],
           "test_acc": evals[-1][1]["test_acc"],
           "launches": {k: v for k, v in launches.items() if v},
           "expected_launches": {k: v for k, v in expected.items() if v},
           "ref_launches": sum(ref_launches.values()),
           "logs_equal_ref": [vars(l) for l in logs] == [vars(l) for l in ref_logs],
           "max_param_diff_vs_ref": diff,
           "seconds": secs, "rounds_per_s": T / secs,
           "ref_seconds": ref_secs, "ref_rounds_per_s": T / ref_secs}
    flip = None
    if rule in DECISION_CORES:  # replay both with each choice recorded
        with record_decisions(DECISION_CORES[rule]) as kcalls:
            run("auto")
        with record_decisions(DECISION_CORES[rule]) as rcalls:
            run("ref")
        margins = [decision_margin(rule, d2, args) for d2, args, _ in kcalls]
        c = min(range(len(margins)), key=margins.__getitem__)
        row.update(decisions=len(kcalls), min_margin=margins[c],
                   min_margin_round=round_of_call(logs, c, j_max))
        flip = next((i for i, (a, b) in enumerate(zip(kcalls, rcalls))
                     if not torch.equal(a[2], b[2])), None)
        if flip is None and len(kcalls) != len(rcalls):
            flip = min(len(kcalls), len(rcalls))
        row["first_flip"] = None if flip is None else {
            "call": flip, "round": round_of_call(logs, flip, j_max),
            "margin": margins[flip] if flip < len(margins) else None}
    emit(row)

    assert flip is None, f"{rule}: a choice differs from the plain backend's: {row['first_flip']}"
    assert row["logs_equal_ref"], f"{rule}: round logs differ from the plain backend's"
    assert diff <= 1e-5, f"{rule}: kernel vs plain params differ by {diff}"
    for k in params:
        assert params[k].shape == params0[k].shape, k
        assert bool(torch.isfinite(params[k]).all()), f"{rule}: non-finite {k}"
    assert launches == expected, (rule, launches, expected)
    assert row["expected_launches"] == EXPECTED_LAUNCHES[rule], row["expected_launches"]
    assert row["ref_launches"] == 0, ref_launches
    if rule == "nnm+cwtm":
        assert row["test_acc"] > 0.8, f"{rule}: final test_acc {row['test_acc']} <= 0.8"
    return launches


# ----------------------------------------------- 6. the compiled driver

# rule: (MLMC option, optimizer, params limit against the per-round driver)
SCAN_PATHS = {
    "cwtm": (1, lambda: sgd(0.1), 1e-6),
    "nnm+cwtm": (1, lambda: sgd(0.1), 1e-5),
    "mfm": (2, lambda: adagrad_norm(0.5), 1e-5),
    "krum": (1, lambda: sgd(0.1), 1e-5),
    "geomed": (1, lambda: sgd(0.1), 1e-5),
}
TIMED_PAIRS = 3  # per-round and compiled runs in turns, on CWTM and GeoMed
SYNC_DEBUG_ERROR = 2  # torch.cuda.get_sync_debug_mode() under "error"


@contextlib.contextmanager
def watch_replays():
    """Count the CUDA graph replays made while the block runs and the sync
    debug mode each one ran under."""
    modes, replay = [], torch.cuda.CUDAGraph.replay

    def watched(graph):
        modes.append(torch.cuda.get_sync_debug_mode())
        replay(graph)

    torch.cuda.CUDAGraph.replay = watched
    try:
        yield modes
    finally:
        torch.cuda.CUDAGraph.replay = replay


def fig1_cfg(rule, option=1, attack="sign_flip", kwargs=None):
    return DynaBROConfig(
        mlmc=MLMCConfig(T=T, m=M, V=5.0, option=option, kappa=1.0, j_cap=5),
        aggregator=rule, delta=DELTA, attack=attack, attack_kwargs=kwargs)


def periodic():
    return get_switcher("periodic", M, n_byz=N_BYZ, K=10)


def max_diff(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def compare_drivers(round_out, scan_out, params0, limit, what):
    """Round logs and evals equal, params finite, of their shapes and within
    ``limit`` of the per-round driver's. Returns (max diff, bitwise)."""
    (p1, l1, e1), (p2, l2, e2) = round_out, scan_out
    assert [vars(l) for l in l1] == [vars(l) for l in l2], f"{what}: logs differ"
    assert e1 == e2, f"{what}: evals differ: {e1} {e2}"
    for k in params0:
        assert p2[k].shape == params0[k].shape, (what, k)
        assert bool(torch.isfinite(p2[k]).all()), f"{what}: non-finite {k}"
    diff = max_diff(p1, p2)
    assert diff <= limit, f"{what}: scan vs per-round params differ by {diff}"
    return diff, all(torch.equal(p1[k], p2[k]) for k in p1)


def scan_path(task, rule):
    """Train the Figure-1 setting with ``rule`` through ``run_dynabro_scan``
    (one CUDA graph per level) and through ``run_dynabro``, and check the
    compiled driver against the per-round one. On CWTM and GeoMed, time the
    two in turns with the graphs kept."""
    params0, grad_fn, sampler, eval_fn = task
    option, make_opt, limit = SCAN_PATHS[rule]
    cfg = fig1_cfg(rule, option)
    scan_fn = make_dynabro_scan_fn(grad_fn, cfg, make_opt())

    def run(driver):
        kw = dict(scan_fn=scan_fn) if driver is run_dynabro_scan else {}
        return timed(lambda: driver(grad_fn, params0, make_opt(), cfg,
                                    periodic(), sampler, T, seed=0,
                                    eval_fn=eval_fn, eval_every=30, **kw))

    reset_launches()
    with watch_replays() as modes:
        scan_out, first_s = run(run_dynabro_scan)  # captures every level
    launches = {k: v for k, v in LAUNCHES.items() if v}
    reset_launches()
    round_out, round_s = run(run_dynabro)
    round_launches = {k: v for k, v in LAUNCHES.items() if v}
    diff, bitwise = compare_drivers(round_out, scan_out, params0, limit,
                                    f"scan {rule}")
    logs, evals = scan_out[1], scan_out[2]
    expected = ({"cw_reduce": 440} if rule == "cwtm"
                else EXPECTED_LAUNCHES[rule])
    row = {"phase": "scan_path", "rule": rule, "T": T, "m": M,
           "levels": sorted(scan_fn.capture_seconds),
           "capture_s": {str(j): s for j, s in scan_fn.capture_seconds.items()},
           "replays": len(modes),
           "replays_under_sync_error": modes.count(SYNC_DEBUG_ERROR),
           "launches": launches, "round_launches": round_launches,
           "expected_launches": expected, "logs_equal": True,
           "evals": [[t, e["test_acc"]] for t, e in evals],
           "test_acc": evals[-1][1]["test_acc"],
           "max_param_diff_vs_round": diff, "bitwise_equal": bitwise,
           "limit": limit, "first_run_s": first_s, "round_run_s": round_s}
    if rule in ("cwtm", "geomed"):
        pairs = []
        for _ in range(TIMED_PAIRS):
            _, r_s = run(run_dynabro)
            _, s_s = run(run_dynabro_scan)
            pairs.append({"round_rounds_per_s": T / r_s,
                          "scan_rounds_per_s": T / s_s})
        assert scan_fn.captures == len(scan_fn.capture_seconds), "recaptured"
        row["timed_pairs"] = pairs
    emit(row)
    # no fallback: every round was a replay, each under the sync check
    assert len(modes) == T == row["replays_under_sync_error"], modes
    assert launches == round_launches == expected, row
    if rule in ("cwtm", "nnm+cwtm"):
        assert row["test_acc"] > 0.8, f"scan {rule}: test_acc {row['test_acc']}"
    return launches


# attack: its kwargs; the Figure-1 setting with CWTM under each
ATTACK_CASES = [("shift", {"v": 1.0}), ("ipm", {"eps": 0.1}),
                ("alie", {"z": 1.22}), ("alie", {"z": None}),
                ("random", {"scale": 10.0})]


def check_random_stack(dev, scale=10.0):
    """The random attack on one stack of the main path's four leaves on the
    card: honest rows untouched, the Byzantine rows' N entries with mean
    within 5·scale/√N of 0 and standard deviation within 2 % of scale."""
    gen = torch.Generator(device=dev).manual_seed(17)
    stack = {f"l{i}": torch.randn(m, d, generator=gen, device=dev)
             for i, (m, d) in enumerate(LEAF_SHAPES)}
    mask = torch.as_tensor(periodic().mask(0), device=dev)
    out = get_attack("random", scale=scale)(stack, mask, generator=gen)
    byz = torch.cat([out[k][mask].reshape(-1) for k in sorted(out)]).double()
    for k in stack:
        assert torch.equal(out[k][~mask], stack[k][~mask]), f"honest rows of {k}"
    n = byz.numel()
    mean, std = float(byz.mean()), float(byz.std())
    assert abs(mean) <= 5 * scale / n ** 0.5, (mean, n)
    assert abs(std / scale - 1.0) <= 0.02, std
    return {"entries": n, "mean": mean, "mean_limit": 5 * scale / n ** 0.5,
            "std": std, "std_limit": [0.98 * scale, 1.02 * scale]}


def attack_paths(task, dev):
    """CWTM on the Figure-1 setting under each attack, through both drivers
    on the card: finite params, equal logs, params within 1e-6."""
    params0, grad_fn, sampler, eval_fn = task
    rows = []
    for attack, kwargs in ATTACK_CASES:
        cfg = fig1_cfg("cwtm", attack=attack, kwargs=kwargs)
        runs = [driver(grad_fn, params0, sgd(0.1), cfg, periodic(), sampler,
                       T, seed=0, eval_fn=eval_fn, eval_every=T)
                for driver in (run_dynabro, run_dynabro_scan)]
        diff, bitwise = compare_drivers(*runs, params0, 1e-6,
                                        f"attack {attack} {kwargs}")
        rows.append({"attack": attack, "kwargs": kwargs,
                     "test_acc": runs[1][2][-1][1]["test_acc"],
                     "failsafe_ok": sum(l.failsafe_ok for l in runs[1][1]),
                     "max_param_diff_vs_round": diff, "bitwise_equal": bitwise})
    emit({"phase": "attacks", "rule": "cwtm", "T": T, "m": M, "rows": rows,
          "random_stack": check_random_stack(dev)})


def momentum_path(task):
    """App. E at full width: worker momentum (β = 0.9, lr = 0.1) under
    momentum_tailored(α = 0.1) and shift (v=1), CWTM, through both momentum
    drivers, beside DynaBRO's compiled driver on the same switcher and
    attack."""
    params0, grad_fn, sampler, eval_fn = task
    cfg = fig1_cfg("cwtm", attack="shift", kwargs={"v": 1.0})

    def tailored():
        return get_switcher("momentum_tailored", M, alpha=0.1)

    runs, launches = {}, {}
    for name, call in [
            ("run_momentum", lambda: run_momentum(
                grad_fn, params0, cfg, tailored(), sampler, T, lr=0.1,
                beta=0.9, eval_fn=eval_fn, eval_every=T)),
            ("run_momentum_scan", lambda: run_momentum_scan(
                grad_fn, params0, cfg, tailored(), sampler, T, lr=0.1,
                beta=0.9, eval_fn=eval_fn, eval_every=T,
                scan_fn=make_momentum_scan_fn(grad_fn, cfg, 0.1, 0.9)))]:
        reset_launches()
        with watch_replays() as modes:
            runs[name], secs = timed(call)
        launches[name] = {"cw_reduce": LAUNCHES["cw_reduce"],
                          "replays": len(modes), "seconds": secs}
    dyn_p, dyn_logs, dyn_evals = run_dynabro_scan(
        grad_fn, params0, sgd(0.1), cfg, tailored(), sampler, T, seed=0,
        eval_fn=eval_fn, eval_every=T)
    (p1, e1), (p2, e2) = runs["run_momentum"], runs["run_momentum_scan"]
    diff = max_diff(p1, p2)
    emit({"phase": "momentum_path", "T": T, "m": M, "alpha": 0.1, "beta": 0.9,
          "lr": 0.1, "attack": "shift v=1", "rule": "cwtm",
          "momentum_test_acc": e1[-1][1]["test_acc"],
          "momentum_scan_test_acc": e2[-1][1]["test_acc"],
          "dynabro_scan_test_acc": dyn_evals[-1][1]["test_acc"],
          "dynabro_failsafe_ok": sum(l.failsafe_ok for l in dyn_logs),
          "max_param_diff": diff,
          "bitwise_equal": all(torch.equal(p1[k], p2[k]) for k in p1),
          "runs": launches})
    for k in params0:
        assert bool(torch.isfinite(p2[k]).all()), f"momentum: non-finite {k}"
        assert bool(torch.isfinite(dyn_p[k]).all()), f"dynabro: non-finite {k}"
    assert diff <= 1e-6, f"momentum drivers differ by {diff}"
    assert launches["run_momentum"]["cw_reduce"] == T, launches
    assert launches["run_momentum_scan"]["cw_reduce"] == T, launches
    assert launches["run_momentum_scan"]["replays"] == T, launches
    return {"cw_reduce": T}


# ------------------------------------------------ 7. the session and sweeps


def mlp_task(task):
    """The Figure-1 task as a ``Task`` of the facade (its sampler serves m
    = M workers; the objective is the final test accuracy)."""
    params0, grad_fn, sampler, eval_fn = task
    return Task(params0, grad_fn, lambda m: sampler,
                lambda p: eval_fn(p, T - 1)["test_acc"])


def bitwise(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


# the recompile guard's counts on each guarded path: {"lint": ...}
LINT = {}


def forced_recapture(sess, task, cfg, p_run, levels):
    """On the warmed guarded session: its graphs dropped, a guarded
    ``run(150)`` raises ``RecompileError`` naming its captures; a
    ``recompile_guard(action="count")`` over a run on the same scan_fn
    counts them without raising (the run bitwise ``run``'s); an exception
    inside a guarded block comes through unmasked, its count kept."""
    params0, grad_fn, sampler, _ = task
    sess.scan_fn.drop_graphs()
    c0 = compile_count()
    try:
        sess.run(T)
    except RecompileError as e:
        raised = str(e)
    else:
        raise AssertionError("a guarded run after drop_graphs did not raise")
    captured = compile_count() - c0
    assert captured == len(levels), (captured, levels)
    assert raised.startswith(f"Session.run (T={T}): {captured} recompile"), raised

    def rerun():
        return run_dynabro_scan(grad_fn, params0, sgd(0.1), cfg, periodic(),
                                sampler, T, seed=0, scan_fn=sess.scan_fn)[0]

    sess.scan_fn.drop_graphs()
    with recompile_guard("forced recapture, counted", action="count") as g:
        p = rerun()
    assert g.count == len(levels) and bitwise(p, p_run), g
    sess.scan_fn.drop_graphs()
    try:
        with recompile_guard("forced recapture, raise-through") as through:
            rerun()
            raise RuntimeError("original failure")
    except RuntimeError as e:
        assert str(e) == "original failure", e
    else:
        raise AssertionError("the guard swallowed the block's exception")
    assert through.count == len(levels), through
    return {"guarded_run_raised": raised, "guarded_run_captures": captured,
            "action_count": g.count, "action_count_bitwise_equal_run": True,
            "raise_through_unmasked": True,
            "raise_through_count": through.count}


def session_path(task):
    """``build_session`` on the Figure-1 task with CWTM under sign_flip and
    under random (Periodic(10)), the session guarded
    (``guard_recompiles=True``): ``Session.run(150)`` bitwise equal to
    ``run_dynabro_scan``, capturing each level once, and a second
    ``run(150)`` under the guard bitwise equal with no capture; 150 calls of
    ``Session.step`` bitwise equal to ``run``, each ``StepInfo`` against the
    run's round logs, with no capture (a level's first step is warmup, the
    rest run guarded); a checkpoint of the carry at t = 75, loaded into a
    new guarded session and stepped to 150, bitwise equal to ``run``; then
    (sign_flip) the forced recapture (``forced_recapture``)."""
    params0, grad_fn, sampler, _ = task
    rows = []
    for attack, kwargs in [("sign_flip", None), ("random", {"scale": 10.0})]:
        cfg = fig1_cfg("cwtm", attack=attack, kwargs=kwargs)

        def session():
            return build_session(cfg, mlp_task(task), opt=sgd(0.1),
                                 switcher=periodic(), seed=0,
                                 guard_recompiles=True)

        sess = session()
        reset_launches()
        c0 = compile_count()
        with watch_replays() as modes:
            (p_run, logs, _), run_s = timed(lambda: sess.run(T))
        run_warmup = compile_count() - c0
        run_launches = LAUNCHES["cw_reduce"]
        levels = sorted({l.level for l in logs})
        assert run_warmup == len(levels) == sess.scan_fn.captures, run_warmup
        p_ref, logs_ref, _ = run_dynabro_scan(grad_fn, params0, sgd(0.1), cfg,
                                              periodic(), sampler, T, seed=0)
        assert bitwise(p_run, p_ref), f"session {attack}: run vs run_dynabro_scan"
        assert [vars(l) for l in logs] == [vars(l) for l in logs_ref]
        c0 = compile_count()
        (p_again, _, _), again_s = timed(lambda: sess.run(T))  # guarded
        run_steady = compile_count() - c0
        assert run_steady == 0 and bitwise(p_again, p_run), run_steady
        sched = sess.schedule(T)
        carry = sess.init_carry()
        reset_launches()
        c0 = compile_count()
        t0 = time.perf_counter()
        infos, captures = [], None
        with watch_replays() as step_modes:
            for t in range(T):
                carry, info = sess.step(carry, sess.round_inputs(sched, t))
                infos.append(info)
                if t == 0:
                    captures = sess.scan_fn.captures
                if t == T // 2 - 1:
                    mid = (carry, t + 1)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        step_compiles = compile_count() - c0
        step_launches = LAUNCHES["cw_reduce"]
        step_sigs = sorted(sig[2] for sig in sess._steady_sigs
                           if sig[0] == "step")
        assert step_compiles == 0, step_compiles
        assert step_sigs == [(j,) for j in levels], step_sigs
        assert bitwise(carry[0], p_run), f"session {attack}: steps vs run"
        assert [i.failsafe_ok for i in infos] == [l.failsafe_ok for l in logs]
        assert all(i.corr_norm == 0.0 for i, l in zip(infos, logs)
                   if l.level > cfg.mlmc.j_max), "beyond-cap corr_norm"
        assert sess.scan_fn.captures == captures, "a step captured a graph"
        with tempfile.TemporaryDirectory() as d:
            path = str(Path(d) / "carry")
            save_checkpoint(path, mid[0], step=mid[1])
            resumed_sess = session()
            resumed = load_checkpoint(path, resumed_sess.init_carry())
            start = checkpoint_step(path)
        c0 = compile_count()
        for t in range(start, T):
            resumed, _ = resumed_sess.step(
                resumed, resumed_sess.round_inputs(resumed_sess.schedule(T), t))
        resume_warmup = compile_count() - c0
        resume_levels = {int(j) for j in sched.levels[start:]}
        assert resume_warmup == len(resume_levels), resume_warmup
        assert bitwise(resumed[0], p_run), f"session {attack}: resume at {start}"
        assert len(step_modes) == T == step_modes.count(SYNC_DEBUG_ERROR)
        assert len(modes) == T and step_launches == run_launches == 440
        LINT[f"session {attack}"] = {
            "levels": levels, "run_warmup_captures": run_warmup,
            "second_run_compiles": run_steady,
            "step_compiles": step_compiles,
            "guarded_steps": T - len(step_sigs),
            "resumed_steps_warmup_captures": resume_warmup,
            "resumed_steps_guarded": T - start - resume_warmup}
        rows.append({"attack": attack, "run_bitwise_equal_run_dynabro_scan": True,
                     "steps_bitwise_equal_run": True, "step_infos_equal_logs": True,
                     "captures_after_first_step": captures,
                     "captures_after_last_step": sess.scan_fn.captures,
                     "step_replays": len(step_modes),
                     "checkpoint_step": start, "resume_bitwise_equal_run": True,
                     "cw_reduce_launches": {"run": run_launches,
                                            "steps": step_launches},
                     "run_s": run_s, "guarded_run_s": again_s,
                     "steps_s": step_s, "step_rounds_per_s": T / step_s})
        if attack == "sign_flip":
            LINT["forced recapture"] = forced_recapture(sess, task, cfg,
                                                        p_run, levels)
    emit({"phase": "session_path", "T": T, "m": M, "rule": "cwtm",
          "rows": rows})
    return {"cw_reduce": 440}


def lone_cfg(base, attack, agg):
    """The per-cell config of a sweep lane: its attack and rule specs
    applied to ``base`` (``AggSpec.apply_to``: MFM on Option 2)."""
    a = AttackSpec.coerce(attack)
    cfg = dataclasses.replace(base, attack=a.name, attack_kwargs=a.kwargs or None)
    return AggSpec.coerce(agg).apply_to(cfg)


def sweep_grid(name):
    """(switchers, attacks, aggregators, limit) of a sweep grid."""
    ks = (10, 25)
    if name == "grid1":  # CWTM: attack x K x delta (trims 8 and 6)
        cells = [(a, k, dl) for a in ("sign_flip", "ipm") for k in ks
                 for dl in (DELTA, 0.35)]
        return ([("periodic", {"n_byz": N_BYZ, "K": k}) for _, k, _ in cells],
                [a for a, _, _ in cells],
                [("cwtm", {"delta": dl}) for _, _, dl in cells], 1e-6)
    rules = [("cwtm", {"delta": DELTA}), ("nnm+cwtm", {"delta": DELTA}),
             ("krum", {"delta": DELTA}), ("geomed", {}), ("mfm", {})]
    cells = [(g, k) for g in rules for k in ks]
    return ([("periodic", {"n_byz": N_BYZ, "K": k}) for _, k in cells],
            None, [g for g, _ in cells], 1e-5)


SWEEP_TIMED_PAIRS = 2


def sweep_path(task, grid):
    """A lane-batched sweep of ``grid`` on the Figure-1 task through
    ``Session.sweep``: every round a graph replay under the sync check, one
    ``cw_reduce`` launch an aggregation for all the CWTM lanes of grid 1,
    each lane against a lone ``run_dynabro_scan`` of that lane (equal round
    logs, params within 1e-6 for CWTM and 1e-5 for the geometry rules);
    grid 1 again with the deltas swapped, with no capture and each lane's
    bits those of the first sweep's lane of the same delta; and
    lanes·rounds/s of the sweep beside the sum of the lone compiled runs,
    in turns."""
    params0, grad_fn, sampler, _ = task
    switchers, attacks, aggs, limit = sweep_grid(grid)
    base = fig1_cfg("cwtm")
    sess = build_session(base, mlp_task(task), m=M, opt=sgd(0.1), seed=0)
    spec = SweepSpec(switchers=tuple(switchers),
                     attacks=None if attacks is None else tuple(attacks),
                     aggregators=tuple(aggs))
    C = spec.lanes
    reset_launches()
    with watch_replays() as modes:
        outs, first_s = timed(lambda: sess.sweep(spec, T))
    launches = {k: v for k, v in LAUNCHES.items() if v}
    lone_fns, lone = {}, []

    def lone_run(c):
        cfg = lone_cfg(base, attacks[c] if attacks else base.attack, aggs[c])
        key = (cfg.attack, repr(cfg.attack_kwargs), cfg.aggregator,
               repr(cfg.aggregator_kwargs), cfg.delta)
        fn = lone_fns.setdefault(key, make_dynabro_scan_fn(grad_fn, cfg, sgd(0.1)))
        name, kw = switchers[c]
        return run_dynabro_scan(grad_fn, params0, sgd(0.1), cfg,
                                get_switcher(name, M, **kw), sampler, T,
                                seed=0, scan_fn=fn)

    diffs = []
    for c in range(C):
        p1, l1, _ = lone_run(c)
        lone.append(p1)
        p, logs = outs[c]
        assert [vars(l) for l in logs] == [vars(l) for l in l1], f"{grid} lane {c}: logs"
        for k in params0:
            assert p[k].shape == params0[k].shape and bool(torch.isfinite(p[k]).all())
        diffs.append(max_diff(p, p1))
    rules = [AggSpec.coerce(g).rule for g in aggs]
    j_max = base.mlmc.j_max
    aggregations = sum(3 if 1 <= l.level <= j_max else 1 for l in outs[0][1])
    row = {"phase": "sweep_path", "grid": grid, "lanes": C, "T": T, "m": M,
           "lane_specs": [[sw[1]["K"], attacks[c] if attacks else base.attack,
                           AggSpec.coerce(aggs[c]).label]
                          for c, sw in enumerate(switchers)],
           "replays": len(modes),
           "replays_under_sync_error": modes.count(SYNC_DEBUG_ERROR),
           "launches": launches, "aggregations": aggregations,
           "max_param_diff_vs_lone": max(diffs), "per_lane_diff": diffs,
           "bitwise_lanes": sum(d == 0.0 for d in diffs), "limit": limit,
           "failsafe_ok": [sum(l.failsafe_ok for l in logs) for _, logs in outs],
           "first_sweep_s": first_s,
           "capture_s": {str(k): sum(fn.capture_seconds.values())
                         for k, fn in sess._lane_fns.items()}}
    groups = len(dict.fromkeys(rules))
    limits = [1e-6 if r == "cwtm" else 1e-5 for r in rules]
    if any(d > lim for d, lim in zip(diffs, limits)):
        emit(row)
    assert len(modes) == T * groups == row["replays_under_sync_error"], modes
    for c, (d, lim) in enumerate(zip(diffs, limits)):
        assert d <= lim, f"{grid} lane {c} ({rules[c]}): params differ by {d}"
    if grid == "grid1":
        assert launches == {"cw_reduce": aggregations}, launches
        assert aggregations == 440, aggregations
        # the deltas swapped: the same lane groups, new rows, no capture
        fn = sess._lane_fns[(tuple(dict.fromkeys(attacks)), ("cwtm",))]
        captures = fn.captures
        swapped = SweepSpec(switchers=spec.switchers, attacks=spec.attacks,
                            aggregators=tuple(
                                ("cwtm", {"delta": 0.35 if g[1]["delta"] == DELTA
                                          else DELTA}) for g in aggs))
        with watch_replays() as modes2:
            outs2 = sess.sweep(swapped, T)
        assert fn.captures == captures, "the swapped sweep captured"
        assert len(modes2) == T
        for c in range(C):  # lane c now runs lane c ^ 1's delta
            assert bitwise(outs2[c][0], outs[c ^ 1][0]), f"swapped lane {c}"
        row.update(swapped_captures=fn.captures - captures,
                   swapped_bitwise_equal=True, captures=captures)
    pairs = []
    for _ in range(SWEEP_TIMED_PAIRS):
        _, sweep_s = timed(lambda: sess.sweep(spec, T))
        _, lone_s = timed(lambda: [lone_run(c) for c in range(C)])
        pairs.append({"sweep_lane_rounds_per_s": C * T / sweep_s,
                      "lone_lane_rounds_per_s": C * T / lone_s,
                      "sweep_s": sweep_s, "lone_s": lone_s})
    row["timed_pairs"] = pairs
    emit(row)
    return launches


def matrix_path(dev):
    """The README's grid on App. E's quadratic (m=16, T=200, V=3, CWTM under
    sign_flip and ipm, Periodic(n_byz=3, K=10)): ``run_matrix(driver="vmap",
    seeds=(0, 1, 2))`` (finite rows, three seeds each), and for each seed s
    the rows of ``driver="vmap"`` at seed s against ``driver="scan"`` at
    seed s: equal log columns, finals within 1e-6 relative."""
    task = make_quadratic_task(device=dev)
    grid = scenario_grid(["sign_flip", "ipm"],
                         [("periodic", {"n_byz": 3, "K": 10})], ["cwtm"])
    kw = dict(m=16, T=200, V=3.0)
    rows = run_matrix(task, grid, driver="vmap", seeds=(0, 1, 2), **kw)
    for r in rows:
        assert r["n_seeds"] == 3 and np.isfinite(r["final_mean"]), r
    per_seed = []
    for seed in (0, 1, 2):
        vm = run_matrix(task, grid, driver="vmap", seed=seed, **kw)
        sc = run_matrix(task, grid, driver="scan", seed=seed, **kw)
        for a, b in zip(vm, sc):
            for key in ("failsafe_trips", "mean_level", "cost"):
                assert a[key] == b[key], (seed, key, a[key], b[key])
            rel = abs(a["final"] - b["final"]) / max(abs(b["final"]), 1e-30)
            assert rel <= 1e-6, (seed, a["final"], b["final"])
            per_seed.append({"seed": seed, "attack": a["attack"],
                             "vmap_final": a["final"], "scan_final": b["final"],
                             "rel_diff": rel})
    emit({"phase": "matrix_path", **kw, "table": format_table(rows),
          "rows": [{k: r[k] for k in ("attack", "final_mean", "final_std",
                                      "final_stderr", "n_seeds")} for r in rows],
          "vmap_vs_scan": per_seed})


# ------------------------------------------- 8. the service and the halving

SERVE_JITTER_S = 0.002
SERVE_TIMEOUT_S = 300.0  # every join and poll of a served stream
SERVE_TIMED_PAIRS = 2  # a served stream and 150 Session.step calls, in turns
STRAGGLERS = ((2, 30), (9, 30), (5, 70))  # (worker, round) never submitted
KILL_AFTER, CHECKPOINT_EVERY = 80, 25
HALVING_RUNGS, HALVING_TIMED_PAIRS = [50, 100], 2


@contextlib.contextmanager
def watch_captures():
    """Record each level-graph capture made while the block runs: its
    thread, levels and lanes, the worker threads alive as it began, the
    first round of the run that made it (``ScanFn.run``'s ``start``) and
    its seconds."""
    calls, state = [], {"start": 0}
    capture, run = rt._LevelGraphs.capture, rt.ScanFn.run

    def watched(self, keys):
        keys = [int(k) for k in keys]
        alive = sum(t.is_alive() for t in threading.enumerate()
                    if t.name.startswith("serve-worker"))
        t0 = time.perf_counter()
        capture(self, keys)
        if keys:
            calls.append({"thread": threading.current_thread().name,
                          "levels": keys, "workers_alive": alive,
                          "lanes": None if self.lane is None else self.lane[0].lanes,
                          "start": state["start"],
                          "s": time.perf_counter() - t0})

    def watched_run(self, *args, **kw):
        state["start"] = kw.get("start", 0)
        return run(self, *args, **kw)

    rt._LevelGraphs.capture, rt.ScanFn.run = watched, watched_run
    try:
        yield calls
    finally:
        rt._LevelGraphs.capture, rt.ScanFn.run = capture, run


def poll_health(server):
    """GET /health until the stream is "completed"; fails on "error" or
    past the timeout. Returns the last answer."""
    deadline = time.monotonic() + SERVE_TIMEOUT_S
    while time.monotonic() < deadline:
        with urllib.request.urlopen(server.health.url + "/health",
                                    timeout=5) as r:
            health = json.load(r)
        assert health["status"] != "error", (health, server.error)
        if health["status"] == "completed":
            return health
        time.sleep(0.005)
    raise AssertionError(f"served stream stalled: {server.snapshot()}")


def serve(sess, payloads, cfg, *, rounds=T, start_round=0, drop=(),
          server=None):
    """Stream ``payloads`` from 17 worker threads into an
    ``AggregationServer`` over ``sess`` (or ``server``) until it finishes:
    over HTTP when ``cfg`` has a health port. Fails on a worker failure or a
    server error. Returns (server, snapshot, health answer, seconds from
    ``start`` to ``join``)."""
    server = server or AggregationServer(sess, rounds, cfg)
    t0 = time.perf_counter()
    server.start()
    workers = SimulatedWorkers(server, payloads, start_round=start_round,
                               drop=drop, jitter_s=SERVE_JITTER_S).start()
    health = poll_health(server) if cfg.health_port is not None else None
    done = server.join(timeout=SERVE_TIMEOUT_S)
    secs = time.perf_counter() - t0
    assert workers.join(timeout=30.0), "worker threads still running"
    snap = server.snapshot()
    server.stop(drain=True, timeout=30.0)
    server.close()
    if server.error is not None:
        raise RuntimeError(f"server error: {server.error!r}") from server.error
    assert done and not workers.failures, (snap, workers.failures)
    assert snap["status"] == "completed", snap
    return server, snap, health, secs


def serve_rates(snap, secs, updates):
    return {"rounds_per_s": snap["rounds_completed"] / secs,
            "updates_per_s": updates / secs, "start_to_join_s": secs,
            "staleness_mean_s": snap["staleness_mean_s"],
            "staleness_max_s": snap["staleness_max_s"],
            "ring_high_water": snap["ring_high_water"],
            "last_round_s": snap["last_round_s"]}


def serve_path(task):
    """The aggregation service on the Figure-1 setting (CWTM at trim 8,
    sign_flip under Periodic(10), T=150, sgd(0.1)), each row a hard
    failure: (a) 17 ``SimulatedWorkers`` threads (2 ms jitter) stream 2,550
    updates into a session built with ``REPRO_RECOMPILE_GUARD=1`` (a
    level's first round captures, every later round runs guarded), the
    health polled over HTTP until "completed": params bitwise
    equal to a fresh session's ``Session.run(150)``, its logs, 440
    ``cw_reduce`` launches, every round a graph replay under the sync
    check, each level captured once, on the serve thread, with the worker
    threads alive; then a served stream and 150 ``Session.step`` calls on
    the same session, in turns, with no compile; (b) under the random attack, periodic
    checkpoints every 25 rounds, a kill after round 80 and a resume from 75
    bitwise equal to ``run``, with a final checkpoint at 150; (c) three
    stragglers on two rounds masked after a 0.25 s deadline, bitwise equal
    to an offline ``Session.step`` replay of the same zero-fill and mask OR;
    (d) ``python -m repro_torch.serve.smoke`` on the card."""
    dev = task[0]["w1"].device

    def session(cfg):
        return build_session(cfg, mlp_task(task), opt=sgd(0.1),
                             switcher=periodic(), seed=0)

    # (a) a full stream, its session guarded from the environment (read
    # when the session is built)
    cfg = fig1_cfg("cwtm")
    p_ref, logs_ref, _ = session(cfg).run(T)
    env_before = os.environ.get(GUARD_ENV)
    os.environ[GUARD_ENV] = "1"
    try:
        sess = session(cfg)
    finally:
        if env_before is None:
            del os.environ[GUARD_ENV]
        else:
            os.environ[GUARD_ENV] = env_before
    assert sess.guard_recompiles, "serve: the env var did not guard"
    payloads = worker_payloads(sess, T)
    reset_launches()
    c0 = compile_count()
    with watch_replays() as modes, watch_captures() as caps:
        server, snap, health, first_s = serve(sess, payloads, ServeConfig(
            capacity=1024, lookahead_rounds=8, health_port=0))
    serve_warmup = compile_count() - c0
    launches = {k: v for k, v in LAUNCHES.items() if v}
    levels = sorted({l.level for l in logs_ref})
    assert bitwise(server.params, p_ref), "serve: stream vs Session.run"
    assert [vars(l) for l in server.logs] == [vars(l) for l in logs_ref]
    assert snap["updates_accepted"] == M * T == 2550, snap
    assert health["round"] == T and health["updates_accepted"] == M * T
    assert launches == {"cw_reduce": 440}, launches
    assert len(modes) == T == modes.count(SYNC_DEBUG_ERROR), modes
    assert sorted(l for c in caps for l in c["levels"]) == levels, caps
    assert all(c["thread"] == "serve-loop" for c in caps), caps
    assert caps[0]["workers_alive"] == M, caps
    assert sess.scan_fn.captures == len(levels) == serve_warmup, serve_warmup
    rows = [{"stream": "a", "bitwise_equal_run": True, "logs_equal": True,
             "updates_accepted": snap["updates_accepted"],
             "cw_reduce_launches": launches["cw_reduce"],
             "replays": len(modes),
             "replays_under_sync_error": modes.count(SYNC_DEBUG_ERROR),
             "captures": caps, "health": health,
             **serve_rates(snap, first_s, snap["updates_accepted"])}]
    sched = sess.schedule(T)
    inputs = [sess.round_inputs(sched, t) for t in range(T)]
    pairs = []
    c0 = compile_count()
    for _ in range(SERVE_TIMED_PAIRS):
        _, snap2, _, serve_s = serve(sess, payloads, ServeConfig(
            capacity=1024, lookahead_rounds=8))

        def steps():
            carry = sess.init_carry()
            for inp in inputs:
                carry, _ = sess.step(carry, inp)
            return carry

        carry, step_s = timed(steps)
        assert bitwise(carry[0], p_ref), "serve: timed steps vs run"
        pairs.append({"serve": serve_rates(snap2, serve_s, M * T),
                      "step_rounds_per_s": T / step_s, "steps_s": step_s,
                      "serve_minus_step_ms_a_round":
                          (serve_s - step_s) / T * 1e3})
    assert sess.scan_fn.captures == len(levels), "serve: a timed run captured"
    serve_steady = compile_count() - c0
    assert serve_steady == 0, serve_steady
    rows[0]["timed_pairs"] = pairs
    step_sigs = sorted(sig[2] for sig in sess._steady_sigs if sig[0] == "step")
    assert step_sigs == [(j,) for j in levels], step_sigs
    LINT["serve a (REPRO_RECOMPILE_GUARD=1)"] = {
        "levels": levels, "stream_warmup_captures": serve_warmup,
        "stream_guarded_rounds": T - len(levels),
        "timed_pairs_compiles": serve_steady,
        "timed_pairs_guarded_rounds": 2 * T * SERVE_TIMED_PAIRS,
        "recompile_errors": 0}

    # (b) kill and resume, under the random attack
    cfg_r = fig1_cfg("cwtm", attack="random", kwargs={"scale": 10.0})
    p_ref_r, _, _ = session(cfg_r).run(T)
    with tempfile.TemporaryDirectory() as d:
        scfg = ServeConfig(capacity=1024, lookahead_rounds=8,
                           checkpoint_every=CHECKPOINT_EVERY, checkpoint_dir=d)
        sess = session(cfg_r)
        payloads = worker_payloads(sess, T)[:KILL_AFTER]
        server = AggregationServer(sess, T, scfg)
        server.start()
        workers = SimulatedWorkers(server, payloads,
                                   jitter_s=SERVE_JITTER_S).start()
        assert workers.join(timeout=SERVE_TIMEOUT_S) and not workers.failures
        deadline = time.monotonic() + SERVE_TIMEOUT_S
        while server.round < KILL_AFTER and time.monotonic() < deadline:
            time.sleep(0.005)
        assert server.round == KILL_AFTER, server.snapshot()
        assert server.stop(drain=False, timeout=30.0)
        server.close()
        if server.error is not None:
            raise RuntimeError(f"server error: {server.error!r}")
        killed = latest_checkpoint(d, prefix="carry_")
        start = KILL_AFTER // CHECKPOINT_EVERY * CHECKPOINT_EVERY
        assert killed is not None and killed[1] == start, killed
        sess2 = session(cfg_r)
        resumed = AggregationServer.resume(sess2, T, scfg)
        assert resumed.start_round == start
        rest = worker_payloads(sess2, T, start=start)
        resumed, snap_b, _, resume_s = serve(sess2, rest, scfg,
                                             start_round=start, server=resumed)
        final = latest_checkpoint(d, prefix="carry_")
        assert bitwise(resumed.params, p_ref_r), "serve: resume vs run"
        assert final[1] == T, final
    rows.append({"stream": "b", "attack": "random", "killed_at_round": KILL_AFTER,
                 "resumed_from": killed[1], "final_checkpoint": final[1],
                 "bitwise_equal_run": True,
                 **serve_rates(snap_b, resume_s, M * (T - start))})

    # (c) stragglers
    ref = session(cfg)
    sched = ref.schedule(T)
    carry = ref.init_carry()
    for t in range(T):
        inp = ref.round_inputs(sched, t)
        dropped = [w for w, r in STRAGGLERS if r == t]
        if dropped:
            masks = np.array(inp.masks)
            masks[..., dropped] = True
            inp.masks = masks
            keep = torch.tensor([w not in dropped for w in range(M)], device=dev)
            inp.batches = tree_map(
                lambda l: torch.where(keep.reshape((-1,) + (1,) * (l.ndim - 1)),
                                      l, torch.zeros_like(l)), inp.batches)
        carry, _ = ref.step(carry, inp)
    sess = session(cfg)
    server, snap_c, _, strag_s = serve(
        sess, worker_payloads(sess, T),
        ServeConfig(capacity=1024, lookahead_rounds=8, round_timeout_s=0.25),
        drop=STRAGGLERS)
    assert snap_c["stragglers_masked"] == len(STRAGGLERS), snap_c
    assert snap_c["updates_accepted"] == M * T - len(STRAGGLERS), snap_c
    assert bitwise(server.params, carry[0]), "serve: stragglers vs replay"
    n_byz = {}
    for t in sorted({r for _, r in STRAGGLERS}):
        dropped = [w for w, r in STRAGGLERS if r == t]
        want = int(np.logical_or(sched.masks[t][0],
                                 np.isin(np.arange(M), dropped)).sum())
        assert server.logs[t].n_byz == want, (t, server.logs[t], want)
        n_byz[t] = want
    rows.append({"stream": "c", "stragglers": STRAGGLERS,
                 "stragglers_masked": snap_c["stragglers_masked"],
                 "n_byz_on_straggler_rounds": n_byz,
                 "bitwise_equal_step_replay": True,
                 **serve_rates(snap_c, strag_s, snap_c["updates_accepted"])})

    # (d) the smoke
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve_smoke.main([])
    assert rc == 0, out.getvalue()
    rows.append({"stream": "d", "module": "repro_torch.serve.smoke",
                 "rc": rc, "output": out.getvalue().strip()})
    emit({"phase": "serve_path", "T": T, "m": M, "rule": "cwtm", "rows": rows})
    return launches


def heldout_loss(dev):
    """The MLP's mean cross-entropy on its 4000 held-out points (the
    objective of the halving: lower is better)."""
    X, y = clf.gaussian_mixture_dataset(clf.N_CLASSES, clf.DIM,
                                        clf.N_TRAIN + 4000, seed=0)
    Xte = torch.from_numpy(X[clf.N_TRAIN:]).to(dev)
    yte = torch.from_numpy(y[clf.N_TRAIN:]).long().to(dev)

    def objective(params):
        with torch.no_grad():
            return float(clf.clf_loss(params, (Xte, yte)))
    return objective


def halving_path(task, grid):
    """``Session.sweep_halving`` over ``grid`` of ``sweep_path`` on the
    Figure-1 task, rungs at 50 and 100, keep 0.5, the held-out loss as the
    objective: every survivor bitwise equal to a plain ``Session.sweep`` of
    the surviving subset (params and logs); each pruned cell bitwise equal
    to the sweep of the cells alive in its last segment, stopped at its
    rung; every round of every lane batch a graph replay under the sync
    check. Prints the pruned cells, the captures at each rung with their
    seconds, and lanes·rounds/s beside the plain full sweep's, in turns."""
    switchers, attacks, aggs, _ = sweep_grid(grid)
    base = fig1_cfg("cwtm")
    sess = build_session(base, mlp_task(task), m=M, opt=sgd(0.1), seed=0)
    spec = SweepSpec(switchers=tuple(switchers),
                     attacks=None if attacks is None else tuple(attacks),
                     aggregators=tuple(aggs))
    C = spec.lanes
    objective = heldout_loss(task[0]["w1"].device)
    rules = [AggSpec.coerce(g).rule for g in aggs]

    def halving():
        return sess.sweep_halving(spec, T, objective=objective, keep=0.5,
                                  rungs=HALVING_RUNGS)

    reset_launches()
    with watch_replays() as modes, watch_captures() as caps:
        out, first_s = timed(halving)
    launches = {k: v for k, v in LAUNCHES.items() if v}
    alive = [c for c in range(C) if not out[c]["pruned"]]
    # every round of every lane batch (one a rule among the live cells)
    bounds = [0] + HALVING_RUNGS + [T]
    replays = sum(
        (b - a) * len({rules[c] for c in range(C) if out[c]["rounds_run"] >= b})
        for a, b in zip(bounds, bounds[1:]))
    assert len(modes) == replays == modes.count(SYNC_DEBUG_ERROR), \
        (len(modes), replays)
    subset = sess.sweep(spec.lane_subset(alive), T)
    for j, c in enumerate(alive):
        [(p, logs)] = out[c]["results"]
        assert bitwise(p, subset[j][0]), f"halving {grid}: survivor {c}"
        assert [vars(l) for l in logs] == [vars(l) for l in subset[j][1]]
    for a, b in zip(bounds, bounds[1:-1]):
        live = [c for c in range(C) if out[c]["rounds_run"] >= b]
        pruned = [c for c in live if out[c]["rounds_run"] == b]
        stopped = sess.sweep(spec.lane_subset(live), b)
        for c in pruned:
            [(p, logs)] = out[c]["results"]
            i = live.index(c)
            assert bitwise(p, stopped[i][0]), f"halving {grid}: pruned {c}"
            assert [vars(l) for l in logs] == [vars(l) for l in stopped[i][1]]
    lane_rounds = sum(o["rounds_run"] for o in out)
    pairs = []
    for _ in range(HALVING_TIMED_PAIRS):
        _, halving_s = timed(halving)
        _, sweep_s = timed(lambda: sess.sweep(spec, T))
        pairs.append({"halving_lane_rounds_per_s": lane_rounds / halving_s,
                      "sweep_lane_rounds_per_s": C * T / sweep_s,
                      "halving_s": halving_s, "sweep_s": sweep_s})
    by_rung = {}
    for cap in caps:
        r = by_rung.setdefault(str(cap["start"]), {"captures": 0, "s": 0.0,
                                                   "lanes": []})
        r["captures"] += len(cap["levels"])
        r["s"] += cap["s"]
        r["lanes"].append(cap["lanes"])
    emit({"phase": "halving_path", "grid": grid, "lanes": C, "T": T, "m": M,
          "rungs": HALVING_RUNGS, "keep": 0.5,
          "lane_specs": [[sw[1]["K"], attacks[c] if attacks else base.attack,
                          AggSpec.coerce(aggs[c]).label]
                         for c, sw in enumerate(switchers)],
          "pruned": {str(c): out[c]["rounds_run"] for c in range(C)
                     if out[c]["pruned"]},
          "survivors": alive, "survivors_bitwise_equal_subset_sweep": True,
          "pruned_bitwise_equal_stopped_sweep": True,
          "replays": len(modes),
          "replays_under_sync_error": modes.count(SYNC_DEBUG_ERROR),
          "launches": launches, "captures_by_rung_start": by_rung,
          "lane_rounds": lane_rounds, "first_halving_s": first_s,
          "timed_pairs": pairs})
    return launches


# ------------------------------------------------- 8b. the worker meshes

MESH_RANKS = 2  # gloo ranks on the one card: NCCL takes one rank a card
MESH_M, MESH_BYZ = 16, 7  # m divisible by the ranks; trim 7
MESH_DELTA = MESH_BYZ / MESH_M + 1e-3
MESH_TIMEOUT_S = 300  # each rank's whole run, start-up included
MESH_TIMED = 2  # sharded and unsharded reruns in turns, graphs kept
# a 2-rank run's params against the unsharded run of the same setting, in
# units in the last place of each leaf's largest |value|: a rank's
# vmap(grad) over 8 workers rounds unlike the one over 16 at 1 and 4 units
# a worker (cuBLAS picks another product); the sweep's lanes on a (2, 1)
# lane mesh compute what they computed unsharded, bitwise (0)
MESH_ULPS = 32
MESH_LAUNCHES = {"cwtm": {"cw_reduce": 440},
                 "geomed": EXPECTED_LAUNCHES["geomed"],
                 "nnm+cwtm": EXPECTED_LAUNCHES["nnm+cwtm"],
                 "momentum": {"cw_reduce": T}, "sweep grid1": {"cw_reduce": 440}}


def ulps(a, b):
    """The largest difference between two dicts of float32 tensors, in
    units in the last place of the leaf's largest |value| in ``b``."""
    def one(x, y):
        top = y.abs().max()
        return float((x - y).abs().max() / (torch.nextafter(top, top + 1) - top))
    return max(one(a[k], b[k]) for k in a)


# the m=16 runs' params against the plain backend's, as in geometry_path
MESH_PLAIN = {"cwtm": 1e-6, "geomed": 1e-5, "nnm+cwtm": 1e-5}


def mesh_plain(dev):
    """The rules the ranks run, at m=16 through ``run_dynabro`` on the
    kernels and on the plain backend, as ``geometry_path`` runs m=17: the
    shapes the ranks give the kernels (K3-K6 with k = m = 16) held to their
    plain versions, with equal round logs, params within ``MESH_PLAIN`` and
    the kernels' launches the ranks' own."""
    params0, grad_fn, sampler, _ = make_task(MESH_M, seed=0, device=dev)
    rows = []
    for rule, limit in MESH_PLAIN.items():
        outs, launches = [], []
        for backend in ("auto", "ref"):
            cfg = dataclasses.replace(mesh_cfg(rule), agg_backend=backend)
            reset_launches()
            p, logs, _ = run_dynabro(
                grad_fn, params0, sgd(0.1), cfg,
                get_switcher("periodic", MESH_M, n_byz=MESH_BYZ, K=10),
                sampler, T, seed=0)
            outs.append((p, logs))
            launches.append({k: v for k, v in LAUNCHES.items() if v})
        (p, logs), (q, ref_logs) = outs
        row = {"rule": rule, "launches": launches[0],
               "plain_launches": launches[1],
               "logs_equal_plain": ([vars(x) for x in logs]
                                    == [vars(x) for x in ref_logs]),
               "max_param_diff_vs_plain": max_diff(p, q), "limit": limit,
               "finite": all(bool(torch.isfinite(v).all()) for v in p.values())}
        rows.append(row)
    emit({"phase": "mesh_path", "case": "plain backend", "T": T, "m": MESH_M,
          "rows": rows})
    for row in rows:
        assert row["launches"] == MESH_LAUNCHES[row["rule"]], row
        assert not row["plain_launches"], row
        assert row["finite"] and row["logs_equal_plain"], row
        assert row["max_param_diff_vs_plain"] <= row["limit"], row


def one_device_mesh(task):
    """``make_worker_mesh(1)`` on the Figure-1 setting (m=17) with CWTM and
    GeoMed: params and logs bitwise ``mesh=None``'s with the same launches,
    and rounds/s of both in turns (graphs kept)."""
    params0, grad_fn, sampler, _ = task
    by_rule = {}
    for rule in ("cwtm", "geomed"):
        cfg = fig1_cfg(rule)
        meshes = {"mesh=None": None, "make_worker_mesh(1)": make_worker_mesh(1)}
        fns = {k: make_dynabro_scan_fn(grad_fn, cfg, sgd(0.1), mesh=mesh)
               for k, mesh in meshes.items()}

        def run(which):
            return timed(lambda: run_dynabro_scan(
                grad_fn, params0, sgd(0.1), cfg, periodic(), sampler, T,
                seed=0, scan_fn=fns[which], mesh=meshes[which]))

        outs, launches = {}, {}
        for which in meshes:
            reset_launches()
            outs[which], _ = run(which)
            launches[which] = {k: v for k, v in LAUNCHES.items() if v}
        secs = {which: [] for which in meshes}
        for which in list(meshes) * MESH_TIMED:
            secs[which].append(run(which)[1])
        (p0, l0, _), (p1, l1, _) = outs.values()
        row = {"phase": "mesh_path", "case": f"one device {rule}", "T": T,
               "m": M, "bitwise_equal": bitwise(p0, p1),
               "logs_equal": [vars(x) for x in l0] == [vars(x) for x in l1],
               "launches": launches,
               "rounds_per_s": {k: [T / s for s in v] for k, v in secs.items()}}
        emit(row)
        assert row["bitwise_equal"] and row["logs_equal"], row
        assert launches["mesh=None"] == launches["make_worker_mesh(1)"], row
        by_rule[f"mesh1 {rule}"] = launches["make_worker_mesh(1)"]
    return by_rule


def mesh_cfg(rule, attack="sign_flip", kwargs=None):
    return DynaBROConfig(
        mlmc=MLMCConfig(T=T, m=MESH_M, V=5.0, kappa=1.0, j_cap=5),
        aggregator=rule, delta=MESH_DELTA, attack=attack, attack_kwargs=kwargs)


def mesh_driver(case, task, mesh):
    """(sharded run, unsharded run, the sharded run's capture seconds) of
    ``case`` on the m=16 setting, each run giving its lanes' [(params, logs
    or None)]; momentum is ``momentum_path``'s setting."""
    params0, grad_fn, sampler, _ = task
    if case == "momentum":
        cfg = mesh_cfg("cwtm", attack="shift", kwargs={"v": 1.0})
        fns = {m: make_momentum_scan_fn(grad_fn, cfg, 0.1, 0.9, mesh=m)
               for m in (mesh, None)}

        def run(m):
            p, _ = run_momentum_scan(
                grad_fn, params0, cfg,
                get_switcher("momentum_tailored", MESH_M, alpha=0.1), sampler,
                T, lr=0.1, beta=0.9, scan_fn=fns[m], mesh=m)
            return [(p, None)]
    else:
        cfg = mesh_cfg(case)
        fns = {m: make_dynabro_scan_fn(grad_fn, cfg, sgd(0.1), mesh=m)
               for m in (mesh, None)}

        def run(m):
            p, logs, _ = run_dynabro_scan(
                grad_fn, params0, sgd(0.1), cfg,
                get_switcher("periodic", MESH_M, n_byz=MESH_BYZ, K=10),
                sampler, T, seed=0, scan_fn=fns[m], mesh=m)
            return [(p, logs)]
    return (lambda: run(mesh), lambda: run(None),
            lambda: fns[mesh].capture_seconds)


def mesh_sweep(task, lane_mesh):
    """(sharded, unsharded, the sharded run's capture seconds)
    ``Session.sweep`` of grid 1 (8 CWTM lanes, m=17), the sharded one on
    ``lane_mesh``."""
    switchers, attacks, aggs, _ = sweep_grid("grid1")
    sess = build_session(fig1_cfg("cwtm"), mlp_task(task), m=M, opt=sgd(0.1),
                         seed=0)
    spec = SweepSpec(switchers=tuple(switchers), attacks=tuple(attacks),
                     aggregators=tuple(aggs))
    return (lambda: sess.sweep(spec, T, lane_mesh=lane_mesh),
            lambda: sess.sweep(spec, T),
            lambda: next(f for k, f in sess._lane_fns.items()
                         if lane_mesh in k).capture_seconds)


def counted(fn):
    """fn()'s result, and its seconds, launches, worker gathers, gather ms
    and graph replays (those under the sync check)."""
    reset_launches()
    gathers, gather_s = GATHERS["gathers"], GATHERS["seconds"]
    with watch_replays() as modes:
        out, secs = timed(fn)
    return out, {"seconds": secs, "rounds_per_s": T / secs,
                 "launches": {k: v for k, v in LAUNCHES.items() if v},
                 "gathers": GATHERS["gathers"] - gathers,
                 "gather_ms": 1e3 * (GATHERS["seconds"] - gather_s),
                 "replays": len(modes),
                 "replays_under_sync_error": modes.count(SYNC_DEBUG_ERROR)}


def mesh_runs(rank, case, sharded_run, plain_run, capture_seconds):
    """``case`` sharded on every rank at once and unsharded on rank 0 while
    the other ranks wait, then ``MESH_TIMED`` reruns of each in turns; the
    row of this rank: its counts, whether every rank's lanes are bitwise
    equal, and on rank 0 its lanes against the unsharded run's."""
    barrier = torch.distributed.barrier
    barrier()
    out, sharded = counted(sharded_run)
    barrier()
    ref, unsharded = counted(plain_run) if rank == 0 else (None, None)
    reruns = []
    for _ in range(MESH_TIMED):
        barrier()
        s = counted(sharded_run)[1]
        barrier()
        u = counted(plain_run)[1] if rank == 0 else None
        reruns.append({"sharded": s, "unsharded": u})
    got = [None] * MESH_RANKS
    torch.distributed.all_gather_object(
        got, [{k: v.cpu() for k, v in p.items()} for p, _ in out])
    row = {"case": case, "rank": rank, "sharded": sharded, "reruns": reruns,
           "capture_s": {str(k): v for k, v in capture_seconds().items()},
           "ranks_bitwise_equal": all(
               len(g) == len(got[0]) and all(map(bitwise, g, got[0]))
               for g in got)}
    if rank == 0:
        row.update(
            unsharded=unsharded, lanes=len(out),
            logs_equal=all([vars(x) for x in a or []]
                           == [vars(x) for x in b or []]
                           for (_, a), (_, b) in zip(out, ref)),
            failsafe_ok=[sum(x.failsafe_ok for x in logs or [])
                         for _, logs in out],
            bitwise_lanes=sum(bitwise(p, q) for (p, _), (q, _) in zip(out, ref)),
            max_param_diff=max(max_diff(p, q)
                               for (p, _), (q, _) in zip(out, ref)),
            max_ulps=max(ulps(p, q) for (p, _), (q, _) in zip(out, ref)),
            finite=all(bool(torch.isfinite(v).all())
                       for p, _ in out for v in p.values()))
    return row


def mesh_rank(rank, tmp):
    """One rank of ``mesh_path``'s gloo group on the card: the drivers on a
    2-rank worker mesh, then grid 1's sweep on a (2, 1) lane mesh. Writes
    its rows to ``<tmp>/rank<rank>.json``."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
        world_size=MESH_RANKS)
    try:
        dev = torch.device("cuda", 0)
        mesh = make_worker_mesh(MESH_RANKS)
        task = make_task(MESH_M, seed=0, device=dev)
        rows = [mesh_runs(rank, case, *mesh_driver(case, task, mesh))
                for case in ("cwtm", "geomed", "nnm+cwtm", "momentum")]
        rows.append(mesh_runs(rank, "sweep grid1", *mesh_sweep(
            make_task(M, seed=0, device=dev), make_lane_mesh(MESH_RANKS, 1))))
    finally:
        torch.distributed.destroy_process_group()
    Path(tmp, f"rank{rank}.json").write_text(json.dumps(rows))


def mesh_path(task):
    """The sharded Mode A drivers on the card: ``one_device_mesh``, then
    ``MESH_RANKS`` gloo ranks on the one card (``mesh_rank``, each a process
    of this script), each rank's rows checked here: CWTM (K1), GeoMed (K4,
    K6), NNM+CWTM (K3, K5) and momentum on a 2-rank worker mesh, at m=16
    with 7 Byzantine (trim 7) under sign_flip and Periodic(10), T=150: every
    round two graph replays under the sync check with one worker gather
    between them; each rank's launches the unsharded run's; the ranks'
    params bitwise equal; rank 0's round logs equal to the unsharded run's
    and its params within ``MESH_ULPS``; and grid 1's sweep (K2) on a (2,
    1) lane mesh, each lane bitwise the unsharded sweep's; then
    ``mesh_plain``. Rounds/s of each run beside the unsharded one's, and
    the gathers and gather ms a run."""
    t0 = time.perf_counter()
    by_path = one_device_mesh(task)
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
             str(r), tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(MESH_RANKS)]
        try:
            logs = [p.communicate(timeout=MESH_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"mesh rank {r} failed:\n{log[-6000:]}"
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(MESH_RANKS)]
    for rows in zip(*ranks):
        case, r0 = rows[0]["case"], rows[0]
        sweep = case.startswith("sweep")
        row = {"phase": "mesh_path", "case": case, "ranks": MESH_RANKS,
               "T": T, "m": M if sweep else MESH_M,
               **{k: v for k, v in r0.items() if k not in ("case", "rank")},
               "other_ranks": [{k: r[k] for k in ("sharded", "reruns")}
                               for r in rows[1:]],
               "limit_ulps": 0 if sweep else MESH_ULPS}
        emit(row)
        want = MESH_LAUNCHES[case]
        assert r0["unsharded"]["launches"] == want, (case, r0["unsharded"])
        for r in rows:
            assert r["ranks_bitwise_equal"], f"{case}: the ranks' params differ"
            counts = [r["sharded"]] + [x["sharded"] for x in r["reruns"]]
            for c in counts:
                assert c["launches"] == want, (case, r["rank"], c["launches"])
                # drivers: two graphs a round, a gather between them; the
                # sweep's worker axis is 1: one graph a round, no gather
                assert c["replays"] == c["replays_under_sync_error"] == (
                    T if sweep else 2 * T), (case, c)
                assert c["gathers"] == (0 if sweep else T), (case, c)
        assert r0["finite"] and r0["logs_equal"], f"{case}: logs differ"
        assert r0["max_ulps"] <= row["limit_ulps"], (
            f"{case}: params differ by {r0['max_ulps']} ulps")
        by_path[f"mesh {case}"] = r0["sharded"]["launches"]
    mesh_plain(torch.device("cuda", 0))
    emit({"phase": "mesh_path", "seconds": time.perf_counter() - t0})
    return by_path


# ------------------------------------------------------------- 9. model zoo

ZOO_TIMED_RUNS = 2  # the kernel path again, graphs kept, for rounds/s
ZOO_PLAIN_TOL = 1e-5  # of each leaf's largest |value|


def zoo_dyn_cfg(backend="auto", attack="sign_flip", aggregator="cwtm"):
    return DynaBROConfig(
        mlmc=MLMCConfig(T=ZOO_T, m=M, V=5.0, option=1, kappa=1.0, j_cap=3),
        aggregator=aggregator, delta=DELTA, attack=attack, agg_backend=backend)


def zoo_path(dev):
    """DynaBRO over SmolLM-360M at its published width, 8 of its 32 layers
    (``zoo_config``), through ``zoo_run``: seq_len 128, one sequence a
    unit, m=17 with 8 Byzantine under sign_flip and Periodic(K=4), CWTM at
    trim 8, ``MLMCConfig(T=16, V=5, kappa=1, j_cap=3)``, sgd(0.05),
    ``task_for_config`` and ``run_dynabro_scan(microbatch=True)`` on the
    kernel backend, with one ``cw_reduce`` launch an aggregation, the Mean
    rule's check and (e) of ``serve_path`` on its scan_fn. With CWTM at
    trim 8 (the coordinate-wise median of 17 single-sequence gradients)
    the held-out loss rises in these 16 rounds, under sign_flip and without
    an attack alike (PERF.md), so the fall is held on the Mean rule's
    unattacked run and CWTM's loss is reported. Returns the kernel run's
    launch counts, the served rounds' and the kernel run's reference for
    ``gspmd_path``."""
    return zoo_run(dev, ZOO_ARCH, zoo_config(), phase="zoo_path",
                   timed_runs=ZOO_TIMED_RUNS, mean_check=True, serve=True,
                   keep_ref=True)


ZOO_SERVE_T = 4


def zoo_serve(task, dcfg, scan_fn):
    """(e) of ``serve_path``: the aggregation server over the zoo path's
    SmolLM-360M task (published width, 8 of 32 layers, m=17) for 4 rounds,
    17 worker threads, the health polled over HTTP. Its session shares
    ``zoo_path``'s scan_fn, whose kept graphs serve ``Session.step`` (no
    second graph pool, no capture). Checks params and logs bitwise equal to
    ``Session.run(4)`` of a session sharing the scan_fn, every round a
    replay under the sync check, one ``cw_reduce`` launch an aggregation;
    prints rounds/s and the peak memory allocated and reserved."""
    dev = next(iter(task.params0.values())).device

    def session():
        return build_session(dcfg, task, opt=sgd(0.05), seed=0,
                             switcher=get_switcher("periodic", M, n_byz=N_BYZ,
                                                   K=4),
                             scan_fn=scan_fn, microbatch=True)

    captures = scan_fn.captures
    p_ref, logs_ref, _ = session().run(ZOO_SERVE_T)
    sess = session()
    payloads = worker_payloads(sess, ZOO_SERVE_T)
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    with watch_replays() as modes:
        server, snap, health, secs = serve(
            sess, payloads, ServeConfig(capacity=1024, lookahead_rounds=8,
                                        health_port=0), rounds=ZOO_SERVE_T)
    launches = {k: v for k, v in LAUNCHES.items() if v}
    j_max = dcfg.mlmc.j_max
    expected = sum(3 if 1 <= l.level <= j_max else 1 for l in logs_ref)
    row = {"phase": "serve_path", "stream": "e", "arch": ZOO_ARCH,
           "layers": ZOO_LAYERS, "T": ZOO_SERVE_T, "m": M,
           "bitwise_equal_run": bitwise(server.params, p_ref),
           "logs_equal": [vars(l) for l in server.logs] == [vars(l) for l in logs_ref],
           "captures": scan_fn.captures - captures, "replays": len(modes),
           "replays_under_sync_error": modes.count(SYNC_DEBUG_ERROR),
           "launches": launches, "expected_cw_reduce": expected,
           "health": health,
           "peak_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "peak_reserved_gb": torch.cuda.max_memory_reserved(dev) / 1e9,
           **serve_rates(snap, secs, snap["updates_accepted"])}
    emit(row)
    assert row["bitwise_equal_run"] and row["logs_equal"], "zoo serve vs run"
    assert row["captures"] == 0, "zoo serve: a capture"
    assert len(modes) == ZOO_SERVE_T == row["replays_under_sync_error"], modes
    assert launches == {"cw_reduce": expected}, launches
    assert snap["updates_accepted"] == M * ZOO_SERVE_T, snap
    del server, sess, p_ref
    return launches


# ------------------------------------------------ 9a. the zoo's GSPMD path

GSPMD_LAYERS = 8  # of 32: zoo_path's, so its run is the unsharded reference
GSPMD_TIMEOUT_S = 300  # each group of ranks, start-up included
# the (2, 2) cell: a dense arch at get_reduced_config(d_model=512) (8 heads
# over 8 KV heads; SmolLM-360M's there keeps 5 KV heads, which divide no
# head count of 8: ROADMAP.md §3), m=16 with 7 Byzantine (trim 7)
GSPMD_REDUCED_ARCH = "qwen3-0.6b"
GSPMD_REDUCED_M, GSPMD_REDUCED_BYZ, GSPMD_REDUCED_T = 16, 7, 8
GSPMD_TOL = dict(rtol=1e-5, atol=1e-6)  # the JAX package's, test_zoo_driver.py
# the zoo run's cw_reduce launches (T=16, seed 0: 44 aggregations of the
# 11-leaf tree), each rank's on its blocks: PERF.md's count
GSPMD_K1_LAUNCHES = 44


def within(a, b, tol=GSPMD_TOL):
    """Every leaf of ``a`` within rtol/atol of ``b``'s."""
    return all(bool(torch.all((a[k] - b[k]).abs()
                              <= tol["atol"] + tol["rtol"] * b[k].abs()))
               for k in b)


def gspmd_counted(fn, scan_fn, T):
    """fn()'s result (a run of T rounds) and its seconds, launches, GSPMD
    collectives (counts, host ms), graph replays and the scan_fn's eager
    rounds."""
    reset_launches()
    before = dict(COLLECTIVES)
    eager = scan_fn.eager_rounds
    with watch_replays() as modes:
        out, secs = timed(fn)
    return out, {"seconds": secs, "first_run_rounds_per_s": T / secs,
                 "launches": {k: v for k, v in LAUNCHES.items() if v},
                 **{k: COLLECTIVES[k] - before[k]
                    for k in ("param_gathers", "exchanges", "sums")},
                 "collective_ms": 1e3 * (COLLECTIVES["seconds"]
                                         - before["seconds"]),
                 "replays": len(modes),
                 "eager_rounds": scan_fn.eager_rounds - eager}


def gspmd_zoo_run(dev, cfg, mesh, dcfg, microbatch=True):
    """One ``run_dynabro_scan`` of ``cfg``'s task (seq_len 128, one sequence
    a unit, sgd(0.05), Periodic(4), seed 0) on ``mesh`` with
    ``plan_params(fsdp=True)``'s specs (``mesh=None``: unsharded);
    (params, logs, counts)."""
    task = task_for_config(cfg, seq_len=ZOO_SEQ, unit_batch=1, seed=0,
                           device=dev)
    m, T = dcfg.mlmc.m, dcfg.mlmc.T
    n_byz = GSPMD_REDUCED_BYZ if m == GSPMD_REDUCED_M else N_BYZ
    specs = (None if mesh is None
             else plan_params(cfg, mesh, fsdp=True, dtype=torch.float32)[0])
    scan_fn = make_dynabro_scan_fn(task.grad_fn, dcfg, sgd(0.05), mesh=mesh,
                                   param_specs=specs, microbatch=microbatch)

    def run():
        return run_dynabro_scan(
            task.grad_fn, task.params0, sgd(0.05), dcfg,
            get_switcher("periodic", m, n_byz=n_byz, K=4), task.make_sampler(m),
            T, seed=0, scan_fn=scan_fn, mesh=mesh, param_specs=specs,
            microbatch=microbatch)
    (p, logs, _), counts = gspmd_counted(run, scan_fn, T)
    if mesh is None:  # graphs kept: the rate of a run after the capture
        counts["rerun_s"] = timed(run)[1]
        counts["rerun_rounds_per_s"] = T / counts["rerun_s"]
    return p, [vars(l) for l in logs], counts


def gspmd_reduced_cfg(rule):
    return DynaBROConfig(
        mlmc=MLMCConfig(T=GSPMD_REDUCED_T, m=GSPMD_REDUCED_M, V=5.0, option=1,
                        kappa=1.0, j_cap=3),
        aggregator=rule, delta=GSPMD_REDUCED_BYZ / GSPMD_REDUCED_M + 1e-3,
        attack="sign_flip")


GSPMD_REDUCED_CASES = (("cwtm", True), ("geomed", False))


def gspmd_rank(case, world, rank, tmp):
    """One rank of ``gspmd_path``'s gloo groups on the card. ``smollm``: a
    (1, 2) mesh, SmolLM-360M at its published width, ``GSPMD_LAYERS``
    layers, zoo_path's setting, CWTM streamed; its params go to
    ``<tmp>/params<rank>.pt``. ``reduced``: a (2, 2) mesh,
    ``GSPMD_REDUCED_ARCH`` at ``get_reduced_config(d_model=512)``, m=16
    with 7 Byzantine, CWTM streamed and GeoMed stacked, each also unsharded on
    rank 0 (the other ranks waiting), the ranks' params compared there.
    Writes its rows to ``<tmp>/rank<rank>.json``, each with the rank's
    wall seconds from its spawn to this call (``startup_s``: the imports)
    and from being let go to the row (``rank_s``)."""
    t_entry = time.time()
    startup_s = t_entry - float(os.environ["GSPMD_SPAWN_T"])
    while not Path(tmp, "go").exists():  # gspmd_finish lets the ranks go
        assert time.time() - t_entry < GSPMD_TIMEOUT_S, "never let go"
        time.sleep(0.05)
    t_entry = time.time()
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
        world_size=world)
    dev = torch.device("cuda", 0)
    rows = []
    try:
        if case == "smollm":
            mesh = make_worker_mesh(1, model=2)
            torch.cuda.reset_peak_memory_stats(dev)
            p, logs, counts = gspmd_zoo_run(dev, zoo_config(GSPMD_LAYERS),
                                            mesh, zoo_dyn_cfg())
            alloc, reserved = peak_gb(dev)
            torch.save({k: v.cpu() for k, v in p.items()},
                       Path(tmp, f"params{rank}.pt"))
            rows.append({"case": "smollm (1, 2)", "rank": rank, "logs": logs,
                         "sharded": counts, "peak_allocated_gb": alloc,
                         "peak_reserved_gb": reserved})
            rows[-1].update(startup_s=startup_s, rank_s=time.time() - t_entry)
        else:
            mesh = make_worker_mesh(2, model=2)
            cfg = get_reduced_config(GSPMD_REDUCED_ARCH, d_model=REDUCED_D)
            for rule, microbatch in GSPMD_REDUCED_CASES:
                dcfg = gspmd_reduced_cfg(rule)
                torch.distributed.barrier()
                p, logs, counts = gspmd_zoo_run(dev, cfg, mesh, dcfg,
                                                microbatch)
                got = [None] * world
                torch.distributed.all_gather_object(
                    got, {k: v.cpu() for k, v in p.items()})
                row = {"case": f"reduced (2, 2) {rule}", "rank": rank,
                       "microbatch": microbatch, "logs": logs,
                       "sharded": counts,
                       "ranks_bitwise_equal": all(bitwise(g, got[0])
                                                  for g in got)}
                if rank == 0:
                    q, ref_logs, ref_counts = gspmd_zoo_run(
                        dev, cfg, None, dcfg, microbatch)
                    row.update(unsharded=ref_counts, unsharded_logs=ref_logs,
                               max_param_diff=max_diff(p, q),
                               max_ulps=ulps(p, q), within_tol=within(p, q),
                               bitwise_unsharded=bitwise(p, q),
                               finite=all(bool(torch.isfinite(v).all())
                                          for v in p.values()))
                rows.append(row)
                row.update(startup_s=startup_s, rank_s=time.time() - t_entry)
                del p
                gc.collect()
                torch.cuda.empty_cache()
                torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    Path(tmp, f"rank{rank}.json").write_text(json.dumps(rows))


def gspmd_start(case, world, env=None):
    """Start ``gspmd_rank(case)`` as ``world`` processes of this script;
    each imports, then waits for ``gspmd_finish`` to let it go, so the
    imports overlap the parent's work. Returns (processes, the
    ``TemporaryDirectory`` the ranks write to)."""
    tmp = tempfile.TemporaryDirectory()
    env = dict(os.environ if env is None else env,
               GSPMD_SPAWN_T=repr(time.time()))
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--gspmd-rank", case,
         str(world), str(r), tmp.name], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(world)]
    return procs, tmp


def gspmd_finish(case, procs, tmp):
    """Let ``gspmd_start``'s ranks go and wait for them (a rank that fails
    or outlasts ``GSPMD_TIMEOUT_S`` fails the phase, and every rank is
    ended); returns each rank's rows and ``tmp``, for the caller to clean
    up."""
    Path(tmp.name, "go").touch()
    try:
        logs = [p.communicate(timeout=GSPMD_TIMEOUT_S)[0] for p in procs]
    finally:
        gspmd_end(procs)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"gspmd {case} rank {r} failed:\n{log[-6000:]}"
    return [json.loads(Path(tmp.name, f"rank{r}.json").read_text())
            for r in range(len(procs))], tmp


def gspmd_end(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def gspmd_mesh11(dev, zoo_ref):
    """(a) of ``gspmd_path``: a (1, 1) mesh on ``zoo_path``'s setting."""
    assert GSPMD_LAYERS == ZOO_LAYERS, "zoo_ref is the 8-layer run"
    p, logs, counts = gspmd_zoo_run(dev, zoo_config(),
                                    make_worker_mesh(1, model=1), zoo_dyn_cfg())
    row = {"phase": "gspmd_path", "case": "smollm (1, 1)", "T": ZOO_T, "m": M,
           "layers": ZOO_LAYERS, "bitwise_equal_mesh_none": bitwise(
               {k: v.cpu() for k, v in p.items()}, zoo_ref["params"]),
           "logs_equal": logs == zoo_ref["logs"], "run": counts,
           "mesh_none_launches": zoo_ref["launches"],
           "mesh_none_first_rounds_per_s": zoo_ref["first_rounds_per_s"]}
    emit(row)
    assert row["bitwise_equal_mesh_none"] and row["logs_equal"], row
    assert counts["launches"] == zoo_ref["launches"], row
    assert counts["replays"] == ZOO_T and counts["eager_rounds"] == 0, row
    del p
    gc.collect()
    torch.cuda.empty_cache()
    return counts["launches"]


def gspmd_smollm(dev, zoo_ref, started):
    """(b) of ``gspmd_path``: two gloo ranks on a (1, 2) mesh, ``started``
    by ``gspmd_start``."""
    t0 = time.perf_counter()
    parent_gb = torch.cuda.memory_reserved(dev) / 1e9
    ranks, tmp = gspmd_finish("smollm", *started)
    ranks_s = time.perf_counter() - t0
    with tmp:
        params = [torch.load(Path(tmp.name, f"params{r}.pt"))
                  for r in range(2)]
    ref = zoo_ref["params"]
    rows = [r[0] for r in ranks]
    row = {"phase": "gspmd_path", "case": "smollm (1, 2)", "ranks": 2,
           "T": ZOO_T, "m": M, "layers": GSPMD_LAYERS,
           "d_model": zoo_config().d_model,
           "ranks_bitwise_equal": bitwise(params[1], params[0]),
           "logs_equal_mesh_none": all(r["logs"] == zoo_ref["logs"]
                                       for r in rows),
           "bitwise_mesh_none": bitwise(params[0], ref),
           "max_param_diff": max_diff(params[0], ref),
           "max_ulps": ulps(params[0], ref),
           "within_tol": within(params[0], ref), "tol": GSPMD_TOL,
           "per_rank": [{k: r[k] for k in ("rank", "sharded",
                                            "peak_allocated_gb",
                                            "peak_reserved_gb", "startup_s",
                                            "rank_s")}
                        for r in rows],
           # a rank's rate is its one run's, warm-up included: beside
           # mesh=None's first run (its captures included) and its reruns
           "mesh_none_first_rounds_per_s": zoo_ref["first_rounds_per_s"],
           "mesh_none_rerun_rounds_per_s": zoo_ref["rounds_per_s"],
           "parent_reserved_gb": parent_gb, "ranks_s": ranks_s,
           "seconds": time.perf_counter() - t0}
    emit(row)
    del params
    assert row["ranks_bitwise_equal"] and row["logs_equal_mesh_none"], row
    assert row["within_tol"], row
    for r in rows:
        c = r["sharded"]
        assert c["launches"] == {"cw_reduce": GSPMD_K1_LAUNCHES}, r
        assert c["replays"] == 0 and c["eager_rounds"] == ZOO_T, r
    return rows[0]["sharded"]["launches"]


def gspmd_reduced(started):
    """(c) of ``gspmd_path``: four gloo ranks on a (2, 2) mesh, ``started``
    by ``gspmd_start``."""
    t0 = time.perf_counter()
    ranks, tmp = gspmd_finish("reduced", *started)
    tmp.cleanup()
    ranks_s = time.perf_counter() - t0
    by_path = {}
    for rows in zip(*ranks):
        r0 = rows[0]
        row = {"phase": "gspmd_path", "case": r0["case"], "ranks": 4,
               "arch": GSPMD_REDUCED_ARCH, "T": GSPMD_REDUCED_T,
               "m": GSPMD_REDUCED_M,
               "d_model": REDUCED_D, "microbatch": r0["microbatch"],
               **{k: r0[k] for k in ("unsharded", "max_param_diff", "max_ulps",
                                     "within_tol", "bitwise_unsharded",
                                     "finite")},
               "logs_equal": r0["logs"] == r0["unsharded_logs"],
               "ranks_bitwise_equal": all(r["ranks_bitwise_equal"]
                                          for r in rows),
               "per_rank": [{"rank": r["rank"], **r["sharded"],
                             "startup_s": r["startup_s"],
                             "rank_s": r["rank_s"]} for r in rows],
               "tol": GSPMD_TOL}
        emit(row)
        assert row["ranks_bitwise_equal"] and row["logs_equal"], row
        assert row["within_tol"] and row["finite"], row
        for r in rows:
            c = r["sharded"]
            assert c["launches"] == r0["unsharded"]["launches"], (r["rank"], c)
            assert c["replays"] == 0 and c["eager_rounds"] == GSPMD_REDUCED_T, c
        by_path[f"gspmd {r0['case']}"] = r0["sharded"]["launches"]
    emit({"phase": "gspmd_path", "case": "reduced (2, 2)", "ranks_s": ranks_s,
          "seconds": time.perf_counter() - t0})
    return by_path


def gspmd_path(dev, zoo_ref):
    """The model zoo's GSPMD path on the card (``run_dynabro_scan(mesh=,
    param_specs=)`` on ``(workers, 'model')`` meshes, ``plan_params``'s
    specs, every round eager):

    (a) a (1, 1) mesh on ``zoo_path``'s setting (SmolLM-360M, 8 layers,
        m=17, CWTM streamed): bitwise ``zoo_ref`` (zoo_path's kernel run)
        with its launches, every round a graph replay;
    (b) two gloo ranks on a (1, 2) mesh, the same setting at
        ``GSPMD_LAYERS``: the ranks bitwise equal, logs equal to
        ``zoo_ref``'s, params within rtol 1e-5, atol 1e-6 of them, each
        rank's ``GSPMD_K1_LAUNCHES`` cw_reduce launches, no replay, T eager
        rounds; each rank's peak GB, rounds/s, collectives and their ms;
    (c) four gloo ranks on a (2, 2) mesh, ``GSPMD_REDUCED_ARCH`` at
        d_model 512, m=16, 7 Byzantine, T=8: CWTM streamed (K1) and GeoMed
        stacked (K4, K6), the ranks bitwise, rank 0's logs equal to its
        unsharded run's, params within the same tolerance, each rank's
        launches the unsharded run's.

    The six rank processes start first and import while (a) runs (so
    (a)'s rate is taken beside their imports); (b)'s two ranks then run
    alone on the card, then (c)'s four. Returns each path's launches (a
    rank's)."""
    t0 = time.perf_counter()
    smollm = gspmd_start("smollm", 2, dict(
        os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
    reduced = gspmd_start("reduced", 4)
    try:
        by_path = {"gspmd (1, 1)": gspmd_mesh11(dev, zoo_ref),
                   "gspmd smollm (1, 2)": gspmd_smollm(dev, zoo_ref, smollm)}
        by_path.update(gspmd_reduced(reduced))
    finally:
        for procs, tmp in (smollm, reduced):
            gspmd_end(procs)
            tmp.cleanup()
    emit({"phase": "gspmd_path", "seconds": time.perf_counter() - t0})
    return by_path


# ------------------------------------------------ 9b. Mode B's robust step

MODEB_RANKS, MODEB_MESH = 8, (4, 2)  # ('data', 'model'): m=4 workers
MODEB_STEPS, MODEB_BATCH, MODEB_LR = 8, 8, 0.05
MODEB_MLMC = dict(T=64, m=4, V=1e9)  # J=1, the fail-safe passes
MODEB_MASK = (1.0, 0.0, 0.0, 0.0)  # sign_flip on worker 0
MODEB_WAIT_S = 900  # a rank's wait to be let go (it starts before gspmd_path)
MODEB_TIMEOUT_S = 300  # the ranks' run once let go
# K1 launches a rank: one tree reduce a scope ("top", then each of the 8
# layer groups) a gradient, 8 train steps + the MLMC step's 2 gradients
# (levels 0 and 1; at J=1 level J-1 is level 0)
MODEB_K1_PER_GRAD = 1 + GSPMD_LAYERS
MODEB_K1_LAUNCHES = MODEB_K1_PER_GRAD * (MODEB_STEPS + 2)


def modeb_shape():
    return ShapeConfig("modeb", ZOO_SEQ, MODEB_BATCH, "train")


def modeb_data(dev):
    return SyntheticLMData(zoo_config().vocab_size, ZOO_SEQ, MODEB_BATCH,
                           seed=0, device=dev)


def modeb_rank(rank, tmp):
    """One rank of ``modeb_path``'s gloo group on the card: a (4, 2)
    ``('data', 'model')`` mesh, SmolLM-360M at its published width,
    ``GSPMD_LAYERS`` layers, seed 0's params; ``MODEB_STEPS`` steps of
    ``build_train_step`` (CWTM at delta 0.25, sign_flip on worker 0,
    sgd(0.05), seq 128, global batch 8), then one ``build_mlmc_train_step``
    at J=1 (CWMed) from seed 0's params on step 100's 16 rows. Writes its
    row to ``<tmp>/rank<rank>.json``; rank 0 also writes both runs' full
    params (``<tmp>/train.pt``, ``<tmp>/mlmc.pt``)."""
    t_entry = time.time()
    startup_s = t_entry - float(os.environ["MODEB_SPAWN_T"])
    while not Path(tmp, "go").exists():  # modeb_path lets the ranks go
        assert time.time() - t_entry < MODEB_WAIT_S, "never let go"
        time.sleep(0.05)
    t_entry = time.time()
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
        world_size=MODEB_RANKS)
    dev = torch.device("cuda", 0)
    cfg, data = zoo_config(GSPMD_LAYERS), modeb_data(dev)
    maskf = torch.tensor(MODEB_MASK, device=dev)
    try:
        mesh = make_test_mesh(MODEB_MESH)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        before = dict(COLLECTIVES)
        step = build_train_step(cfg, mesh, modeb_shape(), aggregator="cwtm",
                                attack="sign_flip", delta=0.25,
                                opt=sgd(MODEB_LR), dtype=torch.float32)
        blocks = step.place(init_params(cfg, 0, device=dev))
        block_numel = sum(v.numel() for v in blocks.values())
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(MODEB_STEPS):
            blocks, _, loss = step.fn(blocks, (), data.batch(t), maskf)
            losses.append(float(loss))
        train_s = time.perf_counter() - t0
        train = {k: COLLECTIVES[k] - before[k] for k in COLLECTIVES}
        full = step.gather(blocks)
        row = {"rank": rank, "losses": losses, "train_s": train_s,
               "first_run_steps_per_s": MODEB_STEPS / train_s,
               "train_collectives": train,
               "block_numel": block_numel, "block_gb": 4 * block_numel / 1e9,
               "blocks_are_the_full_blocks": bitwise(blocks,
                                                     step.place(full)),
               "train_digest": digest(full)}
        if rank == 0:
            torch.save({k: v.cpu() for k, v in full.items()},
                       Path(tmp, "train.pt"))
        del blocks, full
        before = dict(COLLECTIVES)
        mlmc = build_mlmc_train_step(
            cfg, mesh, modeb_shape(), MLMCConfig(**MODEB_MLMC), 1,
            aggregator="cwmed", opt=sgd(MODEB_LR), dtype=torch.float32)
        t0 = time.perf_counter()
        blocks, _, (ok, dn) = mlmc.fn(mlmc.place(init_params(cfg, 0,
                                                             device=dev)),
                                      (), data.batch(100, 2 * MODEB_BATCH),
                                      maskf)
        row["mlmc_s"] = time.perf_counter() - t0
        row["mlmc_collectives"] = {k: COLLECTIVES[k] - before[k]
                                   for k in COLLECTIVES}
        full = mlmc.gather(blocks)
        row.update(failsafe_ok=float(ok), corr_norm=float(dn),
                   mlmc_digest=digest(full),
                   launches={k: v for k, v in LAUNCHES.items() if v})
        if rank == 0:
            torch.save({k: v.cpu() for k, v in full.items()},
                       Path(tmp, "mlmc.pt"))
        alloc, reserved = peak_gb(dev)
        row.update(peak_allocated_gb=alloc, peak_reserved_gb=reserved,
                   startup_s=startup_s, rank_s=time.time() - t_entry)
    finally:
        torch.distributed.destroy_process_group()
    Path(tmp, f"rank{rank}.json").write_text(json.dumps(row))


def digest(params):
    """A sha256 of a dict of tensors' bytes, in sorted key order."""
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(params[k].detach().cpu().contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def modeb_start():
    """Start ``modeb_rank`` as ``MODEB_RANKS`` processes of this script on
    expandable segments; each imports, then waits for ``modeb_path`` to let
    it go. Returns (processes, the ``TemporaryDirectory`` they write to)."""
    tmp = tempfile.TemporaryDirectory()
    env = dict(os.environ, MODEB_SPAWN_T=repr(time.time()),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--modeb-rank",
         str(r), tmp.name], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(MODEB_RANKS)]
    return procs, tmp


def modeb_reference(dev, cfg):
    """The unsharded computation of ``modeb_rank``'s runs, in this process:
    each worker's gradient on its rows (``torch.autograd.grad`` of
    ``loss_fn`` on the full params, as a rank differentiates), worker 0's
    negated, ``get_aggregator("cwtm").tree`` (K1), sgd; then the MLMC step
    of CWMed's trees of levels 0 and 1 and ``mlmc_combine``. Each of its
    aggregations is also held to the plain version's on the same (4, P)
    stack, within TOL. Returns (the train run's params, its losses, the
    MLMC step's params, its failsafe_ok, the largest |K1 - plain|)."""
    m, data = MODEB_MESH[0], modeb_data(dev)
    opt = sgd(MODEB_LR)

    def worker_grads(params, batch):
        rows = batch["tokens"].shape[0] // m
        losses, grads = [], []
        for i in range(m):
            leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
            keys = sorted(leaves)
            loss = zoo_loss(leaves, {k: v[i * rows:(i + 1) * rows]
                                     for k, v in batch.items()}, cfg)
            losses.append(loss.detach())
            grads.append(dict(zip(keys, torch.autograd.grad(
                loss, [leaves[k] for k in keys]))))
        return losses, {k: torch.stack([g[k] for g in grads]) for k in grads[0]}

    def update(params, g):
        return apply_updates(params, opt.update(g, (), params)[0])

    worst = [0.0]

    def tree(rule, stack, **kw):
        got = get_aggregator(rule, **kw).tree(stack)
        plain = get_aggregator(rule, backend="ref", **kw).tree(stack)
        for k in got:
            worst[0] = max(worst[0], check(got[k], plain[k],
                                           f"modeb {rule} K1 vs plain {k}"))
        return got

    params, losses = init_params(cfg, 0, device=dev), []
    for t in range(MODEB_STEPS):
        worker_losses, stack = worker_grads(params, data.batch(t))
        total = worker_losses[0]
        for v in worker_losses[1:]:
            total = total + v
        losses.append(float(total / m))
        for k in stack:
            stack[k][0] = -stack[k][0]
        with torch.no_grad():
            params = update(params, tree("cwtm", stack, delta=0.25))
    p0, batch = init_params(cfg, 0, device=dev), data.batch(100, 2 * MODEB_BATCH)
    half = {k: v.reshape(m, -1, *v.shape[1:])[:, :2].reshape(-1, *v.shape[1:])
            for k, v in batch.items()}
    g0 = tree("cwmed", worker_grads(p0, half)[1])
    g1 = tree("cwmed", worker_grads(p0, batch)[1])
    with torch.no_grad():
        g, info = mlmc_combine(g0, g0, g1, 1, MLMCConfig(**MODEB_MLMC))
        mlmc = update(p0, g)
    return params, losses, mlmc, float(info["failsafe_ok"]), worst[0]


def modeb_path(dev, started):
    """Mode B's robust step on the card: ``MODEB_RANKS`` gloo ranks
    (``started`` by ``modeb_start``) on a (4, 2) ``('data', 'model')`` mesh,
    SmolLM-360M at its published width (d_model 960, 15 / 5 heads, vocab
    49152; ``_perf_cfg`` splits the attention's q-sequence over 'model'),
    ``GSPMD_LAYERS`` layers, every parameter FSDP-split over the 4 workers
    and split over 'model'. First the unsharded computation of the same
    steps in this process (``modeb_reference``, its K1 aggregations held
    to the plain version's on the same stacks), then the ranks: their
    full params bitwise each other (a digest) and each rank's blocks those
    of its full params, losses equal; the params within rtol 1e-5, atol
    1e-6 of the unsharded computation (bitwise predicted; ulps printed);
    the losses within rtol 1e-6 of the unsharded losses (equal predicted)
    and finite; failsafe_ok 1;
    ``MODEB_K1_LAUNCHES`` cw_reduce launches a rank and no other kernel
    (every aggregation on the kernel). The losses also fall from the first
    step to the last, a weak check: 8 steps at lr 0.05 move them by about
    1e-3, while the batches move them by about 3e-2. Prints a rank's
    steps/s (its one run, warm-up included), its gloo seconds (gathers,
    exchanges, sums) and peak GB. Returns a rank's launches."""
    t0 = time.perf_counter()
    cfg = zoo_config(GSPMD_LAYERS)
    procs, tmp = started
    try:
        ref, ref_losses, ref_mlmc, ref_ok, k1_vs_plain = modeb_reference(
            dev, cfg)
        ref_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        Path(tmp.name, "go").touch()
        logs = [p.communicate(timeout=MODEB_TIMEOUT_S)[0] for p in procs]
        ranks_s = time.perf_counter() - t1
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"modeb rank {r} failed:\n{log[-6000:]}"
        rows = [json.loads(Path(tmp.name, f"rank{r}.json").read_text())
                for r in range(MODEB_RANKS)]
        got = torch.load(Path(tmp.name, "train.pt"), map_location=dev)
        got_mlmc = torch.load(Path(tmp.name, "mlmc.pt"), map_location=dev)
    finally:
        modeb_end(started)
    losses = rows[0]["losses"]
    row = {"phase": "modeb_path", "ranks": MODEB_RANKS, "mesh": MODEB_MESH,
           "arch": ZOO_ARCH, "layers": GSPMD_LAYERS, "d_model": cfg.d_model,
           "params": sum(v.numel() for v in ref.values()),
           "steps": MODEB_STEPS, "seq_len": ZOO_SEQ,
           "global_batch": MODEB_BATCH,
           "ranks_bitwise_equal": all(
               (r["train_digest"], r["mlmc_digest"], r["losses"])
               == (rows[0]["train_digest"], rows[0]["mlmc_digest"], losses)
               and r["blocks_are_the_full_blocks"] for r in rows),
           "bitwise_unsharded": bitwise(got, ref),
           "max_param_diff": max_diff(got, ref), "max_ulps": ulps(got, ref),
           "within_tol": within(got, ref), "tol": GSPMD_TOL,
           "unsharded_k1_vs_plain_max_abs_err": k1_vs_plain,
           "losses": losses, "unsharded_losses": ref_losses,
           "losses_equal_unsharded": losses == ref_losses,
           "losses_max_rel_diff": max(abs(a - b) / abs(b) for a, b in
                                      zip(losses, ref_losses)),
           "mlmc_bitwise_unsharded": bitwise(got_mlmc, ref_mlmc),
           "mlmc_max_param_diff": max_diff(got_mlmc, ref_mlmc),
           "mlmc_max_ulps": ulps(got_mlmc, ref_mlmc),
           "mlmc_within_tol": within(got_mlmc, ref_mlmc),
           "failsafe_ok": rows[0]["failsafe_ok"], "unsharded_failsafe_ok": ref_ok,
           "k1_launches_predicted": MODEB_K1_LAUNCHES,
           "per_rank": [{k: r[k] for k in (
               "rank", "launches", "first_run_steps_per_s", "train_s",
               "mlmc_s", "train_collectives", "mlmc_collectives",
               "block_gb", "peak_allocated_gb", "peak_reserved_gb",
               "startup_s", "rank_s")} for r in rows],
           "reference_s": ref_s, "ranks_s": ranks_s,
           "seconds": time.perf_counter() - t0}
    emit(row)
    assert row["ranks_bitwise_equal"], row
    assert row["within_tol"] and row["mlmc_within_tol"], row
    assert row["failsafe_ok"] == 1.0 == ref_ok, row
    assert all(math.isfinite(v) for v in losses), row
    assert row["losses_max_rel_diff"] <= 1e-6, row
    assert losses[-1] < losses[0], row  # weak: see the docstring
    for r in rows:
        assert r["launches"] == {"cw_reduce": MODEB_K1_LAUNCHES}, r
    return rows[0]["launches"]


def modeb_end(started):
    procs, tmp = started
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    tmp.cleanup()


# ------------------------------------------------ 9b. the zoo's families

WHISPER = "whisper-base"
# the five other non-dense architectures, at the reduced form's widest
REDUCED_ARCHS = ("llama-3.2-vision-90b", "qwen2-moe-a2.7b", "arctic-480b",
                 "rwkv6-1.6b", "jamba-1.5-large-398b")
REDUCED_D = 512
MOE_ARCHS = ("qwen2-moe-a2.7b", "arctic-480b")
# cw_reduce launches one aggregation of each tree takes (MAX_LEAVES a launch)
TREE_LAUNCHES = {ZOO_ARCH: 1, WHISPER: 2, "llama-3.2-vision-90b": 2, "qwen2-moe-a2.7b": 1,
                 "arctic-480b": 1, "rwkv6-1.6b": 1, "jamba-1.5-large-398b": 4}
WHISPER_TIMED_RUNS = 1  # the rerun alone: 20 s a run at full size
# zoo_run also runs these at remat=False, in turns with remat=True
REMAT_COMPILED = (WHISPER, "jamba-1.5-large-398b")


@contextlib.contextmanager
def record_routing():
    """Keep, for every ``moe._topk_dispatch`` call while the block runs
    (eager calls only), its top-k expert indices and the least gap over its
    tokens between the k-th and the (k+1)-th router probability."""
    calls, orig = [], zoo_moe._topk_dispatch

    def recorded(probs, top_k, capacity):
        srt = torch.sort(probs.detach(), dim=-1, descending=True, stable=True)
        gap = srt.values[:, top_k - 1] - srt.values[:, top_k]
        calls.append((srt.indices[:, :top_k].cpu(), float(gap.min())))
        return orig(probs, top_k, capacity)

    zoo_moe._topk_dispatch = recorded
    try:
        yield calls
    finally:
        zoo_moe._topk_dispatch = orig


def routing_of_run(task, cfg, sampler, params_by_round, logs, j_max):
    """Each round's top-k routing: the round's units (its level's count) of
    every worker through the model at the params the round started from,
    eagerly on the card. Returns [(indices, least gap)] a round."""
    out = []
    for t, (p, log) in enumerate(zip(params_by_round, logs)):
        n = 2 ** log.level if log.level <= j_max else 1
        b = sampler(t, n)
        with torch.no_grad(), record_routing() as calls:
            for w in range(M):
                for k in range(n):
                    zoo_loss(p, {"tokens": b["tokens"][w, k],
                                 "labels": b["labels"][w, k]}, cfg)
        out.append((torch.cat([c[0].reshape(-1) for c in calls]),
                    min(c[1] for c in calls)))
    return out


def schedule_bytes(scan_fn):
    """Bytes of the level graphs' static batch schedule on the card: all of
    it, and its ``extra`` (frames or patches)."""
    batches = scan_fn._graphs.batches
    extra = batches.get("extra", {})
    size = sum(v.numel() * v.element_size() for k, v in batches.items()
               if k != "extra")
    ext = sum(v.numel() * v.element_size() for v in extra.values())
    return size + ext, ext


def zoo_run(dev, arch, cfg, *, phase, timed_runs=1, mean_check=False,
            serve=False, remat_pair=False, keep_ref=False):
    """DynaBRO over the model ``cfg`` (seq_len 128, one sequence a unit,
    m=17, 8 Byzantine under sign_flip and Periodic(4), CWTM at trim 8,
    ``MLMCConfig(T=16, V=5, kappa=1, j_cap=3)``, sgd(0.05),
    ``task_for_config`` and ``run_dynabro_scan(microbatch=True)``).
    Checks, each a hard failure: every round a graph replay under the sync
    check; exactly ``TREE_LAUNCHES[arch]`` ``cw_reduce`` launches an
    aggregation and no other kernel; a second run bitwise equal (params,
    logs, correction norms) with no capture; finite params and held-out
    loss; the plain backend's run with equal logs and params within 1e-5
    of each leaf's largest |value|; with ``mean_check``, the Mean rule's
    unattacked run (``cw_reduce``'s mean mode) ending below the round-0
    held-out loss; for the MoE archs, every round's top-k routing equal in
    both backends (recorded eagerly at each round's starting params, read
    through ``eval_fn`` after every round), a differing round failing with
    its round and its least gap; with ``serve``, ``zoo_serve`` on the
    kernel run's scan_fn; with ``remat_pair``, ``remat_compiled`` after the
    kernel runs (``forward``'s default, remat=True, is the kernel run);
    with ``keep_ref``, the kernel run's params (on the host), logs, launches
    and rounds/s are returned last, for ``gspmd_path``.
    Prints, as the ``phase`` row, rounds/s (runs after the first), each
    level's warm-up and capture seconds, the peak memory and the batch
    schedule's bytes. Returns the kernel run's launch
    counts, and with ``serve`` the served rounds' as well."""
    gc.collect()
    torch.cuda.empty_cache()
    task = task_for_config(cfg, seq_len=ZOO_SEQ, unit_batch=1, seed=0,
                           device=dev)
    sampler = task.make_sampler(M)
    dcfg = zoo_dyn_cfg()
    j_max = dcfg.mlmc.j_max
    loss0 = task.objective(task.params0)
    moe = arch in MOE_ARCHS

    def run(scan_fn, c, keep=None):
        scan_fn = scan_fn or make_dynabro_scan_fn(task.grad_fn, c, sgd(0.05),
                                                  microbatch=True)
        sw = get_switcher("periodic", M, n_byz=N_BYZ, K=4)
        kw = {}
        if moe:  # every round's params, for its routing
            kw = dict(eval_every=1, eval_fn=lambda p, t: (
                keep.append(p) if keep is not None else None))
        return timed(lambda: run_dynabro_scan(
            task.grad_fn, task.params0, sgd(0.05), c, sw, sampler, ZOO_T,
            seed=0, scan_fn=scan_fn, microbatch=True, **kw))

    scan_fn = make_dynabro_scan_fn(task.grad_fn, dcfg, sgd(0.05),
                                   microbatch=True)
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    kept = [task.params0]
    with watch_replays() as modes:
        (p1, l1, _), first_s = run(scan_fn, dcfg, kept)
    launches = {k: v for k, v in LAUNCHES.items() if v}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    reserved_gb = torch.cuda.max_memory_reserved(dev) / 1e9
    sched_bytes, extra_bytes = schedule_bytes(scan_fn)
    dn1 = scan_fn.corr_norms.copy()
    captures = scan_fn.captures
    reset_launches()
    with watch_replays() as modes2:
        (p2, l2, _), second_s = run(scan_fn, dcfg)
    launches2 = {k: v for k, v in LAUNCHES.items() if v}
    rerun_bitwise = bitwise(p1, p2) and np.array_equal(dn1, scan_fn.corr_norms)
    times = [second_s] + [run(scan_fn, dcfg)[1] for _ in range(timed_runs - 1)]
    capture_s = {str(j): c for j, c in sorted(scan_fn.capture_seconds.items())}
    recaptured = scan_fn.captures != captures
    loss1 = task.objective(p1)
    finite = all(bool(torch.isfinite(v).all()) for v in p1.values())
    del p2
    serve_launches = zoo_serve(task, dcfg, scan_fn) if serve else None
    del scan_fn
    gc.collect()
    torch.cuda.empty_cache()
    remat_false = (remat_compiled(dev, arch, cfg, task, p1, l1, launches)
                   if remat_pair else None)

    loss_mean = mean_launches = mean_s = None
    if mean_check:
        reset_launches()
        (p_mean, l_mean, _), mean_s = run(
            None, zoo_dyn_cfg(attack="none", aggregator="mean"))
        mean_launches = {k: v for k, v in LAUNCHES.items() if v}
        loss_mean = task.objective(p_mean)
        assert [l.level for l in l_mean] == [l.level for l in l1], \
            f"{arch}, mean: levels"
        del p_mean
        gc.collect()
        torch.cuda.empty_cache()

    reset_launches()
    kept_ref = [task.params0]
    (p3, l3, _), ref_s = run(None, zoo_dyn_cfg("ref"), kept_ref)
    ref_launches = {k: v for k, v in LAUNCHES.items() if v}
    rel = {k: float((p1[k] - p3[k]).abs().max()
                    / p3[k].abs().max().clamp_min(1e-30)) for k in p1}
    del p3
    gc.collect()
    torch.cuda.empty_cache()
    routing = None
    if moe:
        r1 = routing_of_run(task, cfg, sampler, kept, l1, j_max)
        r3 = routing_of_run(task, cfg, sampler, kept_ref, l1, j_max)
        flips = [{"round": t, "least_gap": a[1], "least_gap_plain": b[1]}
                 for t, (a, b) in enumerate(zip(r1, r3))
                 if not torch.equal(a[0], b[0])]
        routing = {"rounds": len(r1), "choices": sum(a[0].numel() for a in r1),
                   "least_gap": min(a[1] for a in r1), "flips": flips}
    del kept, kept_ref
    levels = [l.level for l in l1]
    per_tree = TREE_LAUNCHES[arch]
    assert per_tree == -(-len(p1) // fused.MAX_LEAVES), (arch, len(p1))
    expected = per_tree * sum(3 if 1 <= j <= j_max else 1 for j in levels)
    row = {"phase": phase, "arch": arch, "family": cfg.family, "remat":
           inspect.signature(zoo_tf.forward).parameters["remat"].default,
           "layers": cfg.n_layers, "of_layers": get_config(arch).n_layers,
           "encoder_layers": cfg.n_encoder_layers,
           "d_model": cfg.d_model, "n_heads": cfg.n_heads, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "encoder_seq": cfg.encoder_seq,
           "n_image_tokens": cfg.n_image_tokens, "attn_impl": cfg.attn_impl,
           "seq_len": ZOO_SEQ, "unit_batch": 1, "T": ZOO_T, "m": M,
           "n_byz": N_BYZ, "trim": TRIM, "K": 4, "j_max": j_max,
           "leaves": len(p1), "params": sum(v.numel() for v in p1.values()),
           "cw_reduce_launches_a_tree": per_tree,
           "levels": {j: levels.count(j) for j in sorted(set(levels))},
           "failsafe_ok": sum(l.failsafe_ok for l in l1),
           "replays": len(modes), "replays_under_sync_error":
               modes.count(SYNC_DEBUG_ERROR) + modes2.count(SYNC_DEBUG_ERROR),
           "launches": launches, "second_run_launches": launches2,
           "expected_cw_reduce": expected, "ref_launches": ref_launches,
           "rerun_bitwise": rerun_bitwise, "recaptured": recaptured,
           "corr_norms": dn1.tolist(),
           "loss_round0": loss0, "loss_after_T": loss1,
           "loss_after_T_mean_no_attack": loss_mean, "mean_run_s": mean_s,
           "mean_launches": mean_launches,
           "max_rel_param_diff_vs_plain": max(rel.values()),
           "plain_limit": ZOO_PLAIN_TOL, "routing": routing,
           "capture_s": capture_s, "first_run_s": first_s, "run_s": times,
           "rounds_per_s": [ZOO_T / t for t in times], "plain_run_s": ref_s,
           "plain_rounds_per_s": ZOO_T / ref_s,
           "schedule_bytes": sched_bytes, "schedule_extra_bytes": extra_bytes,
           "peak_allocated_gb": peak_gb, "peak_reserved_gb": reserved_gb,
           "device_gb": torch.cuda.get_device_properties(dev).total_memory / 1e9,
           "remat_false_run": remat_false}
    emit(row)
    assert len(modes) == len(modes2) == ZOO_T, (arch, len(modes), len(modes2))
    assert row["replays_under_sync_error"] == 2 * ZOO_T, row
    assert launches == launches2 == {"cw_reduce": expected}, row
    assert not ref_launches, ref_launches
    assert rerun_bitwise and not recaptured, f"{arch}: rerun differs or recaptured"
    assert [vars(l) for l in l1] == [vars(l) for l in l2], f"{arch}: rerun logs"
    assert finite and np.isfinite(loss1), (arch, finite, loss1)
    if mean_check:
        assert mean_launches == launches, (mean_launches, launches)
        assert np.isfinite(loss_mean) and loss_mean < loss0, \
            f"{arch}, mean, no attack: held-out loss {loss_mean} not below {loss0}"
    assert [vars(l) for l in l3] == [vars(l) for l in l1], f"{arch}: plain logs"
    assert max(rel.values()) <= ZOO_PLAIN_TOL, (arch, rel)
    assert routing is None or not routing["flips"], (arch, routing["flips"])
    ref = ({"params": {k: v.cpu() for k, v in p1.items()},
            "logs": [vars(l) for l in l1], "launches": launches,
            "rounds_per_s": row["rounds_per_s"],
            "first_rounds_per_s": ZOO_T / first_s} if keep_ref else None)
    del task, p1
    gc.collect()
    torch.cuda.empty_cache()
    out = (launches, serve_launches) if serve else (launches,)
    out += (ref,) if keep_ref else ()
    return out if len(out) > 1 else out[0]


def zoo_families_path(dev):
    """(a) whisper-base at its published width and depth
    (``get_config``: 6 encoder and 6 decoder layers, d_model 512, 8 heads,
    d_ff 2048, vocab 51865, 1500 encoder frames, untied embeddings; 33
    leaves, two ``cw_reduce`` launches an aggregation), with the Mean
    rule's check; (b) the five other non-dense architectures at
    ``get_reduced_config(arch, d_model=512)``, the MoE ones with their
    routing held; each through ``zoo_run``. Returns each path's kernel
    launches."""
    phase = "zoo_families_path"
    out = {f"zoo {WHISPER}": zoo_run(
        dev, WHISPER, get_config(WHISPER), phase=phase,
        timed_runs=WHISPER_TIMED_RUNS, mean_check=True, remat_pair=True)}
    for arch in REDUCED_ARCHS:
        cfg = get_reduced_config(arch, d_model=REDUCED_D)
        out[f"zoo {arch}"] = zoo_run(dev, arch, cfg, phase=phase,
                                     remat_pair=arch in REMAT_COMPILED)
    return out


# ------------------------------------------- 9c. the recomputing forward

def plain_zoo_loss(params, batch, cfg):
    """``loss_fn``'s lines over ``forward(remat=False)``: the un-recomputed
    model that ``remat_path`` holds the default against."""
    logits, aux = zoo_tf.forward(params, batch["tokens"], cfg,
                                 extra=batch.get("extra"), remat=False)
    labels = batch["labels"].to(torch.int64)
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (lse - gold).mean() + cfg.router_aux_weight * aux


def remat_grad_fns(cfg):
    """{remat: a unit's gradient}: True the zoo task's own (``loss_fn``,
    ``forward``'s default), False over ``plain_zoo_loss``."""
    return {True: lambda p, b: torch.func.grad(
                lambda q: zoo_loss(q, b, cfg))(p),
            False: lambda p, b: torch.func.grad(
                lambda q: plain_zoo_loss(q, b, cfg))(p)}


def peak_gb(dev):
    return (torch.cuda.max_memory_allocated(dev) / 1e9,
            torch.cuda.max_memory_reserved(dev) / 1e9)


def fresh_peak(dev):
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)


def leaves_differing(got, ref, tag):
    """{leaf (tag): its largest |difference|} of the card tensors ``got``
    not bitwise the host tensors ``ref``."""
    out = {}
    for k, v in got.items():
        want = ref[k].to(v.device)
        if not torch.equal(v, want):
            out[f"{k} ({tag})"] = float((v - want).abs().max())
    return out


def remat_unit(dev, arch, cfg, task):
    """One unit's ``vmap(grad)`` over the 17 workers (round 0's first unit
    of ``task``'s sampler, as ``_stream_levels`` takes it) with remat=False,
    True, True, False: each run's ms and peak GB, and every gradient bitwise
    the first run's (held in pinned host memory). A leaf that differs fails
    the phase with its name and largest difference."""
    unit = tree_map(lambda l: l.select(1, 0), task.make_sampler(M)(0, 1))
    w0 = tree_map(lambda l: l[0], unit)
    same_loss = torch.equal(zoo_loss(task.params0, w0, cfg),
                            plain_zoo_loss(task.params0, w0, cfg))
    fns = {flag: torch.func.vmap(fn, in_dims=(None, 0))
           for flag, fn in remat_grad_fns(cfg).items()}
    runs, ref, differ = [], None, {}
    for flag in (False, True, True, False):
        fresh_peak(dev)
        g, s = timed(lambda: fns[flag](task.params0, unit))
        alloc, reserved = peak_gb(dev)
        runs.append({"remat": flag, "ms": s * 1e3, "peak_allocated_gb": alloc,
                     "peak_reserved_gb": reserved})
        if ref is None:  # pinned: a leaf crosses back in a fraction of a s
            ref = {k: torch.empty(v.shape, dtype=v.dtype,
                                  pin_memory=True).copy_(v)
                   for k, v in g.items()}
        else:
            differ.update(leaves_differing(g, ref, f"remat={flag}"))
        del g
    del ref
    row = {"phase": "remat_path", "arch": arch, "layers": cfg.n_layers,
           "of_layers": get_config(arch).n_layers, "d_model": cfg.d_model,
           "params": sum(v.numel() for v in task.params0.values()),
           "m": M, "seq_len": ZOO_SEQ, "unit_batch": 1,
           "gradient_gb": M * sum(v.numel() * 4 for v in task.params0.values())
           / 1e9, "runs": runs, "bitwise": not differ, "differ": differ,
           "same_loss": same_loss}
    emit(row)
    assert same_loss, f"{arch}: plain_zoo_loss is not loss_fn's value"
    assert not differ, f"{arch}: remat=True not bitwise remat=False: {differ}"


def remat_compiled(dev, arch, cfg, task, params, logs, launches):
    """``zoo_run``'s setting through ``run_dynabro_scan(microbatch=True)``
    with the remat=False gradient on a fresh scan_fn, in turns with
    ``zoo_run``'s kernel runs (remat=True): a first run (its captures
    included) and a timed rerun with the graphs kept, every round a replay
    under the sync check, the same ``cw_reduce`` launches, params and logs
    bitwise the remat=True run's (``params``, ``logs``). Returns its
    rounds/s, seconds and peak GB (over both runs)."""
    grad_fn = remat_grad_fns(cfg)[False]
    dcfg = zoo_dyn_cfg()
    sampler = task.make_sampler(M)
    scan_fn = make_dynabro_scan_fn(grad_fn, dcfg, sgd(0.05), microbatch=True)

    def run():
        sw = get_switcher("periodic", M, n_byz=N_BYZ, K=4)
        return run_dynabro_scan(grad_fn, task.params0, sgd(0.05), dcfg, sw,
                                sampler, ZOO_T, seed=0, scan_fn=scan_fn,
                                microbatch=True)

    fresh_peak(dev)
    reset_launches()
    with watch_replays() as modes:
        (p, l_false, _), first_s = timed(run)
        false_launches = {k: v for k, v in LAUNCHES.items() if v}
        (p2, _, _), run_s = timed(run)
    alloc, reserved = peak_gb(dev)
    out = {"rounds_per_s": ZOO_T / run_s, "first_run_s": first_s,
           "run_s": run_s, "peak_allocated_gb": alloc,
           "peak_reserved_gb": reserved, "replays": len(modes),
           "replays_under_sync_error": modes.count(SYNC_DEBUG_ERROR),
           "launches": false_launches, "rerun_bitwise": bitwise(p, p2),
           "params_bitwise_remat_true": bitwise(p, params),
           "logs_equal_remat_true": [vars(x) for x in l_false]
           == [vars(x) for x in logs]}
    del scan_fn, p, p2
    fresh_peak(dev)
    assert out["replays"] == out["replays_under_sync_error"] == 2 * ZOO_T, out
    assert false_launches == launches and out["rerun_bitwise"], (arch, out)
    assert out["params_bitwise_remat_true"] and out["logs_equal_remat_true"], \
        f"{arch}: the compiled remat=False run differs from remat=True: {out}"
    return out


def remat_path(dev):
    """``remat_unit`` for SmolLM-360M (8 of 32 layers, ``zoo_config``),
    whisper-base at its published width and depth and the five reduced
    archs of ``zoo_families_path`` (d_model 512); the compiled runs of
    whisper-base and jamba at remat=False are ``zoo_run``'s
    (``remat_pair``)."""
    t0 = time.perf_counter()
    models = [(ZOO_ARCH, zoo_config()), (WHISPER, get_config(WHISPER))] + [
        (a, get_reduced_config(a, d_model=REDUCED_D)) for a in REDUCED_ARCHS]
    for arch, cfg in models:
        task = task_for_config(cfg, seq_len=ZOO_SEQ, unit_batch=1, seed=0,
                               device=dev)
        remat_unit(dev, arch, cfg, task)
        del task
        fresh_peak(dev)
    emit({"phase": "remat_path", "seconds": time.perf_counter() - t0})


# ------------------------------------------- 9d. the decode entry points

DECODE_BATCH = 4
# (arch, at its published width and depth?, prompt tokens, decode steps)
DECODE_MODELS = (("smollm-360m", True, 128, 32), (WHISPER, True, 64, 32),
                 ("rwkv6-1.6b", True, 64, 16),
                 ("llama-3.2-vision-90b", False, 32, 8),
                 ("qwen2-moe-a2.7b", False, 32, 8),
                 ("arctic-480b", False, 32, 8),
                 ("jamba-1.5-large-398b", False, 32, 8))
ROUTED_ARCHS = ("qwen2-moe-a2.7b", "arctic-480b", "jamba-1.5-large-398b")
# a step's logits against the full forward's: of the step's largest |logit|
# (the JAX package's own decode test allows 5e-3)
DECODE_TOL = 1e-3


def greedy(params, cfg, prompt, extra, steps):
    """``prefill`` of the prompt (pad_to = prompt + steps + 1), then
    ``steps`` greedy ``decode_step`` calls with a device ``pos``. Returns
    (tokens (B, steps + 1), logits (B, steps + 1, V), prefill seconds,
    decode seconds, the last cache, the next pos)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = zoo_tf.prefill(params, prompt, cfg, extra=extra,
                                   pad_to=prompt.shape[1] + steps + 1)
    tok = logits.argmax(-1)
    pos = torch.tensor(prompt.shape[1], device=prompt.device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks, outs = [tok], [logits]
    for _ in range(steps):
        logits, cache = zoo_tf.decode_step(params, cache, tok, pos, cfg)
        tok = logits.argmax(-1)
        pos = pos + 1
        toks.append(tok)
        outs.append(logits)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (torch.stack(toks, 1), torch.stack(outs, 1), t1 - t0, t2 - t1,
            cache, pos)


def decode_model(dev, arch, cfg, prompt_len, steps, smi):
    """Greedy decoding of ``cfg`` at batch ``DECODE_BATCH`` from seeded
    tokens (and frames or patches): a first run (the MoE archs' routing
    recorded), then a second, timed, that must be bitwise equal. Each
    step's logits, the prefill's included, against a full ``forward`` over
    the same prefix (the tokens decoded so far): within ``DECODE_TOL`` of
    the step's largest |logit|, and the decoded token the forward's argmax
    wherever its top-2 margin exceeds twice that row's largest logit error
    (a flip inside it is printed with its step and margin); the MoE layers'
    top-k experts of each decode step equal to the forward's for the same
    token; one more ``decode_step`` with the device ``pos`` under
    ``set_sync_debug_mode("error")``. Prints the row."""
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, 0, device=dev)
    gen = torch.Generator().manual_seed(0)
    B = DECODE_BATCH
    prompt = torch.randint(0, cfg.vocab_size, (B, prompt_len),
                           generator=gen).to(dev)
    extra = None
    if cfg.family in ("audio", "vlm"):
        name, n = (("frames", cfg.encoder_seq) if cfg.family == "audio"
                   else ("patches", cfg.n_image_tokens))
        extra = {name: (0.1 * torch.randn(B, n, cfg.d_model,
                                          generator=gen)).to(dev)}
    routed = arch in ROUTED_ARCHS
    with record_routing() if routed else contextlib.nullcontext([]) as calls:
        toks1, out1, *_ = greedy(params, cfg, prompt, extra, steps)
    moe_layers = len(calls) // (steps + 1) if routed else 0
    step_routes = calls[moe_layers:]  # after the prefill's calls
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    toks, out, prefill_s, decode_s, cache, pos = greedy(
        params, cfg, prompt, extra, steps)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches = {k: v for k, v in LAUNCHES.items() if v}
    rerun_bitwise = torch.equal(toks, toks1) and torch.equal(out, out1)
    torch.cuda.set_sync_debug_mode("error")
    try:
        zoo_tf.decode_step(params, cache, toks[:, -1], pos, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)

    worst, least, flips, route_diff, least_gap = 0.0, float("inf"), [], [], None
    for i in range(steps + 1):  # step 0 the prefill's logits
        seq = torch.cat([prompt, toks[:, :i]], 1)
        with torch.no_grad(), (record_routing() if routed and i
                               else contextlib.nullcontext([])) as fcalls:
            full = zoo_tf.forward(params, seq, cfg, extra=extra)[0][:, -1]
        err = (out[:, i] - full).abs().amax(-1)
        worst = max(worst, float(err.max() / full.abs().max()))
        top2 = full.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        least = min(least, float(margin.min()))
        for b in torch.nonzero(full.argmax(-1) != toks[:, i]).flatten().tolist():
            flips.append({"step": i, "row": b, "margin": float(margin[b]),
                          "allowed": float(2 * err[b])})
        for layer, (fc, dc) in enumerate(zip(fcalls, step_routes[
                (i - 1) * moe_layers:i * moe_layers] if i else [])):
            last = fc[0].reshape(B, seq.shape[1], -1)[:, -1]
            least_gap = dc[1] if least_gap is None else min(least_gap, dc[1])
            if not torch.equal(last.sort(-1).values, dc[0].sort(-1).values):
                route_diff.append({"step": i, "layer": layer, "gap": dc[1]})
    row = {"phase": "decode_path", "arch": arch, "family": cfg.family,
           "layers": cfg.n_layers, "of_layers": get_config(arch).n_layers,
           "encoder_layers": cfg.n_encoder_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "encoder_seq": cfg.encoder_seq,
           "params": sum(v.numel() for v in params.values()),
           "batch": B, "prompt": prompt_len, "decode_steps": steps,
           "prefill_ms": prefill_s * 1e3,
           "decode_ms_per_token": decode_s * 1e3 / steps,
           "tokens_per_s": B * steps / decode_s, "peak_allocated_gb": peak_gb,
           "max_rel_logit_err": worst, "limit": DECODE_TOL,
           "least_top2_margin": least, "flips": flips,
           "rerun_bitwise": rerun_bitwise, "sync_free_step": True,
           "launches": launches,
           "routing": {"moe_layers": moe_layers, "compared": moe_layers * steps,
                       "differing": route_diff, "least_gap": least_gap}
           if routed else None, "nvidia_smi": smi}
    emit(row)
    assert worst <= DECODE_TOL, (arch, worst)
    assert all(f["margin"] <= f["allowed"] for f in flips), (arch, flips)
    assert rerun_bitwise, f"{arch}: the rerun's tokens or logits differ"
    assert not launches, (arch, launches)
    assert not routed or (moe_layers and not route_diff), (arch, row["routing"])
    del params, cache, out, out1
    return row


def decode_path(dev, smi):
    """The zoo's decode entry points (``prefill``, ``decode_step``) through
    ``decode_model``: SmolLM-360M at its published width and full depth (32
    layers; prompt 128, 32 steps), whisper-base (1500 encoder frames;
    prompt 64, 32 steps) and rwkv6-1.6b (24 layers, d_model 2048; prompt
    64, 16 steps) at theirs, and llama-3.2-vision, qwen2-moe, arctic and
    jamba at ``get_reduced_config(arch, d_model=512)`` (prompt 32, 8
    steps). No kernel of the port is on this path. Returns the rows."""
    rows = []
    for arch, full, prompt, steps in DECODE_MODELS:
        cfg = (get_config(arch) if full
               else get_reduced_config(arch, d_model=REDUCED_D))
        rows.append(decode_model(dev, arch, cfg, prompt, steps, smi))
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------- 10. timing


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


def time_graph_us(fn, iters=200, reps=5):
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed, so no host launch gap sits between them; the median
    of ``reps`` replays."""
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
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3 / iters)
    return sorted(times)[reps // 2]


def bound_from(nbytes, ops):
    """Least time for one call, in µs: the larger of its bytes (each input
    read once, each output written once) over the HBM rate and its float32
    operations over the f32 rate, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e6, "bytes" if t_bytes >= t_ops else "operations"


def sort_ops(k):
    """min+max operations of the bitonic network over next_pow2(k) rows."""
    np2 = 1 << (k - 1).bit_length()
    log2 = np2.bit_length() - 1
    return np2 * log2 * (log2 + 1) // 2


def bound_us(m, d, itemsize):
    """``cw_reduce`` of an (m, d) stack: the sort network and the sum."""
    return bound_from(m * d * itemsize + 4 * d, d * (sort_ops(m) + m))


CW_SHAPES = ([(m, d, torch.float32) for m, d in LEAF_SHAPES]
             + [(M, 9610, torch.float32), (64, 8192, torch.float32),
                (M, 1 << 20, torch.float32), (M, 1 << 20, torch.bfloat16)])


def timing(dev):
    """``cw_reduce`` at the main path's shapes, at 64 x 8192 and at 17 x
    2^20, beside its plain version and, for the median, ``torch.median``;
    ``*_us`` is device time per call (CUDA graph replay); ``*_call_us`` is
    the time per call issued back to back from Python. The masked form reads
    its trim on the card, in the graph too."""
    gen = torch.Generator().manual_seed(1)
    t_dev = torch.tensor(TRIM, dtype=torch.int32, device=dev)
    rows = {}
    for m, d, dtype in CW_SHAPES:
        x = (torch.randn(m, d, generator=gen) * 1e-2).to(dtype).to(dev)
        b_us, b_by = bound_us(m, d, x.element_size())
        # mode: (kernel, plain, library)
        cases = {
            "tm": (lambda: fused.cwtm(x, TRIM), lambda: kref.cwtm_ref(x, TRIM),
                   None),
            "tm_masked": (lambda: fused.cwtm_masked(x, t_dev),
                          lambda: kref.cwtm_ref(x, t_dev), None),
            "med": (lambda: fused.cwmed(x), lambda: kref.cwmed_ref(x),
                    lambda: torch.median(x, 0).values),
        }
        for mode, (kern, plain, library) in cases.items():
            row = {"phase": "timing", "kernel": "cw_reduce", "mode": mode,
                   "trim": None if mode == "med" else TRIM, "m": m, "d": d,
                   "dtype": str(dtype).removeprefix("torch."),
                   "max_abs_err": max_abs_err(kern(), plain()),
                   "kernel_us": time_graph_us(kern),
                   "kernel_call_us": time_calls_us(kern),
                   "plain_us": time_graph_us(plain),
                   "plain_call_us": time_calls_us(plain),
                   # no single PyTorch call computes a trimmed mean
                   "library_us": time_graph_us(library) if library else None,
                   "library_call_us": time_calls_us(library) if library else None,
                   "bound_us": b_us, "bound_by": b_by}
            row["bound_share"] = b_us / row["kernel_us"]
            emit(row)
            rows[(mode, m, d, row["dtype"])] = row
    xs = [(torch.randn(m, d, generator=gen) * 1e-2).to(dev) for m, d in LEAF_SHAPES]
    d_all = sum(d for _, d in LEAF_SHAPES)
    nbytes = sum(m * d * 4 + 4 * d for m, d in LEAF_SHAPES)
    ops = sum(d * (sort_ops(m) + m) for m, d in LEAF_SHAPES)
    plain = [lambda: [kref.cwtm_ref(x, TRIM) for x in xs]]
    library = [lambda: [torch.median(x, 0).values for x in xs]]
    # at trim (m-1)/2 of odd m the trimmed mean keeps only the middle row,
    # so torch.median computes the same function
    for case, kern in [
            ("tm tree", lambda: fused.tree_cw_reduce(xs, "tm", TRIM)),
            ("tm_masked tree", lambda: fused.tree_cw_reduce(xs, "tm", t_dev)),
            ("tm per leaf", lambda: [fused.cwtm(x, TRIM) for x in xs])]:
        rows[(case, M, d_all)] = time_case("cw_reduce", case, M, d_all, kern,
                                           *plain, *library, nbytes, ops)
    # the sweep's lane form: 8 lanes of the tree in one launch, a trim a
    # lane on the card (grid 1's trims 8 and 6), beside one tree call a lane
    lanes = 8
    xl = [(torch.randn(lanes, m, d, generator=gen) * 1e-2).to(dev)
          for m, d in LEAF_SHAPES]
    t_l = torch.tensor([TRIM, 6] * (lanes // 2), dtype=torch.int32, device=dev)
    per_lane = [[x[c] for x in xl] for c in range(lanes)]
    for case, kern in [
            ("tm lanes C=8", lambda: fused.tree_cw_reduce_lanes(xl, "tm", t_l)),
            ("tm tree per lane C=8", lambda: [o for c in range(lanes) for o in (
                fused.tree_cw_reduce(per_lane[c], "tm", t_l[c]))])]:
        rows[(case, M, d_all)] = time_case(
            "cw_reduce", case, M, d_all, kern,
            lambda: [kref.cw_reduce_lanes_ref(x, "tm", t_l) for x in xl],
            None, lanes * nbytes, lanes * ops)  # no one call: a trim a lane
    return rows


def zoo_tree_timing(dev, cfg=None, case="tm zoo tree"):
    """``cw_reduce`` over the zoo's 11-leaf stack (17 x 125.8M float32,
    trim 8, one launch), or over the tree of ``cfg`` (whisper-base: 33
    leaves, 17 x 113,959,936, two launches), beside its plain version
    (``cwtm_ref`` per leaf), ``torch.median(x, 0)`` per leaf (the same
    function at trim 8 of 17) and its bytes bound: device µs by graph
    replay, the median of five replays of 10 calls (2 for the plain and
    library calls, 0.1-1 s each); the launches of one call."""
    leaves = zoo_stack(dev, 8, cfg)
    xs = [x for _, x in leaves]
    widths = [x.shape[1] for x in xs]
    b_us, b_by = bound_from(sum(M * d * 4 + 4 * d for d in widths),
                            sum(d * (sort_ops(M) + M) for d in widths))

    def kern():
        return fused.tree_cw_reduce(xs, "tm", TRIM)

    def plain():
        return [kref.cwtm_ref(x, TRIM) for x in xs]

    def library():
        return [torch.median(x, 0).values for x in xs]

    before = LAUNCHES["cw_reduce"]
    kern()
    launches = LAUNCHES["cw_reduce"] - before
    row = {"phase": "timing", "kernel": "cw_reduce", "case": case,
           "m": M, "d": sum(widths), "leaves": len(xs), "launches": launches,
           "dtype": "float32",
           "trim": TRIM, "max_abs_err": max_abs_err(flat(kern()), flat(plain())),
           "kernel_us": time_graph_us(kern, iters=10),
           "plain_us": time_graph_us(plain, iters=2),
           "library_us": time_graph_us(library, iters=2),
           "bound_us": b_us, "bound_by": b_by}
    row["bound_share"] = b_us / row["kernel_us"]
    emit(row)
    del leaves, xs
    gc.collect()
    torch.cuda.empty_cache()
    return row


def flat(out):
    """A kernel's output, or the concatenation of a tree form's outputs."""
    if isinstance(out, (list, tuple)):
        return torch.cat([o.reshape(-1) for o in out])
    return out


def time_case(name, case, m, d, kern, plain, library, nbytes, ops):
    """One ``timing`` row: device and per-call µs of the kernel, its plain
    version and the library call (None where there is none), and the bound
    of ``nbytes`` and ``ops``."""
    b_us, b_by = bound_from(nbytes, ops)
    row = {"phase": "timing", "kernel": name, "case": case, "m": m,
           "d": d, "dtype": "float32",
           "max_abs_err": max_abs_err(flat(kern()), flat(plain())),
           "kernel_us": time_graph_us(kern),
           "kernel_call_us": time_calls_us(kern),
           "plain_us": time_graph_us(plain),
           "plain_call_us": time_calls_us(plain),
           "library_us": time_graph_us(library) if library else None,
           "library_call_us": time_calls_us(library) if library else None,
           "bound_us": b_us, "bound_by": b_by}
    emit(row)
    return row


def combine_cases(xs, w1, wm, m, d, tree):
    """K4 at k = 1 and k = m and K5 (trim 8) over the leaves ``xs`` (one
    call each: the tree forms when ``tree``), with their plain versions, the
    ``torch.mm`` call(s) computing K4, bytes and operations."""
    if tree:
        k4 = [lambda w: fused.tree_weighted_combine(xs, w),
              lambda w: [kref.weighted_combine_ref(x, w) for x in xs],
              lambda w: [torch.mm(w, x) for x in xs]]
        k5 = [lambda: fused.tree_combine_reduce(xs, wm, "tm", TRIM),
              lambda: [kref.combine_reduce_ref(x, wm, "tm", TRIM) for x in xs]]
    else:
        (x,) = xs
        k4 = [lambda w: fused.weighted_combine(x, w),
              lambda w: kref.weighted_combine_ref(x, w),
              lambda w: torch.mm(w, x)]
        k5 = [lambda: fused.combine_reduce(x, wm, "tm", TRIM),
              lambda: kref.combine_reduce_ref(x, wm, "tm", TRIM)]
    suffix = " tree" if tree else ""
    return {
        ("weighted_combine", "k=1" + suffix): (
            *[(lambda f=f: f(w1)) for f in k4],
            4 * (m * d + m + d), 2 * m * d),
        ("weighted_combine", "k=m" + suffix): (
            *[(lambda f=f: f(wm)) for f in k4],
            4 * (2 * m * d + m * m), 2 * m * m * d),
        ("combine_reduce", "k=m tm" + suffix): (
            *k5, None,  # no single PyTorch call mixes and trims
            4 * (m * d + m * m + d), d * (2 * m * m + sort_ops(m) + m)),
    }


def geometry_timing(dev):
    """pairwise_sqdist, cross_sqdist (k=1), weighted_combine (k=1 and k=m)
    and combine_reduce (NNM's mixing, trim 8) at the main path's shapes,
    float32, beside their plain versions and a library call where one
    computes the same function, and the two combines over the main path's
    four leaves in one tree call, beside one ``torch.mm`` per leaf; fields
    as in ``timing``."""
    gen = torch.Generator().manual_seed(3)
    rows = {}
    for m, d in LEAF_SHAPES + [(M, 9610)]:
        x = (torch.randn(m, d, generator=gen) * 1e-2).to(dev)
        z = (torch.randn(1, d, generator=gen) * 1e-2).to(dev)
        w1 = torch.full((1, m), 1.0 / m, device=dev)  # GeoMed's first combine
        k_nn = m - aggregators.count_ceil(DELTA * m)
        wm = aggregators._nnm_weights(kref.pairwise_sqdist_ref(x), k_nn)
        # name, case: (kernel, plain, library, bytes, f32 operations)
        cases = {
            ("pairwise_sqdist", "k=m"): (
                lambda: fused.pairwise_sqdist(x),
                lambda: kref.pairwise_sqdist_ref(x),
                lambda: torch.cdist(x, x).square_(),
                4 * (m * d + m * m), m * (m + 1) * d),  # 2 per pair i <= j
            ("cross_sqdist", "k=1"): (
                lambda: fused.cross_sqdist(x, z),
                lambda: kref.cross_sqdist_ref(x, z),
                lambda: torch.cdist(x, z).square_(),
                4 * ((m + 1) * d + m), 3 * m * d),
            **combine_cases([x], w1, wm, m, d, tree=False),
        }
        for (name, case), args in cases.items():
            rows[(name, case, m, d)] = time_case(name, case, m, d, *args)
    xs = [(torch.randn(m, d, generator=gen) * 1e-2).to(dev) for m, d in LEAF_SHAPES]
    d_all = sum(d for _, d in LEAF_SHAPES)
    w1 = torch.full((1, M), 1.0 / M, device=dev)
    wm = aggregators._nnm_weights(
        sum(kref.pairwise_sqdist_ref(x) for x in xs), M - aggregators.count_ceil(DELTA * M))
    for (name, case), args in combine_cases(xs, w1, wm, M, d_all, tree=True).items():
        rows[(name, case, M, d_all)] = time_case(name, case, M, d_all, *args)
    # K5 with its trim on the card (the sweep's NNM+CWTM lanes)
    t_dev = torch.tensor(TRIM, dtype=torch.int32, device=dev)
    case = "k=m tm tree, trim on the card"
    rows[("combine_reduce", case, M, d_all)] = time_case(
        "combine_reduce", case, M, d_all,
        lambda: fused.tree_combine_reduce(xs, wm, "tm", t_dev),
        lambda: [kref.combine_reduce_ref(x, wm, "tm", t_dev) for x in xs], None,
        sum(4 * (M * d + M * M + d) for d in (d for _, d in LEAF_SHAPES)),
        sum(d * (2 * M * M + sort_ops(M) + M) for _, d in LEAF_SHAPES))
    return rows


def ptxas_report(name):
    """Registers, stack and spill bytes of every kernel instance in the
    compiler's report of library ``name``, names demangled where c++filt
    is there."""
    entries, cur, frame = [], None, None
    for ln in kbuild.build_log(name).splitlines():
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1]
        elif "bytes stack frame" in ln:
            frame = [int(v) for v in re.findall(r"(\d+) bytes", ln)]
        elif "registers" in ln and cur is not None:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            entries.append([cur, regs] + (frame or [0, 0, 0]))
            cur, frame = None, None
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and entries:
        out = subprocess.run([cxxfilt], input="\n".join(e[0] for e in entries),
                             capture_output=True, text=True, timeout=60).stdout
        for e, demangled in zip(entries, out.splitlines()):
            e[0] = re.sub(r"\(anonymous namespace\)::|\(.*\)$", "", demangled)
    return {"library": name, "instances": len(entries),
            "fields": ["kernel", "registers", "stack_bytes", "spill_stores",
                       "spill_loads"], "entries": entries}


def kernel_entry(name, source, replaces, launches, by_path, err, row, lib_row,
                 library, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_by_path": by_path, "max_abs_err": err,
            "ms": row["kernel_us"] / 1e3, "call_ms": row["kernel_call_us"] / 1e3,
            "plain_ms": row["plain_us"] / 1e3,
            "plain_call_ms": row["plain_call_us"] / 1e3,
            "bound_ms": row["bound_us"] / 1e3, "bound_by": row["bound_by"],
            "library_ms": None if lib_row is None else lib_row["library_us"] / 1e3,
            "library_call_ms": (None if lib_row is None
                                else lib_row["library_call_us"] / 1e3),
            "library": library, **extra}


def static_lint():
    """``python -m repro_torch.lint --check`` over the port's trees, in a
    subprocess; fails unless it exits 0."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.lint", "--check"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return {"command": "python -m repro_torch.lint --check",
            "rc": out.returncode, "output": out.stdout.strip(),
            "seconds": time.perf_counter() - t0}


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
    build_s = kbuild.build(LIBRARIES)  # one nvcc per source, in parallel
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_seconds": build_s})
    for name in LIBRARIES:
        emit({"phase": "ptxas", **ptxas_report(name)})
    LINT["static pass"] = static_lint()

    worst, n_checks = check_kernels(dev)
    emit({"phase": "kernel_check", "kernel": "cw_reduce", "comparisons": n_checks,
          "max_abs_err": worst, "rtol": TOL["rtol"], "atol": TOL["atol"]})
    geo_worst, geo_checks = check_geometry_kernels(dev)
    emit({"phase": "kernel_check",
          "kernel": "pairwise_sqdist, cross_sqdist, weighted_combine, "
                    "combine_reduce", "comparisons": geo_checks,
          "max_err": geo_worst,
          "tolerance": {"weighted_combine, combine_reduce": TOL,
                        "pairwise_sqdist, cross_sqdist": {
                            "atol": DIST_ATOL, "of": "max(largest distance, "
                                                     "largest squared row norm)"}}})

    tree_worst, tree_checks = check_tree_kernels(dev)
    emit({"phase": "kernel_check",
          "kernel": "tree_weighted_combine, tree_combine_reduce",
          "trees": {k: len(v) for k, v in TREE_CHECKS.items()},
          "comparisons": tree_checks, "max_abs_err": tree_worst,
          "bitwise_equal_per_leaf_launches": True, "tolerance": TOL})

    cw_tree_worst, cw_tree_checks = check_cw_tree_kernels(dev)
    emit({"phase": "kernel_check", "kernel": "tree_cw_reduce",
          "trees": {k: len(v) for k, v in TREE_CHECKS.items()}, "m": CW_TREE_M,
          "comparisons": cw_tree_checks, "max_abs_err": cw_tree_worst,
          "bitwise_equal_per_leaf_launches": True,
          "bitwise_equal_every_plan": True, "tolerance": TOL})

    zoo_worst = check_zoo_tree_kernels(dev)
    modeb_worst = check_modeb_kernels(dev)
    whisper_worst = check_zoo_tree_kernels(dev, get_config(WHISPER),
                                           "whisper-base widths")

    device_kernels_per_call(dev)
    check_device_trim(dev)
    lane_worst, _ = check_lane_kernels(dev)

    launches = main_path(dev)
    task = make_task(M, seed=0, device=dev)
    by_path = {"cwtm": {"cw_reduce": launches}}
    for rule in GEOMETRY_PATHS:
        by_path[rule] = geometry_path(task, rule)
    for rule in SCAN_PATHS:
        by_path[f"scan {rule}"] = scan_path(task, rule)
    attack_paths(task, dev)
    by_path["momentum"] = momentum_path(task)
    by_path["session"] = session_path(task)
    for grid in ("grid1", "grid2"):
        by_path[f"sweep {grid}"] = sweep_path(task, grid)
    matrix_path(dev)
    by_path["serve"] = serve_path(task)
    for grid in ("grid1", "grid2"):
        by_path[f"halving {grid}"] = halving_path(task, grid)
    by_path.update(mesh_path(task))
    by_path["zoo"], by_path["serve zoo"], zoo_ref = zoo_path(dev)
    modeb = modeb_start()  # the ranks import while gspmd_path runs
    try:
        by_path.update(gspmd_path(dev, zoo_ref))
        del zoo_ref
        gc.collect()
        by_path["modeb"] = modeb_path(dev, modeb)
    finally:
        modeb_end(modeb)
    by_path.update(zoo_families_path(dev))
    remat_path(dev)
    t_decode = time.perf_counter()
    decode_path(dev, smi)
    emit({"phase": "decode_path", "seconds": time.perf_counter() - t_decode})
    # every kernel ran on some path: its own count was not 0 there
    for k in KERNELS:
        assert any(counts.get(k) for counts in by_path.values()), f"{k} never ran"
    rows = timing(dev)
    geo_rows = geometry_timing(dev)
    zoo_row = zoo_tree_timing(dev)
    whisper_row = zoo_tree_timing(dev, get_config(WHISPER), "tm whisper tree")

    def launches_of(kernel):
        return {path: c[kernel] for path, c in by_path.items() if c.get(kernel)}

    d_all = sum(d for _, d in LEAF_SHAPES)
    tree_row = rows[("tm tree", M, d_all)]
    entries = [kernel_entry(
        "cw_reduce", "src/repro_torch/kernels/csrc/cw_reduce.cu",
        "src/repro/kernels/fused.py:156", launches, launches_of("cw_reduce"),
        max([worst, cw_tree_worst, lane_worst, zoo_worst, modeb_worst,
             zoo_row["max_abs_err"], whisper_worst,
             whisper_row["max_abs_err"]]
            + [r["max_abs_err"] for r in rows.values()]),
        tree_row, tree_row, "torch.median(x, 0) per leaf",
        shape=[[m, d] for m, d in LEAF_SHAPES], case="tm tree", trim=TRIM,
        per_leaf_ms=rows[("tm per leaf", M, d_all)]["kernel_us"] / 1e3,
        masked_ms=rows[("tm_masked tree", M, d_all)]["kernel_us"] / 1e3,
        lanes8_ms=rows[("tm lanes C=8", M, d_all)]["kernel_us"] / 1e3,
        tree_per_lane8_ms=rows[("tm tree per lane C=8", M, d_all)]["kernel_us"] / 1e3,
        zoo_tree_ms=zoo_row["kernel_us"] / 1e3,
        zoo_tree_bound_ms=zoo_row["bound_us"] / 1e3,
        zoo_tree_plain_ms=zoo_row["plain_us"] / 1e3,
        zoo_tree_library_ms=zoo_row["library_us"] / 1e3,
        zoo_tree_columns=zoo_row["d"],
        whisper_tree_ms=whisper_row["kernel_us"] / 1e3,
        whisper_tree_launches=whisper_row["launches"],
        whisper_tree_bound_ms=whisper_row["bound_us"] / 1e3,
        whisper_tree_plain_ms=whisper_row["plain_us"] / 1e3,
        whisper_tree_library_ms=whisper_row["library_us"] / 1e3,
        whisper_tree_columns=whisper_row["d"])]
    for name, case, replaces, path, library in [
            ("pairwise_sqdist", "k=m", "src/repro/kernels/fused.py:266",
             "nnm+cwtm", "torch.cdist(x, x).square_()"),
            ("weighted_combine", "k=1 tree", "src/repro/kernels/fused.py:273",
             "krum", "torch.mm(w, x) per leaf"),
            ("combine_reduce", "k=m tm tree", "src/repro/kernels/fused.py:143",
             "nnm+cwtm", None),
            ("cross_sqdist", "k=1", "src/repro/kernels/fused.py:304",
             "geomed", "torch.cdist(x, z).square_()")]:
        tree = case.endswith("tree")
        row = geo_rows[(name, case, M, d_all if tree else 8192)]
        source = ("src/repro_torch/kernels/csrc/sqdist.cu" if "sqdist" in name
                  else "src/repro_torch/kernels/csrc/combine.cu")
        err = max([r["max_abs_err"] for key, r in geo_rows.items()
                   if key[0] == name] + ([tree_worst[name]] if tree else []))
        shape = ([[m, d] for m, d in LEAF_SHAPES] if tree else [M, 8192])
        extra = {}
        if name == "combine_reduce":
            extra["trim_on_card_ms"] = geo_rows[(
                name, "k=m tm tree, trim on the card", M, d_all)]["kernel_us"] / 1e3
        entries.append(kernel_entry(
            name, source, replaces, by_path[path][name], launches_of(name), err,
            row, row if library else None, library,
            check_max_err=geo_worst[name], shape=shape, case=case, **extra))
    emit({"lint": LINT})
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:  # one rank of mesh_path
        mesh_rank(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--gspmd-rank"]:  # one rank of gspmd_path
        gspmd_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    elif sys.argv[1:2] == ["--modeb-rank"]:  # one rank of modeb_path
        modeb_rank(int(sys.argv[2]), sys.argv[3])
    else:
        main()
