"""Mode B on gloo CPU ranks against the JAX package's unsharded
computation, its inference steps, and the training CLI (``python -m
repro_torch.launch.train``, the port of the JAX package's
``launch/train.py``).

- ``tests/_torch_modeb_cases.py``'s group "unsharded" as 8 ranks beside
  one 8-device JAX process (as ``tests/test_torch_modeb_ranks.py`` runs
  its group): every rank bitwise rank 0 with the predicted collectives.
  AdaGrad-Norm: the port's accumulator is the global ‖g‖² of the
  aggregate and its params match the JAX package's unsharded computation
  within atol 1e-5; the JAX package's Mode B step norms only a device's
  blocks (a fault of the reference, ROADMAP.md §3), and its accumulator is
  shown to differ. sign_flip on worker 0 of 4 under CWTM for 8 steps: the
  JAX package's Mode B step refuses placed inputs on this JAX, so the port
  is held to the JAX package's unsharded computation (each worker's
  ``jax.grad``, the sign flip, CWTM's ``tree``, SGD): params within atol
  1e-5, losses within rtol 1e-5, finite, the last below the first.
- ``build_prefill_step`` and ``build_decode_step`` on a ``(2, 2)`` mesh
  (``tests/_torch_modeb_ranks.py`` as 4 ranks; SmolLM-360M and qwen2-moe,
  whose experts ``_perf_cfg`` places on 'model', reduced): every rank's
  logits and cache bitwise the port's ``prefill`` / ``decode_step`` on the
  full params.
- ``launch.train --device cpu --devices 4 --mesh 2x2 --reduced --mlmc
  --steps 3`` exits with 0 and prints the reference's lines from rank 0
  only; ``--aggregator krum`` exits non-zero naming "coordinate-wise".
"""
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_modeb_cases as cases
import _torch_modeb_ranks as ranks
from repro_torch.configs import get_config, reduced
from repro_torch.models import init_cache, init_params, transformer

ATOL = 1e-5
SRC = str(Path(__file__).resolve().parents[1] / "src")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return cases.run_group(tmp_path_factory.mktemp("modeb_unsharded"),
                           "unsharded")


@pytest.mark.parametrize("name", list(cases.group_cases("unsharded")))
def test_ranks_bitwise_each_other(name, runs):
    cases.check_ranks(runs[0], name)


def test_adagrad_norm_takes_the_global_norm(runs):
    rank_results, arrays = runs
    name = "adagrad_norm"
    got = rank_results[0][name]
    true_acc = float(arrays[f"{name}|unsharded|state/"])
    np.testing.assert_allclose(float(got["state"][""]), true_acc, rtol=1e-6)
    assert cases.max_gap(got["params"], cases.jax_part(
        arrays, name, "unsharded", "params")) <= ATOL
    # the JAX package's Mode B step norms one device's blocks only
    jax_acc = float(arrays[f"{name}|modeb|state/"])
    assert abs(jax_acc - true_acc) > 0.1 * true_acc, (jax_acc, true_acc)


def test_sign_flip_matches_the_unsharded_computation(runs):
    rank_results, arrays = runs
    name = "sign_flip 8 steps"
    got = rank_results[0][name]
    assert cases.max_gap(got["params"], cases.jax_part(
        arrays, name, "unsharded", "params")) <= ATOL
    losses = got["outs"][:, 0]
    np.testing.assert_allclose(losses, arrays[f"{name}|unsharded|outs"][:, 0],
                               rtol=1e-5, atol=0)
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses


# ------------------------------------------------ prefill and decode


@pytest.fixture(scope="module")
def infer_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("modeb_infer")
    cases.wait([cases.spawn("_torch_modeb_ranks.py", 4, r, tmp / "rendezvous",
                            tmp) for r in range(4)])
    return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
            for r in range(4)]


@pytest.mark.parametrize("arch,batch,prompt", ranks.INFER)
def test_prefill_and_decode_steps_are_the_unsharded_ones(arch, batch, prompt,
                                                         infer_ranks):
    cfg = reduced(get_config(arch))
    params = init_params(cfg, 1, dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (batch, prompt), dtype=np.int32))
    logits, cache = transformer.prefill(params, toks, cfg)
    empty = init_cache(cfg, batch, prompt, dtype=torch.float32, device="cpu")
    step, _ = transformer.decode_step(
        params, empty, torch.argmax(logits, -1).to(torch.int32), 0, cfg)
    for r, res in enumerate(infer_ranks):
        got = res[arch]
        assert np.array_equal(got["prefill"], logits.numpy()), r
        assert np.array_equal(got["decode"], step.numpy()), r
        assert got["cache"].keys() == cache.keys()
        assert all(np.array_equal(got["cache"][k], cache[k].numpy())
                   for k in cache), r
        assert got["names"] == (f"prefill[{arch}/p]", f"decode[{arch}/d]")


# ------------------------------------------------------------- the CLI


def _train(*args):
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + (os.pathsep + path if path else ""))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         *args], capture_output=True, text=True, timeout=cases.TIMEOUT_S,
        env=env)


def test_cli_mlmc_on_four_ranks():
    r = _train("--devices", "4", "--mesh", "2x2", "--reduced", "--mlmc",
               "--steps", "3")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert lines[0].startswith(
        "mesh={'data': 2, 'model': 2} workers(m)=2 arch=smollm-360m"), lines
    steps = [ln for ln in lines if ln.startswith("step")]
    assert len(steps) == 3, lines  # rank 0's lines only
    for ln in steps:
        assert re.match(r"step +\d+ byz=1/2 J=\d+ failsafe_ok=[01] ", ln), ln
    assert lines[-1].startswith("done in"), lines


def test_cli_refuses_a_rule_that_is_not_coordinate_wise():
    r = _train("--reduced", "--steps", "2", "--aggregator", "krum")
    assert r.returncode != 0
    assert "coordinate-wise" in r.stderr
