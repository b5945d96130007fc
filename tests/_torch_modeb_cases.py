"""The cases of ``tests/test_torch_modeb_ranks.py`` and
``tests/test_torch_modeb_cli.py``: Mode B's training step on the JAX
package's ``tests/test_sharded.py`` settings and a few more, each with its
inputs made from seeds with numpy (the port's ``init_params`` at seed 0 on
the CPU, token rows from ``numpy.random.default_rng``), so the port's gloo
ranks (``_torch_modeb_ranks.py``) and the JAX package's 8-device run
(``_torch_modeb_jax.py``) start from the same numbers; and ``run_group``,
which runs one group of them on both sides.

A case: the arch (at ``configs.reduced``), the mesh's shape and axes, the
sequence length and global batch (of one MLMC level unit), the rule, the
attack and its (m,) mask, the optimizer and learning rate, the steps, and
the MLMC level (None: ``build_train_step``). ``against`` says what the
JAX side computes: ``"modeb"`` its Mode B step; ``"unsharded"`` its
unsharded computation of the same step (``jax.grad`` of each worker's
rows, the attack, the rule's ``tree``, the optimizer); ``"both"`` the two.
``group`` names the test file's group that runs the case: "modeb"
(``tests/test_torch_modeb_ranks.py``) by default for the cases held to
the JAX Mode B step alone, "unsharded" (``tests/test_torch_modeb_cli.py``)
for the others; each group is run by its own 8 ranks and JAX process.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import init_params

DATA_MODEL = ((4, 2), ("data", "model"))
POD_DATA_MODEL = ((2, 2, 2), ("pod", "data", "model"))


def _case(arch, seq, aggregator, attack="none", mask=(0, 0, 0, 0),
          opt=("sgd", 0.05), steps=1, mesh=DATA_MODEL, mlmc=None,
          against="modeb", group=None):
    return dict(arch=arch, mesh=mesh, seq=seq, batch=8, aggregator=aggregator,
                attack=attack, mask=list(mask), opt=opt, steps=steps,
                mlmc=mlmc, against=against,
                group=group or ("modeb" if against == "modeb" else "unsharded"))


CASES = {
    # the four cases of tests/test_sharded.py that pass on this JAX
    "mean none": _case("smollm-360m", 32, "mean", opt=("sgd", 0.1)),
    "cwmed none": _case("qwen3-0.6b", 16, "cwmed"),
    "multipod ipm": _case("qwen2-moe-a2.7b", 16, "cwmed", "ipm", (1, 0, 0, 0),
                          mesh=POD_DATA_MODEL),
    "mlmc J=1": _case("qwen3-0.6b", 16, "cwmed", mlmc=1),
    # the other attacks and optimizers
    "momentum alie": _case("smollm-360m", 16, "cwtm", "alie", (0, 1, 0, 0),
                           opt=("momentum", 0.05), steps=2),
    # and the JAX package's unsharded computation: a second witness of
    # how far two float32 computations of Adam's step lie apart
    "adam sign_flip": _case("qwen3-0.6b", 16, "cwtm", "sign_flip",
                            (0, 0, 1, 0), opt=("adam", 1e-3), steps=2,
                            against="both", group="modeb"),
    # the JAX package's Mode B norms only a device's blocks (ROADMAP.md §3)
    "adagrad_norm": _case("smollm-360m", 16, "mean", opt=("adagrad_norm", 0.1),
                          against="both"),
    # the JAX package's Mode B step stops here on this JAX (ROADMAP.md §3)
    "sign_flip 8 steps": _case("smollm-360m", 32, "cwtm", "sign_flip",
                               (1, 0, 0, 0), opt=("sgd", 0.5), steps=8,
                               against="unsharded"),
}
MLMC = dict(T=64, m=4, V=1e9)


def model_cfg(case):
    return reduced(get_config(case["arch"]))


def params_np(case) -> dict:
    """The port's flat float32 params at seed 0, as numpy."""
    p = init_params(model_cfg(case), 0, dtype=torch.float32, device="cpu")
    return {k: v.numpy() for k, v in p.items()}


def batches_np(case) -> list:
    """One global batch a step: (B·2^level, seq) int32 tokens and their
    next-token labels, the tokens drawn as the synthetic LM data of both
    packages draws its base tokens (u² · vocab, u uniform: a skewed
    unigram a model learns in a few steps)."""
    rows = case["batch"] * 2 ** (case["mlmc"] or 0)
    vocab = model_cfg(case).vocab_size
    out = []
    for t in range(case["steps"]):
        u = np.random.default_rng(100 + t).random((rows, case["seq"]))
        toks = (u * u * vocab).astype(np.int32)
        out.append({"tokens": toks, "labels": np.roll(toks, -1, 1)})
    return out


def port_unsharded(case):
    """The port's unsharded computation of the case's steps on the CPU:
    each worker's gradient of ``loss_fn`` on its rows, the flagged
    workers' negated (``none`` and ``sign_flip`` only), the rule's
    ``tree`` at delta 0.25 (Mode B's), the optimizer. Returns (params,
    optimizer state, the first step's aggregate), flat numpy dicts as the
    ranks give them ("m/<leaf>", "t", ... for the state)."""
    from repro_torch.core.agg_engine import get_aggregator
    from repro_torch.models import transformer
    from repro_torch.optim.optimizers import apply_updates, get_optimizer

    assert case["attack"] in ("none", "sign_flip")
    cfg, m = model_cfg(case), len(case["mask"])
    params = {k: torch.from_numpy(v) for k, v in params_np(case).items()}
    opt = get_optimizer(*case["opt"])
    state = opt.init(params)
    agg = get_aggregator(case["aggregator"], delta=0.25)
    aggs = []
    for batch in batches_np(case):
        rows = batch["tokens"].shape[0] // m
        grads = []
        for i in range(m):
            leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
            keys = sorted(leaves)
            loss = transformer.loss_fn(leaves, {
                k: torch.from_numpy(v[i * rows:(i + 1) * rows])
                for k, v in batch.items()}, cfg)
            g = torch.autograd.grad(loss, [leaves[k] for k in keys])
            sign = -1.0 if case["attack"] == "sign_flip" and case["mask"][i] \
                else 1.0
            grads.append({k: sign * v for k, v in zip(keys, g)})
        with torch.no_grad():
            aggs.append(agg.tree({k: torch.stack([g[k] for g in grads])
                                  for k in grads[0]}))
            updates, state = opt.update(aggs[-1], state, params)
            params = apply_updates(params, updates)

    def flat(tree, pre=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in flat(v, f"{pre}{k}/").items()}
        return {pre.rstrip("/"): tree.detach().numpy()}
    return flat(params), flat(state), flat(aggs[0])


GROUPS = ("modeb", "unsharded")
HERE = Path(__file__).resolve().parent
TIMEOUT_S = 240


def group_cases(group: str) -> dict:
    return {n: c for n, c in CASES.items() if c["group"] == group}


def spawn(name: str, *args):
    """This directory's script ``name`` as a process on one thread."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, str(HERE / name),
                             *map(str, args)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)


def wait(procs) -> None:
    """Wait for ``procs`` (each under ``TIMEOUT_S``; the rest are ended
    when one fails or outlasts it); each must exit with 0."""
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {i}:\n{log[-4000:]}"


def run_group(tmp: Path, group: str):
    """The group's cases on 8 gloo ranks and in one 8-device JAX process,
    at the same time: (each rank's results, the JAX side's arrays)."""
    procs = [spawn("_torch_modeb_ranks.py", 8, r, tmp / "rendezvous", tmp,
                   group) for r in range(8)]
    procs.append(spawn("_torch_modeb_jax.py", tmp / "jax.npz", group))
    wait(procs)
    ranks = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
             for r in range(8)]
    return ranks, dict(np.load(tmp / "jax.npz"))


def jax_part(arrays, name, how, part) -> dict:
    pre = f"{name}|{how}|{part}/"
    return {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}


def max_gap(got, want) -> float:
    assert got.keys() == want.keys()
    return max(float(np.max(np.abs(got[k] - want[k]))) for k in want)


def equal(a, b) -> bool:
    """Bitwise equality of nested results (arrays by dtype and bits)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def counts(case) -> dict:
    """The collectives of one step: per gradient a gather of the top scope
    and two of each layer group (the forward's and the recompute's) and an
    exchange a scope; a sum for the MLMC correction's norm and one for
    AdaGrad-Norm's. An MLMC step takes the gradients of levels 0, J-1 and
    J: two at J=1."""
    groups = model_cfg(case).n_groups
    grads = 1 if not case["mlmc"] else 2 if case["mlmc"] == 1 else 3
    return {"param_gathers": grads * (1 + 2 * groups),
            "exchanges": grads * (1 + groups),
            "sums": int(bool(case["mlmc"]))
            + int(case["opt"][0] == "adagrad_norm")}


def check_ranks(ranks, name) -> None:
    """Every rank's result of case ``name`` bitwise rank 0's, its blocks
    those of its full params, each step's collectives ``counts``."""
    outs = [r[name] for r in ranks]
    for r, out in enumerate(outs):
        assert out["blocks_are_the_full_blocks"], r
        assert out["counts"] == [counts(CASES[name])] * len(out["counts"]), \
            out["counts"]
        assert equal(out, outs[0]), f"rank {r} differs from rank 0"
