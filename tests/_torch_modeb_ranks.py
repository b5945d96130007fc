"""The port's side of ``tests/test_torch_modeb_ranks.py`` and
``tests/test_torch_modeb_cli.py``: Mode B's steps (``launch/steps.py``) as
one rank of a gloo group on the CPU.

    python tests/_torch_modeb_ranks.py <world> <rank> <init file> <out dir>
        [<group>]

World 8 runs the cases of ``_torch_modeb_cases``' group ``group`` (on a
``(4, 2)`` ``('data', 'model')`` or a ``(2, 2, 2)`` ``('pod', 'data',
'model')`` mesh); world 4 runs ``build_prefill_step`` and
``build_decode_step`` on a ``(2, 2)`` mesh. Each case's result (the full params gathered after
its last step, its outputs, whether the rank's blocks are the full
params' blocks, the collectives a step) is pickled with the rest to
``<out dir>/rank<rank>.pkl``. It imports the port only, never JAX.
"""
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import _torch_modeb_cases as cases  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import sharded  # noqa: E402
from repro_torch.core.mlmc import MLMCConfig  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    build_decode_step, build_mlmc_train_step, build_prefill_step,
    build_train_step,
)
from repro_torch.models import init_cache, init_params  # noqa: E402
from repro_torch.optim.optimizers import get_optimizer  # noqa: E402

COUNTS = ("param_gathers", "exchanges", "sums")
# prefill and decode: (arch, batch, prompt length)
INFER = (("smollm-360m", 4, 8), ("qwen2-moe-a2.7b", 2, 8))


def _np(tree):
    return {k: v.detach().numpy().copy() for k, v in sorted(tree.items())}


def train_case(case, mesh):
    cfg = cases.model_cfg(case)
    shape = ShapeConfig("t", case["seq"], case["batch"], "train")
    opt = get_optimizer(*case["opt"])
    kw = dict(aggregator=case["aggregator"], attack=case["attack"], opt=opt,
              dtype=torch.float32)
    if case["mlmc"]:
        step = build_mlmc_train_step(cfg, mesh, shape,
                                     MLMCConfig(**cases.MLMC), case["mlmc"],
                                     **kw)
    else:
        step = build_train_step(cfg, mesh, shape, **kw)
    params = {k: torch.from_numpy(v) for k, v in cases.params_np(case).items()}
    blocks = step.place(params)
    state = step.place(opt.init(params))
    maskf = torch.tensor(case["mask"], dtype=torch.float32)
    outs, counts = [], []
    for batch in cases.batches_np(case):
        before = dict(sharded.COLLECTIVES)
        blocks, state, out = step.fn(
            blocks, state, {k: torch.from_numpy(v) for k, v in batch.items()},
            maskf)
        counts.append({k: sharded.COLLECTIVES[k] - before[k] for k in COUNTS})
        outs.append([float(v) for v in (out if isinstance(out, tuple)
                                         else (out,))])
    full = step.gather(blocks)
    return {"params": _np(full), "outs": np.asarray(outs, np.float32),
            "state": _full_state(step, state), "counts": counts,
            "blocks_are_the_full_blocks": all(
                torch.equal(v, step.place(full)[k])
                for k, v in blocks.items())}


def _full_state(step, state) -> dict:
    """An optimizer state of blocks, flat: its param-shaped dicts gathered
    ("m/<leaf>", ...), its scalars as they are ("t", "" for a bare
    one)."""
    if isinstance(state, dict) and state and set(state) <= set(step.plan.specs):
        return _np(step.gather(state))
    if isinstance(state, dict):
        return {f"{k}/{leaf}" if leaf else k: v
                for k, sub in state.items()
                for leaf, v in _full_state(step, sub).items()}
    if isinstance(state, torch.Tensor):
        return {"": state.numpy().copy()}
    return {}


def infer_case(arch, batch, prompt, mesh):
    """A prefill of ``prompt`` tokens (seed 1's float32 params) and a decode
    step of its greedy tokens from an empty cache of ``prompt`` slots at
    position 0, through the step builders on ``mesh``."""
    cfg = reduced(get_config(arch))
    params = init_params(cfg, 1, dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (batch, prompt), dtype=np.int32))
    pre = build_prefill_step(cfg, mesh, ShapeConfig("p", prompt, batch,
                                                    "prefill"),
                             dtype=torch.float32)
    logits, cache = pre.fn(pre.place(params), toks, {})
    dec = build_decode_step(cfg, mesh, ShapeConfig("d", prompt, batch,
                                                   "decode"),
                            dtype=torch.float32)
    token = torch.argmax(logits, -1).to(torch.int32)
    empty = init_cache(cfg, batch, prompt, dtype=torch.float32, device="cpu")
    step_logits, _ = dec.fn(dec.place(params), empty, token, torch.tensor(0))
    return {"prefill": logits.numpy(), "decode": step_logits.numpy(),
            "cache": _np(cache), "names": (pre.name, dec.name)}


def main(world: int, rank: int, init_file: str, out_dir: str,
         group: str = "") -> None:
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world)
    try:
        if world == 8:
            meshes = {}
            results = {}
            for name, case in cases.group_cases(group).items():
                if case["mesh"] not in meshes:  # every rank in this order
                    meshes[case["mesh"]] = make_test_mesh(*case["mesh"])
                results[name] = train_case(case, meshes[case["mesh"]])
        else:
            mesh = make_test_mesh((2, 2))
            results = {arch: infer_case(arch, b, s, mesh)
                       for arch, b, s in INFER}
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
