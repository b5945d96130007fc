"""The JAX package's side of ``tests/test_torch_modeb_ranks.py`` and
``tests/test_torch_modeb_cli.py``, one process with 8 host devices:

    python tests/_torch_modeb_jax.py <out.npz> <group>

For each case of ``_torch_modeb_cases``' group ``group`` it runs the JAX
package's Mode B step (``launch.steps.build_train_step`` /
``build_mlmc_train_step``) or its unsharded computation of the same step,
or both, as the case asks, on the cases' numpy inputs, and writes the
params and optimizer state after the last step, and the unsharded
computation's aggregate of its first step (keyed
"<case>|<how>|<part>/<leaf>" by the port's flat names, part "params",
"state" or "agg1") and the outputs to one ``.npz``.
"""
import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_modeb_cases as cases  # noqa: E402
from repro.configs import get_config, reduced  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.core.aggregators import get_aggregator  # noqa: E402
from repro.core.mlmc import MLMCConfig  # noqa: E402
from repro.launch.mesh import set_mesh  # noqa: E402
from repro.launch.steps import build_mlmc_train_step, build_train_step  # noqa: E402
from repro.models import loss_fn  # noqa: E402
from repro.optim.optimizers import apply_updates, get_optimizer  # noqa: E402
from repro_torch.convert import zoo_params_to_numpy  # noqa: E402


def _nested(flat):
    import torch
    return zoo_params_to_numpy({k: torch.from_numpy(v) for k, v in flat.items()})


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = np.asarray(v)
    return out


def modeb(case, cfg):
    (dims, axes), m = case["mesh"], 4
    mesh = jax.make_mesh(dims, axes)
    shape = ShapeConfig("t", case["seq"], case["batch"], "train")
    opt = get_optimizer(*case["opt"])
    kw = dict(aggregator=case["aggregator"], attack=case["attack"], opt=opt,
              dtype=jnp.float32)
    if case["mlmc"]:
        step = build_mlmc_train_step(cfg, mesh, shape,
                                     MLMCConfig(**cases.MLMC), case["mlmc"],
                                     **kw)
    else:
        step = build_train_step(cfg, mesh, shape, **kw)
    params = _nested(cases.params_np(case))
    state = opt.init(jax.tree.map(jnp.asarray, params))
    maskf = np.asarray(case["mask"], np.float32)
    assert maskf.shape == (m,)
    outs = []
    with set_mesh(mesh):
        for batch in cases.batches_np(case):
            # host copies: on this JAX a placed array's type carries its
            # sharding, and the step's embedding gather refuses it
            # (ROADMAP.md §3); numpy inputs are placed by the step itself
            params, state, out = step.fn(*jax.tree.map(np.asarray, (
                params, state)), batch, maskf)
            outs.append(np.asarray(jax.tree.leaves(out), np.float32))
    return {"params": _flat(params), "outs": np.stack(outs),
            "state": _flat_state(state)}


def _flat_state(state) -> dict:
    """An optimizer state flat, keyed as the port's ranks key theirs."""
    if isinstance(state, dict) and "embed" in state:
        return _flat(state)
    if isinstance(state, dict):
        return {f"{k}/{leaf}" if leaf else k: v for k, sub in state.items()
                for leaf, v in _flat_state(sub).items()}
    if isinstance(state, tuple):
        return {}
    return {"": np.asarray(state)}


def unsharded(case, cfg):
    """Each worker's ``jax.grad`` on its rows, the attack on the flagged
    workers' gradients, the rule's ``tree``, the optimizer (AdaGrad-Norm's
    norm over the whole aggregate): the computation Mode B shards."""
    m = 4
    params = jax.tree.map(jnp.asarray, _nested(cases.params_np(case)))
    opt = get_optimizer(*case["opt"])
    state = opt.init(params)
    agg = get_aggregator(case["aggregator"])
    byz = np.asarray(case["mask"], np.float32) > 0.5
    assert case["attack"] in ("none", "sign_flip")
    vg = jax.jit(jax.value_and_grad(lambda p, b: loss_fn(p, b, cfg)))
    losses, aggs = [], []
    for batch in cases.batches_np(case):
        rows = batch["tokens"].shape[0] // m
        vals, grads = [], []
        for i in range(m):
            b = {k: jnp.asarray(v[i * rows:(i + 1) * rows])
                 for k, v in batch.items()}
            v, g = vg(params, b)
            if case["attack"] == "sign_flip" and byz[i]:
                g = jax.tree.map(lambda x: -x, g)
            vals.append(float(v))
            grads.append(g)
        stacked = jax.tree.map(lambda *ls: jnp.stack(ls), *grads)
        aggs.append(agg.tree(stacked))
        updates, state = opt.update(aggs[-1], state, params)
        params = apply_updates(params, updates)
        losses.append([np.mean(vals)])
    return {"params": _flat(params), "outs": np.asarray(losses, np.float32),
            "state": _flat_state(state), "agg1": _flat(aggs[0])}


def main(out_path, group):
    arrays = {}
    for name, case in cases.group_cases(group).items():
        cfg = reduced(get_config(case["arch"]))
        hows = {"modeb": ["modeb"], "unsharded": ["unsharded"],
                "both": ["modeb", "unsharded"]}[case["against"]]
        for how in hows:
            res = (modeb if how == "modeb" else unsharded)(case, cfg)
            for part in ("params", "state", "agg1"):
                for k, v in res.get(part, {}).items():
                    arrays[f"{name}|{how}|{part}/{k}"] = v
            arrays[f"{name}|{how}|outs"] = res["outs"]
    np.savez(out_path, **arrays)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
