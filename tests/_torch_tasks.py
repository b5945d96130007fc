"""Small tasks for the port's parity tests, fed to the JAX package and to the
port from the same numpy data.

A softmax regression (256 points, 6 features, 3 classes) whose units are
index batches drawn by numpy per (sampler seed, round), so both packages'
samplers return the same indices; and App. E's quadratic whose units are
numpy noise vectors per (sampler seed, round), as the port's
``make_quadratic_task`` draws them. Each comes as a ``Task`` of either
package's ``core.scenarios``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import scenarios as j_scen
from repro_torch.core import scenarios as t_scen

X = np.random.default_rng(0).normal(size=(256, 6)).astype(np.float32)
Y = np.random.default_rng(1).integers(0, 3, size=256)
P0 = {"b": np.zeros(3, np.float32),
      "w": (np.random.default_rng(2).normal(size=(6, 3)) * 0.3).astype(np.float32)}
A = np.array([[2.0, 1.0], [1.0, 2.0]], np.float32)


def index_units(seed, t, m, n):
    return np.random.default_rng((seed, t)).integers(0, len(X), size=(m, n, 4))


def noise_units(seed, t, m, n):
    units = np.random.default_rng((seed, t)).standard_normal((m, n, 2))
    return units.astype(np.float32)


def _sampler_factory(units, seed, convert):
    def make_sampler(m, sampler_seed=None):
        s = seed if sampler_seed is None else sampler_seed
        return lambda t, n: convert(units(s, t, m, n))
    return make_sampler


def jax_softmax(seed=0):
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)

    def loss(params, idx):
        logp = jax.nn.log_softmax(Xj[idx] @ params["w"] + params["b"])
        return -jnp.mean(jnp.take_along_axis(logp, Yj[idx][:, None], 1))

    def objective(p):
        return float(loss(p, jnp.arange(len(X))))

    return j_scen.Task({k: jnp.asarray(v) for k, v in P0.items()},
                       jax.grad(loss), _sampler_factory(index_units, seed,
                                                        jnp.asarray),
                       objective)


def torch_softmax(seed=0):
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)

    def loss(params, idx):
        return torch.nn.functional.cross_entropy(
            Xt[idx] @ params["w"] + params["b"], Yt[idx])

    def grad_fn(params, idx):
        return torch.func.grad(loss)(params, idx)

    def objective(p):
        with torch.no_grad():
            return float(loss(p, torch.arange(len(X))))

    return t_scen.Task({k: torch.from_numpy(v.copy()) for k, v in P0.items()},
                       grad_fn, _sampler_factory(index_units, seed,
                                                 torch.from_numpy),
                       objective)


def jax_quadratic(sigma=0.5, seed=0):
    """App. E's quadratic with the port's numpy noise units."""
    Aj = jnp.asarray(A)

    def grad_fn(params, unit):
        return {"x": Aj @ params["x"] + sigma * unit}

    def objective(p):
        return float(0.5 * p["x"] @ Aj @ p["x"])

    return j_scen.Task({"x": jnp.asarray([3.0, -2.0])}, grad_fn,
                       _sampler_factory(noise_units, seed, jnp.asarray),
                       objective)


def to_numpy(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def logs_of(logs):
    return [(l.level, bool(l.failsafe_ok), l.n_byz, l.cost) for l in logs]
