"""Mode B's training step of the port (``launch/steps.py``,
``core/sharded.py``'s param hook) as 8 gloo CPU ranks, against the JAX
package's Mode B step.

The cases are ``tests/_torch_modeb_cases.py``'s group "modeb": the four
cases of the JAX package's ``tests/test_sharded.py`` that pass on this JAX
(Mean with no attack, CWMed, qwen2-moe under IPM on a ``(pod, data,
model)`` mesh, the MLMC J=1 step), momentum under ALIE and Adam under
sign_flip. When the module starts, 8 rank processes
(``tests/_torch_modeb_ranks.py``, a ``file://`` rendezvous under
``tmp_path``) and one 8-device JAX process (``tests/_torch_modeb_jax.py``)
run every case, each under a timeout. The other cases (AdaGrad-Norm and
sign_flip for 8 steps, against the JAX package's unsharded computation)
are in ``tests/test_torch_modeb_cli.py``.

- Every rank returns the same full params, outputs and optimizer state,
  bitwise, and holds the blocks of those params; each step runs the
  predicted collectives (per gradient a gather for the top scope and two
  a layer group, one of them the recompute's, and an exchange a scope).
- Against the JAX package's Mode B step: params within atol 1e-5, the
  outputs (the workers' mean loss; MLMC's failsafe_ok and correction norm)
  within rtol 1e-5, each leaf of the optimizer state within 1e-5 of its
  largest |value| (integer leaves equal). Adam's params are held to atol
  2e-4 (0.2·lr) and its moments to 2e-4 of their largest |value|: its
  first update lr·g/(|g| + 1e-8) is ill-conditioned where the aggregate
  |g| is near 1e-8, so float32 rounding in g (a few 1e-6 of the leaf's
  largest |g|) parts the params by up to 1.4e-4 in a few coordinates, and
  the second step's moments are taken at those params.
- The witness of that for Adam: the ranks' params and moments bitwise the
  port's unsharded computation (``_torch_modeb_cases.port_unsharded``),
  the JAX package's Mode B step within 1e-7 of its own unsharded
  computation, so the gap lies between the two packages' unsharded
  arithmetic; their first aggregates within 1e-5 of each leaf's largest
  |g|; and every coordinate whose params part by more than 1e-5 has a
  first aggregate below 1e-6 in both.
"""
import numpy as np
import pytest

import _torch_modeb_cases as cases

ATOL = 1e-5
STATE_RTOL = 1e-5  # of a state leaf's largest |value|
ADAM_PARAMS_ATOL = ADAM_STATE_RTOL = 2e-4
ADAM_EPS = 1e-8
NAMES = list(cases.group_cases("modeb"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return cases.run_group(tmp_path_factory.mktemp("modeb"), "modeb")


@pytest.mark.parametrize("name", NAMES)
def test_ranks_bitwise_each_other(name, runs):
    cases.check_ranks(runs[0], name)


@pytest.mark.parametrize("name", NAMES)
def test_matches_the_jax_mode_b_step(name, runs):
    ranks, arrays = runs
    got = ranks[0][name]
    np.testing.assert_allclose(got["outs"], arrays[f"{name}|modeb|outs"],
                               rtol=1e-5, atol=0)
    is_adam = cases.CASES[name]["opt"][0] == "adam"
    want_state = cases.jax_part(arrays, name, "modeb", "state")
    assert got["state"].keys() == want_state.keys()
    for k, want in want_state.items():
        if not np.issubdtype(want.dtype, np.floating):
            assert np.array_equal(got["state"][k], want), k
            continue
        gap = float(np.max(np.abs(got["state"][k] - want)))
        rel = ADAM_STATE_RTOL if is_adam else STATE_RTOL
        assert gap <= rel * float(np.max(np.abs(want))), (k, gap)
    gap = cases.max_gap(got["params"],
                        cases.jax_part(arrays, name, "modeb", "params"))
    assert gap <= (ADAM_PARAMS_ATOL if is_adam else ATOL), gap


def test_adam_gap_is_rounding(runs):
    ranks, arrays = runs
    name = "adam sign_flip"
    got = ranks[0][name]
    params, state, agg1 = cases.port_unsharded(cases.CASES[name])
    assert cases.equal(got["params"], params)
    assert cases.equal(got["state"], state)
    jax_modeb, jax_flat = (cases.jax_part(arrays, name, "modeb", "params"),
                           cases.jax_part(arrays, name, "unsharded", "params"))
    assert cases.max_gap(jax_modeb, jax_flat) <= 1e-7
    jax_agg1 = cases.jax_part(arrays, name, "unsharded", "agg1")
    assert agg1.keys() == jax_agg1.keys()
    for k, want in jax_agg1.items():
        scale = float(np.max(np.abs(want)))
        assert float(np.max(np.abs(agg1[k] - want))) <= 1e-5 * scale, k
        far = np.abs(got["params"][k] - jax_modeb[k]) > ATOL
        small = np.maximum(np.abs(agg1[k]), np.abs(want)) < 100 * ADAM_EPS
        assert np.all(small[far]), (k, int(far.sum()), int((far & ~small).sum()))
