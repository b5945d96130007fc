"""The port's linter and runtime sanitizers (``repro_torch.lint``) on the
CPU: every JXL000, JXL003, JXL004 and JXL006 fixture of the JAX package's
``tests/test_lint.py``, its select case and its syntax-error case give the
same ``(rule, line, col)`` list through both linters; the torch clause of
JXL004 (a draw from, or a seeding of, torch's global generator); the port's
trees ship clean; the CLI; the static side imports with torch and numpy
blocked; the recompile guard over the capture counter; a guarded
``Session``; and the NaN tripwire."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.lint import engine as j_engine
from repro_torch.api import session as t_session
from repro_torch.core import robust_train as t_rt
from repro_torch.core.scenarios import make_quadratic_task
from repro_torch.core.switching import get_switcher
from repro_torch.kernels import build as t_build
from repro_torch.lint import engine as t_engine
from repro_torch.lint.__main__ import DEFAULT_TREES, REPO_ROOT
from repro_torch.lint.rules import RULES
from repro_torch.lint.runtime import (
    RecompileError, assert_all_finite, compile_count, maybe_assert_finite,
    recompile_guard, tripwire_enabled,
)
from repro_torch.optim.optimizers import sgd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))

# (id, source, path, select): the fixtures of tests/test_lint.py whose rules
# the port has, case for case
FIXTURES = [
    ("jxl003_fires", "import math\ndef caps(delta, m):\n"
     "    return math.ceil(delta * m), int(delta * m)\n", "fixture.py", None),
    ("jxl003_clean", "def caps(delta, m):\n"
     "    return int(round(delta)), int(m), m // 2\n", "fixture.py", None),
    ("jxl003_suppressed", "import math\ndef count_ceil(v):\n"
     "    # jaxlint: disable=JXL003 -- the sanctioned nudged helper\n"
     "    return math.ceil(v - 1e-5)\n", "fixture.py", None),
    ("jxl004_hash", "def seed_for(name):\n    return hash(name) % 2 ** 31\n",
     "fixture.py", None),
    ("jxl004_seedless_np", "import numpy as np\ndef draw(m):\n"
     "    return np.random.rand(m), np.random.default_rng()\n", "fixture.py",
     None),
    ("jxl004_wall_clock", "import time\ndef seed():\n"
     "    return int(time.time())\n", "src/repro/core/sched.py", None),
    ("jxl004_wall_clock_port", "import time\ndef seed():\n"
     "    return int(time.time())\n", "src/repro_torch/core/sched.py", None),
    ("jxl004_wall_clock_bench", "import time\ndef bench():\n"
     "    return time.time()\n", "benchmarks/bench_x.py", None),
    ("jxl004_perf_counter", "import time\ndef wall():\n"
     "    return time.perf_counter()\n", "src/repro/core/scenarios.py", None),
    ("jxl004_set_iteration", "def f(d):\n    out = []\n    for k in set(d):\n"
     "        out.append(k)\n    return out\n", "fixture.py", None),
    ("jxl004_seeded_rng", "import numpy as np\ndef draw(m, seed):\n"
     "    return np.random.default_rng(seed).random(m)\n", "fixture.py", None),
    ("jxl004_suppressed", "def seed_for(name):\n"
     "    # jaxlint: disable=JXL004 -- never replayed, diagnostics only\n"
     "    return hash(name)\n", "fixture.py", None),
    ("jxl006_unguarded", "def main(rows):\n"
     '    return [f"x/{n},,gap={m:.3f}+-{s:.3f}" for n, m, s in rows]\n',
     "fixture.py", None),
    ("jxl006_pm_sign", 'def fmt(m, s):\n    return f"acc {m:.2f}±{s:.2f}"\n',
     "fixture.py", None),
    ("jxl006_module_scope", 'ROW = f"gap={1.0:.3f}+-{0.0:.3f}"\n',
     "fixture.py", None),
    ("jxl006_n_seeds", "def fmt(vals):\n    n = len(vals)\n"
     "    m = sum(vals) / n\n    if n == 1:\n"
     '        return f"gap={m:.3f};n_seeds=1"\n    s = 1.0\n'
     '    return f"gap={m:.3f}+-{s:.3f};n_seeds={n}"\n', "fixture.py", None),
    ("jxl006_literal_pm", 'def fmt(r):\n    return f"a +- b literal {r}"\n'
     'def fmt2(m):\n    return f"gap={m}+-const"\n', "fixture.py", None),
    ("jxl006_suppressed", "def main(m, s):\n"
     '    return f"gap={m:.3f}+-{s:.3f}"'
     "  # jaxlint: disable=JXL006 -- spread is always multi-sample here\n",
     "fixture.py", None),
    ("jxl000_reasonless", "import math\ndef f(v):\n"
     "    return math.ceil(v)  # jaxlint: disable=JXL003\n", "fixture.py",
     None),
    ("select", "import math\ndef f(v, name):\n"
     "    return math.ceil(v), hash(name)\n", "fixture.py", ["JXL004"]),
    ("syntax_error", "def f(:\n", "fixture.py", None),
]


def _hits(engine, src, path="fixture.py", select=None):
    return [(v.rule, v.line, v.col)
            for v in engine.lint_source(src, path=path, select=select)]


@pytest.mark.parametrize("src,path,select", [f[1:] for f in FIXTURES],
                         ids=[f[0] for f in FIXTURES])
def test_fixture_hits_equal_the_reference(src, path, select):
    want = _hits(j_engine, src, path, select)
    assert _hits(t_engine, src, path, select) == want


def test_fixtures_fire_where_the_reference_says():
    """The parity above is not vacuous: the fixtures' hits, as
    ``tests/test_lint.py`` asserts them."""
    got = {f[0]: [h[0] for h in _hits(t_engine, *f[1:])] for f in FIXTURES}
    assert got["jxl003_fires"] == ["JXL003", "JXL003"]
    assert got["jxl004_seedless_np"] == ["JXL004", "JXL004"]
    assert got["jxl004_wall_clock_port"] == ["JXL004"]
    assert got["jxl004_wall_clock_bench"] == []
    assert got["jxl006_module_scope"] == ["JXL006"]
    assert {"JXL000", "JXL003"} <= set(got["jxl000_reasonless"])
    assert got["select"] == ["JXL004"]
    assert got["syntax_error"] == ["JXL999"]


# ------------------------------------------------- JXL004's torch clause

GLOBAL_DRAWS = [
    "torch.randn(3)", "torch.rand(2, 3)", "torch.randint(0, 5, (3,))",
    "torch.randperm(7)", "torch.normal(0.0, 1.0, (3,))",
    "torch.bernoulli(p)", "torch.multinomial(p, 2)", "torch.rand_like(x)",
    "torch.randn_like(x)", "torch.randint_like(x, 5)", "x.normal_()",
    "x.uniform_(-1, 1)", "x.bernoulli_(0.5)", "x.random_(0, 9)",
    "x.exponential_()", "torch.nn.init.normal_(x)", "torch.manual_seed(0)",
    "torch.cuda.manual_seed_all(0)",
]


def _codes(src, path="src/repro_torch/serve/x.py"):
    return [v.rule for v in t_engine.lint_source(src, path=path)]


@pytest.mark.parametrize("call", GLOBAL_DRAWS)
def test_torch_global_generator_fires(call):
    src = f"import torch\ndef f(x, p):\n    return {call}\n"
    # everywhere, as the np.random clause: not only in deterministic layers
    assert _codes(src) == ["JXL004"]
    assert _codes(src, path="benchmarks_torch/b.py") == ["JXL004"]


@pytest.mark.parametrize("call", [
    "torch.randn(3, generator=g)", "torch.rand_like(x, generator=g)",
    "x.normal_(generator=g)", "x.uniform_(-1, 1, generator=g)",
    "torch.Generator().manual_seed(0)", "g.manual_seed(0)",
    "torch.randn(3, **kw)", "rng.normal(0.0, 1.0)", "torch.zeros(3)"])
def test_torch_own_generator_is_clean(call):
    src = f"import torch\ndef f(x, g, kw, rng):\n    return {call}\n"
    assert _codes(src) == []


def test_torch_clause_pragma_honored():
    src = ("import torch\ndef f(x):\n"
           "    # jaxlint: disable=JXL004 -- a test fixture's throwaway draw\n"
           "    return torch.randn(3) + x.normal_()\n")
    assert _codes(src) == []
    assert _codes(src.replace(" -- a test fixture's throwaway draw", "")) \
        == ["JXL000", "JXL004", "JXL004"]


def test_port_rules_are_the_torch_ones():
    assert sorted(RULES) == ["JXL003", "JXL004", "JXL006"]


# ---------------------------------------------------------- trees and CLI


def test_port_trees_ship_clean():
    paths = [os.path.join(REPO_ROOT, t) for t in DEFAULT_TREES]
    assert all(os.path.exists(p) for p in paths), paths
    violations = t_engine.lint_paths(paths)
    assert not violations, "\n".join(v.render() for v in violations)


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "repro_torch.lint", *args],
                          env=ENV, capture_output=True, text=True, timeout=120)


def test_cli_list_rules():
    out = _cli("--list-rules")
    assert out.returncode == 0, out.stderr
    for code in ("JXL003", "JXL004", "JXL006"):
        assert code in out.stdout
    for code in ("JXL001", "JXL002", "JXL005"):
        assert code not in out.stdout


def test_cli_check_gates(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\ndef f():\n    return torch.randn(3)\n")
    out = _cli("--check", str(bad))
    assert out.returncode == 1, out.stdout
    assert f"{bad}:3:11: JXL004" in out.stdout
    assert "jaxlint: 1 violation(s)" in out.stdout
    assert _cli("--check", "--select", "JXL003", str(bad)).returncode == 0
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    out = _cli("--check", str(good))
    assert out.returncode == 0 and "jaxlint: clean" in out.stdout


def test_static_side_imports_without_torch():
    code = (
        "import sys; sys.modules['torch'] = None; sys.modules['numpy'] = None\n"
        "import repro_torch.lint\n"
        "from repro_torch.lint.engine import lint_source\n"
        "from repro_torch.lint.rules import RULES\n"
        "from repro_torch.lint.__main__ import main\n"
        "assert len(RULES) == 3 and lint_source('x = 1') == []\n"
        "assert main(['--list-rules']) == 0\n"
        "assert callable(repro_torch.lint.recompile_guard)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ok" in out.stdout


# ------------------------------------------------------- the recompile guard


def test_compile_count_is_captures_and_builds():
    assert compile_count() == t_rt.capture_count() + t_build.build_count()
    before = compile_count()
    t_rt.count_captures(2)
    assert compile_count() == before + 2


def test_capture_counter_loses_no_update_across_threads():
    """The serve thread captures while others may: the counter's
    read-modify-write is under its lock."""
    import threading
    n_threads, n_each = 4 * (os.cpu_count() or 1), 500
    before = t_rt.capture_count()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [t_rt.count_captures() for _ in range(n_each)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert t_rt.capture_count() - before == n_threads * n_each


def test_recompile_guard_catches_a_capture():
    with pytest.raises(RecompileError, match="recompile"):
        with recompile_guard("forced"):
            t_rt.count_captures()


def test_recompile_guard_steady_state_clean():
    with recompile_guard("steady") as g:
        for _ in range(4):
            torch.ones(5) * 3.0
    assert g.count == 0
    with recompile_guard("allowed", max_recompiles=1) as g:
        t_rt.count_captures()
    assert g.count == 1


def test_recompile_guard_count_mode_never_raises():
    with recompile_guard("count", action="count") as g:
        t_rt.count_captures(3)
    assert g.count == 3
    with pytest.raises(ValueError, match="raise|count"):
        with recompile_guard("x", action="warn"):
            pass


def test_recompile_guard_does_not_mask_exceptions():
    with pytest.raises(RuntimeError, match="original"):
        with recompile_guard("raise-through") as g:
            t_rt.count_captures()
            raise RuntimeError("original failure")
    assert g.count == 1  # the delta is still recorded


# ------------------------------------------------------ a guarded Session


def _quadratic_session(**kw):
    from repro_torch.api.session import build_session
    from repro_torch.core.mlmc import MLMCConfig
    from repro_torch.core.robust_train import DynaBROConfig

    cfg = DynaBROConfig(mlmc=MLMCConfig(T=16, m=5, V=3.0, kappa=1.0, j_cap=2),
                        aggregator="cwmed", delta=0.4, attack="sign_flip")
    return build_session(
        cfg, make_quadratic_task(device="cpu"),
        switcher=get_switcher("periodic", 5, n_byz=2, K=4, seed=0),
        opt=sgd(2e-2), seed=0, **kw)


def _capture_in(monkeypatch, cls, name):
    """Make ``cls.name`` count one capture a call, as a card's would."""
    real = getattr(cls, name)

    def capturing(self, *args, **kw):
        t_rt.count_captures()
        return real(self, *args, **kw)
    monkeypatch.setattr(cls, name, capturing)


def test_session_steady_state_under_guard(monkeypatch):
    sess = _quadratic_session(guard_recompiles=True)
    assert sess.guard_recompiles
    p1, l1, _ = sess.run(16)  # warmup: records the run's signature
    p2, l2, _ = sess.run(16)  # steady state: guarded, captures nothing here
    assert torch.equal(p1["x"], p2["x"])
    assert [vars(l) for l in l1] == [vars(l) for l in l2]
    sched = sess.schedule(16)
    carry = sess.init_carry()
    for t in range(16):  # a level's first step is warmup, the rest guarded
        carry, _ = sess.step(carry, sess.round_inputs(sched, t))
    assert torch.equal(carry[0]["x"], p1["x"])
    levels = sorted({int(j) for j in sched.levels})
    assert sorted(s[2] for s in sess._steady_sigs if s[0] == "step") == \
        [(j,) for j in levels]
    # a guarded call that captures raises; a first call at a new signature
    # (another T) is warmup
    _capture_in(monkeypatch, t_rt.ScanFn, "run")
    with pytest.raises(RecompileError, match=r"Session.run \(T=16\)"):
        sess.run(16)
    sess.run(8)
    _capture_in(monkeypatch, t_rt.ScanFn, "run_round")
    with pytest.raises(RecompileError, match="Session.step"):
        sess.step(sess.init_carry(), sess.round_inputs(sched, 0))


def test_session_guard_from_the_environment(monkeypatch):
    monkeypatch.setenv(t_session.GUARD_ENV, "1")
    sess = _quadratic_session()
    assert sess.guard_recompiles
    assert not _quadratic_session(guard_recompiles=False).guard_recompiles
    sess.run(16)
    _capture_in(monkeypatch, t_rt.ScanFn, "run")
    with pytest.raises(RecompileError):
        sess.run(16)
    monkeypatch.delenv(t_session.GUARD_ENV)
    assert not _quadratic_session().guard_recompiles


def test_unguarded_session_never_guards(monkeypatch):
    sess = _quadratic_session()
    sess.run(16)
    _capture_in(monkeypatch, t_rt.ScanFn, "run")
    sess.run(16)
    assert not sess._steady_sigs


# ------------------------------------------------------------ NaN tripwire


def test_nan_tripwire():
    assert_all_finite({"x": torch.ones(3)}, "fine")
    with pytest.raises(FloatingPointError, match=r"non-finite.*\['x'\]"):
        assert_all_finite({"x": torch.tensor([1.0, float("inf")])}, "agg")
    with pytest.raises(FloatingPointError, match="2 non-finite"):
        assert_all_finite({"a": torch.ones(2),
                           "b": [np.array([np.nan, 1.0, np.inf])]}, "agg")
    with pytest.raises(FloatingPointError):
        maybe_assert_finite({"x": torch.tensor([float("nan")])}, "agg",
                            enabled=True)
    maybe_assert_finite({"x": torch.tensor([float("nan")])}, "agg",
                        enabled=False)
    assert_all_finite({"i": torch.tensor([1, 2]), "m": torch.ones(2) > 0},
                      "ints and bools are exempt")
    assert_all_finite({"i": np.array([1, 2], np.int64)}, "ints are exempt")


def test_tripwire_env(monkeypatch):
    monkeypatch.delenv("REPRO_NAN_TRIPWIRE", raising=False)
    assert not tripwire_enabled()
    monkeypatch.setenv("REPRO_NAN_TRIPWIRE", "on")
    assert tripwire_enabled() and not tripwire_enabled(False)
    with pytest.raises(FloatingPointError):
        maybe_assert_finite({"x": torch.tensor([float("nan")])})
