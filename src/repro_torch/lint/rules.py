"""The rule registry of the port's linter: the JAX package's rules that read
torch code, under its codes.

Each rule is an AST checker registered under a ``JXL00x`` code; it yields
``(node, message)`` pairs, and the engine applies suppressions and
formats. Stdlib only (see the engine's docstring).

- JXL003: f64 host arithmetic feeding integer counts (``math.ceil`` of a
  product, ``int()`` of a product or quotient);
- JXL004: nondeterminism in schedule and replay paths: salted ``hash()``,
  the wall clock in the deterministic layers, set iteration, seedless
  ``np.random``, and, in torch, a draw from the global generator (no
  ``generator=``) or a seeding of it (``torch.manual_seed``);
- JXL006: a ``+-`` spread formatted where nothing in scope handles
  ``n_seeds``.

JXL001, JXL002 and JXL005 key on JAX's tracer and PRNG keys, which torch
code has neither of; on a card their hazards are caught at run time
(each captured graph replays under ``torch.cuda.set_sync_debug_mode(
"error")``, and ``torch.func.vmap`` refuses data-dependent control flow).
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Dict, Iterator, List, Tuple

RuleHit = Tuple[ast.AST, str]


@dataclasses.dataclass(frozen=True)
class Rule:
    code: str
    summary: str
    check: Callable[[ast.Module, str], Iterator[RuleHit]]


RULES: Dict[str, Rule] = {}


def rule(code: str, summary: str):
    def register(fn: Callable[[ast.Module, str], Iterator[RuleHit]]) -> Rule:
        r = Rule(code, summary, fn)
        RULES[code] = r
        return r

    return register


def _attr_chain(node: ast.AST) -> List[str]:
    """``torch.cuda.manual_seed`` -> ["torch", "cuda", "manual_seed"]; []
    for chains that do not start at a name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return []


def _call_name(call: ast.Call) -> str:
    chain = _attr_chain(call.func)
    return chain[-1] if chain else ""


# ------------------------------------------------------------------- JXL003


@rule("JXL003", "f64 host arithmetic feeding integer/count math")
def jxl003(tree: ast.Module, path: str) -> Iterator[RuleHit]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if chain[:1] == ["math"] and chain[-1] in ("ceil", "floor", "trunc"):
            yield (node,
                   f"math.{chain[-1]} on a float product picks up f64 "
                   f"representation error at exact boundaries "
                   f"(ceil(0.28 * 25) == 8); use "
                   f"agg_engine.count_ceil/count_floor")
        elif (chain == ["int"] and len(node.args) == 1
              and isinstance(node.args[0], ast.BinOp)
              and isinstance(node.args[0].op, (ast.Mult, ast.Div))):
            yield (node,
                   "int() truncation of a float product/quotient: "
                   "int(0.3 * 10) == 2; use agg_engine.count_floor (nudged) "
                   "or an exact integer formula")


# ------------------------------------------------------------------- JXL004


_DETERMINISTIC_PARTS = ("/core/", "/api/", "/data/", "/checkpoint", "/optim/")
_WALL_CLOCK = {"time", "time_ns", "now", "utcnow", "today"}
_SEEDLESS_NP_RANDOM = {
    "rand", "randn", "random", "randint", "random_integers", "random_sample",
    "choice", "permutation", "shuffle", "normal", "uniform", "standard_normal",
    "seed",
}
# torch's draws that take ``generator=`` and read the global one without it
_TORCH_DRAWS = {
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "rand_like", "randn_like", "randint_like",
}
_TORCH_INPLACE_DRAWS = {"normal_", "uniform_", "bernoulli_", "random_",
                        "exponential_"}
_TORCH_SEEDERS = {"manual_seed", "manual_seed_all"}


def _in_deterministic_layer(path: str) -> bool:
    p = path.replace("\\", "/")
    return any(part in p for part in _DETERMINISTIC_PARTS)


def _global_torch_draw(node: ast.Call, chain: List[str]) -> str:
    """The draw's name when ``node`` reads or seeds torch's global
    generator, else ''. A call with ``generator=`` (or a ``**kw`` that may
    hold one) draws from its own."""
    name = chain[-1] if chain else ""
    if chain[:1] == ["torch"] and len(chain) >= 2 and name in _TORCH_SEEDERS:
        return ".".join(chain)
    if any(kw.arg in ("generator", None) for kw in node.keywords):
        return ""
    if chain[:1] == ["torch"] and len(chain) == 2 and name in _TORCH_DRAWS:
        return ".".join(chain)
    if (isinstance(node.func, ast.Attribute)
            and node.func.attr in _TORCH_INPLACE_DRAWS):
        return f".{node.func.attr}"
    return ""


@rule("JXL004", "nondeterminism in schedule/replay paths")
def jxl004(tree: ast.Module, path: str) -> Iterator[RuleHit]:
    deterministic = _in_deterministic_layer(path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            name = chain[-1] if chain else ""
            draw = _global_torch_draw(node, chain)
            if chain == ["hash"] and node.args:
                yield (node,
                       "hash() is salted per process (PYTHONHASHSEED), so "
                       "a seed derived from it differs between runs; derive "
                       "seeds from explicit integers "
                       "(torch.Generator().manual_seed(seed))")
            elif (deterministic and len(chain) >= 2 and chain[-2] == "time"
                  and name in _WALL_CLOCK):
                yield (node,
                       f"time.{name}() in a deterministic layer: schedules "
                       f"and replay streams must be pure functions of "
                       f"(cfg, seed, T)")
            elif (len(chain) >= 2 and chain[-2] == "random"
                  and chain[0] in ("np", "numpy")
                  and name in _SEEDLESS_NP_RANDOM):
                yield (node,
                       f"seedless np.random.{name}() draws from global "
                       f"mutable state; use np.random.default_rng(seed)")
            elif (name == "default_rng" and len(chain) >= 2
                  and chain[-2] == "random" and not node.args
                  and not node.keywords):
                yield (node,
                       "np.random.default_rng() without a seed is entropy-"
                       "seeded; pass an explicit seed")
            elif draw:
                yield (node,
                       f"{draw}() reads or seeds torch's global generator, "
                       f"shared mutable state; draw from a "
                       f"torch.Generator(device).manual_seed(seed) passed "
                       f"as generator=")
        elif isinstance(node, ast.For):
            it = node.iter
            is_set_iter = isinstance(it, (ast.Set, ast.SetComp)) or (
                isinstance(it, ast.Call) and _call_name(it) == "set")
            if is_set_iter:
                yield (it,
                       "iteration over a set: element order depends on the "
                       "per-process hash seed for str keys; sort it or use "
                       "dict.fromkeys for ordered dedup")


# ------------------------------------------------------------------- JXL006


def _enclosing_scopes(tree: ast.Module) -> Dict[ast.AST, ast.AST]:
    """Map each node to its nearest enclosing function (module as fallback)."""
    scope_of: Dict[ast.AST, ast.AST] = {}

    def visit(node: ast.AST, scope: ast.AST) -> None:
        scope_of[node] = scope
        child_scope = (node if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef)) else scope)
        for child in ast.iter_child_nodes(node):
            visit(child, child_scope)

    visit(tree, tree)
    return scope_of


def _mentions_n_seeds(scope: ast.AST) -> bool:
    for node in ast.walk(scope):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if "n_seeds" in node.value:
                return True
        elif isinstance(node, ast.Name) and node.id == "n_seeds":
            return True
        elif isinstance(node, ast.Attribute) and node.attr == "n_seeds":
            return True
    return False


@rule("JXL006", "'+-' spread formatted with no n_seeds handling in scope")
def jxl006(tree: ast.Module, path: str) -> Iterator[RuleHit]:
    """An f-string that renders a spread after ``+-`` (or ``±``) is an error
    bar. One computed from a length-1 sample prints ``+-0.000``: typography
    posing as statistics. A formatter that handles the degenerate case
    talks about ``n_seeds`` somewhere in the same function (to branch on it
    or to report it beside the spread); one that never mentions it cannot
    be guarding, so it is flagged."""
    scope_of = _enclosing_scopes(tree)
    guarded: Dict[ast.AST, bool] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.JoinedStr):
            continue
        parts = node.values
        for lit, nxt in zip(parts, parts[1:]):
            if not (isinstance(lit, ast.Constant)
                    and isinstance(lit.value, str)
                    and (lit.value.endswith("+-") or lit.value.endswith("±"))
                    and isinstance(nxt, ast.FormattedValue)):
                continue
            scope = scope_of.get(node, tree)
            if scope not in guarded:
                guarded[scope] = _mentions_n_seeds(scope)
            if guarded[scope]:
                continue
            yield (node,
                   "f-string renders a '+-' spread but the enclosing scope "
                   "never mentions n_seeds: a single-seed sample prints a "
                   "fake '+-0.000' error bar; carry n_seeds in the output "
                   "and omit the spread when n_seeds == 1")
            break
