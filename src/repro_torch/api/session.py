"""The session driver API: one entry point over every driver, the port of the
JAX package's ``api/session.py``.

A ``Session`` binds what the ``run_*`` drivers take one by one (grad_fn,
initial params, optimizer, config, switcher, batch sampler, seed) and runs
the round loop at every granularity:

- ``init_carry()`` / ``step(carry, round_inputs)``: one round at a time,
  through the round the compiled driver runs: eager on the CPU, and on a
  card the replay of the same level graph (``ScanFn.run_round``), so rounds
  driven one at a time give the bits of the same rounds inside ``run(T)``;
- ``run(T)``: the compiled driver (``driver="scan"``) or the per-round one
  (``"legacy"``), exactly as ``run_dynabro_scan`` / ``run_dynabro`` /
  ``run_momentum_scan`` / ``run_momentum``;
- ``sweep(spec, T)``: the lane-batched sweep over a ``SweepSpec``
  (``run_dynabro_scan_sweep`` wraps it), and ``sweep_halving(spec, T,
  objective=...)``, the successive-halving sweep that prunes cells at rungs.

The compiled machinery (``make_*_scan_fn``, the schedules, the lane plans)
stays in ``core.robust_train``, called through the module (``rt.``).

The ``random`` attack draws from one generator a run (``core/attacks.py``),
so a round's noise depends on the draws of the rounds before it. When the
session's attack draws, the carry holds the generator's state at the start
of the next round as its last entry (``torch.Generator.get_state()``, a CPU
uint8 tensor): ``step`` sets the generator to it, and a checkpoint of the
carry saves it, so a resumed run draws what the uninterrupted one draws.
Every other carry is the JAX package's ``(params, opt_state)`` /
``(params, worker_momenta)``, and a checkpoint of it loads in either
package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import os
from typing import Any, Callable, Dict, List, Mapping, Optional, Set, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.api.specs import SweepSpec
from repro_torch.core import attacks as attacks_lib
from repro_torch.core import robust_train as rt
from repro_torch.core import sharded
from repro_torch.core.switching import Switcher
from repro_torch.lint import runtime as sanitizers
from repro_torch.optim.optimizers import Optimizer

GUARD_ENV = "REPRO_RECOMPILE_GUARD"


@dataclasses.dataclass(frozen=True)
class RoundSchedule:
    """The host round schedule of ``T`` rounds: the levels and masks the
    compiled driver runs, for callers that drive rounds one at a time.
    Momentum-mode schedules have ``n_max == 1`` and masks of shape (T, m);
    DynaBRO masks are (T, n_max, m) within-round masks.

    ``keys`` is (T, 2) int64, row t ``(s, t)``: the seed s of the run's
    ``random``-attack generator (``seed * 100_003``, or ``seed * 77_003`` in
    momentum mode) and the round. It stands where the JAX package keeps
    round t's threefry key (``PRNGKey(s + t)``): here round t's noise is the
    draw of that generator after the draws of rounds 0..t-1, and the carry
    holds the generator's position (module docstring)."""

    T: int
    levels: np.ndarray  # (T,) MLMC level plan (zeros in momentum mode)
    ns: np.ndarray      # (T,) per-round unit counts
    n_max: int
    masks: np.ndarray   # (T, n_max, m) bool, or (T, m) in momentum mode
    keys: np.ndarray    # (T, 2) int64: (generator seed, round)


@dataclasses.dataclass
class RoundInputs:
    """Everything one round consumes: ``batches``, the n_max-padded batch
    tree (leading (m, n_max) axes; momentum mode: (m,) unit batches);
    ``masks``, the round's Byzantine-identity mask, which a caller may
    change (a timed-out worker is a Byzantine one); ``key``, the round's
    ``RoundSchedule.keys`` row."""

    t: int
    level: int
    batches: Any
    masks: Any  # (n_max, m) bool, or (m,) in momentum mode
    key: Any    # (2,) int64


@dataclasses.dataclass
class StepInfo:
    """Per-round diagnostics of ``step``: the fail-safe verdict and the
    correction norm (None in momentum mode, which has neither)."""

    failsafe_ok: Optional[bool] = None
    corr_norm: Optional[float] = None


class Session:
    """One bound training session; see the module docstring. Use
    ``build_session`` (or the ``run_*`` drivers) rather than spelling out
    every field.

    ``mode`` is ``"dynabro"`` (Algorithm 2; needs ``opt``) or ``"momentum"``
    (the worker-momentum baseline; needs ``lr``/``beta``). ``microbatch``
    streams each round's units (``make_dynabro_scan_fn``; the model zoo's
    path), and a ``scan_fn`` given must be built with the same.
    ``mesh`` (a 1-axis worker mesh, ``launch.mesh.make_worker_mesh``) runs
    the compiled driver and ``step`` sharded over ``worker_axis``
    (``make_dynabro_scan_fn``); it needs the worker count (``switcher=`` or
    ``m=``), divisible by the axis, and the per-round driver refuses it. A
    2-axis ``(workers, 'model')`` mesh (dynabro mode) takes the GSPMD path
    with ``param_specs`` (``launch.sharding.plan_params``'s): there
    ``init_carry`` places the params per their specs, so its carries, and
    ``step``'s, hold this rank's blocks (``scan_fn.full(carry[0])`` gathers
    the full params), while ``run`` returns full params.
    ``guard_recompiles`` (None: the ``REPRO_RECOMPILE_GUARD`` env var,
    '1'/'true'/'on') runs each ``step`` and compiled ``run`` whose
    signature was seen before under ``lint.runtime.recompile_guard``: the
    first call with a signature is warmup and may capture; a later one that
    captures a level graph (or builds a kernel) raises ``RecompileError``.
    A signature holds the call's shapes and dtypes and, unlike the JAX
    package's, the MLMC level(s) it runs (the level for ``step``, the
    schedule's set of levels for ``run``): each level is its own graph,
    captured at its first use, where the JAX step compiles once for every
    level. The sweeps are not guarded (the halving captures its shrunk
    batches anew at each rung). ``nan_tripwire`` (None: the
    ``REPRO_NAN_TRIPWIRE`` env var) reads the params back after each step
    and run and raises on a non-finite value.
    """

    def __init__(self, cfg, *, grad_fn, params0, opt: Optional[Optimizer] = None,
                 switcher: Optional[Switcher] = None,
                 sample_batches: Optional[Callable[[int, int], Any]] = None,
                 seed: int = 0, mode: str = "dynabro",
                 lr: Optional[float] = None, beta: Optional[float] = None,
                 scan_fn=None, vectorize_batches: bool = True,
                 mesh=None, worker_axis: str = "workers", param_specs=None,
                 microbatch: bool = False, m: Optional[int] = None,
                 guard_recompiles: Optional[bool] = None,
                 nan_tripwire: Optional[bool] = None,
                 sampler_factory: Optional[Callable[[int], Any]] = None):
        if mode not in ("dynabro", "momentum"):
            raise ValueError(
                f"unknown session mode {mode!r}; expected 'dynabro' or "
                f"'momentum'")
        if mode == "dynabro" and opt is None:
            raise ValueError("dynabro sessions need opt= (an Optimizer)")
        if mode == "momentum" and (lr is None or beta is None):
            raise ValueError("momentum sessions need lr= and beta=")
        rt._check_param_specs(mesh, param_specs)
        self.cfg = cfg
        self.grad_fn = grad_fn
        self.params0 = params0
        self.opt = opt
        self.switcher = switcher
        self.sample_batches = sample_batches
        self.sampler_factory = sampler_factory
        self.seed = seed
        self.mode = mode
        self.lr, self.beta = lr, beta
        self.vectorize_batches = vectorize_batches
        self.mesh = mesh
        self.worker_axis = worker_axis
        self.param_specs = param_specs
        self.microbatch = microbatch
        self.m = m if m is not None else (switcher.m if switcher else None)
        # runtime sanitizers: the recompile guard asserts a signature seen
        # once never captures again (the service inherits it through step);
        # the NaN tripwire reads the params back. Both default to their env
        # opt-ins (REPRO_RECOMPILE_GUARD / REPRO_NAN_TRIPWIRE).
        if guard_recompiles is None:
            guard_recompiles = os.environ.get(GUARD_ENV, "").lower() in (
                "1", "true", "on")
        self.guard_recompiles = guard_recompiles
        self.nan_tripwire = nan_tripwire
        self._steady_sigs: Set[Tuple] = set()
        if mesh is not None:
            if self.m is None:
                raise ValueError("mesh= needs a worker count: pass switcher= "
                                 "or m=")
            rt._check_worker_mesh(mesh, worker_axis, self.m,
                                  allow_model=(mode == "dynabro"))
        if scan_fn is not None:
            if mode == "dynabro":
                for lane_kind in ("lane_attacks", "lane_aggregators"):
                    if getattr(scan_fn, lane_kind, None) is not None:
                        raise ValueError(
                            f"scan_fn was built with {lane_kind}="
                            f"{getattr(scan_fn, lane_kind)!r}; that variant "
                            f"is for run_dynabro_scan_sweep(...), not "
                            f"run_dynabro_scan")
            rt._check_scan_fn_mesh(scan_fn, mesh)
            if mode == "dynabro":
                rt._check_scan_fn_microbatch(scan_fn, microbatch)
        self._scan_fn = scan_fn
        self._schedules: Dict[int, RoundSchedule] = {}
        self._lane_fns: Dict[Tuple, Any] = {}
        # the random attack reads the run's generator: its state rides in
        # the carry (module docstring)
        self._draws = cfg.attack in attacks_lib.STACK_ATTACKS

    # ------------------------------------------------------------ pieces

    @property
    def scan_fn(self):
        """The session's compiled round loop, built on first use."""
        if self._scan_fn is None:
            if self.mode == "dynabro":
                self._scan_fn = rt.make_dynabro_scan_fn(
                    self.grad_fn, self.cfg, self.opt, mesh=self.mesh,
                    worker_axis=self.worker_axis,
                    param_specs=self.param_specs, microbatch=self.microbatch)
            else:
                self._scan_fn = rt.make_momentum_scan_fn(
                    self.grad_fn, self.cfg, self.lr, self.beta,
                    mesh=self.mesh, worker_axis=self.worker_axis)
        return self._scan_fn

    def _generator_seed(self, seed: int) -> int:
        return seed * (rt.DYNABRO_SEED if self.mode == "dynabro"
                       else rt.MOMENTUM_SEED)

    def schedule(self, T: int) -> RoundSchedule:
        """The full host round schedule (cached per T): the compiled
        driver's, so rounds driven one at a time and ``run(T)`` draw from
        one stream."""
        sched = self._schedules.get(T)
        if sched is not None:
            return sched
        if self.switcher is None:
            raise ValueError("schedules need a switcher; build the session "
                             "with switcher=")
        if self.mode == "dynabro":
            levels, ns, n_max = rt._level_plan(
                self.cfg, np.random.default_rng(self.seed), T)
            masks = rt._mask_schedule(self.switcher, T, n_max, ns)
        else:
            levels = np.zeros(T, np.int32)
            ns = np.ones(T, np.int64)
            n_max = 1
            masks = np.stack([self.switcher.mask(t) for t in range(T)])
        keys = np.stack([np.full(T, self._generator_seed(self.seed), np.int64),
                         np.arange(T, dtype=np.int64)], -1)
        sched = RoundSchedule(T, levels, ns, n_max, masks, keys)
        self._schedules[T] = sched
        return sched

    def init_carry(self):
        """The carry at round 0: ``(params, opt_state)`` (dynabro) or
        ``(params, worker_momenta)`` (momentum), followed, when the attack
        draws, by the generator's state at round 0. On the GSPMD path the
        params are placed per their specs: the rank's blocks, and the
        optimizer state of those."""
        params = self.params0
        if self.mode == "dynabro":
            if self.mesh is not None and "model" in self.mesh.axis_names:
                params = self.scan_fn.place(params)
            carry = (params, self.opt.init(params))
        else:
            carry = (params, rt._zero_momenta(params, self.m))
        if not self._draws:
            return carry
        dev = rt._device_of(params)
        gen = torch.Generator(device=dev).manual_seed(
            self._generator_seed(self.seed))
        return carry + (gen.get_state(),)

    def round_inputs(self, sched: RoundSchedule, t: int) -> RoundInputs:
        """Round ``t``'s inputs from the schedule: the sampler's batch for
        round t, padded to n_max units as the compiled driver pads it, and
        the round's masks and key."""
        n = int(sched.ns[t])
        if self.mode == "dynabro":
            batches = rt._pad_units(self.sample_batches(t, n), sched.n_max,
                                    axis=1)
            return RoundInputs(t, int(sched.levels[t]), batches,
                               sched.masks[t], sched.keys[t])
        batches = tree_map(lambda l: l[:, 0], self.sample_batches(t, 1))
        return RoundInputs(t, 0, batches, sched.masks[t], sched.keys[t])

    def _steady_guard(self, tag: str, levels, xs, label: str):
        """A ``recompile_guard`` once this (tag, levels, xs shapes/dtypes)
        signature has been seen (the first call with a signature is warmup:
        it may capture), else a null context that records the signature."""
        if not self.guard_recompiles:
            return contextlib.nullcontext()
        shapes = tuple((tuple(l.shape), str(l.dtype)) if hasattr(l, "shape")
                       else l for l in tree_leaves(xs))
        sig: Tuple = (tag, self.mode, tuple(levels)) + shapes
        if sig in self._steady_sigs:
            return sanitizers.recompile_guard(label)
        self._steady_sigs.add(sig)
        return contextlib.nullcontext()

    def step(self, carry, inputs: RoundInputs):
        """Advance one round: the round of the compiled driver at the
        round's level (on a card the replay of the level's graph that
        ``run`` replays, captured once), bitwise equal to the same round
        inside ``run``. Returns ``(carry, StepInfo)``; reads the flag and
        the correction norm back to the host."""
        dev = rt._device_of(carry[0])
        state = carry[2] if self._draws else None
        masks = torch.as_tensor(np.asarray(inputs.masks), device=dev)
        level = int(inputs.level)
        with self._steady_guard("step", (level,), (inputs.batches, masks),
                                f"Session.step (round {inputs.t})"):
            core, ok, dn, state = self.scan_fn.run_round(
                carry[:2], level, inputs.batches, masks, state)
        carry = core + ((state,) if self._draws else ())
        sanitizers.maybe_assert_finite(
            carry[0], f"Session.step round {inputs.t}", self.nan_tripwire)
        if self.mode == "dynabro":
            return carry, StepInfo(failsafe_ok=bool(ok), corr_norm=float(dn))
        return carry, StepInfo()

    # ------------------------------------------------------------ drivers

    def run(self, T: int, *, eval_fn=None, eval_every: int = 0,
            chunk: int = 0, driver: str = "scan", step=None):
        """The whole-``T`` drivers: ``driver="scan"`` the compiled one
        (``run_dynabro_scan`` / ``run_momentum_scan`` with the session's
        scan_fn, whose graphs ``step`` replays), ``"legacy"`` the per-round
        one (``run_dynabro`` / ``run_momentum``). Returns ``(params, logs,
        evals)`` in dynabro mode and ``(params, evals)`` in momentum mode."""
        if driver not in ("scan", "legacy"):
            raise ValueError(
                f"unknown driver {driver!r}; expected 'scan' or 'legacy'")
        if driver == "legacy" and self.mesh is not None:
            raise ValueError("the legacy per-round driver runs unsharded;"
                             " drop mesh= or use driver='scan'")
        common = dict(seed=self.seed, eval_fn=eval_fn, eval_every=eval_every)
        sharding = dict(mesh=self.mesh, worker_axis=self.worker_axis)
        if self.mode == "dynabro":
            sharding["param_specs"] = self.param_specs
            if driver == "legacy":
                out = rt.run_dynabro(self.grad_fn, self.params0, self.opt,
                                     self.cfg, self.switcher,
                                     self.sample_batches, T, step=step,
                                     **common)
            else:
                with self._run_guard(T, eval_fn, eval_every, chunk):
                    out = rt.run_dynabro_scan(
                        self.grad_fn, self.params0, self.opt, self.cfg,
                        self.switcher, self.sample_batches, T, chunk=chunk,
                        scan_fn=self.scan_fn, microbatch=self.microbatch,
                        vectorize_batches=self.vectorize_batches,
                        **sharding, **common)
        elif driver == "legacy":
            out = rt.run_momentum(self.grad_fn, self.params0, self.cfg,
                                  self.switcher, self.sample_batches, T,
                                  lr=self.lr, beta=self.beta, step=step,
                                  **common)
        else:
            with self._run_guard(T, eval_fn, eval_every, chunk):
                out = rt.run_momentum_scan(
                    self.grad_fn, self.params0, self.cfg, self.switcher,
                    self.sample_batches, T, lr=self.lr, beta=self.beta,
                    chunk=chunk, scan_fn=self.scan_fn,
                    vectorize_batches=self.vectorize_batches, **sharding,
                    **common)
        sanitizers.maybe_assert_finite(
            out[0], f"Session.run ({driver}, T={T})", self.nan_tripwire)
        return out

    def _run_guard(self, T: int, eval_fn, eval_every: int, chunk: int):
        """``_steady_guard`` of a compiled run: its signature is T, its
        segments' bounds and the schedule's set of levels."""
        if not self.guard_recompiles or T <= 0:
            return contextlib.nullcontext()
        levels = sorted({int(j) for j in self.schedule(T).levels})
        bounds = rt._segment_bounds(T, eval_every if eval_fn else 0, chunk)
        return self._steady_guard("run", levels, (T, bounds),
                                  f"Session.run (T={T})")

    # ------------------------------------------------------------- sweep

    def _sampler_for(self, seed: int):
        """The batch sampler of one replicate stream: ``sampler_factory``
        when the session has one, else the bound ``sample_batches``, valid
        only for the session's own seed."""
        if self.sampler_factory is not None:
            return self.sampler_factory(seed)
        if seed == self.seed:
            return self.sample_batches
        raise ValueError(
            "per-replicate batch streams need sampler_factory= (seed -> "
            "sample_batches); build the session with sampler_factory=, or "
            "via build_session with a Task whose make_sampler accepts "
            "sampler_seed=")

    def _sweep_streams(self, spec: SweepSpec, T: int):
        """The host schedules of a sweep: the session seed's level plan, and
        per replicate the masks ((C, T, n_max, m), or (C, R, T, n_max, m)
        when the spec replicates), the generator seed and the sampler."""
        cfg = self.cfg
        C = spec.lanes
        rep_seeds = spec.replicate_seeds(self.seed)
        replicated = spec.n_replicates > 1
        levels, ns, n_max = rt._level_plan(
            cfg, np.random.default_rng(self.seed), T)
        sw_reps = [spec.resolve_switchers(self.m, s) for s in rep_seeds]
        if replicated:
            masks = np.stack([
                np.stack([rt._mask_schedule(sws[c], T, n_max, ns)
                          for sws in sw_reps]) for c in range(C)])
        else:
            masks = np.stack([rt._mask_schedule(sw, T, n_max, ns)
                              for sw in sw_reps[0]])
        gen_seeds = tuple(self._generator_seed(s) for s in rep_seeds)
        samplers = [self._sampler_for(s) for s in rep_seeds]
        return levels, ns, n_max, masks, gen_seeds, samplers, replicated

    def _sweep_batches(self, samplers, a: int, b: int, ns, n_max: int,
                       replicated: bool, row_fn=None):
        """One segment's padded batch schedule (``row_fn`` as in
        ``_batch_schedule``); with replicates the replicates' schedules
        stack on axis 1, after the rounds'."""
        tn = list(zip(range(a, b), ns[a:b]))
        if not replicated:
            return rt._batch_schedule(samplers[0], tn, n_max,
                                      vectorize=self.vectorize_batches,
                                      row_fn=row_fn)
        per_rep = [rt._batch_schedule(s, tn, n_max,
                                      vectorize=self.vectorize_batches,
                                      row_fn=row_fn)
                   for s in samplers]
        return tree_map(lambda *ls: torch.stack(ls, 1), *per_rep)

    def _sweep_scan_fn(self, spec_scan_fn, atk_names, agg_names, lm):
        """The sweep's lane scan_fn: built (and kept by the session, so a
        later sweep with the same names replays its graphs) or, when the
        spec carries one, checked against the names this sweep derives and
        against the (normalized) lane mesh ``lm``."""
        if spec_scan_fn is None:
            key = (atk_names, agg_names) + (() if lm is None else (lm,))
            fn = self._lane_fns.get(key)
            if fn is None:
                fn = rt.make_dynabro_scan_fn(
                    self.grad_fn, self.cfg, self.opt, lane_attacks=atk_names,
                    lane_aggregators=agg_names, sweep_mesh=lm,
                    worker_axis=self.worker_axis)
                if not fn.lanes:
                    fn = fn.lane_form()
                self._lane_fns[key] = fn
            return fn
        scan_fn = spec_scan_fn
        if getattr(scan_fn, "worker_mesh", None) is not None:
            raise ValueError(
                "scan_fn was built with mesh=; vmapped sweeps run "
                "unsharded (DESIGN.md §7) — rebuild it without mesh")
        have_sm = rt._norm_mesh(getattr(scan_fn, "sweep_mesh", None))
        if have_sm != lm:
            raise ValueError(
                f"scan_fn was built with sweep_mesh={have_sm}, but this "
                f"sweep passes lane_mesh={lm}; rebuild it with "
                f"make_dynabro_scan_fn(..., sweep_mesh=...) to match")
        # the lane ids index the names: a scan_fn built with other names
        # (or another order) would run the wrong attack or rule on a lane
        for kind, want, arg in (
                ("lane_attacks", atk_names, "attacks"),
                ("lane_aggregators", agg_names, "aggregators")):
            have = getattr(scan_fn, kind, None)
            if have == want:
                continue
            if want is None:
                raise ValueError(
                    f"scan_fn was built with {kind}={have!r} but this "
                    f"sweep passes no {arg}; rebuild it without {kind} "
                    f"(or pass the per-lane {arg})")
            raise ValueError(
                f"scan_fn was built with {kind}={have!r} but this "
                f"sweep's {arg} derive {want!r}; rebuild it with "
                f"make_dynabro_scan_fn(..., {kind}={want!r})")
        if not getattr(scan_fn, "lanes", False):
            if not hasattr(scan_fn, "lane_form"):
                raise ValueError("scan_fn has no lane form: pass a "
                                 "make_dynabro_scan_fn result")
            scan_fn = scan_fn.lane_form()
        return scan_fn

    def _check_sweep_lane_mesh(self, lane_mesh, lane_axis: str, C: int):
        if lane_mesh is None:
            return
        rt._check_lane_mesh(lane_mesh, lane_axis, self.worker_axis, self.m)
        n_lanes = lane_mesh.shape[lane_axis]
        if C % n_lanes:
            raise ValueError(
                f"sweep cell count C={C} not divisible by the "
                f"{lane_axis!r} mesh axis size {n_lanes}")

    @staticmethod
    def _lane_block(lm, lane_axis: str, C: int) -> List[int]:
        """The cells of a C-cell grid this rank runs: its block on the lane
        axis of ``lm`` (all of them without one)."""
        n = 1 if lm is None else lm.shape[lane_axis]
        if n == 1:
            return list(range(C))
        k = C // n
        r = lm.coordinate(lane_axis)
        return list(range(r * k, (r + 1) * k))

    @staticmethod
    def _gather_lanes(obj, lm, lane_axis: str, dev) -> list:
        """Every rank's ``obj`` (results of its cells) along the lane axis of
        ``lm``, in rank order, its tensors on ``dev`` (they cross through
        the host, bitwise)."""
        if lm is None or lm.shape[lane_axis] == 1:
            return [obj]

        def to(x, d):
            return x.to(d) if isinstance(x, torch.Tensor) else x
        got = sharded.gather_objects(tree_map(lambda x: to(x, "cpu"), obj),
                                     lm, lane_axis)
        return [tree_map(lambda x: to(x, dev), o) for o in got]

    def sweep(self, spec: SweepSpec, T: int, *, chunk: int = 0,
              lane_chunk: int = 0, lane_mesh=None,
              lane_axis: str = "lanes") -> List[Any]:
        """Run ``spec.lanes`` cells as lanes of one compiled loop
        (``run_dynabro_scan_sweep`` describes the lanes and their contract).
        Mixed-rule grids run one sub-sweep per distinct rule; results come
        back in the caller's lane order, ``[(params, logs), ...]``.

        With spec ``seeds=`` / ``replicates=`` every cell runs one lane per
        replicate seed: masks, ``random``-attack generator and batch draws
        (through ``sampler_factory``) follow the replicate seed, the level
        plan stays the session seed's, and the result is a list over cells
        of per-replicate ``(params, logs)`` lists.

        ``lane_chunk`` runs the grid in chunks of at most that many cells
        (each lane's result is the same).

        ``lane_mesh`` (a 2-axis ``launch.mesh.make_lane_mesh`` mesh; every
        rank calls this with the same arguments) splits the cells over
        ``lane_axis`` in blocks, C divisible by it, and each cell's workers
        over the worker axis (``make_dynabro_scan_fn(sweep_mesh=)``); the
        results are gathered over the lane axis, so every rank returns every
        cell's. A lane's bits do not depend on the lanes beside it, so each
        equals the unsharded sweep's where the worker axis is 1; a mesh of
        one device is bitwise the unsharded sweep."""
        if self.mode != "dynabro":
            raise ValueError("sweeps are dynabro-mode only")
        spec = spec if isinstance(spec, SweepSpec) else SweepSpec(**spec)
        C = spec.lanes
        R = spec.n_replicates
        if C == 0:
            return []
        if T <= 0:
            return [[(self.params0, [])] * R for _ in range(C)] if R > 1 \
                else [(self.params0, []) for _ in range(C)]
        self._check_sweep_lane_mesh(lane_mesh, lane_axis, C)
        lm = rt._norm_mesh(lane_mesh)
        cells = self._lane_block(lm, lane_axis, C)
        if len(cells) < C:
            spec = spec.lane_subset(cells, scan_fn=spec.scan_fn)
        outs = self._sweep(spec, T, chunk, lane_chunk, lm)
        return [o for part in self._gather_lanes(
            outs, lm, lane_axis, rt._device_of(self.params0)) for o in part]

    def _sweep(self, spec: SweepSpec, T: int, chunk: int, lane_chunk: int,
               lm) -> List[Any]:
        """``sweep``'s grid on this rank, T >= 1, the lanes sharded over
        ``lm``'s worker axis."""
        cfg, opt, params = self.cfg, self.opt, self.params0
        C = spec.lanes
        R = spec.n_replicates
        replicated = R > 1
        if lane_chunk and lane_chunk > 0 and C > lane_chunk:
            outs: List[Any] = []
            for a in range(0, C, lane_chunk):
                sub = spec.lane_subset(range(a, min(a + lane_chunk, C)),
                                       scan_fn=spec.scan_fn)
                outs.extend(self._sweep(sub, T, chunk, 0, lm))
            return outs

        attacks = spec.attack_lanes()
        aggregators = spec.agg_lanes()
        scan_fn = spec.scan_fn

        # one sub-sweep per distinct rule, in first-appearance order, the
        # results scattered back to the caller's lane order
        group_fns = None
        if isinstance(scan_fn, Mapping):
            if aggregators is None:
                raise ValueError(
                    "scan_fn given as a {rule_name: scan_fn} mapping but "
                    "this sweep passes no aggregators to group by")
            group_fns = scan_fn
        if aggregators is not None:
            distinct = tuple(dict.fromkeys(name for name, _ in aggregators))
            if group_fns is not None and not set(distinct) <= set(group_fns):
                raise ValueError(
                    f"scan_fn mapping keys {sorted(group_fns)} do not cover "
                    f"the grid's distinct aggregator names "
                    f"{sorted(distinct)}")
            if len(distinct) > 1 and (scan_fn is None
                                      or group_fns is not None):
                outs = [None] * C
                for name in distinct:
                    idx = [c for c in range(C) if aggregators[c][0] == name]
                    sub = self._sweep(
                        spec.lane_subset(
                            idx, scan_fn=(None if group_fns is None
                                          else group_fns[name])),
                        T, chunk, 0, lm)
                    for j, c in enumerate(idx):
                        outs[c] = sub[j]
                return outs
            if group_fns is not None:
                scan_fn = group_fns[distinct[0]]

        (levels, ns, n_max, masks, gen_seeds, samplers,
         replicated) = self._sweep_streams(spec, T)
        (atk_names, agg_names), plan = rt.make_lane_plan(
            cfg, C, attacks, aggregators)
        scan_fn = self._sweep_scan_fn(scan_fn, atk_names, agg_names, lm)
        if replicated:
            plan = plan.repeat(R)

        def lanes(tree):  # the same start in every lane
            return tree_map(
                lambda l: l.expand((C * R,) + l.shape).clone(), tree)

        carry = (lanes(params), lanes(opt.init(params)))
        lane_masks = masks.reshape((C * R,) + masks.shape[-3:])
        params_out, ok, _ = scan_fn.run(
            carry, levels, np.ascontiguousarray(np.swapaxes(lane_masks, 0, 1)),
            lambda a, b, row_fn=None: self._sweep_batches(
                samplers, a, b, ns, n_max, replicated, row_fn),
            rt._segment_bounds(T, 0, chunk), gen_seeds, lane=plan)
        results = [(tree_map(lambda l, c=c: l[c].clone(), params_out),
                    rt._round_logs(levels, ok[:, c], lane_masks[c],
                                   cfg.mlmc.j_max))
                   for c in range(C * R)]
        if not replicated:
            return results
        return [results[c * R:(c + 1) * R] for c in range(C)]

    def sweep_halving(self, spec: SweepSpec, T: int, *,
                      objective: Callable[[Any], float],
                      keep: float = 0.5, rungs=None, lane_mesh=None,
                      lane_axis: str = "lanes",
                      min_cells: int = 1) -> List[Dict[str, Any]]:
        """Adaptive successive-halving sweep: run every cell, and at each
        rung boundary prune the worst cells, scored by the mean of
        ``objective(params)`` (lower is better) over the cell's replicate
        lanes, keeping a ``keep`` fraction (at least ``min_cells``; NaN
        scores prune first; the sort is stable). Survivors continue from
        their carries and generator states, sliced to the surviving lanes,
        so a survivor's trajectory is bitwise identical to a plain
        ``sweep`` of the surviving subset.

        ``rungs`` is the increasing list of round counts at which to prune
        (default: one prune at ``T // 2``). A mixed-rule grid runs as
        ``sweep`` runs it, one lane batch per distinct rule (on a card the
        level graphs of a batch whose lanes a rung pruned are captured
        anew); the scores are global across the rules. Returns one dict per
        cell, in caller order: ``{"pruned": bool, "rounds_run": int,
        "results": [(params, logs), ...]}`` with one entry per replicate; a
        pruned cell's results are its state at the rung that dropped it.

        ``lane_mesh`` splits the cells over the lane axis and their workers
        over the worker axis as ``sweep`` does; the scores are gathered over
        the lane axis at each rung, and the cells kept there are rounded up
        to a multiple of the lane axis (as the JAX package keeps its lane
        axis divisible). Every rank returns every cell's dict."""
        if self.mode != "dynabro":
            raise ValueError("sweeps are dynabro-mode only")
        spec = spec if isinstance(spec, SweepSpec) else SweepSpec(**spec)
        if isinstance(spec.scan_fn, Mapping):
            raise ValueError(
                "sweep_halving scores a mixed-rule grid across all its "
                "rules; pass a plain scan_fn (or None), not a {rule: "
                "scan_fn} mapping")
        cfg = self.cfg
        C = spec.lanes
        R = spec.n_replicates
        if C == 0:
            return []
        if T <= 0:
            raise ValueError("sweep_halving needs T >= 1")
        if not 0.0 < keep <= 1.0:
            raise ValueError(f"keep= must be in (0, 1], got {keep}")
        if rungs is None:
            rungs = [T // 2] if T >= 2 else []
        rungs = [int(r) for r in rungs]
        if any(not 0 < r < T for r in rungs) or \
                any(b <= a for a, b in zip(rungs, rungs[1:])):
            raise ValueError(
                f"rungs= must be strictly increasing round counts in "
                f"(0, T={T}), got {rungs}")

        attacks = spec.attack_lanes()
        aggregators = spec.agg_lanes()
        (levels, ns, n_max, masks, gen_seeds, samplers,
         replicated) = self._sweep_streams(spec, T)
        masks = masks.reshape((C, R) + masks.shape[-3:])
        j_max = cfg.mlmc.j_max
        dev = tree_leaves(self.params0)[0].device
        self._check_sweep_lane_mesh(lane_mesh, lane_axis, C)
        lm = rt._norm_mesh(lane_mesh)
        n_lanes = 1 if lm is None else lm.shape[lane_axis]
        mine = self._lane_block(lm, lane_axis, C)
        # the lane batches of ``sweep`` over this rank's cells: one per
        # distinct rule, unless a plain scan_fn runs them all
        names = [name for name, _ in aggregators] if aggregators else None
        if names is None or spec.scan_fn is not None:
            batches_of = [mine]
        else:
            batches_of = [[c for c in mine if names[c] == name]
                          for name in dict.fromkeys(names[c] for c in mine)]

        def lanes(tree, n):  # the same start in every lane
            return tree_map(lambda l: l.expand((n,) + l.shape).clone(), tree)

        groups = []
        for cells in batches_of:
            (atk_names, agg_names), plan = rt.make_lane_plan(
                cfg, len(cells),
                None if attacks is None else [attacks[c] for c in cells],
                None if aggregators is None else [aggregators[c] for c in cells])
            n = len(cells) * R
            groups.append({
                "cells": cells,
                "fn": self._sweep_scan_fn(spec.scan_fn, atk_names, agg_names,
                                          lm),
                "plan": plan.repeat(R) if replicated else plan,
                "carry": (lanes(self.params0, n),
                          lanes(self.opt.init(self.params0), n)),
                "seeds": gen_seeds, "oks": []})

        def results(g, j, b):
            """(params, logs) per replicate of the group's j-th live cell
            after round b."""
            ok = np.concatenate(g["oks"])
            cell = g["cells"][j]
            return [(tree_map(lambda l, i=j * R + r: l[i].clone(),
                              g["carry"][0]),
                     rt._round_logs(levels[:b], ok[:, j * R + r],
                                    masks[cell, r], j_max))
                    for r in range(R)]

        outs: List[Optional[Dict[str, Any]]] = [None] * C
        a = 0
        for b in rungs + [T]:
            drawn = {}

            def batches(x, y, row_fn=None):  # one draw for every group
                if (x, y) not in drawn:
                    drawn[(x, y)] = self._sweep_batches(
                        samplers, x, y, ns, n_max, replicated, row_fn)
                return drawn[(x, y)]

            for g in groups:
                if not g["cells"]:
                    continue
                lane_masks = masks[g["cells"]].reshape((-1,) + masks.shape[-3:])
                g["carry"], ok, _ = g["fn"].run(
                    g["carry"], levels,
                    np.ascontiguousarray(np.swapaxes(lane_masks, 0, 1)),
                    batches, [b], g["seeds"], lane=g["plan"], start=a,
                    whole_carry=True)
                g["oks"].append(ok)
                g["seeds"] = tuple(gen.get_state() for gen in
                                   g["fn"].generators(dev, len(gen_seeds)))
            if b == T:
                break
            # prune: the replicate-mean objective over every live cell of
            # every group and every lane rank, in caller order; lower is
            # better
            res = {cell: results(g, j, b) for g in groups
                   for j, cell in enumerate(g["cells"])}
            scored = [(cell, [float(objective(p)) for p, _ in res[cell]])
                      for cell in sorted(res)]
            live = sorted(c for part in self._gather_lanes(
                scored, lm, lane_axis, dev) for c in part)
            finals = np.array([row for _, row in live])
            scores = np.where(np.isnan(finals), np.inf, finals).mean(axis=1)
            k = max(int(min_cells), int(np.ceil(len(live) * keep)))
            if n_lanes > 1:  # keep the lane axis divisible
                k = max(n_lanes, int(np.ceil(k / n_lanes)) * n_lanes)
            k = min(k, len(live))
            order = np.argsort(scores, kind="stable")
            kept = {live[int(i)][0] for i in order[:k]}
            for cell in res:
                if cell not in kept:
                    outs[cell] = {"pruned": True, "rounds_run": b,
                                  "results": res[cell]}
            for g in groups:
                js = [j for j, cell in enumerate(g["cells"]) if cell in kept]
                if len(js) == len(g["cells"]):
                    continue
                idx = [j * R + r for j in js for r in range(R)]
                sel = torch.tensor(idx, dtype=torch.long, device=dev)
                g["carry"] = tree_map(lambda l: l.index_select(0, sel),
                                      g["carry"])
                g["plan"] = g["plan"].take(idx)
                g["oks"] = [o[:, idx] for o in g["oks"]]
                g["cells"] = [g["cells"][j] for j in js]
            a = b
        for g in groups:
            for j, cell in enumerate(g["cells"]):
                outs[cell] = {"pruned": False, "rounds_run": T,
                              "results": results(g, j, T)}
        for part in self._gather_lanes({c: outs[c] for c in mine}, lm,
                                       lane_axis, dev):
            for c, out in part.items():
                outs[c] = out
        return outs


def _task_sampler_factory(task, m: int):
    """A seed -> sampler factory from a Task whose ``make_sampler`` accepts
    ``sampler_seed=`` (the replicate axis's data streams); None when the
    task cannot re-seed its sampler."""
    try:
        params = inspect.signature(task.make_sampler).parameters
    except (TypeError, ValueError):
        return None
    if "sampler_seed" not in params:
        return None
    return lambda s: task.make_sampler(m, sampler_seed=s)


def build_session(cfg, task=None, *, m: Optional[int] = None,
                  switcher: Optional[Switcher] = None, **kw) -> Session:
    """The facade constructor: ``build_session(cfg, task) -> Session``.

    ``task`` (a ``scenarios.Task``) supplies ``grad_fn`` / ``params0`` and,
    given a worker count through ``m=`` or ``switcher=``, the batch sampler
    (and, when ``task.make_sampler`` accepts ``sampler_seed=``, the
    per-replicate ``sampler_factory`` of the sweep's seed axis); any Session
    keyword overrides or extends it. Without a task, pass ``grad_fn=`` /
    ``params0=`` / ``sample_batches=``."""
    if m is None and switcher is not None:
        m = switcher.m
    if task is not None:
        kw.setdefault("grad_fn", task.grad_fn)
        kw.setdefault("params0", task.params0)
        if m is not None:
            kw.setdefault("sample_batches", task.make_sampler(m))
            factory = _task_sampler_factory(task, m)
            if factory is not None:
                kw.setdefault("sampler_factory", factory)
    return Session(cfg, switcher=switcher, m=m, **kw)
