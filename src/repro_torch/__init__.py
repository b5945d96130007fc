"""repro_torch — the PyTorch/CUDA port of the JAX package ``repro``.

It mirrors ``repro``'s layout and runs on an NVIDIA GPU by default; pass
``device="cpu"`` to run it on the CPU, where every kernel wrapper computes
its plain PyTorch version. It imports nothing of JAX or of ``repro``.

Ported so far: Algorithm 2 (MLMC + fail-safe, Options 1 and 2) and the
worker-momentum baseline, each through the per-round driver and the compiled
whole-T driver (one CUDA graph per MLMC level on a card), with every class
rule of the JAX package: the
coordinate-wise rules (Mean, CWMed, CWTM) on the CUDA kernel
``kernels/csrc/cw_reduce.cu``, and the geometry rules (Krum, GeoMed, MFM and
``nnm+<base>``) on ``kernels/csrc/sqdist.cu`` (pairwise and cross squared
distances) and ``kernels/csrc/combine.cu`` (weighted combine, mix+reduce);
every attack, every switching strategy and every optimizer, on the
Gaussian-mixture MLP task.
"""
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import (
    DynaBROConfig, MLMCConfig, RoundLog, get_aggregator, get_attack,
    get_switcher, make_dynabro_scan_fn, make_dynabro_step,
    make_momentum_scan_fn, make_momentum_step, run_dynabro, run_dynabro_scan,
    run_momentum, run_momentum_scan,
)
from repro_torch.data import make_task
from repro_torch.device import resolve_device
from repro_torch.kernels import LAUNCHES
from repro_torch.optim import adagrad_norm, adam, momentum, sgd

__all__ = ["params_from_numpy", "params_to_numpy", "DynaBROConfig",
           "MLMCConfig", "RoundLog", "get_aggregator", "get_attack",
           "get_switcher", "make_dynabro_scan_fn", "make_dynabro_step",
           "make_momentum_scan_fn", "make_momentum_step", "run_dynabro",
           "run_dynabro_scan", "run_momentum", "run_momentum_scan", "make_task",
           "resolve_device", "LAUNCHES", "adagrad_norm", "adam", "momentum",
           "sgd"]
