"""Wrappers of the hand-written CUDA kernels of ``csrc/``:

  * ``cw_reduce.cu``: the coordinate-wise reduce, each column of an (m, d)
    stack sorted across its m rows and reduced to one float32, over every
    leaf of a parameter tree in one launch (``tree_cw_reduce``; ``cw_reduce``,
    ``cwmed``, ``cwtm`` and ``cwtm_masked`` are its one-leaf forms), with the
    trim a value or an int32 on the card that the kernel reads, and over
    every leaf of every lane of a sweep in one launch, a trim a lane
    (``tree_cw_reduce_lanes``);
  * ``sqdist.cu``: the (m, m) pairwise squared distances
    (``pairwise_sqdist``) and the (m, k) cross squared distances
    (``cross_sqdist``);
  * ``combine.cu``: the weighted combine ``w @ x`` (``weighted_combine``)
    and its mix-then-reduce form (``combine_reduce``, with the trim a value
    or an int32 on the card), and both over every leaf of a parameter tree
    in one launch (``tree_weighted_combine``, ``tree_combine_reduce``).

Together they are the CUDA counterpart of the JAX package's two Pallas
kernels, ``repro/kernels/fused.py::fused_pass`` (every stage) and
``::cross_sqdist``; ``fused_pass`` below takes the same requests. Each source
file's header gives its kernel's design and what bounds it.

On a CUDA tensor a wrapper launches its kernel, or raises. On a CPU tensor,
and only there, it computes the plain version in ``kernels/ref.py``. Every
call that launches adds one to its own key of ``LAUNCHES``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as kref

REDUCE_MODES = ("med", "tm", "mean")
MAX_ROWS = 64  # the register-resident sorts and accumulators go to 64
LAUNCHES = {"cw_reduce": 0, "pairwise_sqdist": 0, "cross_sqdist": 0,
            "weighted_combine": 0, "combine_reduce": 0}

_KERNEL_MODE = {"med": 0, "tm": 0, "mean": 1, None: -1}
_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
_PP, _IP = ctypes.POINTER(_P), ctypes.POINTER(_I)
_SIGNATURES = {
    "cw_reduce": {"cw_reduce_launch": [_PP, _PP, _IP, _IP] + [_I] * 5
                  + [_P, _I, _I, _I, _P]},
    "sqdist": {"pairwise_sqdist_launch": [_P, _P, _P, _P] + [_I] * 5 + [_P],
               "cross_sqdist_launch": [_P] * 5 + [_I] * 6 + [_P]},
    "combine": {"combine_launch": [_PP, _PP, _PP, _IP, _IP] + [_I, _P]
                + [_I] * 5 + [_P, _I, _I, _P]},
}


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    lib = build.load_library(name)
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def _device_guard(dev: torch.device):
    """Make ``dev`` the current device for a launch, unless it already is."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _raise_on(name: str, fn: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{fn} failed: "
                           f"{getattr(_library(name), f'{name}_error_string')(err).decode()}")


def _check_stack(x: torch.Tensor, what: str, rows: str = "rows"):
    """(m, d) of a contiguous float32/bfloat16 matrix with 1 <= m <= 64."""
    if x.dim() != 2:
        raise ValueError(f"{what} takes an (m, d) matrix, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous (m, d) matrix")
    if not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"{what} takes 1 to {MAX_ROWS} {rows}, got "
                         f"{x.shape[0]}")
    return x.shape


def _on_cpu(x: torch.Tensor, what: str, *others: torch.Tensor) -> bool:
    """True for CPU tensors (the plain version), False for CUDA tensors (the
    kernel); raises for any other device or a mix of devices."""
    for o in others:
        if o.device != x.device:
            raise ValueError(f"{what}: tensors on {x.device} and {o.device}")
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {x.device}")
    return False


def _is_bf16(x: torch.Tensor) -> int:
    return int(x.dtype == torch.bfloat16)


def _clip_trim(mode: Optional[str], trim, k: int):
    """The trim a reduce over k rows applies: (k-1)//2 for the median, the
    given count clipped to [0, (k-1)//2] for the trimmed mean (an integer
    tensor is clipped where it lies, with no host copy), else 0."""
    if mode == "med":
        return (k - 1) // 2
    if mode == "tm":
        return kref.clip_trim(trim if torch.is_tensor(trim) else int(trim), k)
    return 0


def _check_mode(mode: str) -> None:
    if mode not in REDUCE_MODES:
        raise ValueError(f"unknown reduce mode {mode!r}; want one of "
                         f"{REDUCE_MODES}")


# ------------------------------------------------- trees of leaves

MAX_LEAVES = 32  # leaves one launch takes (leaf_table.cuh kMaxLeaves)


class TreeLaunch(NamedTuple):
    leaves: tuple  # indices into the tree's leaves
    first_blocks: tuple  # each leaf's first block in the launch
    blocks: int


@functools.lru_cache(maxsize=4096)
def tree_launches(widths: tuple, cols: int, stacks: int = 1) -> tuple:
    """The launches of a tree kernel (``combine.cu``, ``cw_reduce.cu``) over
    leaves of widths ``widths``: empty leaves take none, the others go in
    order, ``MAX_LEAVES`` to a launch, and a leaf of width d holding
    ``stacks`` stacks (one per lane of a sweep) takes stacks * ceil(d /
    cols) blocks of ``cols`` columns, numbered on from the blocks of the
    leaves before it."""
    live = [i for i, d in enumerate(widths) if d > 0]
    launches = []
    for g in range(0, len(live), MAX_LEAVES):
        leaves = tuple(live[g:g + MAX_LEAVES])
        firsts, blocks = [], 0
        for i in leaves:
            firsts.append(blocks)
            blocks += stacks * -(-widths[i] // cols)
        launches.append(TreeLaunch(leaves, tuple(firsts), blocks))
    return tuple(launches)


@functools.lru_cache(maxsize=4096)
def _launch_args(widths: tuple, cols: int, stacks: int = 1) -> tuple:
    """``tree_launches`` with each launch's widths and first blocks as the C
    arrays the tree kernels take, built once per tree shape."""
    return tuple((leaves, len(leaves),
                  (_I * len(leaves))(*[widths[i] for i in leaves]),
                  (_I * len(leaves))(*firsts))
                 for leaves, firsts, _ in tree_launches(widths, cols, stacks))


def _pointers(ts, leaves):
    """The data pointers of ``ts[i]`` for i in ``leaves`` as a C array, or
    None for no tensors."""
    return None if ts is None else (_P * len(leaves))(
        *[ts[i].data_ptr() for i in leaves])


def _check_leaves(xs, what: str) -> int:
    """m of a non-empty list of contiguous (m, d_l) float32/bfloat16 leaves
    of one m and one dtype."""
    if not xs:
        raise ValueError(f"{what} takes at least one leaf")
    m = _check_stack(xs[0], what)[0]
    for x in xs[1:]:
        _check_stack(x, what)
        if x.shape[0] != m or x.dtype != xs[0].dtype:
            raise ValueError(f"{what} takes leaves of one m and one dtype, got "
                             f"{tuple(xs[0].shape)} {xs[0].dtype} and "
                             f"{tuple(x.shape)} {x.dtype}")
    return m


# ------------------------------------------------- coordinate-wise reduce

CW_REDUCE_LANES = (1, 2)  # threads a column: cw_reduce.cu's instances
CW_REDUCE_MAX_THREADS = 256  # a block's C * L (cw_reduce.cu kMaxThreads)


class CwReducePlan(NamedTuple):
    lanes: int  # L: the column's sort split over L adjacent lanes
    cols_per_block: int  # C: columns of one leaf a block


def cw_reduce_plan_fits(plan: CwReducePlan, m: int) -> bool:
    """Whether ``cw_reduce.cu`` takes ``plan`` for m rows: an instance of its
    L, at most next_pow2(m) lanes, and whole warps within the launch bound."""
    lanes, cols = plan
    threads = lanes * cols
    return (lanes in CW_REDUCE_LANES and lanes <= 1 << (m - 1).bit_length()
            and cols >= 1 and threads % 32 == 0
            and threads <= CW_REDUCE_MAX_THREADS)


# The tuned plans (the table in cw_reduce.cu's header), keyed by m > 32:
# one lane a column up to 32 rows, two lanes above, 64 columns a block.
CW_REDUCE_TUNED = {False: CwReducePlan(1, 64), True: CwReducePlan(2, 64)}


@functools.lru_cache(maxsize=None)
def cw_reduce_plan(m: int) -> CwReducePlan:
    """The plan of a ``cw_reduce.cu`` launch over m rows, tuned on the H100
    (the table in ``cw_reduce.cu``'s header): ``CW_REDUCE_TUNED[m > 32]``. A
    pure function of m."""
    if not 1 <= m <= MAX_ROWS:
        raise ValueError(f"cw_reduce_plan: needs 1 <= m <= {MAX_ROWS}, got {m}")
    return CW_REDUCE_TUNED[m > 32]


def _check_trim(trim, n: int = 1) -> bool:
    """Whether ``trim`` is a tensor (holding ``n`` integers), else an int."""
    if not isinstance(trim, torch.Tensor):
        return False
    if (trim.numel() != n or trim.dtype.is_floating_point or trim.is_complex()
            or trim.dtype == torch.bool):
        raise TypeError(f"a trim tensor holds {n} integer(s), got "
                        f"{tuple(trim.shape)} {trim.dtype}")
    return True


def _device_trim(trim, mode: Optional[str], dev: torch.device, what: str,
                 n: int = 1) -> Optional[torch.Tensor]:
    """A trimmed mean's trim as the contiguous int32 tensor of ``n``
    integers the kernel reads on ``dev`` (another integer type is cast
    there: no host sync), or None where the trim is a value: not a tensor,
    or one integer in a CPU tensor. ``n`` integers in a CPU tensor are
    copied to ``dev``."""
    if not (_check_trim(trim, n) and mode == "tm"):
        return None
    if trim.device.type == "cpu":
        if n == 1:
            return None
        trim = trim.to(dev)
    if trim.device != dev:
        raise ValueError(f"{what}: trim on {trim.device}, leaves on {dev}")
    return trim.reshape(n).to(torch.int32).contiguous()


def _cw_reduce(xs, mode: str, trim, plan: Optional[CwReducePlan],
               stacks: int, what: str, lead: tuple = ()) -> list:
    """The launches of ``cw_reduce.cu`` over leaves ``xs`` of ``stacks``
    contiguous (m, d_l) stacks each, with m and the leaves checked; each
    output ``lead + (d_l,)``."""
    m = xs[0].shape[-2]
    dev = xs[0].device
    t_dev = _device_trim(trim, mode, dev, what, stacks)
    # the kernel reads the int32s on the card, or takes a value clipped here
    trim = 0 if t_dev is not None else _clip_trim(mode, trim, m)
    widths = tuple(x.shape[-1] for x in xs)
    outs = [torch.empty(lead + (d,), dtype=torch.float32, device=dev)
            for d in widths]
    plan = plan or cw_reduce_plan(m)
    lib = _library("cw_reduce")
    with _device_guard(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for leaves, n, d_arr, first_arr in _launch_args(
                widths, plan.cols_per_block, stacks):
            err = lib.cw_reduce_launch(
                _pointers(xs, leaves), _pointers(outs, leaves), d_arr,
                first_arr, n, m, _is_bf16(xs[0]), _KERNEL_MODE[mode], trim,
                None if t_dev is None else t_dev.data_ptr(), stacks,
                plan.lanes, plan.cols_per_block, stream)
            _raise_on("cw_reduce", "cw_reduce_launch", err)
            LAUNCHES["cw_reduce"] += 1
    return outs


def tree_cw_reduce(xs, mode: str, trim=0,
                   plan: Optional[CwReducePlan] = None) -> list:
    """The coordinate-wise reduce of every leaf of a tree in one launch (one
    per ``MAX_LEAVES`` leaves): xs a list of contiguous (m, d_l) float32 or
    bfloat16 leaves of one m, dtype and device, 1 <= m <= 64 -> one (d_l,)
    float32 output per leaf.

    ``mode``: "med" (median; the mean of the two middle rows for even m),
    "tm" (trimmed mean dropping ``trim`` rows at each end, ``trim`` clipped
    to [0, (m-1)//2]) or "mean". ``trim`` is an int or an integer tensor of
    one element; on a card the kernel reads a tensor there and clips it
    itself, so the call makes no host sync and can be captured in a CUDA
    graph that replays with the trim changed in place."""
    _check_mode(mode)
    _check_leaves(xs, "tree_cw_reduce")
    _check_trim(trim)
    if _on_cpu(xs[0], "tree_cw_reduce", *xs[1:]):
        return [kref.cw_reduce_ref(x, mode, trim) for x in xs]
    return _cw_reduce(xs, mode, trim, plan, 1, "tree_cw_reduce")


def tree_cw_reduce_lanes(xs, mode: str, trim=0,
                         plan: Optional[CwReducePlan] = None) -> list:
    """``tree_cw_reduce`` of every lane of a sweep in one launch (one per
    ``MAX_LEAVES`` leaves): xs a list of contiguous (C, m, d_l) leaves, lane
    c's stack of leaf l at ``xs[l][c]``, of one C, m, dtype and device ->
    one (C, d_l) float32 output per leaf, row c the reduce of lane c.

    ``trim`` (for "tm") is an int for every lane, or an integer tensor of C
    elements, lane c's trim at c, each clipped to [0, (m-1)//2]; on a card
    the kernel reads lane c's there, so the call makes no host sync and a
    captured CUDA graph replays with the trims changed in place. Each row
    has the bits of a one-lane ``tree_cw_reduce`` call of that lane."""
    _check_mode(mode)
    if not xs:
        raise ValueError("tree_cw_reduce_lanes takes at least one leaf")
    for x in xs:
        if x.dim() != 3 or x.shape[:2] != xs[0].shape[:2]:
            raise ValueError(f"tree_cw_reduce_lanes takes (C, m, d) leaves of "
                             f"one C and m, got {tuple(x.shape)} and "
                             f"{tuple(xs[0].shape)}")
    lanes = xs[0].shape[0]
    if lanes < 1:
        raise ValueError("tree_cw_reduce_lanes takes at least one lane")
    _check_leaves([x[0] for x in xs], "tree_cw_reduce_lanes")
    for x in xs:
        if not x.is_contiguous():
            raise ValueError("tree_cw_reduce_lanes takes contiguous leaves")
    _check_trim(trim, lanes)
    if _on_cpu(xs[0], "tree_cw_reduce_lanes", *xs[1:]):
        return [kref.cw_reduce_lanes_ref(x, mode, trim) for x in xs]
    return _cw_reduce(xs, mode, trim, plan, lanes, "tree_cw_reduce_lanes",
                      (lanes,))


def cw_reduce(x: torch.Tensor, mode: str, trim=0) -> torch.Tensor:
    """x: (m, d) float32 or bfloat16, contiguous, 1 <= m <= 64 -> (d,)
    float32: ``tree_cw_reduce`` of one leaf."""
    return tree_cw_reduce([x], mode, trim)[0]


def cwmed(x: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median. x: (m, d) -> (d,) float32."""
    return cw_reduce(x, "med")


def cwtm(x: torch.Tensor, trim: int) -> torch.Tensor:
    """Coordinate-wise trimmed mean with an int trim. x: (m, d) -> (d,)."""
    return cw_reduce(x, "tm", int(trim))


def cwtm_masked(x: torch.Tensor, trim: torch.Tensor) -> torch.Tensor:
    """Trimmed mean with the trim count as an integer tensor (the JAX
    package's traced-trim form): on a card the kernel reads it there, with
    no host sync."""
    return cw_reduce(x, "tm", trim)


# ------------------------------------------------- squared distances

SQDIST_UNIT = 64  # columns: a block's span is whole units (sqdist.cu kUnit)
SQDIST_MAX_BLOCKS = 132  # one block per SM of the H100 (sqdist.cu kMaxBlocks)
# A block's share of d, tuned on the H100 (the table in sqdist.cu's header):
# two 64-column units, or one where a unit already holds more than
# SQDIST_PAIR_COLS / 2 pair-columns (more than 256 pairs: the Gram matrix of
# m > 22 rows, the cross distances of m*k > 256).
SQDIST_MAX_UNITS = 2
SQDIST_PAIR_COLS = 32768
COUNTER_SLOTS = 256  # per device: one per stream that has called sqdist.cu

_COUNTERS: dict = {}  # device index -> int32 (COUNTER_SLOTS,), zero between calls
_SLOTS: dict = {}  # (device index, stream handle) -> address of its counter


class SqdistPlan(NamedTuple):
    blocks: int
    units_per_block: int


@functools.lru_cache(maxsize=4096)
def sqdist_plan(n_pairs: int, d: int) -> SqdistPlan:
    """The grid of one ``sqdist.cu`` launch over ``n_pairs`` pairs of rows
    and ``d`` columns: ``SQDIST_PAIR_COLS / n_pairs`` columns a block, in whole
    64-column units, at least one and at most ``SQDIST_MAX_UNITS``; at most
    one block per SM, which widens the share of every block for large d;
    the units spread evenly and no block left empty. A pure function of its
    arguments; one block (no scratch, no step across blocks) when d fits in
    one block's share."""
    if n_pairs < 1 or d < 1:
        raise ValueError(f"sqdist_plan: needs n_pairs, d >= 1, got {n_pairs}, {d}")
    n_units = -(-d // SQDIST_UNIT)
    want = max(1, min(SQDIST_MAX_UNITS,
                      SQDIST_PAIR_COLS // (n_pairs * SQDIST_UNIT)))
    blocks = min(-(-n_units // want), SQDIST_MAX_BLOCKS)
    per_block = -(-n_units // blocks)
    return SqdistPlan(-(-n_units // per_block), per_block)


def _counter_ptr(dev: torch.device, stream: int) -> int:
    """Address of the int32 counter of ``stream`` on ``dev``: one slot of a
    per-device tensor allocated (zeroed, and waited for) at the first call
    on the device, so that no CUDA graph capture records or owns it, and
    one slot per stream, so that calls running at once never share one."""
    key = (dev.index, stream)
    address = _SLOTS.get(key)
    if address is None:
        counters = _COUNTERS.get(dev.index)
        if counters is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "pairwise_sqdist/cross_sqdist: the first call on a device "
                    "allocates the kernel's counters and cannot be captured; "
                    "call once before capturing a CUDA graph")
            counters = torch.zeros(COUNTER_SLOTS, dtype=torch.int32, device=dev)
            torch.cuda.synchronize(dev)
            _COUNTERS[dev.index] = counters
        slot = sum(1 for k in _SLOTS if k[0] == dev.index)
        if slot >= COUNTER_SLOTS:
            raise RuntimeError(f"pairwise_sqdist/cross_sqdist: more than "
                               f"{COUNTER_SLOTS} streams on {dev}")
        address = _SLOTS[key] = counters.data_ptr() + 4 * slot
    return address


def _sqdist(x: torch.Tensor, y: Optional[torch.Tensor], n_pairs: int,
            out: torch.Tensor, plan: Optional[SqdistPlan] = None) -> torch.Tensor:
    """One launch of ``sqdist.cu`` into ``out``: the Gram distances of x
    (``y`` None) or x against y, by ``plan`` (default: ``sqdist_plan``);
    scratch only for more than one block."""
    m, d = x.shape
    blocks, per_block = plan or sqdist_plan(n_pairs, d)
    dev = x.device
    scratch = (torch.empty(blocks * n_pairs, dtype=torch.float32, device=dev)
               if blocks > 1 else None)
    lib = _library("sqdist")
    with _device_guard(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        counter = _counter_ptr(dev, stream) if blocks > 1 else 0
        partial = 0 if scratch is None else scratch.data_ptr()
        if y is None:
            fn = "pairwise_sqdist_launch"
            err = lib.pairwise_sqdist_launch(
                x.data_ptr(), partial, counter, out.data_ptr(), m, d, blocks,
                per_block, _is_bf16(x), stream)
        else:
            fn = "cross_sqdist_launch"
            err = lib.cross_sqdist_launch(
                x.data_ptr(), y.data_ptr(), partial, counter, out.data_ptr(), m,
                y.shape[0], d, blocks, per_block, _is_bf16(x), stream)
    _raise_on("sqdist", fn, err)
    return out


def pairwise_sqdist(x: torch.Tensor) -> torch.Tensor:
    """x: (m, d) float32 or bfloat16, contiguous, 1 <= m <= 64 -> (m, m)
    float32 squared L2 distances ``sq_i + sq_j - 2 x_i.x_j``, clamped at 0."""
    m, d = _check_stack(x, "pairwise_sqdist")
    if _on_cpu(x, "pairwise_sqdist"):
        return kref.pairwise_sqdist_ref(x)
    if d == 0:
        return torch.zeros((m, m), dtype=torch.float32, device=x.device)
    out = torch.empty((m, m), dtype=torch.float32, device=x.device)
    _sqdist(x, None, m * (m + 1) // 2, out)
    LAUNCHES["pairwise_sqdist"] += 1
    return out


def cross_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x: (m, d), y: (k, d), both float32 or both bfloat16, contiguous,
    1 <= m, k <= 64 -> (m, k) float32 squared L2 distances by direct
    subtraction ``sum_c (x_ic - y_jc)^2``, clamped at 0."""
    m, d = _check_stack(x, "cross_sqdist")
    k, dy = _check_stack(y, "cross_sqdist", rows="rows of y")
    if dy != d or y.dtype != x.dtype:
        raise ValueError(f"cross_sqdist takes x and y of one width and dtype, "
                         f"got {tuple(x.shape)} {x.dtype} and "
                         f"{tuple(y.shape)} {y.dtype}")
    if _on_cpu(x, "cross_sqdist", y):
        return kref.cross_sqdist_ref(x, y)
    if d == 0:
        return torch.zeros((m, k), dtype=torch.float32, device=x.device)
    out = torch.empty((m, k), dtype=torch.float32, device=x.device)
    _sqdist(x, y, m * k, out)
    LAUNCHES["cross_sqdist"] += 1
    return out


# ------------------------------------------------- weighted combine

COMBINE_ROWS = (1, 3, 6, 8)  # rows a thread: combine.cu's instances
COMBINE_SMEM = 48 * 1024  # shared bytes a block may use (combine.cu kMaxSmem)


class CombinePlan(NamedTuple):
    rows_per_thread: int  # R: the k rows of a column over ceil(k / R) threads
    cols_per_block: int  # C: columns of one leaf a block, a power of 2 >= 32


def combine_max_threads(k: int) -> int:
    """The launch bound of ``combine.cu``'s instance for k rows: its sort
    holds next_pow2(k) values in registers, 64 of them above k = 32."""
    return 256 if k > 32 else 512


def combine_plan_fits(plan: CombinePlan, m: int, k: int) -> bool:
    """Whether ``combine.cu`` takes ``plan`` for w: (k, m): an instance of
    its R, a power of two of at least one warp of columns, the launch bound
    and the shared memory."""
    r, cols = plan
    groups = -(-k // r)
    m4 = -(-m // 4) * 4
    smem = 4 * (groups * r * m4 + max(m, 1 << (k - 1).bit_length()) * cols)
    return (r in COMBINE_ROWS and cols >= 32 and cols & (cols - 1) == 0
            and groups * cols <= combine_max_threads(k) and smem <= COMBINE_SMEM)


# The tuned plans (the table in combine.cu's header): (rows a thread,
# columns a block) at k = 1, and above it for the combine alone and for the
# mix+reduce.
COMBINE_PLAN_K1 = CombinePlan(1, 64)
COMBINE_TUNED = {False: CombinePlan(3, 32), True: CombinePlan(6, 32)}


@functools.lru_cache(maxsize=None)
def combine_plan(k: int, reduce: bool = False) -> CombinePlan:
    """The plan of a ``combine.cu`` launch for k output rows, with or
    without the reduce, tuned on the H100 (the table in ``combine.cu``'s
    header): ``COMBINE_PLAN_K1`` at k = 1, else ``COMBINE_TUNED``, with more
    rows a thread where its threads would pass the launch bound. A pure
    function of its arguments; fits every m <= 64."""
    if not 1 <= k <= MAX_ROWS:
        raise ValueError(f"combine_plan: needs 1 <= k <= {MAX_ROWS}, got {k}")
    if k == 1:
        return COMBINE_PLAN_K1
    tuned = COMBINE_TUNED[bool(reduce)]
    for r in COMBINE_ROWS[COMBINE_ROWS.index(tuned.rows_per_thread):]:
        plan = CombinePlan(r, tuned.cols_per_block)
        if combine_plan_fits(plan, MAX_ROWS, k):
            return plan
    raise AssertionError(f"combine_plan: no instance fits k = {k}")


def _check_weights(w: torch.Tensor, m: int, what: str) -> torch.Tensor:
    if w.dim() != 2 or w.shape[1] != m or not 1 <= w.shape[0] <= MAX_ROWS:
        raise ValueError(f"{what} takes weights of shape (k, {m}) with 1 <= k "
                         f"<= {MAX_ROWS}, got {tuple(w.shape)}")
    if w.dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16 weights, got "
                        f"{w.dtype}")
    return w.to(torch.float32).contiguous()


def _combine(xs, w: torch.Tensor, mode: Optional[str], trim, write_y: bool,
             what: str, keep_rows: bool = True,
             plan: Optional[CombinePlan] = None):
    """One pass of ``combine.cu`` over the leaves ``xs``, one launch per
    ``MAX_LEAVES`` of them: (y = w @ x per leaf if ``write_y``, the
    reduce of y's rows per leaf if ``mode``), each a list or None. A leaf's
    y is (k, d), or (d,) at k = 1 unless ``keep_rows``."""
    m = _check_leaves(xs, what)
    w = _check_weights(w, m, what)
    k = w.shape[0]
    _check_trim(trim)
    if _on_cpu(xs[0], what, w, *xs[1:]):
        trim = _clip_trim(mode, trim, k)
        ys = reds = None
        if write_y:
            ys = [kref.weighted_combine_ref(x, w) for x in xs]
            if k == 1 and not keep_rows:
                ys = [y[0] for y in ys]
        if mode:
            reds = [kref.combine_reduce_ref(x, w, mode, trim) for x in xs]
        return ys, reds
    dev = xs[0].device
    # a tensor trim: the int32 the kernel reads and clips on the card
    t_dev = _device_trim(trim, mode, dev, what)
    trim = 0 if t_dev is not None else _clip_trim(mode, trim, k)
    widths = tuple(x.shape[1] for x in xs)
    ys = ([torch.empty((k, d) if keep_rows or k > 1 else (d,),
                       dtype=torch.float32, device=dev) for d in widths]
          if write_y else None)
    reds = ([torch.empty(d, dtype=torch.float32, device=dev) for d in widths]
            if mode else None)
    plan = plan or combine_plan(k, mode is not None)
    lib = _library("combine")
    with _device_guard(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for leaves, n, d_arr, first_arr in _launch_args(widths,
                                                        plan.cols_per_block):
            err = lib.combine_launch(
                _pointers(xs, leaves), _pointers(ys, leaves),
                _pointers(reds, leaves), d_arr, first_arr, n,
                w.data_ptr(), m, k, _is_bf16(xs[0]), _KERNEL_MODE[mode], trim,
                None if t_dev is None else t_dev.data_ptr(),
                plan.rows_per_thread, plan.cols_per_block, stream)
            _raise_on("combine", "combine_launch", err)
            LAUNCHES["combine_reduce" if mode else "weighted_combine"] += 1
    return ys, reds


def weighted_combine(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (m, d) float32 or bfloat16, contiguous, w: (k, m), 1 <= m, k <= 64
    -> (k, d) float32 ``w @ x``, each output summed in row order."""
    return _combine([x], w, None, 0, True, "weighted_combine")[0][0]


def combine_reduce(x: torch.Tensor, w: torch.Tensor, mode: str,
                   trim=0) -> torch.Tensor:
    """The k rows of ``w @ x`` (w: (k, m)) reduced per column to (d,)
    float32 by ``mode`` ("med", "tm" with ``trim`` clipped to
    [0, (k-1)//2], or "mean"), without writing ``w @ x``: one pass over x.
    ``trim`` is an int or an integer tensor of one element, which the kernel
    reads and clips on the card (no host sync)."""
    _check_mode(mode)
    return _combine([x], w, mode, trim, False, "combine_reduce")[1][0]


def tree_weighted_combine(xs, w: torch.Tensor) -> list:
    """``weighted_combine`` of every leaf of a tree in one launch (one per
    ``MAX_LEAVES`` leaves): xs a list of contiguous (m, d_l) leaves
    of one m, dtype and device -> one float32 output per leaf, (d_l,) at
    k = 1 and (k, d_l) above it."""
    return _combine(xs, w, None, 0, True, "tree_weighted_combine",
                    keep_rows=False)[0]


def tree_combine_reduce(xs, w: torch.Tensor, mode: str, trim=0) -> list:
    """``combine_reduce`` of every leaf of a tree in one launch (one per
    ``MAX_LEAVES`` leaves) -> one (d_l,) float32 output per leaf; ``trim``
    as in ``combine_reduce``."""
    _check_mode(mode)
    return _combine(xs, w, mode, trim, False, "tree_combine_reduce")[1]


def fused_pass(x: torch.Tensor, *, w: Optional[torch.Tensor] = None,
               reduce: Optional[str] = None, trim=0, pairwise: bool = False,
               combine: bool = False) -> dict:
    """Any subset of the stages of the JAX package's ``fused_pass`` over
    x: (m, d), in a dict keyed by the requested stage:

      ``reduce``    (d,)   median / trimmed mean / mean over the rows of
                           ``w @ x`` when ``w`` is given, of x otherwise;
      ``pairwise``  (m, m) squared L2 distances of the rows of x;
      ``combine``   (k, d) ``w @ x`` (needs ``w``: (k, m)).

    ``trim`` (for "tm") is clipped to leave at least one row of the k rows
    reduced. ``reduce`` and ``combine`` share one launch and one read of x;
    ``pairwise`` is a launch of its own, a second read of x."""
    if reduce is None and not pairwise and not combine:
        raise ValueError("fused_pass: request at least one of "
                         "reduce/pairwise/combine")
    if reduce is not None:
        _check_mode(reduce)
    if combine and w is None:
        raise ValueError("fused_pass: the combine stage needs weights w")
    out = {}
    if reduce is not None or combine:
        if w is None:
            out["reduce"] = cw_reduce(x, reduce, trim)
        else:
            ys, reds = _combine([x], w, reduce, trim, combine,
                                "combine_reduce" if reduce else
                                "weighted_combine")
            if reduce is not None:
                out["reduce"] = reds[0]
            if combine:
                out["combine"] = ys[0]
    if pairwise:
        out["pairwise"] = pairwise_sqdist(x)
    return out
