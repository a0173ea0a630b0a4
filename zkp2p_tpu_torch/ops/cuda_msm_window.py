"""The G1 signed-window MSM accumulate as two kernels a chunk of lane
steps: K6 builds the chunk's multiples tables, K7 adds the chunk's signed
table entries into the (n_digits, lanes) partials.

Replaces, on the windowed G1 path, the per-step launches of the Pallas
kernels ``g1_add_mixed`` (the table) and ``g1_add`` (the accumulate) of
the reference (``ops/pallas_curve.py``).  ``g1_window_table`` and
``g1_window_accumulate`` launch their kernels (``csrc/msm_window.cu``)
for CUDA tensors and run their plain versions for CPU tensors; nothing
else.  The plain versions are the step loop's operations: the table is
``from_affine`` and n-1 chained ``point_op_plain("add_mixed")``, the
accumulate per step a gather of the digits' entries, Y negated for
negative digits, and ``point_op_plain("add")``.  The kernels equal them
bit for bit.

Layouts (int32 limbs, Montgomery form): bases ``(T, lanes, 16)`` with
(0, 0) = infinity; a table ``(T, n, lanes, 16)`` per coordinate, entry k
= (k+1)P in Jacobian; partials ``(n_digits, lanes, 16)``; digit planes
``(n_digits, steps, lanes)``, magnitudes int32 in [0, n] and a bool sign.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..field.tfield import FQ
from . import cuda_build
from .cuda_curve import point_op_plain
from .cuda_mont import NUM_LIMBS, check_cuda_operand, field_consts

Coords = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# Device memory one chunk's table may take: the steps of a chunk are as
# many as fit (at least one).  At 4,096 lanes and n = 8 a step's table
# is 6 MiB, so a chunk is 170 steps.
TABLE_BUDGET_BYTES = 1 << 30
# K7's block: lanes_per_block x n_digits threads, at most this many, and
# lanes_per_block x n at most this many (its shared memory, two buffers
# of three coordinates, then stays within 48 KB)
_BLOCK = 128


def chunk_steps(lanes: int, n_table: int) -> int:
    """Lane steps a chunk holds under TABLE_BUDGET_BYTES."""
    return max(1, TABLE_BUDGET_BYTES // (3 * n_table * lanes * NUM_LIMBS * 4))


# ---------------------------------------------------------- plain versions


def g1_window_table_plain(bases: Tuple[torch.Tensor, torch.Tensor], n_table: int) -> Coords:
    """Plain torch version of K6, any device."""
    x, y = bases
    inf = (x == 0).all(-1) & (y == 0).all(-1)
    z = torch.where(inf[..., None], torch.zeros_like(x), FQ.const("one", x.device).int().expand_as(x))
    entry = (x, y, z)
    table = [entry]
    for _ in range(n_table - 1):
        entry = point_op_plain("add_mixed", False, *entry, x, y)
        table.append(entry)
    return tuple(torch.stack([e[i] for e in table], dim=1) for i in range(3))


def g1_window_accumulate_plain(acc: Coords, table: Coords, mags: torch.Tensor, negs: torch.Tensor,
                               s0: int) -> Coords:
    """Plain torch version of K7, any device: per step, the entry each
    digit's magnitude selects (infinity for 0), Y negated by FQ.neg
    (-0 stays 0) for a negative digit, added by point_op_plain("add")."""
    lane_ix = torch.arange(mags.shape[2], device=mags.device)[None, :]
    for t in range(table[0].shape[0]):
        mag, neg = mags[:, s0 + t].long(), negs[:, s0 + t, :, None]
        zero = (mag == 0)[..., None]
        x, y, z = (torch.where(zero, 0, c[t][(mag - 1).clamp(min=0), lane_ix]) for c in table)
        acc = point_op_plain("add", False, *acc, x, torch.where(neg, FQ.neg(y), y), z)
    return acc


# ------------------------------------------------------------------ wrappers


def _device_of(name: str, tensors) -> torch.device:
    """cpu when every operand lies on the CPU, else their one CUDA device;
    raises for anything else."""
    devs = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devs):
        return torch.device("cpu")
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: operands on {sorted(str(d) for d in devs)}; expected one cuda device")
    return next(iter(devs))


def _limbs(t: torch.Tensor, shape, name: str) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    t = t if t.is_contiguous() else t.contiguous()
    check_cuda_operand(t, name)
    return t


def g1_window_table(bases: Tuple[torch.Tensor, torch.Tensor], n_table: int) -> Coords:
    """The Jacobian multiples 1P..n_table*P of affine G1 bases (T, lanes,
    16), (0, 0) = infinity: three (T, n_table, lanes, 16) tensors (K6)."""
    dev = _device_of("g1_window_table", bases)
    if dev.type == "cpu":
        return g1_window_table_plain(bases, n_table)
    if bases[0].dim() != 3 or bases[0].shape[-1] != NUM_LIMBS or n_table < 1:
        raise ValueError(f"g1_window_table: bases {tuple(bases[0].shape)}, n_table {n_table}")
    steps, lanes = bases[0].shape[:2]
    bx, by = (_limbs(c, bases[0].shape, "g1_window_table base") for c in bases)
    out = tuple(torch.empty((steps, n_table, lanes, NUM_LIMBS), dtype=torch.int32, device=dev) for _ in range(3))
    n = steps * lanes
    if n:
        cuda_build.launch(
            "msm_window", "zk_g1_window_table",
            bx.data_ptr(), by.data_ptr(), *(o.data_ptr() for o in out), n, lanes, n_table,
            field_consts(FQ).ctypes.data,
        )
    return out


def g1_window_accumulate(acc: Coords, table: Coords, mags: torch.Tensor, negs: torch.Tensor, s0: int) -> Coords:
    """acc (n_digits, lanes, 16) x3 plus, for each step t of the table
    (T, n, lanes, 16) x3, the entry its digit selects: digit planes
    mags/negs (n_digits, steps, lanes) read at steps s0 .. s0+T-1.  Returns
    the new partials (K7); acc is not written.  The planes are read in
    place at their strides."""
    dev = _device_of("g1_window_accumulate", (*acc, *table, mags, negs))
    if dev.type == "cpu":
        return g1_window_accumulate_plain(acc, table, mags, negs, s0)
    n_digits, steps, lanes = mags.shape
    T, n_table = table[0].shape[:2]
    if negs.shape != mags.shape or negs.dtype != torch.bool or not 0 <= s0 <= s0 + T <= steps:
        raise ValueError(f"g1_window_accumulate: planes {tuple(mags.shape)}/{tuple(negs.shape)} {negs.dtype}, "
                         f"steps {s0}..{s0 + T}")
    if not (n_digits <= _BLOCK and 1 <= n_table <= _BLOCK):
        raise ValueError(f"g1_window_accumulate: {n_digits} digit planes and n = {n_table}; at most {_BLOCK} each")
    ins = [_limbs(c, (n_digits, lanes, NUM_LIMBS), "g1_window_accumulate acc") for c in acc]
    ins += [_limbs(c, (T, n_table, lanes, NUM_LIMBS), "g1_window_accumulate table") for c in table]
    if mags.dtype != torch.int32:
        raise TypeError(f"g1_window_accumulate: magnitudes must be int32, got {mags.dtype}")
    if not (n_digits and lanes and T):
        return tuple(ins[:3])
    out = tuple(torch.empty((n_digits, lanes, NUM_LIMBS), dtype=torch.int32, device=dev) for _ in range(3))
    lanes_per_block = min(_BLOCK // n_digits, _BLOCK // n_table)
    cuda_build.launch(
        "msm_window", "zk_g1_window_accumulate",
        *(c.data_ptr() for c in ins), mags.data_ptr(), negs.data_ptr(), *(o.data_ptr() for o in out),
        n_digits, lanes, lanes_per_block, n_table, T, s0,
        *mags.stride(), *negs.stride(),
        field_consts(FQ).ctypes.data,
    )
    return out
