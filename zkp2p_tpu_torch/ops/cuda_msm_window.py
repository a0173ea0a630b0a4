"""The signed-window MSM accumulate as two kernels a chunk of lane steps,
for G1 and for G2: a table kernel builds the chunk's multiples tables
(K6 over Fq, K8 over Fq2), an accumulate kernel adds the chunk's signed
table entries into the (n_digits, lanes) partials (K7 over Fq, K9 over
Fq2).

Replaces, on the windowed path, the per-step launches of the Pallas
kernels ``g1_add_mixed`` / ``g2_add_mixed`` (the table) and ``g1_add`` /
``g2_add`` (the accumulate) of the reference (``ops/pallas_curve.py``).
``g1_window_table``, ``g1_window_accumulate``, ``g2_window_table`` and
``g2_window_accumulate`` launch their kernels (``csrc/msm_window.cu``)
for CUDA tensors and run their plain versions for CPU tensors; nothing
else.  The plain versions are the step loop's operations: the table is
``from_affine`` and n-1 chained ``point_op_plain("add_mixed")``, the
accumulate per step a gather of the digits' entries, Y negated for
negative digits, and ``point_op_plain("add")``.  The kernels equal them
bit for bit.

Layouts (int32 limbs, Montgomery form; an element is ``(16,)`` for G1
and ``(2, 16)`` for G2): bases ``(T, lanes, *elem)`` with (0, 0) =
infinity; a table ``(T, n, lanes, *elem)`` per coordinate, entry k =
(k+1)P in Jacobian; partials ``(n_digits, lanes, *elem)``; digit planes
``(n_digits, steps, lanes)``, magnitudes int32 in [0, n] and a bool sign.
The accumulate also takes a batch of B witnesses against one table (the
batch prover's chunk): partials ``(B, n_digits, lanes, *elem)`` and
planes ``(n_digits, B, steps, lanes)``, one launch for the batch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..field.tfield import FQ, FQ2
from . import cuda_build
from .cuda_curve import point_op_plain
from .cuda_mont import NUM_LIMBS, check_cuda_operand, field_consts

Coords = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# Device memory one chunk's table may take: the steps of a chunk are as
# many as fit (at least one).  At 4,096 lanes and n = 8 a step's table
# is 6 MiB for G1 (a chunk of 170 steps) and 12 MiB for G2 (85 steps).
TABLE_BUDGET_BYTES = 1 << 30
# K7's block: lanes_per_block x n_digits threads, at most this many, and
# lanes_per_block x n at most this many (its shared memory, two buffers
# of three coordinates, then stays within 48 KB)
_BLOCK = 128


def chunk_steps(lanes: int, n_table: int, elem_limbs: int) -> int:
    """Lane steps a chunk holds under TABLE_BUDGET_BYTES, for elements of
    `elem_limbs` int32 limbs (16 in G1, 32 in G2)."""
    return max(1, TABLE_BUDGET_BYTES // (3 * n_table * lanes * elem_limbs * 4))


def _elem(g2: bool) -> Tuple[int, ...]:
    return (2, NUM_LIMBS) if g2 else (NUM_LIMBS,)


def _name(g2: bool, what: str) -> str:
    return f"{'g2' if g2 else 'g1'}_window_{what}"


# ---------------------------------------------------------- plain versions


def _table_plain(g2: bool, bases: Tuple[torch.Tensor, torch.Tensor], n_table: int) -> Coords:
    x, y = bases
    nd = len(_elem(g2))
    inf = ((x == 0) & (y == 0)).flatten(-nd).all(-1).reshape(x.shape[:-nd] + (1,) * nd)
    z = torch.where(inf, torch.zeros_like(x), (FQ2 if g2 else FQ).one_like(x))
    entry = (x, y, z)
    table = [entry]
    for _ in range(n_table - 1):
        entry = point_op_plain("add_mixed", g2, *entry, x, y)
        table.append(entry)
    return tuple(torch.stack([e[i] for e in table], dim=1) for i in range(3))


def _accumulate_plain(g2: bool, acc: Coords, table: Coords, mags: torch.Tensor, negs: torch.Tensor,
                      s0: int) -> Coords:
    """Per step, the entry each digit's magnitude selects (infinity for 0),
    Y negated (-0 stays 0) for a negative digit, added by
    point_op_plain("add").  Planes (n_digits, *batch, steps, lanes)
    against partials (*batch, n_digits, lanes, *elem)."""
    ones = (1,) * len(_elem(g2))
    lane_ix = torch.arange(mags.shape[-1], device=mags.device)
    for t in range(table[0].shape[0]):
        # (n_digits, *batch, lanes) -> (*batch, n_digits, lanes)
        mag = mags.select(-2, s0 + t).movedim(0, -2).long()
        neg = negs.select(-2, s0 + t).movedim(0, -2).reshape(mag.shape + ones)
        zero = (mag == 0).reshape(mag.shape + ones)
        x, y, z = (torch.where(zero, 0, c[t][(mag - 1).clamp(min=0), lane_ix]) for c in table)
        acc = point_op_plain("add", g2, *acc, x, torch.where(neg, (FQ2 if g2 else FQ).neg(y), y), z)
    return acc


def g1_window_table_plain(bases: Tuple[torch.Tensor, torch.Tensor], n_table: int) -> Coords:
    """Plain torch version of K6, any device."""
    return _table_plain(False, bases, n_table)


def g2_window_table_plain(bases: Tuple[torch.Tensor, torch.Tensor], n_table: int) -> Coords:
    """Plain torch version of K8, any device."""
    return _table_plain(True, bases, n_table)


def g1_window_accumulate_plain(acc: Coords, table: Coords, mags: torch.Tensor, negs: torch.Tensor,
                               s0: int) -> Coords:
    """Plain torch version of K7, any device: Y negated by FQ.neg."""
    return _accumulate_plain(False, acc, table, mags, negs, s0)


def g2_window_accumulate_plain(acc: Coords, table: Coords, mags: torch.Tensor, negs: torch.Tensor,
                               s0: int) -> Coords:
    """Plain torch version of K9, any device: Y negated by FQ2.neg."""
    return _accumulate_plain(True, acc, table, mags, negs, s0)


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


def _table(g2: bool, bases: Tuple[torch.Tensor, torch.Tensor], n_table: int) -> Coords:
    name = _name(g2, "table")
    dev = _device_of(name, bases)
    if dev.type == "cpu":
        return _table_plain(g2, bases, n_table)
    elem = _elem(g2)
    if bases[0].dim() != 2 + len(elem) or tuple(bases[0].shape[2:]) != elem or n_table < 1:
        raise ValueError(f"{name}: bases {tuple(bases[0].shape)}, n_table {n_table}")
    steps, lanes = bases[0].shape[:2]
    bx, by = (_limbs(c, bases[0].shape, f"{name} base") for c in bases)
    out = tuple(torch.empty((steps, n_table, lanes) + elem, dtype=torch.int32, device=dev) for _ in range(3))
    n = steps * lanes
    if n:
        cuda_build.launch(
            "msm_window", "zk_" + name,
            bx.data_ptr(), by.data_ptr(), *(o.data_ptr() for o in out), n, lanes, n_table,
            field_consts(FQ).ctypes.data,
        )
    return out


def _accumulate(g2: bool, acc: Coords, table: Coords, mags: torch.Tensor, negs: torch.Tensor, s0: int) -> Coords:
    name = _name(g2, "accumulate")
    dev = _device_of(name, (*acc, *table, mags, negs))
    if dev.type == "cpu":
        return _accumulate_plain(g2, acc, table, mags, negs, s0)
    elem = _elem(g2)
    if mags.dim() not in (3, 4):
        raise ValueError(f"{name}: planes {tuple(mags.shape)}, expected (n_digits, [batch,] steps, lanes)")
    n_digits, *batch, steps, lanes = mags.shape
    batch = tuple(batch)
    T, n_table = table[0].shape[:2]
    if negs.shape != mags.shape or negs.dtype != torch.bool or not 0 <= s0 <= s0 + T <= steps:
        raise ValueError(f"{name}: planes {tuple(mags.shape)}/{tuple(negs.shape)} {negs.dtype}, "
                         f"steps {s0}..{s0 + T}")
    if not g2 and not (n_digits <= _BLOCK and 1 <= n_table <= _BLOCK):
        raise ValueError(f"{name}: {n_digits} digit planes and n = {n_table}; at most {_BLOCK} each")
    ins = [_limbs(c, batch + (n_digits, lanes) + elem, f"{name} acc") for c in acc]
    ins += [_limbs(c, (T, n_table, lanes) + elem, f"{name} table") for c in table]
    if mags.dtype != torch.int32:
        raise TypeError(f"{name}: magnitudes must be int32, got {mags.dtype}")
    n_batch = batch[0] if batch else 1
    if not (n_batch and n_digits and lanes and T):
        return tuple(ins[:3])
    out = tuple(torch.empty(batch + (n_digits, lanes) + elem, dtype=torch.int32, device=dev) for _ in range(3))

    def strides(p):  # digit, batch, step, lane; an unbatched plane has batch stride 0
        sd, *sb, ss, sl = p.stride()
        return (sd, sb[0] if sb else 0, ss, sl)

    # K7 stages a block's lanes in shared memory; K9 takes one thread per (digit, lane)
    lanes_per_block = () if g2 else (min(_BLOCK // n_digits, _BLOCK // n_table),)
    cuda_build.launch(
        "msm_window", "zk_" + name,
        *(c.data_ptr() for c in ins), mags.data_ptr(), negs.data_ptr(), *(o.data_ptr() for o in out),
        n_batch, n_digits, lanes, *lanes_per_block, n_table, T, s0, *strides(mags), *strides(negs),
        field_consts(FQ).ctypes.data,
    )
    return out


def g1_window_table(bases: Tuple[torch.Tensor, torch.Tensor], n_table: int) -> Coords:
    """The Jacobian multiples 1P..n_table*P of affine G1 bases (T, lanes,
    16), (0, 0) = infinity: three (T, n_table, lanes, 16) tensors (K6)."""
    return _table(False, bases, n_table)


def g2_window_table(bases: Tuple[torch.Tensor, torch.Tensor], n_table: int) -> Coords:
    """g1_window_table over G2: bases (T, lanes, 2, 16), three (T, n_table,
    lanes, 2, 16) tensors (K8)."""
    return _table(True, bases, n_table)


def g1_window_accumulate(acc: Coords, table: Coords, mags: torch.Tensor, negs: torch.Tensor, s0: int) -> Coords:
    """acc (n_digits, lanes, 16) x3 plus, for each step t of the table
    (T, n, lanes, 16) x3, the entry its digit selects: digit planes
    mags/negs (n_digits, steps, lanes) read at steps s0 .. s0+T-1.  Returns
    the new partials (K7); acc is not written.  The planes are read in
    place at their strides.  A batch of B witnesses against the one
    table: acc (B, n_digits, lanes, 16) x3, planes (n_digits, B, steps,
    lanes), one launch."""
    return _accumulate(False, acc, table, mags, negs, s0)


def g2_window_accumulate(acc: Coords, table: Coords, mags: torch.Tensor, negs: torch.Tensor, s0: int) -> Coords:
    """g1_window_accumulate over G2: acc ([B,] n_digits, lanes, 2, 16) x3,
    table (T, n, lanes, 2, 16) x3 (K9)."""
    return _accumulate(True, acc, table, mags, negs, s0)
