"""The QAP's sparse matrix-vector product over BN254 Fr in one launch of
kernel K13 (``csrc/matvec.cu``): out[i] = sum_j coeff[j] * w[wire[j]]
over the nonzeros of row i, Montgomery form in and out.

Replaces, on the witness side of the proof, the reference's gathered
products (the Pallas kernel ``mont_mul``, ``ops/pallas_mont.py``) and the
segment sum behind them (``field/jfield.py``, ``lazy_segment_sum_mod``),
the ``_matvec`` of its ``prover/groth16_tpu.py``.

The matrix is in compressed sparse rows (``Csr``): coefficients (nnz,
16) int32 limbs, int32 wire ids and int64 row offsets of length rows + 1,
row i holding nonzeros offsets[i] .. offsets[i+1]-1.  ``csr_from_rows``
builds it from the key's (coeff, wire, row) triples, sorting by row (a
stable sort) only when the rows are not sorted already.

``fr_matvec`` launches K13 for CUDA tensors and runs ``fr_matvec_plain``
for CPU tensors; nothing else.  The plain version is the reference's
math on the same CSR arguments (gather, ``mont_mul_plain``,
``lazy_segment_sum_mod``) on any device; every value is canonical and
every operation exact, so the kernel equals it bit for bit whatever the
order of the nonzeros.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..field.tfield import FR, lazy_segment_sum_mod
from . import cuda_build
from .cuda_mont import NUM_LIMBS, check_cuda_operand, field_consts, mont_mul_plain

# Nonzeros a plain version multiplies at a time (bounds the int64
# temporaries of its products on large matrices).
PLAIN_CHUNK = 1 << 20


class Csr(NamedTuple):
    coeff: torch.Tensor  # (nnz, 16) int32 Montgomery limbs, in row order
    wire: torch.Tensor  # (nnz,) int32
    offsets: torch.Tensor  # (rows + 1,) int64, offsets[0] = 0, offsets[-1] = nnz


def csr_from_rows(coeff: torch.Tensor, wire: torch.Tensor, row: torch.Tensor, rows: int) -> Csr:
    """The CSR form of the nonzeros (coeff[j], wire[j], row[j]) of a
    matrix of `rows` rows.  The coefficients are the given tensor when the
    rows are sorted, else a copy permuted by a stable sort on the row."""
    if row.numel() and (int(row.min()) < 0 or int(row.max()) >= rows):
        raise ValueError(f"csr_from_rows: row ids outside [0, {rows})")
    if row.numel() > 1 and not bool((row[1:] >= row[:-1]).all()):
        order = torch.sort(row, stable=True).indices
        coeff, wire, row = coeff.index_select(0, order), wire.index_select(0, order), row.index_select(0, order)
    offsets = torch.zeros(rows + 1, dtype=torch.int64, device=row.device)
    offsets[1:] = torch.cumsum(torch.bincount(row, minlength=rows), 0)
    return Csr(coeff.contiguous(), wire.to(torch.int32).contiguous(), offsets)


def fr_matvec_plain(coeff: torch.Tensor, wire: torch.Tensor, offsets: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K13, any device: the products of the
    gathered witness values (mont_mul_plain, PLAIN_CHUNK nonzeros at a
    time), then lazy_segment_sum_mod over the rows."""
    rows = offsets.numel() - 1
    nnz = wire.numel()
    vals = torch.empty(nnz, NUM_LIMBS, dtype=torch.int32, device=w.device)
    for j in range(0, nnz, PLAIN_CHUNK):
        ws = w.index_select(0, wire[j:j + PLAIN_CHUNK].long())
        vals[j:j + PLAIN_CHUNK] = mont_mul_plain(FR, coeff[j:j + PLAIN_CHUNK], ws)
    row_ids = torch.repeat_interleave(torch.arange(rows, device=w.device), offsets.diff())
    return lazy_segment_sum_mod(FR, vals, row_ids, rows)


def fr_matvec(coeff: torch.Tensor, wire: torch.Tensor, offsets: torch.Tensor, w: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows (rows, 16) of the product of the CSR matrix (coeff, wire,
    offsets) with w (n_wires, 16), int32 Montgomery limbs, canonical.
    Writes `out` (new if None; must not overlap w) and returns it.  CUDA
    tensors launch K13; CPU tensors take the plain version."""
    operands = [t for t in (coeff, wire, offsets, w, out) if t is not None]
    devs = {t.device for t in operands}
    rows = offsets.numel() - 1
    if all(d.type == "cpu" for d in devs):
        res = fr_matvec_plain(coeff, wire, offsets, w)
        return res if out is None else out.copy_(res)
    if len(devs) != 1 or w.device.type != "cuda":
        raise ValueError(f"fr_matvec: operands on {sorted(str(d) for d in devs)}; expected one cuda device")
    if coeff.shape != (wire.numel(), NUM_LIMBS) or w.dim() != 2 or w.shape[-1] != NUM_LIMBS:
        raise ValueError(f"fr_matvec: coeff {tuple(coeff.shape)}, wire {tuple(wire.shape)}, w {tuple(w.shape)}")
    if wire.dtype != torch.int32 or offsets.dtype != torch.int64 or not (wire.is_contiguous()
                                                                         and offsets.is_contiguous()):
        raise TypeError("fr_matvec: wire ids must be contiguous int32 and offsets contiguous int64")
    for t, name in ((coeff, "coeff"), (w, "w")):
        check_cuda_operand(t, f"fr_matvec {name}")
    if out is None:
        out = torch.empty(rows, NUM_LIMBS, dtype=torch.int32, device=w.device)
    elif out.shape != (rows, NUM_LIMBS):
        raise ValueError(f"fr_matvec: out {tuple(out.shape)} for {rows} rows")
    check_cuda_operand(out, "fr_matvec out")
    if rows:
        cuda_build.launch(
            "matvec", "zk_fr_matvec",
            coeff.data_ptr(), wire.data_ptr(), offsets.data_ptr(), w.data_ptr(), out.data_ptr(), rows,
            field_consts(FR).ctypes.data,
        )
    return out
