"""Signed base-2^w digit planes of Fr scalars in one launch of kernel K14
(``csrc/recode.cu``): standard-form limbs (..., n, 16) -> mags
(256/w, ..., n) int32 in [0, 2^(w-1)] and negs, a bool mask of the same
shape, most significant plane first.

No Pallas counterpart: the reference recodes in XLA
(``ops/msm.py:signed_digit_planes_from_limbs``, a Kogge-Stone pass over
the digit axis), and so does the port's plain version of the same name
in ``ops/msm.py``.  One thread of K14 recodes one scalar least significant
digit first with the carry in a register, and gives the same planes bit
for bit.

``signed_recode`` launches K14 and takes CUDA tensors only; the
dispatching entry is ``ops.msm.signed_digit_planes`` (K14 for a CUDA
tensor, the plain version for a CPU tensor).
"""

from __future__ import annotations

import math

import torch

from . import cuda_build
from .cuda_mont import NUM_LIMBS, check_cuda_operand

# the prover's windows: 4 (the witness, the windowed h MSM), 16 (the bucket h MSM)
WINDOWS = (4, 16)


def signed_recode(limbs: torch.Tensor, window: int = 4):
    """(mags, negs) of the standard-form scalars `limbs` (..., 16), int32
    16-bit limbs, by K14.  Laid out as the Kogge-Stone recode lays them
    out: a scalar's digits adjacent, the planes a view of them with the
    digit axis first."""
    if limbs.device.type != "cuda":
        raise ValueError(f"signed_recode: limbs on {limbs.device}; K14 takes CUDA tensors")
    if window not in WINDOWS:
        raise ValueError(f"signed_recode: window {window}, expected one of {WINDOWS}")
    if limbs.dim() < 1 or limbs.shape[-1] != NUM_LIMBS:
        raise ValueError(f"signed_recode: limbs {tuple(limbs.shape)}, expected (..., 16)")
    x = limbs if limbs.is_contiguous() else limbs.contiguous()
    check_cuda_operand(x, "signed_recode limbs")
    shape = tuple(limbs.shape[:-1]) + (256 // window,)
    mags = torch.empty(shape, dtype=torch.int32, device=limbs.device)
    negs = torch.empty(shape, dtype=torch.bool, device=limbs.device)
    n = math.prod(limbs.shape[:-1])
    if n:
        cuda_build.launch("recode", "zk_signed_recode", x.data_ptr(), mags.data_ptr(), negs.data_ptr(), n, window)
    return mags.movedim(-1, 0), negs.movedim(-1, 0)
