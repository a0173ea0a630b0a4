"""The Horner fold of a windowed MSM's digit-plane partials, the whole
fold in one launch: K10 over Fq (G1) and K11 over Fq2 (G2).

For every lane: acc = init, then for each plane p, most significant
first, ``window`` doublings and one add of plane[p]:
acc = 2^window * acc + plane[p].

Replaces the reference's ``horner_fold_planes`` (``ops/msm.py``), whose
``lax.scan`` launches the Pallas kernels ``g1_double`` / ``g2_double``
and ``g1_add`` / ``g2_add`` (``ops/pallas_curve.py``) once a step.
``g1_horner_fold`` and ``g2_horner_fold`` launch their kernels
(``csrc/msm_fold.cu``) for CUDA tensors and run their plain versions for
CPU tensors; nothing else.  The plain versions are the step loop over
``point_op_plain("double" | "add")`` and run on any device; the kernels
equal them bit for bit.

Layouts (int32 limbs, Montgomery form; an element is ``(16,)`` for G1 and
``(2, 16)`` for G2): init ``(*batch, *elem)`` per coordinate, planes
``(n_planes, *batch, *elem)``; the batch is flattened to lanes (a batch
``()`` is one lane).  The result has init's shape; neither input is
written.
"""

from __future__ import annotations

import math

import torch

from ..field.tfield import FQ
from . import cuda_build
from .cuda_curve import point_op_plain
from .cuda_mont import field_consts
from .cuda_msm_window import Coords, _device_of, _elem, _limbs

# ---------------------------------------------------------- plain versions


def _leading_idle_planes(g2: bool, acc: Coords, planes: Coords) -> int:
    """How many leading planes leave `acc` as it is: planes at infinity in
    every lane (Z all zero: the complete add returns acc for them), while
    acc is at infinity in every lane and a doubling returns it bit for bit.
    A witness's small scalars leave most planes so."""
    n = 0
    while n < planes[2].shape[0] and not bool(planes[2][n].any()):
        n += 1
    if n and (bool(acc[2].any()) or not all(torch.equal(d, a) for d, a in
                                            zip(point_op_plain("double", g2, *acc), acc))):
        return 0
    return n


def _fold_plain(g2: bool, init: Coords, planes: Coords, window: int) -> Coords:
    acc = tuple(init)
    for p in range(_leading_idle_planes(g2, acc, planes), planes[0].shape[0]):
        for _ in range(window):
            acc = point_op_plain("double", g2, *acc)
        acc = point_op_plain("add", g2, *acc, *(c[p] for c in planes))
    return acc


def g1_horner_fold_plain(init: Coords, planes: Coords, window: int) -> Coords:
    """Plain torch version of K10, any device."""
    return _fold_plain(False, init, planes, window)


def g2_horner_fold_plain(init: Coords, planes: Coords, window: int) -> Coords:
    """Plain torch version of K11, any device."""
    return _fold_plain(True, init, planes, window)


# ------------------------------------------------------------------ wrappers


def _fold(g2: bool, init: Coords, planes: Coords, window: int) -> Coords:
    name = f"{'g2' if g2 else 'g1'}_horner_fold"
    dev = _device_of(name, (*init, *planes))
    if dev.type == "cpu":
        return _fold_plain(g2, init, planes, window)
    elem = _elem(g2)
    batch = tuple(init[0].shape[:init[0].dim() - len(elem)])
    n_planes = planes[0].shape[0]
    if window < 0 or tuple(init[0].shape[len(batch):]) != elem:
        raise ValueError(f"{name}: init {tuple(init[0].shape)}, window {window}")
    ins = [_limbs(c, batch + elem, f"{name} init") for c in init]
    ins += [_limbs(c, (n_planes,) + batch + elem, f"{name} planes") for c in planes]
    out = tuple(torch.empty(batch + elem, dtype=torch.int32, device=dev) for _ in range(3))
    lanes = math.prod(batch)
    if lanes:
        cuda_build.launch(
            "msm_fold", "zk_" + name,
            *(c.data_ptr() for c in ins), *(o.data_ptr() for o in out), lanes, n_planes, window,
            field_consts(FQ).ctypes.data,
        )
    return out


def g1_horner_fold(init: Coords, planes: Coords, window: int) -> Coords:
    """acc = init (*batch, 16) x3, then for each plane of planes (n_planes,
    *batch, 16) x3, most significant first, 2^window * acc + plane (K10)."""
    return _fold(False, init, planes, window)


def g2_horner_fold(init: Coords, planes: Coords, window: int) -> Coords:
    """g1_horner_fold over G2: init (*batch, 2, 16) x3, planes (n_planes,
    *batch, 2, 16) x3 (K11)."""
    return _fold(True, init, planes, window)
