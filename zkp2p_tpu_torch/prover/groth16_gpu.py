"""The Groth16 prover of the port: witness in, proof out, on one GPU
(port of the reference's ``prover/groth16_tpu.py``, single proof).

Dataflow, signed digits and no GLV as in the reference; its two
accumulate arms are keyword arguments of ``prove_gpu`` with the
reference's defaults:

  witness -> Montgomery limbs (n_wires, 16)
    |- Az/Bz: gathered coefficient products (K1), segment sums
    |- H: 3 iNTT -> coset shift -> 3 NTT -> a*b - c
    |- signed w=4 digit planes of the witness; of H, w=4 (or w=16 for
    |  the bucket h MSM)
    '- 4 G1 MSMs (a, b1, c, h) + 1 G2 MSM (b2); with width metadata each
       witness MSM splits into a narrow class (3 planes) and a wide class
  host: blinding with (r, s) and assembly of (A, B, C)

``msm_affine=True`` (the reference's ZKP2P_MSM_AFFINE=1) runs the
windowed MSMs with the batch-affine accumulate (``ops.msm_affine``);
``msm_h="bucket"`` (ZKP2P_MSM_H=bucket) runs the h MSM as the
sorted-prefix bucket MSM (``ops.msm_bucket``) over w=16 planes.

Given the same (witness, r, s) the proof equals the reference's
``prove_host`` and ``prove_tpu`` byte for byte.
"""

from __future__ import annotations

import secrets
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..curve.host import G1Point, G2Point, g1_add, g1_mul, g1_neg, g2_add, g2_mul
from ..curve.tcurve import G1C, G2C, AffPoint, g1_jac_to_host, g2_jac_to_host
from ..field.bn254 import R
from ..field.tfield import FR, NUM_LIMBS, lazy_segment_sum_mod
from ..field.tower import Fq2
from ..ops.msm import default_lanes, msm_windowed_signed, signed_digit_planes_from_limbs
from ..ops.msm_affine import msm_windowed_affine
from ..ops.msm_bucket import msm_bucket_affine
from ..ops.ntt import coset_shift, intt, ntt
from ..snark.groth16 import Proof, coset_gen
from ..utils.device import resolve_device

WINDOW = 4
# The key's narrow class (wires with a constraint-backed bound of at most
# 11 bits) needs only the last NARROW_PLANES signed w=4 digit planes
# (k planes hold v < 2^(4k-1)); valid only under the width guard.
NARROW_PLANES = 3
# the window of the h MSM's digit planes under msm_h="bucket"
H_BUCKET_WINDOW = 16
MSM_H_ARMS = ("windowed", "bucket")


@dataclass
class DeviceProvingKey:
    """The proving key as device tensors, in the reference's layout.

    a/b rows: sparse QAP rows of A and B (Montgomery coefficients, wire
    and row indices).  Bases: affine Montgomery limbs, (0, 0) = infinity;
    b1/b2/c are pruned to their non-infinity wires (b_sel, c_sel).  The
    *_nsel/*_wsel positions split each query into its narrow and wide
    width classes (empty narrow = unclassed)."""

    n_public: int
    n_wires: int
    log_m: int
    a_coeff: torch.Tensor
    a_wire: torch.Tensor
    a_row: torch.Tensor
    b_coeff: torch.Tensor
    b_wire: torch.Tensor
    b_row: torch.Tensor
    a_bases: AffPoint
    b1_bases: AffPoint
    b2_bases: AffPoint
    c_bases: AffPoint
    h_bases: AffPoint
    b_sel: torch.Tensor
    c_sel: torch.Tensor
    a_nsel: torch.Tensor
    a_wsel: torch.Tensor
    b_nsel: torch.Tensor
    b_wsel: torch.Tensor
    c_nsel: torch.Tensor
    c_wsel: torch.Tensor
    alpha_1: G1Point
    beta_1: G1Point
    beta_2: G2Point
    delta_1: G1Point
    delta_2: G2Point
    # narrow-classed wire ids whose class was inferred (not tagged): packed
    # int64 bytes, checked against every witness; None for tagged keys
    inferred_narrow_wires: Optional[bytes] = None
    # key-only gathers of the classed split, memoised per key
    _split: Dict[str, object] = field(default_factory=dict, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.a_coeff.device


DPK_ARRAY_FIELDS = (
    "a_coeff", "a_wire", "a_row", "b_coeff", "b_wire", "b_row",
    "a_bases", "b1_bases", "b2_bases", "c_bases", "h_bases",
    "b_sel", "c_sel",
    "a_nsel", "a_wsel", "b_nsel", "b_wsel", "c_nsel", "c_wsel",
)
_BASE_FIELDS = ("a_bases", "b1_bases", "b2_bases", "c_bases", "h_bases")
_LIMB_FIELDS = ("a_coeff", "b_coeff")


def _g2_point(v) -> G2Point:
    if v is None:
        return None
    (x0, x1), (y0, y1) = ((c.c0, c.c1) if hasattr(c, "c0") else c for c in v)
    return (Fq2(x0, x1), Fq2(y0, y1))


def key_from_numpy(arrays: Dict[str, np.ndarray], meta: Dict[str, object], device=None) -> DeviceProvingKey:
    """Build the key on `device` (CUDA unless "cpu" is asked for) from
    numpy arrays in the reference's layout: the 19 array fields, bases as
    (2, n, 16) or (2, n, 2, 16) limb stacks, and `meta` with n_public,
    n_wires, log_m, the blinding points (G1 as int pairs, G2 as pairs of
    (c0, c1)) and inferred_narrow_wires."""
    dev = resolve_device(device)
    missing = [k for k in DPK_ARRAY_FIELDS if k not in arrays]
    if missing:
        raise ValueError(f"key arrays missing {missing}")
    kw = {}
    for name in DPK_ARRAY_FIELDS:
        a = np.asarray(arrays[name])
        if name in _BASE_FIELDS:
            if a.shape[0] != 2:
                raise ValueError(f"{name}: expected an (x, y) stack, got shape {a.shape}")
            kw[name] = tuple(torch.from_numpy(np.ascontiguousarray(c.astype(np.int32))).to(dev) for c in a)
        elif name in _LIMB_FIELDS:
            kw[name] = torch.from_numpy(np.ascontiguousarray(a.astype(np.int32))).to(dev)
        else:
            kw[name] = torch.from_numpy(a.astype(np.int64)).to(dev)
    blob = meta.get("inferred_narrow_wires")
    return DeviceProvingKey(
        n_public=int(meta["n_public"]),
        n_wires=int(meta["n_wires"]),
        log_m=int(meta["log_m"]),
        alpha_1=tuple(meta["alpha_1"]) if meta["alpha_1"] is not None else None,
        beta_1=tuple(meta["beta_1"]) if meta["beta_1"] is not None else None,
        beta_2=_g2_point(meta["beta_2"]),
        delta_1=tuple(meta["delta_1"]) if meta["delta_1"] is not None else None,
        delta_2=_g2_point(meta["delta_2"]),
        inferred_narrow_wires=bytes(blob) if blob else None,
        **kw,
    )


# ------------------------------------------------------------------ witness

_R_U64 = np.frombuffer(R.to_bytes(32, "little"), dtype="<u8").copy()


def _is_u64_witness(witness) -> bool:
    """The (n, 4) uint64 standard-form limb layout."""
    return (
        isinstance(witness, np.ndarray)
        and witness.dtype == np.uint64
        and witness.ndim == 2
        and witness.shape[-1] == 4
    )


def _scalars_to_u64(scalars: Sequence[int]) -> np.ndarray:
    buf = b"".join(int(s).to_bytes(32, "little") for s in scalars)
    return np.frombuffer(buf, dtype="<u8").reshape(len(scalars), 4)


def _check_u64_reduced(rows: np.ndarray) -> None:
    """Reject (n, 4)-u64 witness rows >= R: an unreduced row would give a
    wrong Montgomery form and an unverifiable proof."""
    ge = np.zeros(rows.shape[0], dtype=bool)
    eq = np.ones(rows.shape[0], dtype=bool)
    for j in range(3, -1, -1):
        col = rows[:, j]
        ge |= eq & (col > _R_U64[j])
        eq &= col == _R_U64[j]
    ge |= eq  # exactly R is unreduced too
    if ge.any():
        i = int(np.flatnonzero(ge)[0])
        raise ValueError(
            f"witness row {i} is not reduced below the Fr modulus: the "
            f"(n, 4)-u64 form requires canonical scalars (< R)"
        )


def _witness_std_limbs(witness) -> np.ndarray:
    """Host witness (int sequence or (n, 4) u64 rows) -> (n, 16) int32
    standard-form 16-bit limbs."""
    if _is_u64_witness(witness):
        _check_u64_reduced(witness)
        rows = witness
    else:
        rows = _scalars_to_u64([int(w) % R for w in witness])
    return np.ascontiguousarray(rows).view("<u2").astype(np.int32).reshape(rows.shape[0], NUM_LIMBS)


def _check_inferred_widths(dpk: DeviceProvingKey, witness, w_std: Optional[np.ndarray] = None) -> None:
    """Width guard for inferred-width keys: every wire classed narrow must
    fit the narrow digit planes.  No-op for keys with tagged widths."""
    blob = dpk.inferred_narrow_wires
    if not blob:
        return
    wires = np.frombuffer(blob, dtype=np.int64)
    bound = 1 << (4 * NARROW_PLANES - 1)
    if w_std is None:
        w_std = _scalars_to_u64([witness[j] % R for j in wires])
        wires_idx = np.arange(len(wires))
    else:
        wires_idx = wires
    vals = np.asarray(w_std)[wires_idx]
    bad = (vals[:, 1:].any(axis=1)) | (vals[:, 0] >= bound)
    if not bad.any():
        return
    i = int(wires[int(np.flatnonzero(bad)[0])])
    raise ValueError(
        f"wire {i}: witness value exceeds the width bound inferred from the "
        f"key's bit-constraint pattern; rebuild the key without inferred widths"
    )


def witness_to_device(witness, device) -> torch.Tensor:
    """Host witness -> (n_wires, 16) Montgomery limbs on `device`."""
    std = torch.from_numpy(_witness_std_limbs(witness)).to(device)
    return FR.to_mont(std)


# ------------------------------------------------------------------ H ladder


def _matvec(coeff, wire, row, w_mont, m):
    vals = FR.mul(coeff, w_mont.index_select(0, wire))
    return lazy_segment_sum_mod(FR, vals, row, m)


def abc_evals(dpk: DeviceProvingKey, w_mont: torch.Tensor):
    """Az, Bz and Cz = Az*Bz on the domain."""
    m = 1 << dpk.log_m
    a_ev = _matvec(dpk.a_coeff, dpk.a_wire, dpk.a_row, w_mont, m)
    b_ev = _matvec(dpk.b_coeff, dpk.b_wire, dpk.b_row, w_mont, m)
    return a_ev, b_ev, FR.mul(a_ev, b_ev)


def h_evals(dpk: DeviceProvingKey, w_mont: torch.Tensor, stages=None) -> torch.Tensor:
    """Coset evaluations d_j = (A*B - C)(g*w^j), (m, 16) Montgomery limbs:
    the scalars of the h MSM (Z is constant on the coset and folded into
    the h bases)."""
    g = coset_gen(dpk.log_m)
    log_m = dpk.log_m
    a_ev, b_ev, c_ev = _timed(stages, "matvec", lambda: abc_evals(dpk, w_mont))

    def ladder(ev):
        return ntt(coset_shift(intt(ev, log_m), g, log_m), log_m)

    a_cos, b_cos, c_cos = _timed(stages, "ntt", lambda: (ladder(a_ev), ladder(b_ev), ladder(c_ev)))
    return FR.sub(FR.mul(a_cos, b_cos), c_cos)


def _h_and_planes(dpk: DeviceProvingKey, w_mont: torch.Tensor, h_window: int, stages=None):
    """H evaluations, the signed w=4 digit planes of the witness and the
    signed w=h_window planes of H; the narrow class takes the last
    NARROW_PLANES witness planes."""
    h = _timed(stages, "h_evals", lambda: h_evals(dpk, w_mont, stages))

    def planes():
        w_planes = signed_digit_planes_from_limbs(FR.from_mont(w_mont), WINDOW)
        h_planes = signed_digit_planes_from_limbs(FR.from_mont(h), h_window)
        narrow = tuple(p[-NARROW_PLANES:] for p in w_planes) if dpk.a_nsel.numel() else ()
        return (w_planes, narrow), h_planes

    w_all, h_planes = _timed(stages, "planes", planes)
    if stages is not None:
        stages["h"] = h
    return w_all, h_planes


def _timed(stages, name: str, fn):
    """Run fn; when `stages` is a dict, synchronise around it and record
    its seconds under "s_<name>" (host clock around device work that ends
    in a synchronise)."""
    if stages is None:
        return fn()
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    stages["s_" + name] = stages.get("s_" + name, 0.0) + time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------- MSMs


def _windowed(curve, bases, planes, lanes, window, affine):
    """The signed windowed MSM with the accumulate arm: batch affine when
    `affine`, Jacobian otherwise."""
    msm = msm_windowed_affine if affine else msm_windowed_signed
    return msm(curve, bases, *planes, lanes=lanes, window=window)


def _msm_g1(bases, planes, affine):
    return _windowed(G1C, bases, planes, default_lanes(bases[0].shape[0]), WINDOW, affine)


def _msm_g1_narrow(bases, planes, affine):
    return _windowed(G1C, bases, planes, default_lanes(bases[0].shape[0], cap=16384), 4, affine)


def _msm_g2(bases, planes, affine):
    return _windowed(G2C, bases, planes, default_lanes(bases[0].shape[0], cap=2048), WINDOW, affine)


def _msm_g2_narrow(bases, planes, affine):
    return _windowed(G2C, bases, planes, default_lanes(bases[0].shape[0], cap=4096), 4, affine)


def _msm_h(bases, planes, affine, h_bucket):
    """The h MSM: the sorted-prefix bucket MSM when `h_bucket`, else the
    windowed G1 MSM."""
    if h_bucket:
        return msm_bucket_affine(G1C, bases, *planes, window=H_BUCKET_WINDOW)
    return _msm_g1(bases, planes, affine)


def _take_planes(planes, sel):
    return tuple(p.index_select(-1, sel) for p in planes)


def _take_bases(bases, pos):
    return tuple(c.index_select(0, pos) for c in bases)


def _prove_device(dpk: DeviceProvingKey, w_mont: torch.Tensor, msm_affine: bool, msm_h: str, stages=None):
    """The five MSMs -> (a, b1, b2, c, h) Jacobian accumulators.  b1/b2/c
    run over their pruned lanes; with width metadata each witness MSM is
    a narrow-class and a wide-class MSM joined by one add."""
    h_bucket = msm_h == "bucket"
    h_window = H_BUCKET_WINDOW if h_bucket else WINDOW
    (w_planes, w_narrow), h_planes = _h_and_planes(dpk, w_mont, h_window, stages)

    def key_split(name, bases, sel, wires_of):
        got = dpk._split.get(name)
        if got is None:
            got = (_take_bases(bases, sel), sel if wires_of is None else wires_of.index_select(0, sel))
            dpk._split[name] = got
        return got

    def query(curve, msm, msm_narrow, name, bases, nsel, wsel, wires_of):
        if not dpk.a_nsel.numel():  # unclassed key: one MSM over all lanes
            cols = w_planes if wires_of is None else _take_planes(w_planes, wires_of)
            return msm(bases, cols, msm_affine)
        accs = []
        if nsel.numel():
            nb, nw = key_split(name + ".n", bases, nsel, wires_of)
            accs.append(msm_narrow(nb, _take_planes(w_narrow, nw), msm_affine))
        if wsel.numel():
            wb, ww = key_split(name + ".w", bases, wsel, wires_of)
            accs.append(msm(wb, _take_planes(w_planes, ww), msm_affine))
        return accs[0] if len(accs) == 1 else curve.add(accs[0], accs[1])

    g1 = (G1C, _msm_g1, _msm_g1_narrow)
    g2 = (G2C, _msm_g2, _msm_g2_narrow)
    return (
        _timed(stages, "msm_a", lambda: query(*g1, "a", dpk.a_bases, dpk.a_nsel, dpk.a_wsel, None)),
        _timed(stages, "msm_b1", lambda: query(*g1, "b1", dpk.b1_bases, dpk.b_nsel, dpk.b_wsel, dpk.b_sel)),
        _timed(stages, "msm_b2", lambda: query(*g2, "b2", dpk.b2_bases, dpk.b_nsel, dpk.b_wsel, dpk.b_sel)),
        _timed(stages, "msm_c", lambda: query(*g1, "c", dpk.c_bases, dpk.c_nsel, dpk.c_wsel, dpk.c_sel)),
        _timed(stages, "msm_h", lambda: _msm_h(dpk.h_bases, h_planes, msm_affine, h_bucket)),
    )


def _assemble(dpk: DeviceProvingKey, acc, r: int, s: int) -> Proof:
    a_acc, b1_acc, b2_acc, c_acc, h_acc = acc
    pi_a = g1_add(g1_add(dpk.alpha_1, a_acc), g1_mul(dpk.delta_1, r))
    pi_b = g2_add(g2_add(dpk.beta_2, b2_acc), g2_mul(dpk.delta_2, s))
    pi_b1 = g1_add(g1_add(dpk.beta_1, b1_acc), g1_mul(dpk.delta_1, s))
    pi_c = g1_add(c_acc, h_acc)
    pi_c = g1_add(pi_c, g1_mul(pi_a, s))
    pi_c = g1_add(pi_c, g1_mul(pi_b1, r))
    pi_c = g1_add(pi_c, g1_neg(g1_mul(dpk.delta_1, r * s % R)))
    return Proof(a=pi_a, b=pi_b, c=pi_c)


def accumulators_to_host(acc) -> Tuple:
    """The five device accumulators -> host affine (a, b1, b2, c, h)."""
    a, b1, c, h = (g1_jac_to_host(p)[0] for p in (acc[0], acc[1], acc[3], acc[4]))
    return a, b1, g2_jac_to_host(acc[2])[0], c, h


def prove_gpu(
    dpk: DeviceProvingKey,
    witness,
    r: Optional[int] = None,
    s: Optional[int] = None,
    device=None,
    stages: Optional[dict] = None,
    msm_affine: bool = False,
    msm_h: str = "windowed",
) -> Proof:
    """One Groth16 proof.  `witness` is a sequence of ints or (n, 4)
    uint64 standard-form rows; r, s are the blinding scalars (random when
    None).  Runs on CUDA unless device="cpu"; the key must be on that
    device.  When `stages` is a dict it receives per-stage seconds
    ("s_<stage>", synchronised at each boundary), the five host
    accumulators ("acc") and the H evaluations ("h").

    msm_affine: the windowed MSMs accumulate in batch affine (the
    reference's ZKP2P_MSM_AFFINE=1); msm_h: "windowed" or "bucket" (the
    sorted-prefix bucket h MSM, ZKP2P_MSM_H=bucket).  The defaults are
    the reference's; the proof is the same under every arm."""
    if not isinstance(msm_affine, bool):
        raise ValueError(f"msm_affine must be True or False, got {msm_affine!r}")
    if msm_h not in MSM_H_ARMS:
        raise ValueError(f"msm_h must be one of {MSM_H_ARMS}, got {msm_h!r}")
    dev = resolve_device(device)
    if dpk.device != dev:
        raise ValueError(f"key is on {dpk.device}, prover asked to run on {dev}")
    if r is None:
        r = 1 + secrets.randbelow(R - 1)
    if s is None:
        s = 1 + secrets.randbelow(R - 1)
    _check_inferred_widths(dpk, witness, w_std=witness if _is_u64_witness(witness) else None)
    w_mont = _timed(stages, "witness", lambda: witness_to_device(witness, dev))
    acc = _prove_device(dpk, w_mont, msm_affine, msm_h, stages)
    host = _timed(stages, "assemble", lambda: accumulators_to_host(acc))
    proof = _timed(stages, "assemble", lambda: _assemble(dpk, host, r, s))
    if stages is not None:
        stages["acc"] = host
    return proof
