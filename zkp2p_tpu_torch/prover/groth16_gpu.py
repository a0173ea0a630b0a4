"""The Groth16 prover of the port: witness in, proof out, on one GPU
(port of the reference's ``prover/groth16_tpu.py``, single proof).

Dataflow, signed digits and no GLV as in the reference; its two
accumulate arms are keyword arguments of ``prove_gpu`` with the
reference's defaults:

  witness -> (n_wires, 4) u64 rows on the device -> Montgomery limbs
    |- Az/Bz: one CSR sparse matvec each (K13) into one (3, m) batch
    |- H: 3 iNTT -> coset shift -> 3 NTT (as 3 rows of one batch) -> a*b - c
    |- signed w=4 digit planes of the witness; of H, w=4 (or w=16 for
    |  the bucket h MSM); one recode launch each (K14)
    '- 4 G1 MSMs (a, b1, c, h) + 1 G2 MSM (b2); with width metadata each
       witness MSM splits into a narrow class (3 planes) and a wide class
  host: blinding with (r, s) and assembly of (A, B, C)

``msm_affine=True`` (the reference's ZKP2P_MSM_AFFINE=1) runs the
windowed MSMs with the batch-affine accumulate (``ops.msm_affine``);
``msm_h="bucket"`` (ZKP2P_MSM_H=bucket) runs the h MSM as the
sorted-prefix bucket MSM (``ops.msm_bucket``) over w=16 planes.

Given the same (witness, r, s) the proof equals the reference's
``prove_host`` and ``prove_tpu`` byte for byte.

``prove_gpu_batch`` (the reference's ``prove_tpu_batch``) runs the same
pipeline over a leading batch axis of witnesses against one resident
key, a chunk of witnesses at a time: one upload, one K13 launch each for
Az and Bz, one K12 launch a pass over the chunk's 3B rows, one K14
launch each for the witness's planes and H's, and each MSM's tables
built once a chunk of steps and accumulated for the whole chunk in one
K7/K9 launch (the reference's ``vmap`` leaves the key unbatched).
"""

from __future__ import annotations

import secrets
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..curve.host import G1Point, G2Point, g1_add, g1_mul, g1_neg, g2_add, g2_mul
from ..curve.tcurve import G1C, G2C, AffPoint, g1_jac_to_host, g1_limbs, g2_jac_to_host, g2_limbs
from ..field.bn254 import R
from ..field.tfield import FR, NUM_LIMBS, lazy_segment_sum_mod, mont_limbs
from ..field.tower import Fq2
from ..ops.cuda_matvec import Csr, csr_from_rows, fr_matvec
from ..ops.msm import default_lanes, msm_windowed_signed, signed_digit_planes
from ..ops.msm_affine import msm_windowed_affine
from ..ops.msm_bucket import msm_bucket_affine
from ..ops.ntt import coset_ladder
from ..snark.groth16 import Proof, coset_gen, domain_size_for, qap_rows
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


# ------------------------------------------------------------ key import

# Width classing: wires with a constraint-backed bound below 2^NARROW_WIDTH
# need only NARROW_PLANES signed w=4 digit planes.
NARROW_WIDTH = 11


def widths_array(cs) -> np.ndarray:
    """cs.wire_width (wire -> bits) as a dense per-wire bound array, 254 =
    unbounded.  Duck-typed: reads cs.num_wires and cs.wire_width."""
    widths = np.full(cs.num_wires, 254, dtype=np.int32)
    for w, bits in getattr(cs, "wire_width", {}).items():
        widths[w] = bits
    return widths


def class_sels(widths: Optional[np.ndarray], wire_ids: np.ndarray):
    """(narrow positions, wide positions) into a base array whose row p
    holds the point of wire wire_ids[p]: the one classing rule of every
    key path (the import from points or a zkey, and the setup)."""
    wire_ids = np.asarray(wire_ids)
    if widths is None:
        return np.zeros(0, dtype=np.int32), np.arange(len(wire_ids), dtype=np.int32)
    narrow = np.asarray(widths)[wire_ids] <= NARROW_WIDTH
    return np.flatnonzero(narrow).astype(np.int32), np.flatnonzero(~narrow).astype(np.int32)


def _prune_sel(flags) -> np.ndarray:
    """The positions of the set flags; [0] (one infinity lane) when none is."""
    sel = np.flatnonzero(np.asarray(flags, dtype=bool)).astype(np.int32)
    return sel if sel.size else np.zeros(1, dtype=np.int32)


def _rows_to_arrays(rows: Sequence[dict], m: int):
    """Sparse QAP rows (wire -> coefficient dicts) -> (coefficients as
    Montgomery limbs, wire ids, row ids), row by row in each dict's
    order; an all-zero matrix is one zero coefficient in row m - 1."""
    vals, wires, row_ids = [], [], []
    for j, terms in enumerate(rows):
        for wire, coeff in terms.items():
            vals.append(coeff % R)
            wires.append(wire)
            row_ids.append(j)
    if not vals:
        vals, wires, row_ids = [0], [0], [m - 1]
    return mont_limbs(vals, R), np.array(wires, dtype=np.int32), np.array(row_ids, dtype=np.int32)


def _selections(widths, n_wires: int, b_sel: np.ndarray, c_sel: np.ndarray) -> Dict[str, np.ndarray]:
    out = {"b_sel": b_sel, "c_sel": c_sel}
    for q, wires in (("a", np.arange(n_wires, dtype=np.int32)), ("b", b_sel), ("c", c_sel)):
        out[q + "_nsel"], out[q + "_wsel"] = class_sels(widths, wires)
    return out


def device_pk_from_rows(pk, a_rows: Sequence[dict], b_rows: Sequence[dict], m: int, n_wires: int,
                        widths: Optional[np.ndarray] = None, device=None) -> DeviceProvingKey:
    """A host proving key (query point lists, as the reference's
    ``ProvingKey``; duck-typed) and the QAP's A and B rows -> the key on
    `device` (CUDA unless "cpu"): b1/b2/c pruned to their non-infinity
    wires, h padded with infinity to m points, the width classes of
    `widths` (None: unclassed)."""
    a = _rows_to_arrays(a_rows, m)
    b = _rows_to_arrays(b_rows, m)
    b_sel = _prune_sel([p1 is not None or p2 is not None for p1, p2 in zip(pk.b1_query, pk.b2_query)])
    c_sel = _prune_sel([p is not None for p in pk.c_query])
    arrays = dict(
        a_coeff=a[0], a_wire=a[1], a_row=a[2], b_coeff=b[0], b_wire=b[1], b_row=b[2],
        a_bases=g1_limbs(pk.a_query),
        b1_bases=g1_limbs(pk.b1_query[i] for i in b_sel),
        b2_bases=g2_limbs(pk.b2_query[i] for i in b_sel),
        c_bases=g1_limbs(pk.c_query[i] for i in c_sel),
        h_bases=g1_limbs(list(pk.h_query) + [None] * (m - len(pk.h_query))),
        **_selections(widths, n_wires, b_sel, c_sel),
    )
    meta = dict(n_public=pk.n_public, n_wires=n_wires, log_m=m.bit_length() - 1, alpha_1=pk.alpha_1,
                beta_1=pk.beta_1, beta_2=pk.beta_2, delta_1=pk.delta_1, delta_2=pk.delta_2)
    return key_from_numpy(arrays, meta, device=device)


def device_pk(pk, cs, device=None) -> DeviceProvingKey:
    """A host proving key and its constraint system -> the key on
    `device`, width-classed by the circuit's wire widths.  Duck-typed
    over the ConstraintSystem (constraints, num_public, num_wires,
    wire_width)."""
    rows = qap_rows(cs)
    return device_pk_from_rows(pk, [t[0] for t in rows], [t[1] for t in rows], domain_size_for(len(rows)),
                               cs.num_wires, widths=widths_array(cs), device=device)


def infer_zkey_widths(zk) -> np.ndarray:
    """The narrow class of an imported zkey, from circom's bit-constraint
    rows x*(x-1) = 0 (Num2Bits: A = {x: 1}, B = {x: 1, one: -1}; also
    with A and B swapped): such an x gets width 1, wire 0 too, every
    other wire 254.  The zkey holds no C matrix, so x*(x-1) = y matches
    as well: a key with inferred widths checks every witness against
    them (``_check_inferred_widths``).  A repeated (row, wire) entry
    counts with its last value, as the reference reads it."""
    widths = np.full(zk.n_vars, 254, dtype=np.int32)
    widths[0] = 1
    mats = {}
    for mat in (0, 1):
        row, wire, val = zk.coeff_entries(mat)
        # last write wins: keep the last entry of each (row, wire)
        key = row.astype(np.int64) * (zk.n_vars + 1) + wire
        _, last = np.unique(key[::-1], return_index=True)
        keep = np.sort(len(key) - 1 - last)
        mats[mat] = (row[keep], wire[keep], val[keep])
    one = mont_limbs([1], R)[0]
    minus_one = mont_limbs([R - 1], R)[0]
    for x, y in ((0, 1), (1, 0)):
        xr, xw, xv = mats[x]
        yr, yw, yv = mats[y]
        n_rows = int(max(xr.max(initial=-1), yr.max(initial=-1))) + 1
        xcount = np.bincount(xr, minlength=n_rows)
        ycount = np.bincount(yr, minlength=n_rows)
        single = xcount[xr] == 1
        xr, xw, xv = xr[single], xw[single], xv[single]
        pair = ycount[yr] == 2
        yr, yw, yv = yr[pair], yw[pair], yv[pair]
        is_one = (xv == one).all(axis=1)
        # each pair row: its wire-0 entry is R - 1, its other entry (w, 1)
        neg0 = (yw == 0) & (yv == minus_one).all(axis=1)
        other = (yw != 0) & (yv == one).all(axis=1)
        neg0_rows = set(yr[neg0].tolist())
        w_of_row = dict(zip(yr[other].tolist(), yw[other].tolist()))
        for r, w, ok in zip(xr.tolist(), xw.tolist(), is_one.tolist()):
            if ok and w != 0 and r in neg0_rows and w_of_row.get(r) == w:
                widths[w] = 1
    return widths


def device_pk_from_zkey(zk, infer_widths: bool = True, device=None) -> DeviceProvingKey:
    """A snarkjs zkey (``formats.zkey.ZkeyData``) -> the key on `device`
    (CUDA unless "cpu").  The QAP rows come from the zkey's coefficient
    section (it holds the public binding rows); the point sections are
    Montgomery limbs already.  With `infer_widths` the narrow class is
    inferred (``infer_zkey_widths``) and the key records those wires in
    ``inferred_narrow_wires``, which every proof checks."""
    m = zk.domain_size
    (ac, aw, ar), (bc, bw, br) = zk.qap_row_arrays(m)
    widths = infer_zkey_widths(zk) if infer_widths else None
    nz1 = ~(zk.b1_query[0] == 0).all(-1) | ~(zk.b1_query[1] == 0).all(-1)
    nz2 = ~(zk.b2_query[0] == 0).all((-2, -1)) | ~(zk.b2_query[1] == 0).all((-2, -1))
    b_sel = _prune_sel(nz1 | nz2)
    c_all = zk.c_points()
    c_sel = _prune_sel(~(c_all[0] == 0).all(-1) | ~(c_all[1] == 0).all(-1))
    h = np.zeros((2, m, NUM_LIMBS), dtype=np.int32)
    h[:, :zk.h_query[0].shape[0]] = np.stack(zk.h_query)
    arrays = dict(
        a_coeff=ac, a_wire=aw, a_row=ar, b_coeff=bc, b_wire=bw, b_row=br,
        a_bases=np.stack(zk.a_query), b1_bases=np.stack([c[b_sel] for c in zk.b1_query]),
        b2_bases=np.stack([c[b_sel] for c in zk.b2_query]), c_bases=c_all[:, c_sel], h_bases=h,
        **_selections(widths, zk.n_vars, b_sel, c_sel),
    )
    meta = dict(n_public=zk.n_public, n_wires=zk.n_vars, log_m=m.bit_length() - 1, alpha_1=zk.alpha_1,
                beta_1=zk.beta_1, beta_2=zk.beta_2, delta_1=zk.delta_1, delta_2=zk.delta_2)
    if widths is not None:
        meta["inferred_narrow_wires"] = np.flatnonzero(widths <= NARROW_WIDTH).astype(np.int64).tobytes()
    return key_from_numpy(arrays, meta, device=device)


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
    wrong Montgomery form and an unverifiable proof.  One pass over the
    top words; the full compare only on rows whose top word reaches R's."""
    cand = np.flatnonzero(rows[:, 3] >= _R_U64[3])
    if not cand.size:
        return
    sub = rows[cand]
    ge = np.zeros(cand.size, dtype=bool)
    eq = np.ones(cand.size, dtype=bool)
    for j in range(3, -1, -1):
        col = sub[:, j]
        ge |= eq & (col > _R_U64[j])
        eq &= col == _R_U64[j]
    ge |= eq  # exactly R is unreduced too
    if ge.any():
        i = int(cand[np.flatnonzero(ge)[0]])
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


def _as_u64(witness) -> np.ndarray:
    """A host witness as its (n, 4) u64 rows (ints reduced mod R first)."""
    return witness if _is_u64_witness(witness) else _scalars_to_u64([int(w) % R for w in witness])


def witness_to_device(witness, device) -> torch.Tensor:
    """Host witness -> (n_wires, 16) Montgomery limbs on `device`: the
    (n, 4) u64 rows cross as they are (ints pack into them first), are
    split into 16-bit limbs on the device, and one K1 product takes them
    to Montgomery form.  A (B, n, 4) u64 stack of a batch's rows crosses
    in one copy and gives (B, n_wires, 16)."""
    if isinstance(witness, np.ndarray) and witness.dtype == np.uint64 and witness.ndim == 3:
        for w in witness:
            _check_u64_reduced(w)
        rows = witness
    else:
        if _is_u64_witness(witness):
            _check_u64_reduced(witness)
        rows = _as_u64(witness)
    rows = np.ascontiguousarray(rows)
    if not rows.flags.writeable:
        rows = rows.copy()
    words = torch.from_numpy(rows.view(np.int64)).to(device)
    std = words.view(torch.int16).to(torch.int32) & 0xFFFF
    return FR.to_mont(std)


def _witness_to_device_widened(witness, device) -> torch.Tensor:
    """witness_to_device as the reference does it: the limbs widened to
    (n, 16) int32 on the host and uploaded, then to_mont.  The same
    result; kept as the comparator."""
    std = torch.from_numpy(_witness_std_limbs(witness)).to(device)
    return FR.to_mont(std)


# ------------------------------------------------------------------ H ladder


def _matvec(coeff, wire, row, w_mont, m):
    vals = FR.mul(coeff, w_mont.index_select(0, wire))
    return lazy_segment_sum_mod(FR, vals, row, m)


def _abc_evals_gathered(dpk: DeviceProvingKey, w_mont: torch.Tensor) -> torch.Tensor:
    """abc_evals by gathered K1 products and segment sums (``_matvec``,
    the reference's dataflow): the same (3, m, 16); kept as the
    comparator."""
    m = 1 << dpk.log_m
    a_ev = _matvec(dpk.a_coeff, dpk.a_wire, dpk.a_row, w_mont, m)
    b_ev = _matvec(dpk.b_coeff, dpk.b_wire, dpk.b_row, w_mont, m)
    return torch.stack([a_ev, b_ev, FR.mul(a_ev, b_ev)])


def key_csr(dpk: DeviceProvingKey, name: str) -> Csr:
    """The CSR form of the key's A ("a") or B ("b") rows, built once per
    key (memoised in ``dpk._split``)."""
    got = dpk._split.get("csr." + name)
    if got is None:
        coeff, wire, row = (getattr(dpk, f"{name}_{k}") for k in ("coeff", "wire", "row"))
        got = dpk._split["csr." + name] = csr_from_rows(coeff, wire, row, 1 << dpk.log_m)
    return got


def abc_evals(dpk: DeviceProvingKey, w_mont: torch.Tensor) -> torch.Tensor:
    """Az, Bz and Cz = Az*Bz on the domain, the rows of one (3, m, 16)
    batch: Az and Bz each one K13 launch over the key's CSR rows, Cz one
    K1 product.  A batch of witnesses (B, n_wires, 16) fills one
    (3, B, m, 16) buffer with the same three launches."""
    m = 1 << dpk.log_m
    abc = torch.empty((3,) + tuple(w_mont.shape[:-2]) + (m, NUM_LIMBS), dtype=torch.int32, device=w_mont.device)
    fr_matvec(*key_csr(dpk, "a"), w_mont, out=abc[0])
    fr_matvec(*key_csr(dpk, "b"), w_mont, out=abc[1])
    abc[2] = FR.mul(abc[0], abc[1])
    return abc


def h_evals(dpk: DeviceProvingKey, w_mont: torch.Tensor, stages=None) -> torch.Tensor:
    """Coset evaluations d_j = (A*B - C)(g*w^j), (m, 16) Montgomery limbs:
    the scalars of the h MSM (Z is constant on the coset and folded into
    the h bases).

    The reference (``zkp2p_tpu/prover/groth16_tpu.py:525-538``) runs
    ntt(coset_shift(intt(ev))) on each of Az, Bz, Cz.  Here the three
    are rows of one (3, m, 16) batch through ``coset_ladder``: the iNTT's
    passes, then the NTT's, whose first pass multiplies by the table
    g^i / m as it loads (the iNTT's 1/m and the coset shift in one
    product); each pass is one K12 launch over all three rows (2^23:
    3 + 3 launches).  A batch of witnesses (B, n_wires, 16) gives (B, m,
    16): its 3B rows go through the same launches, and a*b - c runs a
    witness at a time (the plain subtraction's int64 temporaries)."""
    log_m = dpk.log_m
    m = 1 << log_m
    abc = _timed(stages, "matvec", lambda: abc_evals(dpk, w_mont))
    cos = _timed(stages, "ntt", lambda: coset_ladder(abc.reshape(-1, m, NUM_LIMBS), coset_gen(log_m), log_m))
    a_cos, b_cos, c_cos = cos.reshape(abc.shape)
    if a_cos.dim() == 2:
        return FR.sub(FR.mul(a_cos, b_cos), c_cos)
    h = torch.empty_like(a_cos)
    for i in range(h.shape[0]):
        h[i] = FR.sub(FR.mul(a_cos[i], b_cos[i]), c_cos[i])
    return h


def _h_and_planes(dpk: DeviceProvingKey, w_mont: torch.Tensor, h_window: int, stages=None):
    """H evaluations, the signed w=4 digit planes of the witness and the
    signed w=h_window planes of H; the narrow class takes the last
    NARROW_PLANES witness planes.  For a batch (B, n_wires, 16) the planes
    are (n_digits, B, n), one K14 launch each for the witnesses and H."""
    h = _timed(stages, "h_evals", lambda: h_evals(dpk, w_mont, stages))

    def planes():
        w_planes = signed_digit_planes(FR.from_mont(w_mont), WINDOW)
        h_planes = signed_digit_planes(FR.from_mont(h), h_window)
        narrow = tuple(p[-NARROW_PLANES:] for p in w_planes) if dpk.a_nsel.numel() else ()
        return (w_planes, narrow), h_planes

    w_all, h_planes = _timed(stages, "planes", planes)
    if stages is not None and h.dim() == 2:  # a batch's H (B x 512 MiB at 2^23) is not kept
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
    a narrow-class and a wide-class MSM joined by one add.  A batch of
    witnesses w_mont (B, n_wires, 16) gives (B,) accumulators, the key's
    splits built once per key as for one witness."""
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


def accumulators_to_host(acc):
    """The five device accumulators -> host affine (a, b1, b2, c, h); for
    a batch's (B,) accumulators, a list of B such tuples."""
    a, b1, c, h = (g1_jac_to_host(p) for p in (acc[0], acc[1], acc[3], acc[4]))
    rows = list(zip(a, b1, g2_jac_to_host(acc[2]), c, h))
    return rows if acc[0][0].dim() > 1 else rows[0]


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


def batch_spans(n: int, chunk: int) -> List[List[int]]:
    """The witness indices of each chunk of a batch of n (the reference's
    ``prove_tpu_batch`` rule): spans of `chunk` witnesses, the last padded
    by repeating its final witness so that every chunk has one shape;
    chunk 0, or n <= chunk, is one span of all n."""
    if chunk <= 0 or n <= chunk:
        return [list(range(n))]
    spans = [list(range(i, min(i + chunk, n))) for i in range(0, n, chunk)]
    spans[-1] += [spans[-1][-1]] * (chunk - len(spans[-1]))
    return spans


def prove_gpu_batch(
    dpk: DeviceProvingKey,
    witnesses: Sequence,
    rs: Optional[Sequence[Tuple[int, int]]] = None,
    chunk: int = 4,
    device=None,
    stages: Optional[dict] = None,
) -> List[Proof]:
    """Groth16 proofs of a batch of witnesses against one key (port of the
    reference's ``prove_tpu_batch``): one proof per witness, in order.
    Each witness is a sequence of ints or (n, 4) uint64 rows; `rs` holds
    one (r, s) pair per witness (drawn as the reference draws them, r
    then s, 1 + randbelow(R - 1) each, when None).

    The witnesses run `chunk` at a time through the device pipeline over
    a leading batch axis (``batch_spans``; the last chunk is padded with
    copies of its final witness, which give no proof; chunk 0 runs the
    whole batch as one chunk); the default 4 is the reference's.  Every
    witness passes the width guard before any device work.  The MSMs run
    the reference's default arms (Jacobian accumulate, windowed h MSM).
    Runs on CUDA unless device="cpu"; the key must be on that device.
    When `stages` is a dict it receives "chunks", one dict of stage
    seconds a chunk under prove_gpu's names, and "acc", the five host
    accumulators of each witness.  A proof equals prove_gpu's for the
    same (witness, r, s), byte for byte."""
    witnesses = list(witnesses)
    n = len(witnesses)
    if not n:
        raise ValueError("prove_gpu_batch: no witnesses")
    if isinstance(chunk, bool) or not isinstance(chunk, int) or chunk < 0:
        raise ValueError(f"chunk must be an int >= 0 (0: the whole batch as one chunk), got {chunk!r}")
    dev = resolve_device(device)
    if dpk.device != dev:
        raise ValueError(f"key is on {dpk.device}, prover asked to run on {dev}")
    if rs is None:
        rs = [(1 + secrets.randbelow(R - 1), 1 + secrets.randbelow(R - 1)) for _ in range(n)]
    rs = [(int(r), int(s)) for r, s in rs]
    if len(rs) != n:
        raise ValueError(f"prove_gpu_batch: {len(rs)} (r, s) pairs for {n} witnesses")
    for wit in witnesses:
        _check_inferred_widths(dpk, wit, w_std=wit if _is_u64_witness(wit) else None)
    proofs: List[Proof] = []
    accs = []
    for span in batch_spans(n, chunk):
        st = None if stages is None else {}
        rows = _timed(st, "witness", lambda: np.stack([_as_u64(witnesses[i]) for i in span]))
        w_mont = _timed(st, "witness", lambda: witness_to_device(rows, dev))
        del rows
        acc = _prove_device(dpk, w_mont, False, "windowed", st)
        del w_mont
        host = _timed(st, "assemble", lambda: accumulators_to_host(acc))
        real = sorted(set(span))  # the padding repeats the span's last witness
        for i, h in zip(real, host):
            proofs.append(_timed(st, "assemble", lambda: _assemble(dpk, h, *rs[i])))
            accs.append(h)
        if stages is not None:
            stages.setdefault("chunks", []).append(st)
    if stages is not None:
        stages["acc"] = accs
    return proofs
