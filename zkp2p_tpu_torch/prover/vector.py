"""The port's test vector: a small proving key in the reference's array
layout, a witness, the blinding scalars and the proof they must give.

Stored as one .npz of integer arrays (no pickles): limb arrays as
uint16, the witness as (n, 4) uint64 rows, and every host integer (the
blinding points, r, s, the proof) as 16 little-endian 16-bit limbs of its
standard form.  ``data/port_vector.npz`` is the committed instance."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from ..field.tower import Fq2
from ..snark.groth16 import Proof
from .groth16_gpu import DPK_ARRAY_FIELDS

VECTOR_PATH = Path(__file__).resolve().parent.parent / "data" / "port_vector.npz"

_LIMB_ARRAYS = ("a_coeff", "b_coeff", "a_bases", "b1_bases", "b2_bases", "c_bases", "h_bases")


def _limbs(x: int) -> np.ndarray:
    return np.frombuffer(int(x).to_bytes(32, "little"), "<u2").copy()


def _int(limbs) -> int:
    return int.from_bytes(np.asarray(limbs, dtype="<u2").tobytes(), "little")


def _g1(p) -> np.ndarray:
    return np.stack([_limbs(0), _limbs(0)] if p is None else [_limbs(p[0]), _limbs(p[1])])


def _g2(p) -> np.ndarray:
    if p is None:
        return np.zeros((2, 2, 16), dtype=np.uint16)
    return np.stack([np.stack([_limbs(v) for v in ((c.c0, c.c1) if hasattr(c, "c0") else c)]) for c in p])


def _g1_back(a):
    x, y = _int(a[0]), _int(a[1])
    return None if (x, y) == (0, 0) else (x, y)


def _g2_back(a):
    pt = tuple(Fq2(_int(c[0]), _int(c[1])) for c in a)
    return None if all(c.is_zero() for c in pt) else pt


def save_vector(path, arrays: Dict[str, np.ndarray], meta: Dict[str, object],
                witness_u64: np.ndarray, r: int, s: int, proof) -> None:
    """Write a vector.  `arrays`/`meta` are what ``key_from_numpy`` takes;
    a G2 coordinate is a (c0, c1) pair or anything with c0/c1."""
    out = {}
    for name in DPK_ARRAY_FIELDS:
        a = np.asarray(arrays[name])
        out[name] = a.astype(np.uint16) if name in _LIMB_ARRAYS else a.astype(np.int32)
    out["shape"] = np.array([meta["n_public"], meta["n_wires"], meta["log_m"]], dtype=np.int64)
    out["g1_points"] = np.stack([_g1(meta[k]) for k in ("alpha_1", "beta_1", "delta_1")])
    out["g2_points"] = np.stack([_g2(meta[k]) for k in ("beta_2", "delta_2")])
    blob = meta.get("inferred_narrow_wires") or b""
    out["inferred_narrow_wires"] = np.frombuffer(blob, dtype=np.int64)
    out["witness"] = np.asarray(witness_u64, dtype=np.uint64)
    out["r_s"] = np.stack([_limbs(r), _limbs(s)])
    out["proof_a"], out["proof_b"], out["proof_c"] = _g1(proof.a), _g2(proof.b), _g1(proof.c)
    np.savez_compressed(path, **out)


def load_vector(path=VECTOR_PATH) -> Tuple[Dict[str, np.ndarray], Dict[str, object], np.ndarray, int, int, Proof]:
    """-> (arrays, meta, witness (n, 4) uint64, r, s, expected proof)."""
    with np.load(path) as z:
        arrays = {name: z[name] for name in DPK_ARRAY_FIELDS}
        n_public, n_wires, log_m = (int(v) for v in z["shape"])
        g1, g2 = z["g1_points"], z["g2_points"]
        blob = z["inferred_narrow_wires"].tobytes()
        meta = dict(
            n_public=n_public, n_wires=n_wires, log_m=log_m,
            alpha_1=_g1_back(g1[0]), beta_1=_g1_back(g1[1]), delta_1=_g1_back(g1[2]),
            beta_2=_g2_back(g2[0]), delta_2=_g2_back(g2[1]),
            inferred_narrow_wires=blob or None,
        )
        r, s = (_int(v) for v in z["r_s"])
        proof = Proof(a=_g1_back(z["proof_a"]), b=_g2_back(z["proof_b"]), c=_g1_back(z["proof_c"]))
        return arrays, meta, z["witness"].copy(), r, s, proof
