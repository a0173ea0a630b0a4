"""snarkjs's proof, public-signal and verification-key JSON (the part of
the reference's ``formats/proof_json.py`` that the command line needs).

The shapes are those snarkjs and rapidsnark write, so a proof from the
port drops into ``snarkjs groth16 verify``: a G1 point is [x, y, "1"], a
G2 point [[x.c0, x.c1], [y.c0, y.c1], ["1", "0"]], every number a
decimal string.  A point at infinity has no such form and raises.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

from ..curve.host import G1Point, G2Point
from ..field.tower import Fq2
from ..snark.groth16 import Proof, VerifyingKey


def _g1(pt: G1Point) -> List[str]:
    if pt is None:
        raise ValueError("a G1 point at infinity has no snarkjs JSON form")
    return [str(pt[0]), str(pt[1]), "1"]


def _g2(pt: G2Point) -> List[List[str]]:
    if pt is None:
        raise ValueError("a G2 point at infinity has no snarkjs JSON form")
    x, y = pt
    return [[str(x.c0), str(x.c1)], [str(y.c0), str(y.c1)], ["1", "0"]]


def _parse_g1(v: Sequence) -> G1Point:
    x, y = int(v[0]), int(v[1])
    if x == 0 and y == 0:
        return None
    return (x, y)


def _parse_g2(v: Sequence) -> G2Point:
    return (Fq2(int(v[0][0]), int(v[0][1])), Fq2(int(v[1][0]), int(v[1][1])))


def proof_to_json(proof: Proof) -> Dict:
    return {
        "pi_a": _g1(proof.a),
        "pi_b": _g2(proof.b),
        "pi_c": _g1(proof.c),
        "protocol": "groth16",
        "curve": "bn128",
    }


def proof_from_json(d: Dict) -> Proof:
    return Proof(a=_parse_g1(d["pi_a"]), b=_parse_g2(d["pi_b"]), c=_parse_g1(d["pi_c"]))


def public_to_json(signals: Sequence[int]) -> List[str]:
    return [str(s) for s in signals]


def vkey_to_json(vk: VerifyingKey) -> Dict:
    """snarkjs verification_key.json, without ``vk_alphabeta_12`` (snarkjs
    computes the pairings from the points when it verifies)."""
    return {
        "protocol": "groth16",
        "curve": "bn128",
        "nPublic": vk.n_public,
        "vk_alpha_1": _g1(vk.alpha_1),
        "vk_beta_2": _g2(vk.beta_2),
        "vk_gamma_2": _g2(vk.gamma_2),
        "vk_delta_2": _g2(vk.delta_2),
        "IC": [_g1(pt) for pt in vk.ic],
    }


def vkey_from_json(d: Dict) -> VerifyingKey:
    return VerifyingKey(
        n_public=int(d["nPublic"]),
        alpha_1=_parse_g1(d["vk_alpha_1"]),
        beta_2=_parse_g2(d["vk_beta_2"]),
        gamma_2=_parse_g2(d["vk_gamma_2"]),
        delta_2=_parse_g2(d["vk_delta_2"]),
        ic=[_parse_g1(p) for p in d["IC"]],
    )


def dump(obj, path: str) -> None:
    """Write `obj` as JSON (indent 1) through a temporary file and a
    rename, so that a reader sees the old file or the new one, never half
    of one."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
    os.replace(tmp, path)


def load(path: str):
    with open(path) as f:
        return json.load(f)
