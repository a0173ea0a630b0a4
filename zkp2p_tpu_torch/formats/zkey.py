"""Reading snarkjs ``.zkey`` proving keys, whole or in chunks (the read
side of the reference's ``formats/zkey.py``; the writers stay there).

Format (iden3 binfile, magic "zkey", version 1; snarkjs
src/zkey_utils.js): sections [type u32][size u64][payload]:

  1 header        : protocol id u32 (1 = groth16)
  2 groth16 header: n8q u32, q, n8r u32, r, nVars u32, nPublic u32,
                    domainSize u32, alpha1 G1, beta1 G1, beta2 G2,
                    gamma2 G2, delta1 G1, delta2 G2
  3 IC            : (nPublic+1) G1
  4 coeffs        : nCoeffs u32, then [matrix u32, row u32, wire u32,
                    value Fr]: matrices A (0) and B (1), the public
                    binding rows (row nConstraints + i, wire i, value 1)
                    included
  5..8 A/B1/B2/C  : one query point a wire (C omits wires 0..nPublic)
  9 H             : domainSize G1 points, the coset-Lagrange basis
  10 contributions: the ceremony's transcript (not read here)

Every field element is little-endian Montgomery form (R = 2^256), which
is the port's limb layout: a point section becomes (n, 16) int32 limb
arrays through a numpy view, with no loop over points.  Infinity is all
zero bytes, the key's (0, 0).  A coordinate or coefficient stored at or
above its modulus is reduced.

The chunked form splits the byte stream into equal slices with suffixes
b..k; ``read_zkey`` takes one path, the list of chunk paths, or bytes.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..curve.host import G1Point, G2Point
from ..field.bn254 import MONT_R, NUM_LIMBS, P, R
from ..field.tower import Fq2
from ..snark.groth16 import ProvingKey, VerifyingKey

ZKEY_MAGIC = b"zkey"
N8 = 32
CHUNK_SUFFIXES = "bcdefghijk"
_Q_INV = pow(MONT_R, -1, P)
_R_INV = pow(MONT_R, -1, R)

Limbs = np.ndarray  # (..., 16) int32 Montgomery limbs
AffArrays = Tuple[Limbs, Limbs]


def _fq_from_m(b: bytes) -> int:
    return int.from_bytes(b, "little") * _Q_INV % P


def _g1_parse(b: bytes) -> G1Point:
    if b == b"\x00" * (2 * N8):
        return None
    return (_fq_from_m(b[:N8]), _fq_from_m(b[N8:]))


def _g2_parse(b: bytes) -> G2Point:
    if b == b"\x00" * (4 * N8):
        return None
    vals = [_fq_from_m(b[i * N8 : (i + 1) * N8]) for i in range(4)]
    return (Fq2(vals[0], vals[1]), Fq2(vals[2], vals[3]))


def _int_of(limbs) -> int:
    return int.from_bytes(np.asarray(limbs, dtype="<u2").tobytes(), "little")


def _limbs_of(x: int) -> np.ndarray:
    return np.frombuffer(x.to_bytes(32, "little"), "<u2").astype(np.int32)


def _canonical(raw: np.ndarray, modulus: int) -> Limbs:
    """Little-endian 256-bit values as (..., 16) u16 limbs -> int32 limbs
    reduced mod `modulus`: one vectorised compare over the top words, a
    Python reduction only for the values at or above the modulus."""
    out = raw.astype(np.int32)
    flat = out.reshape(-1, NUM_LIMBS)
    words = np.ascontiguousarray(raw.reshape(-1, NUM_LIMBS)).view("<u8")
    mwords = np.frombuffer(modulus.to_bytes(32, "little"), "<u8")
    ge = np.zeros(words.shape[0], dtype=bool)
    eq = np.ones(words.shape[0], dtype=bool)
    for j in range(3, -1, -1):
        ge |= eq & (words[:, j] > mwords[j])
        eq &= words[:, j] == mwords[j]
    for i in np.flatnonzero(ge | eq):
        flat[i] = _limbs_of(_int_of(flat[i]) % modulus)
    return out


def _g1_section(buf: bytes, n: int) -> AffArrays:
    a = _canonical(np.frombuffer(buf, "<u2", count=n * 2 * NUM_LIMBS).reshape(n, 2, NUM_LIMBS), P)
    return a[:, 0].copy(), a[:, 1].copy()


def _g2_section(buf: bytes, n: int) -> AffArrays:
    a = _canonical(np.frombuffer(buf, "<u2", count=n * 4 * NUM_LIMBS).reshape(n, 4, NUM_LIMBS), P)
    return a[:, 0:2].copy(), a[:, 2:4].copy()


def _g1_points(arrs: AffArrays) -> List[G1Point]:
    out = []
    for x, y in zip(*arrs):
        xi, yi = _int_of(x), _int_of(y)
        out.append(None if xi == 0 and yi == 0 else (xi * _Q_INV % P, yi * _Q_INV % P))
    return out


def _g2_points(arrs: AffArrays) -> List[G2Point]:
    out = []
    for x, y in zip(*arrs):
        v = [_int_of(c) * _Q_INV % P for c in (x[0], x[1], y[0], y[1])]
        out.append(None if not any(v) else (Fq2(v[0], v[1]), Fq2(v[2], v[3])))
    return out


_COEFF = np.dtype([("m", "<u4"), ("row", "<u4"), ("wire", "<u4"), ("v", "<u2", (NUM_LIMBS,))])


@dataclass
class ZkeyData:
    """A parsed zkey: header and IC points on the host, the coefficient
    section and the query points as arrays (Montgomery limbs)."""

    n_vars: int
    n_public: int
    domain_size: int
    alpha_1: G1Point
    beta_1: G1Point
    beta_2: G2Point
    gamma_2: G2Point
    delta_1: G1Point
    delta_2: G2Point
    ic: List[G1Point]
    coeff_matrix: np.ndarray  # (n_coeffs,) 0 = A, 1 = B, in file order
    coeff_row: np.ndarray  # (n_coeffs,) int64
    coeff_wire: np.ndarray  # (n_coeffs,) int64
    coeff_value: Limbs  # (n_coeffs, 16) Montgomery limbs
    a_query: AffArrays  # (n_vars, 16) x, y
    b1_query: AffArrays
    b2_query: AffArrays  # (n_vars, 2, 16) x, y
    c_query: AffArrays  # wires n_public+1 .. n_vars-1
    h_query: AffArrays  # (domain_size, 16)

    def coeff_entries(self, mat: int):
        """(row, wire, Montgomery value) of matrix `mat` (0 = A, 1 = B), in file order."""
        sel = self.coeff_matrix == mat
        return self.coeff_row[sel], self.coeff_wire[sel], self.coeff_value[sel]

    def qap_row_arrays(self, m: Optional[int] = None):
        """The A and B matrices as (coefficients (nnz, 16) int32
        Montgomery limbs, wire ids, row ids) each, in the order of the
        reference's per-row dicts: rows ascending, a row's entries in the
        order their wires first appear, a repeated (row, wire) summed mod
        r into its first entry; an empty matrix is one zero coefficient
        in row m - 1 (m the domain size by default)."""
        m = self.domain_size if m is None else m
        return tuple(self._matrix(mat, m) for mat in (0, 1))

    def _matrix(self, mat: int, m: int):
        row, wire, val = self.coeff_entries(mat)
        if not row.size:
            return np.zeros((1, NUM_LIMBS), dtype=np.int32), np.zeros(1, np.int32), np.array([m - 1], np.int32)
        order = np.argsort(row, kind="stable")
        row, wire, val = row[order], wire[order], val[order]
        key = row * (self.n_vars + 1) + wire
        _, first, inverse, counts = np.unique(key, return_index=True, return_inverse=True, return_counts=True)
        if (counts > 1).any():
            val = val.copy()
            groups: Dict[int, int] = {}
            for i in np.flatnonzero(counts[inverse] > 1).tolist():
                g = int(inverse[i])
                groups[g] = (groups.get(g, 0) + _int_of(val[i])) % R
            for g, total in groups.items():
                val[first[g]] = _limbs_of(total)
            keep = np.zeros(row.size, dtype=bool)
            keep[first] = True
            row, wire, val = row[keep], wire[keep], val[keep]
        return val.astype(np.int32), wire.astype(np.int32), row.astype(np.int32)

    def c_points(self) -> np.ndarray:
        """The C query over every wire as a (2, n_vars, 16) stack, (0, 0)
        for wires 0..n_public."""
        out = np.zeros((2, self.n_vars, NUM_LIMBS), dtype=np.int32)
        out[:, self.n_public + 1:] = np.stack(self.c_query)
        return out

    def to_proving_key(self) -> ProvingKey:
        """The key as host points (slow at a large key: one Python int a
        coordinate)."""
        c = _g1_points(tuple(self.c_points()))
        return ProvingKey(
            n_public=self.n_public, domain_size=self.domain_size, alpha_1=self.alpha_1, beta_1=self.beta_1,
            beta_2=self.beta_2, delta_1=self.delta_1, delta_2=self.delta_2,
            a_query=_g1_points(self.a_query), b1_query=_g1_points(self.b1_query),
            b2_query=_g2_points(self.b2_query),
            c_query=[None if i <= self.n_public else p for i, p in enumerate(c)],
            h_query=_g1_points(self.h_query),
        )

    def to_verifying_key(self) -> VerifyingKey:
        return VerifyingKey(n_public=self.n_public, alpha_1=self.alpha_1, beta_2=self.beta_2,
                            gamma_2=self.gamma_2, delta_2=self.delta_2, ic=list(self.ic))


def _read_bytes(path_or_chunks) -> bytes:
    if isinstance(path_or_chunks, (bytes, bytearray)):
        return bytes(path_or_chunks)
    paths = path_or_chunks if isinstance(path_or_chunks, (list, tuple)) else [path_or_chunks]
    parts = []
    for p in paths:
        with open(p, "rb") as f:
            parts.append(f.read())
    return b"".join(parts)


def read_zkey(path_or_chunks) -> ZkeyData:
    """Parse a zkey from one path, an ordered list of chunk paths, or raw
    bytes."""
    data = _read_bytes(path_or_chunks)
    if data[:4] != ZKEY_MAGIC:
        raise ValueError(f"not a zkey: magic {data[:4]!r}")
    _version, n_sections = struct.unpack_from("<II", data, 4)
    off = 12
    sections: Dict[int, memoryview] = {}
    view = memoryview(data)
    for _ in range(n_sections):
        stype, size = struct.unpack_from("<IQ", data, off)
        off += 12
        sections[stype] = view[off : off + size]
        off += size

    (protocol,) = struct.unpack_from("<I", sections[1], 0)
    if protocol != 1:
        raise ValueError(f"not a groth16 zkey (protocol {protocol})")
    hdr = bytes(sections[2])
    o = 0
    (n8q,) = struct.unpack_from("<I", hdr, o)
    q = int.from_bytes(hdr[o + 4 : o + 4 + n8q], "little")
    o += 4 + n8q
    (n8r,) = struct.unpack_from("<I", hdr, o)
    r = int.from_bytes(hdr[o + 4 : o + 4 + n8r], "little")
    o += 4 + n8r
    if (n8q, q, n8r, r) != (N8, P, N8, R):
        raise ValueError("not a BN254 zkey")
    n_vars, n_public, domain_size = struct.unpack_from("<III", hdr, o)
    o += 12
    pts = []
    for size, parse in ((64, _g1_parse), (64, _g1_parse), (128, _g2_parse), (128, _g2_parse),
                        (64, _g1_parse), (128, _g2_parse)):
        pts.append(parse(hdr[o : o + size]))
        o += size
    alpha_1, beta_1, beta_2, gamma_2, delta_1, delta_2 = pts
    ic3 = bytes(sections[3])
    ic = [_g1_parse(ic3[i * 64 : (i + 1) * 64]) for i in range(n_public + 1)]

    cbuf = sections[4]
    (n_coeffs,) = struct.unpack_from("<I", cbuf, 0)
    rec = np.frombuffer(cbuf, dtype=_COEFF, count=n_coeffs, offset=4)
    return ZkeyData(
        n_vars=n_vars, n_public=n_public, domain_size=domain_size, alpha_1=alpha_1, beta_1=beta_1,
        beta_2=beta_2, gamma_2=gamma_2, delta_1=delta_1, delta_2=delta_2, ic=ic,
        coeff_matrix=rec["m"].astype(np.int64), coeff_row=rec["row"].astype(np.int64),
        coeff_wire=rec["wire"].astype(np.int64), coeff_value=_canonical(rec["v"], R),
        a_query=_g1_section(sections[5], n_vars), b1_query=_g1_section(sections[6], n_vars),
        b2_query=_g2_section(sections[7], n_vars),
        c_query=_g1_section(sections[8], n_vars - n_public - 1),
        h_query=_g1_section(sections[9], domain_size),
    )
