"""Reading and writing snarkjs ``.zkey`` proving keys, whole or in chunks
(the reference's ``formats/zkey.py`` without its writer from host
points).

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
  10 contributions: the phase-2 ceremony's transcript (``MpcParams``:
                  a 64-byte circuit hash, a u32 count, then each
                  ``Contribution``); a key with none has a zero hash and
                  a count of 0.  A section in another layout (stock
                  snarkjs's records) reads as None.

Every field element is little-endian Montgomery form (R = 2^256), which
is the port's limb layout: a point section becomes (n, 16) int32 limb
arrays through a numpy view, with no loop over points.  Infinity is all
zero bytes, the key's (0, 0).  A coordinate or coefficient stored at or
above its modulus is reduced.

The chunked form splits the byte stream into equal slices with suffixes
b..k (``split_zkey``); ``read_zkey`` takes one path, the list of chunk
paths, or bytes.
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


@dataclass
class Contribution:
    """One phase-2 contribution record of section 10: the delta after it,
    a BGM17 proof of knowledge of the delta' it applied (s*G1, s*delta'*G1,
    delta'*SP), the running transcript hash; kind 0 = interactive, 1 =
    beacon, whose hash and iteration exponent let a verifier re-derive
    delta'."""

    delta_after: G1Point
    pok_g1_s: G1Point
    pok_g1_sx: G1Point
    pok_g2_spx: G2Point
    transcript: bytes  # 64
    kind: int = 0
    name: str = ""
    beacon_hash: bytes = b""
    beacon_iter_exp: int = 0


@dataclass
class MpcParams:
    cs_hash: bytes  # 64-byte circuit digest
    contributions: List[Contribution]


def _mpc_to_bytes(mpc: MpcParams) -> bytes:
    out = bytearray()
    out += mpc.cs_hash.ljust(64, b"\x00")[:64]
    out += struct.pack("<I", len(mpc.contributions))
    for c in mpc.contributions:
        out += _g1_bytes(c.delta_after) + _g1_bytes(c.pok_g1_s) + _g1_bytes(c.pok_g1_sx)
        out += _g2_bytes(c.pok_g2_spx)
        out += c.transcript.ljust(64, b"\x00")[:64]
        name_b = c.name.encode()
        out += struct.pack("<II", c.kind, len(name_b)) + name_b
        if c.kind == 1:
            out += c.beacon_hash.ljust(64, b"\x00")[:64] + struct.pack("<I", c.beacon_iter_exp)
    return bytes(out)


def _mpc_from_bytes(buf: bytes) -> Optional[MpcParams]:
    """Parse section 10 in the layout of ``_mpc_to_bytes``.  A section in
    another layout (stock snarkjs's records), with more than 10,000
    contributions, or with bytes left over parses to None, so that the key
    still imports."""
    try:
        if len(buf) < 68:
            return MpcParams(cs_hash=buf.ljust(64, b"\x00")[:64], contributions=[])
        cs_hash = buf[:64]
        (n,) = struct.unpack_from("<I", buf, 64)
        if n > 10_000:  # no real ceremony has this many rounds
            return None
        o = 68
        contribs = []
        for _ in range(n):
            if o + 384 + 8 > len(buf):
                return None
            delta_after = _g1_parse(buf[o : o + 64]); o += 64
            g1_s = _g1_parse(buf[o : o + 64]); o += 64
            g1_sx = _g1_parse(buf[o : o + 64]); o += 64
            g2_spx = _g2_parse(buf[o : o + 128]); o += 128
            transcript = buf[o : o + 64]; o += 64
            kind, name_len = struct.unpack_from("<II", buf, o); o += 8
            if kind not in (0, 1) or o + name_len > len(buf):
                return None
            name = buf[o : o + name_len].decode(); o += name_len
            beacon_hash, beacon_iter = b"", 0
            if kind == 1:
                if o + 68 > len(buf):
                    return None
                beacon_hash = buf[o : o + 64]; o += 64
                (beacon_iter,) = struct.unpack_from("<I", buf, o); o += 4
            contribs.append(
                Contribution(delta_after, g1_s, g1_sx, g2_spx, transcript, kind, name, beacon_hash, beacon_iter)
            )
        if o != len(buf):
            return None  # trailing bytes: not this layout
        return MpcParams(cs_hash=cs_hash, contributions=contribs)
    except Exception:  # noqa: BLE001 — a foreign or corrupt section imports as None
        return None


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
    mpc: Optional[MpcParams] = None  # section 10; None when absent or foreign

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


def _header(sections) -> Dict:
    """The header (sections 1 and 2) and the IC points (section 3):
    ZkeyData's fields n_vars .. ic."""
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
    ic3 = bytes(sections[3])
    ic = [_g1_parse(ic3[i * 64 : (i + 1) * 64]) for i in range(n_public + 1)]
    return dict(zip(("alpha_1", "beta_1", "beta_2", "gamma_2", "delta_1", "delta_2"), pts), n_vars=n_vars,
                n_public=n_public, domain_size=domain_size, ic=ic)


def read_zkey_vk(path: str) -> VerifyingKey:
    """The verifying key of a zkey file from its header and IC sections
    alone: the other sections (gigabytes at the flagship's size) are
    skipped, not read."""
    sections: Dict[int, bytes] = {}
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != ZKEY_MAGIC:
            raise ValueError(f"not a zkey: magic {head[:4]!r}")
        (n_sections,) = struct.unpack_from("<I", head, 8)
        for _ in range(n_sections):
            stype, size = struct.unpack("<IQ", f.read(12))
            if stype in (1, 2, 3):
                sections[stype] = f.read(size)
            else:
                f.seek(size, 1)
    h = _header(sections)
    return VerifyingKey(n_public=h["n_public"], alpha_1=h["alpha_1"], beta_2=h["beta_2"], gamma_2=h["gamma_2"],
                        delta_2=h["delta_2"], ic=h["ic"])


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

    h = _header(sections)
    n_vars, n_public, domain_size = h["n_vars"], h["n_public"], h["domain_size"]

    cbuf = sections[4]
    (n_coeffs,) = struct.unpack_from("<I", cbuf, 0)
    rec = np.frombuffer(cbuf, dtype=_COEFF, count=n_coeffs, offset=4)
    return ZkeyData(
        **h,
        coeff_matrix=rec["m"].astype(np.int64), coeff_row=rec["row"].astype(np.int64),
        coeff_wire=rec["wire"].astype(np.int64), coeff_value=_canonical(rec["v"], R),
        a_query=_g1_section(sections[5], n_vars), b1_query=_g1_section(sections[6], n_vars),
        b2_query=_g2_section(sections[7], n_vars),
        c_query=_g1_section(sections[8], n_vars - n_public - 1),
        h_query=_g1_section(sections[9], domain_size),
        mpc=_mpc_from_bytes(bytes(sections[10])) if 10 in sections else None,
    )


def _g1_bytes(pt: G1Point) -> bytes:
    if pt is None:
        return b"\x00" * (2 * N8)
    return b"".join((c * MONT_R % P).to_bytes(N8, "little") for c in pt)


def _g2_bytes(pt: G2Point) -> bytes:
    if pt is None:
        return b"\x00" * (4 * N8)
    return b"".join((v * MONT_R % P).to_bytes(N8, "little") for c in pt for v in (c.c0, c.c1))


def _points_payload(arrs: AffArrays) -> np.ndarray:
    """(x, y) Montgomery limb arrays -> the section's records as u16 limbs."""
    return np.ascontiguousarray(np.stack(arrs, axis=1).astype("<u2"))


def zkey_from_key(key, vk: VerifyingKey) -> ZkeyData:
    """The ZkeyData of a key set up by ``setup_device`` /
    ``setup_from_rows`` (duck-typed over its tensors, on any device): the
    a and h query points as they are, b1 / b2 / c scattered back over
    every wire from b_sel / c_sel (the pruned wires at infinity), the
    coefficient records from the key's A and B rows, A's first, in the
    key's order (the QAP rows' order, the binding rows included).  For a
    constraint system with nonempty A and B, written by
    ``write_zkey_data`` it is the reference's ``write_zkey(path, pk, vk,
    qap_rows(cs))`` of the same seed, byte for byte."""
    n = key.n_wires

    def host(t):
        return t.cpu().numpy()

    def scattered(bases, sel):
        out = []
        for c in bases:
            full = np.zeros((n,) + tuple(c.shape[1:]), dtype=np.int32)
            full[host(sel)] = host(c)
            out.append(full)
        return tuple(out)

    c = scattered(key.c_bases, key.c_sel)
    na, nb = key.a_row.numel(), key.b_row.numel()
    return ZkeyData(
        n_vars=n, n_public=key.n_public, domain_size=1 << key.log_m, alpha_1=key.alpha_1, beta_1=key.beta_1,
        beta_2=key.beta_2, gamma_2=vk.gamma_2, delta_1=key.delta_1, delta_2=key.delta_2, ic=list(vk.ic),
        coeff_matrix=np.concatenate([np.zeros(na, np.int64), np.ones(nb, np.int64)]),
        coeff_row=np.concatenate([host(key.a_row), host(key.b_row)]),
        coeff_wire=np.concatenate([host(key.a_wire), host(key.b_wire)]),
        coeff_value=np.concatenate([host(key.a_coeff), host(key.b_coeff)]),
        a_query=tuple(host(x) for x in key.a_bases), b1_query=scattered(key.b1_bases, key.b_sel),
        b2_query=scattered(key.b2_bases, key.b_sel), c_query=tuple(x[key.n_public + 1:] for x in c),
        h_query=tuple(host(x) for x in key.h_bases))


def write_zkey_data(path: str, z: ZkeyData) -> None:
    """Write `z` as a .zkey (the inverse of ``read_zkey``): the header and
    IC points, the coefficient records in their order, the query
    sections from the limb arrays, and section 10 from ``z.mpc`` (a key
    with no contributions when it is None).  A file written by the
    reference's ``write_zkey`` or its ceremony, read and written again,
    comes back byte for byte."""
    hdr = struct.pack("<I", N8) + P.to_bytes(N8, "little") + struct.pack("<I", N8) + R.to_bytes(N8, "little")
    hdr += struct.pack("<III", z.n_vars, z.n_public, z.domain_size)
    hdr += _g1_bytes(z.alpha_1) + _g1_bytes(z.beta_1) + _g2_bytes(z.beta_2)
    hdr += _g2_bytes(z.gamma_2) + _g1_bytes(z.delta_1) + _g2_bytes(z.delta_2)
    rec = np.empty(len(z.coeff_row), dtype=_COEFF)
    rec["m"], rec["row"], rec["wire"] = z.coeff_matrix, z.coeff_row, z.coeff_wire
    rec["v"] = z.coeff_value
    sections = [
        (1, [struct.pack("<I", 1)]),
        (2, [hdr]),
        (3, [b"".join(_g1_bytes(p) for p in z.ic)]),
        (4, [struct.pack("<I", len(rec)), rec]),
        (5, [_points_payload(z.a_query)]),
        (6, [_points_payload(z.b1_query)]),
        (7, [_points_payload(z.b2_query)]),
        (8, [_points_payload(z.c_query)]),
        (9, [_points_payload(z.h_query)]),
        (10, [_mpc_to_bytes(z.mpc or MpcParams(cs_hash=b"\x00" * 64, contributions=[]))]),
    ]
    with open(path, "wb") as f:
        f.write(ZKEY_MAGIC)
        f.write(struct.pack("<II", 1, len(sections)))
        for stype, parts in sections:
            f.write(struct.pack("<IQ", stype, sum(memoryview(p).nbytes for p in parts)))
            for p in parts:
                f.write(p)


def split_zkey(path: str, n_chunks: int = 10) -> List[str]:
    """A whole zkey -> `path` + the suffixes b.. as `n_chunks` equal
    slices of its bytes (the last shorter); returns the chunk paths."""
    if not 1 <= n_chunks <= len(CHUNK_SUFFIXES):
        raise ValueError(f"n_chunks must be 1..{len(CHUNK_SUFFIXES)} (suffixes {CHUNK_SUFFIXES})")
    with open(path, "rb") as f:
        data = f.read()
    per = (len(data) + n_chunks - 1) // n_chunks
    out = []
    for i in range(n_chunks):
        p = path + CHUNK_SUFFIXES[i]
        with open(p, "wb") as f:
            f.write(data[i * per : (i + 1) * per])
        out.append(p)
    return out
