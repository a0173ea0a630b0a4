"""circom's witness file, ``.wtns``, read and written (the witness half of
the reference's ``formats/circom_bin.py``).

Format (iden3 binfile, magic "wtns", version 2): sections [type u32]
[size u64][payload]; section 1 is the header (field size u32 = 32, the
prime, the number of wires u32), section 2 the witness, one 32-byte
little-endian value a wire.

The reader gives the witness as (n, 4) little-endian u64 rows, the
prover's witness layout, from one ``np.frombuffer`` over section 2: no
Python int a wire.  The rows are the file's values as they are: a value
at or above R (the reference's reader returns it raw and its prover
proves its residue) is reduced by ``reduce_rows``.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Sequence

import numpy as np

from ..field.bn254 import R

WTNS_MAGIC = b"wtns"
N8 = 32
R_U64 = np.frombuffer(R.to_bytes(N8, "little"), dtype="<u8").copy()
# every value below 2^256 is below 6 R: at most 5 subtractions reduce it
_MAX_SUBTRACTIONS = (1 << 256) // R


def _sections(data: bytearray, magic: bytes) -> Dict[int, memoryview]:
    if data[:4] != magic:
        raise ValueError(f"not a {magic.decode()} file: magic {data[:4]!r}")
    _version, n_sections = struct.unpack_from("<II", data, 4)
    view = memoryview(data)
    off = 12
    sections: Dict[int, memoryview] = {}
    for _ in range(n_sections):
        stype, size = struct.unpack_from("<IQ", data, off)
        off += 12
        sections[stype] = view[off : off + size]
        off += size
    return sections


def read_wtns(path: str) -> np.ndarray:
    """The witness of a .wtns file as (n, 4) ``<u8`` rows, the file's
    values unreduced: a writable view of the one buffer the file is read
    into, so that the upload copies nothing more.  Raises ValueError on
    another magic, a field other than BN254's scalar field, or a short
    witness section."""
    data = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        f.readinto(data)
    sections = _sections(data, WTNS_MAGIC)
    hdr = bytes(sections[1])
    (fs,) = struct.unpack_from("<I", hdr, 0)
    prime = int.from_bytes(hdr[4 : 4 + fs], "little")
    if fs != N8 or prime != R:
        raise ValueError(f"{path}: not a BN254-scalar witness (field size {fs}, prime {prime})")
    (n,) = struct.unpack_from("<I", hdr, 4 + fs)
    body = sections[2]
    if len(body) < n * N8:
        raise ValueError(f"{path}: witness section holds {len(body)} bytes, {n} wires need {n * N8}")
    return np.frombuffer(body, dtype="<u8", count=n * 4).reshape(n, 4)


def scalars_to_u64(scalars: Sequence[int]) -> np.ndarray:
    """Python ints in [0, 2^256) -> (n, 4) little-endian u64 rows."""
    buf = b"".join(int(s).to_bytes(N8, "little") for s in scalars)
    return np.frombuffer(buf, dtype="<u8").reshape(len(scalars), 4)


def ge_r(rows: np.ndarray) -> np.ndarray:
    """Which (n, 4) u64 rows hold a value at or above R, compared from the
    top word down."""
    ge = np.zeros(rows.shape[0], dtype=bool)
    eq = np.ones(rows.shape[0], dtype=bool)
    for j in range(3, -1, -1):
        ge |= eq & (rows[:, j] > R_U64[j])
        eq &= rows[:, j] == R_U64[j]
    return ge | eq


def _sub_r(rows: np.ndarray) -> np.ndarray:
    out = np.empty_like(rows)
    borrow = np.zeros(rows.shape[0], dtype=np.uint64)
    for j in range(4):
        t = rows[:, j] - R_U64[j]
        out[:, j] = t - borrow
        borrow = ((rows[:, j] < R_U64[j]) | (t < borrow)).astype(np.uint64)
    return out


def reduce_rows(rows: np.ndarray) -> np.ndarray:
    """(n, 4) u64 rows of values below 2^256 -> their residues mod R: the
    rows themselves when all are reduced, else a copy.  Only the rows
    whose top word reaches R's are compared."""
    cand = np.flatnonzero(rows[:, 3] >= R_U64[3])
    if not cand.size:
        return rows
    sub = rows[cand]
    changed = False
    for _ in range(_MAX_SUBTRACTIONS):
        ge = ge_r(sub)
        if not ge.any():
            break
        sub[ge] = _sub_r(sub[ge])
        changed = True
    if not changed:
        return rows
    out = rows.copy()
    out[cand] = sub
    return out


def row_ints(rows: np.ndarray):
    """(k, 4) u64 rows -> their values as Python ints."""
    return [int.from_bytes(r.tobytes(), "little") for r in np.asarray(rows, dtype="<u8")]


def write_wtns(witness, path: str) -> None:
    """Write a witness (a sequence of ints or (n, 4) u64 rows) as a .wtns
    file, each value reduced mod R, as the reference writes it."""
    if isinstance(witness, np.ndarray) and witness.dtype == np.uint64 and witness.ndim == 2:
        body = np.ascontiguousarray(reduce_rows(witness), dtype="<u8")
    else:
        body = scalars_to_u64([int(w) % R for w in witness])
    n = body.shape[0]
    header = struct.pack("<I", N8) + R.to_bytes(N8, "little") + struct.pack("<I", n)
    size = n * N8
    with open(path, "wb") as f:
        f.write(WTNS_MAGIC)
        f.write(struct.pack("<II", 2, 2))
        f.write(struct.pack("<IQ", 1, len(header)))
        f.write(header)
        f.write(struct.pack("<IQ", 2, size))
        f.write(body)
