"""Groth16 phase-2 ceremony over zkeys: contribute, beacon, verify (port of
the reference's ``snark/ceremony.py``, the BGM17 update and proof scheme
snarkjs uses, with blake2b-512 transcripts).

  contribute  pick delta'; delta1 *= delta', delta2 *= delta', every C and
              H query point *= 1/delta'; publish a proof of knowledge
              (s*G1, delta'*s*G1, delta'*SP), SP = hash_to_g2 of the
              transcript's running challenge.
  beacon      the same update with delta' derived from a public beacon
              value by 2^iter_exp iterated hashes, which verifiers
              re-derive.
  verify      per contribution the proof-of-knowledge pairing checks, the
              link deltaAfter = delta' * deltaBefore and the transcript
              hash; beacon deltas re-derived; delta1 / delta2 consistent;
              and a random-linear-combination pairing check that the final
              C and H queries are the initial ones scaled by the
              accumulated 1/delta': e(sum rho_i C_i^f, delta2^f) =
              e(sum rho_i C_i^0, delta2^0).

The query points stay the zkey's limb arrays and the work over them runs
on the card: the rescale is one launch of K19 (``ops.cuda_scale``) over
the C and H queries together, then K15's ``jac_to_affine``; the verify's
on-curve test of every final point is K1 products compared elementwise,
and its four random combinations are the windowed MSM (K14's planes of
127-bit rho, K6/K7, K10, K18).  ``circuit_hash`` converts the points and
coefficients it hashes out of Montgomery form by K1 and hashes them as
packed arrays.  The transcript, the hash to G2, the single-point products
and the pairings stay on the host.

Every file-level entry (``contribute``, ``beacon``, ``verify_chain``)
takes the reference's arguments plus ``device`` (the card unless
"cpu"; raises with no CUDA device) and ``stages`` (a dict that receives
each stage's seconds as "s_<stage>"); ``contribute_zkey``,
``beacon_zkey`` and ``verify_zkeys`` do the same work on parsed keys.
``contribute`` and ``beacon`` draw from ``secrets`` as the reference
does, in its order (``token_bytes(32)`` then ``randbelow(R - 1)``), so
with those pinned both packages write the same file.  ``verify_chain``
draws the combinations' rho from the OS CSPRNG in one call a query; its
verdict and log lines are the reference's.
"""

from __future__ import annotations

import hashlib
import os
import secrets
import struct
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..curve.host import (G1_GENERATOR, G2_GENERATOR, TWIST_B, G1Point, G2Point, g1_is_on_curve, g1_mul, g1_neg,
                          g2_is_on_curve, g2_mul)
from ..curve.tcurve import G1C, g1_jac_to_host
from ..field.bn254 import NUM_LIMBS, P, R
from ..field.tfield import FQ, FR
from ..field.tower import Fq2
from ..formats.zkey import Contribution, MpcParams, ZkeyData, read_zkey, write_zkey_data
from ..ops.cuda_scale import g1_scale
from ..ops.msm import default_lanes, msm_windowed_signed, signed_digit_planes
from ..ops.msm_affine import jac_to_affine_batch
from ..pairing.pairing import pairing_product_is_one
from ..prover.groth16_gpu import _timed
from ..utils.device import resolve_device

ZERO_HASH = b"\x00" * 64
RHO_BITS = 127  # the verify's random combination coefficients
WINDOW = 4  # of the combinations' signed digit planes

# ------------------------------------------------------------- hash-to-G2

# The order of the sextic twist E'(Fq2) that carries G2 is h2 * r with
# h2 = 2p - r; multiplying a twist point by h2 lands it in the r-torsion.
G2_COFACTOR = 2 * P - R


def _fq_sqrt(a: int) -> Optional[int]:
    """Square root in Fq (p = 3 mod 4): a^((p+1)/4), checked."""
    r_ = pow(a, (P + 1) // 4, P)
    return r_ if r_ * r_ % P == a % P else None


def _fq2_sqrt(a: Fq2) -> Optional[Fq2]:
    """Square root in Fq2 = Fq[u]/(u^2+1) by the norm."""
    if a.c0 == 0 and a.c1 == 0:
        return Fq2(0, 0)
    norm = (a.c0 * a.c0 + a.c1 * a.c1) % P
    alpha = _fq_sqrt(norm)
    if alpha is None:
        return None
    inv2 = pow(2, P - 2, P)
    lam = (a.c0 + alpha) * inv2 % P
    x0 = _fq_sqrt(lam)
    if x0 is None:
        lam = (a.c0 - alpha) * inv2 % P
        x0 = _fq_sqrt(lam)
        if x0 is None:
            return None
    x1 = a.c1 * inv2 % P * pow(x0, P - 2, P) % P
    cand = Fq2(x0, x1)
    return cand if cand * cand == a else None


def hash_to_g2(seed: bytes) -> G2Point:
    """Deterministic try-and-increment map into the r-torsion of the twist
    (the SP point of the proof of knowledge)."""
    ctr = 0
    while True:
        h = hashlib.blake2b(seed + ctr.to_bytes(4, "little"), digest_size=64).digest()
        x = Fq2(int.from_bytes(h[:32], "little") % P, int.from_bytes(h[32:], "little") % P)
        y = _fq2_sqrt(x * x * x + TWIST_B)
        ctr += 1
        if y is None:
            continue
        pt = (x, y)
        assert g2_is_on_curve(pt)
        pt = g2_mul(pt, G2_COFACTOR)
        if pt is not None:  # cofactor clearing can hit infinity: retry
            assert g2_mul(pt, R) is None, "cofactor clearing left the r-torsion"
            return pt


# ------------------------------------------------------------- transcript


def _challenge(mpc: MpcParams, upto: int) -> bytes:
    """The challenge the contributor at position `upto` signs into its SP
    point: the circuit hash chained through every earlier transcript."""
    h = hashlib.blake2b(digest_size=64)
    h.update(mpc.cs_hash)
    for c in mpc.contributions[:upto]:
        h.update(c.transcript)
    return h.digest()


def _g1_raw(pt: G1Point) -> bytes:
    if pt is None:
        return b"\x00" * 64
    return pt[0].to_bytes(32, "little") + pt[1].to_bytes(32, "little")


def _g2_raw(pt: G2Point) -> bytes:
    if pt is None:
        return b"\x00" * 128
    x, y = pt
    return b"".join(v.to_bytes(32, "little") for v in (x.c0, x.c1, y.c0, y.c1))


# ------------------------------------------------------------ the card's part


def _standard(field, limbs: np.ndarray, dev: torch.device) -> np.ndarray:
    """Montgomery limbs (..., 16) int32 -> the canonical standard-form
    values as (..., 16) little-endian u16, i.e. 32 bytes a value: one K1
    product by 1 on the card."""
    t = torch.from_numpy(np.ascontiguousarray(limbs)).to(dev)
    return field.from_mont(t).cpu().numpy().astype("<u2")


_COEFF_RAW = np.dtype([("m", "u1"), ("row", "<u4"), ("wire", "<u4"), ("v", "<u2", (NUM_LIMBS,))])
HASH_RECORDS = 1 << 22  # coefficient records a piece of circuit_hash


def _hashed_pieces(z: ZkeyData, dev: torch.device):
    """circuit_hash's input after the header and IC, in order: each of the
    A, B1 and B2 queries as its points' standard-form bytes, x then y
    (G2: x.c0, x.c1, y.c0, y.c1; a (0, 0) hole zero bytes, as None is),
    then the coefficient records, HASH_RECORDS a piece."""
    for arrs in (z.a_query, z.b1_query, z.b2_query):
        yield np.stack([_standard(FQ, c, dev) for c in arrs], axis=1)
    for i in range(0, len(z.coeff_row), HASH_RECORDS):
        j = min(i + HASH_RECORDS, len(z.coeff_row))
        rec = np.empty(j - i, dtype=_COEFF_RAW)
        rec["m"], rec["row"], rec["wire"] = z.coeff_matrix[i:j], z.coeff_row[i:j], z.coeff_wire[i:j]
        rec["v"] = _standard(FR, z.coeff_value[i:j], dev)
        yield rec


def circuit_hash(z: ZkeyData, device=None) -> bytes:
    """The 64-byte blake2b digest of the key material no contribution may
    touch, as the reference hashes it: alpha1, beta1, beta2, gamma2, the
    IC, A, B1 and B2 query points in standard form, then each coefficient
    record as m (1 byte), row, wire (4 bytes each) and its standard-form
    value (32 bytes).  The points and values leave Montgomery form by K1
    on `device`, a piece at a time, while a thread hashes the piece
    before (hashlib lets go of the interpreter over a large buffer)."""
    dev = resolve_device(device)
    h = hashlib.blake2b(digest_size=64)
    h.update(_g1_raw(z.alpha_1) + _g1_raw(z.beta_1) + _g2_raw(z.beta_2) + _g2_raw(z.gamma_2))
    h.update(b"".join(_g1_raw(pt) for pt in z.ic))
    with ThreadPoolExecutor(1) as pool:
        pending = None
        for piece in _hashed_pieces(z, dev):
            if pending is not None:
                pending.result()
            pending = pool.submit(h.update, piece)
        if pending is not None:
            pending.result()
    return h.digest()


def _scale_queries(z: ZkeyData, delta_prime: int, dev: torch.device, stages=None) -> ZkeyData:
    """A contribution's delta' applied to the key: delta1 and delta2 times
    delta' on the host; the C and H queries times 1/delta' in one K19
    launch over both, normalised by K15 ((0, 0) holes stay (0, 0))."""
    dinv = pow(delta_prime, R - 2, R)
    n_c = z.c_query[0].shape[0]

    def scale():
        x, y = (torch.from_numpy(np.concatenate([c, hq])).to(dev) for c, hq in zip(z.c_query, z.h_query))
        ax, ay = jac_to_affine_batch(FQ, g1_scale((x, y), dinv))
        return ax.cpu().numpy(), ay.cpu().numpy()

    ax, ay = _timed(stages, "scale", scale)
    return replace(
        z,
        delta_1=g1_mul(z.delta_1, delta_prime),
        delta_2=g2_mul(z.delta_2, delta_prime),
        c_query=(ax[:n_c], ay[:n_c]),
        h_query=(ax[n_c:], ay[n_c:]),
    )


def _append_contribution(z: ZkeyData, delta_prime: int, kind: int, name: str, dev: torch.device,
                         beacon_hash: bytes = b"", beacon_iter_exp: int = 0, stages=None) -> ZkeyData:
    mpc = z.mpc or MpcParams(cs_hash=ZERO_HASH, contributions=[])
    challenge = _challenge(mpc, len(mpc.contributions))
    sp = hash_to_g2(challenge)
    s = 1 + secrets.randbelow(R - 1)
    g1_s = g1_mul(G1_GENERATOR, s)
    g1_sx = g1_mul(G1_GENERATOR, s * delta_prime % R)
    g2_spx = g2_mul(sp, delta_prime)
    z2 = _scale_queries(z, delta_prime, dev, stages)
    transcript = hashlib.blake2b(
        challenge + _g1_raw(z2.delta_1) + _g1_raw(g1_s) + _g1_raw(g1_sx) + _g2_raw(g2_spx),
        digest_size=64,
    ).digest()
    contrib = Contribution(
        delta_after=z2.delta_1,
        pok_g1_s=g1_s,
        pok_g1_sx=g1_sx,
        pok_g2_spx=g2_spx,
        transcript=transcript,
        kind=kind,
        name=name,
        beacon_hash=beacon_hash,
        beacon_iter_exp=beacon_iter_exp,
    )
    return replace(z2, mpc=MpcParams(mpc.cs_hash, mpc.contributions + [contrib]))


def _bound(z: ZkeyData, dev: torch.device, stages=None) -> ZkeyData:
    """z with its MPC section bound to its circuit: the circuit hash
    computed where the key has none (a fresh setup's zero hash)."""
    if z.mpc is None or z.mpc.cs_hash == ZERO_HASH:
        cs_hash = _timed(stages, "circuit_hash", lambda: circuit_hash(z, dev))
        z = replace(z, mpc=MpcParams(cs_hash=cs_hash, contributions=(z.mpc.contributions if z.mpc else [])))
    return z


def _read(path, stages=None) -> ZkeyData:
    return _timed(stages, "read", lambda: read_zkey(path))


def _write(path: str, z: ZkeyData, stages=None) -> None:
    _timed(stages, "write", lambda: write_zkey_data(path, z))


# ------------------------------------------------------------ public ops


def contribute_zkey(z: ZkeyData, entropy: bytes, name: str = "", device=None, stages=None) -> ZkeyData:
    """One interactive contribution to a parsed key, delta' drawn from the
    caller's entropy and 32 fresh CSPRNG bytes."""
    dev = resolve_device(device)
    z = _bound(z, dev, stages)
    seed = hashlib.blake2b(entropy + secrets.token_bytes(32), digest_size=64).digest()
    delta_prime = 1 + int.from_bytes(seed, "little") % (R - 1)
    return _append_contribution(z, delta_prime, kind=0, name=name, dev=dev, stages=stages)


def contribute(zkey_in: str, zkey_out: str, entropy: bytes, name: str = "", device=None,
               stages=None) -> ZkeyData:
    """``snarkjs zkey contribute``: read `zkey_in`, contribute, write
    `zkey_out`."""
    dev = resolve_device(device)
    z2 = contribute_zkey(_read(zkey_in, stages), entropy, name=name, device=dev, stages=stages)
    _write(zkey_out, z2, stages)
    return z2


# snarkjs caps the beacon's iteration exponent at 63; past ~32 it is months
# of hashing, and a verifier re-derives it from bytes the file controls
MAX_BEACON_ITER_EXP = 32


def _check_iter_exp(iter_exp: int) -> None:
    if not 0 <= iter_exp <= MAX_BEACON_ITER_EXP:
        raise ValueError(f"beacon iter_exp {iter_exp} outside [0, {MAX_BEACON_ITER_EXP}]")


def beacon_delta(beacon_hash: bytes, iter_exp: int) -> int:
    """The beacon's delta': 2^iter_exp iterated blake2b-512 over the public
    beacon value, reduced into Fr*."""
    _check_iter_exp(iter_exp)
    h = beacon_hash
    for _ in range(1 << iter_exp):
        h = hashlib.blake2b(h, digest_size=64).digest()
    return 1 + int.from_bytes(h, "little") % (R - 1)


def beacon_zkey(z: ZkeyData, beacon_hash: bytes, iter_exp: int = 10, name: str = "final beacon", device=None,
                stages=None) -> ZkeyData:
    """The closing contribution to a parsed key, delta' re-derivable from
    the public beacon value (normalised first to the 64 bytes stored)."""
    dev = resolve_device(device)
    z = _bound(z, dev, stages)
    beacon_hash = beacon_hash.ljust(64, b"\x00")[:64]
    delta_prime = beacon_delta(beacon_hash, iter_exp)
    return _append_contribution(z, delta_prime, kind=1, name=name, dev=dev, beacon_hash=beacon_hash,
                                beacon_iter_exp=iter_exp, stages=stages)


def beacon(zkey_in: str, zkey_out: str, beacon_hash: bytes, iter_exp: int = 10, name: str = "final beacon",
           device=None, stages=None) -> ZkeyData:
    """``snarkjs zkey beacon``: read `zkey_in`, apply the beacon, write
    `zkey_out`."""
    dev = resolve_device(device)
    _check_iter_exp(iter_exp)  # before the read, as beacon_delta would after it
    z2 = beacon_zkey(_read(zkey_in, stages), beacon_hash, iter_exp=iter_exp, name=name, device=dev, stages=stages)
    _write(zkey_out, z2, stages)
    return z2


def _holes(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return FQ.is_zero(x) & FQ.is_zero(y)


ON_CURVE_CHUNK = 1 << 21  # points a pass of _on_curve (bounds its int64 temporaries)


def _on_curve(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether y^2 == x^3 + 3 for every point, Montgomery limbs (three K1
    products a chunk of ON_CURVE_CHUNK points)."""
    three = torch.from_numpy(FQ.to_mont_host(3)).to(x.device)
    for i in range(0, x.shape[0], ON_CURVE_CHUNK):
        xc, yc = x[i:i + ON_CURVE_CHUNK], y[i:i + ON_CURVE_CHUNK]
        if not bool(FQ.eq(FQ.mul(yc, yc), FQ.add(FQ.mul(FQ.mul(xc, xc), xc), three.expand_as(xc))).all()):
            return False
    return True


def _combination(points, rho: torch.Tensor) -> G1Point:
    """sum rho_i * P_i on the card: the windowed MSM over K14's signed
    planes of rho, the planes above its width dropped: rho < 2^127 makes
    its top 4-bit digit at most 7, so no carry leaves it and the planes
    above are zero, and a Horner fold over leading zero planes adds
    nothing."""
    mags, negs = signed_digit_planes(rho, WINDOW)
    live = -(-RHO_BITS // WINDOW)
    n = rho.shape[0]
    jac = msm_windowed_signed(G1C, points, mags[-live:], negs[-live:], lanes=default_lanes(n), window=WINDOW)
    return g1_jac_to_host(jac)[0]


def verify_zkeys(zi: ZkeyData, zf: ZkeyData, device=None, stages=None) -> Tuple[bool, List[str]]:
    """``verify_chain`` on parsed keys: `zi` the trusted initial key (no
    contributions), `zf` the final one.  Returns (ok, log)."""
    dev = resolve_device(device)
    log: List[str] = []

    def fail(msg: str) -> Tuple[bool, List[str]]:
        log.append(f"FAIL: {msg}")
        return False, log

    # 1. the material no contribution touches is the initial key's
    hash_i = _timed(stages, "circuit_hash", lambda: circuit_hash(zi, dev))
    if hash_i != _timed(stages, "circuit_hash", lambda: circuit_hash(zf, dev)):
        return fail("circuit material (alpha/beta/gamma/IC/A/B/coeffs) differs")
    mpc = zf.mpc
    if mpc is None:
        return fail("final zkey has no MPC section")
    if mpc.cs_hash != hash_i:
        return fail("cs_hash does not bind to the initial circuit")
    log.append(f"circuit hash bound; {len(mpc.contributions)} contribution(s)")

    # every point checked before any pairing sees it: G1 has cofactor 1
    # (on the curve = in the group), G2 needs the r-torsion check
    def g1_ok(pt) -> bool:
        return pt is not None and g1_is_on_curve(pt)

    def g2_ok(pt) -> bool:
        return pt is not None and g2_is_on_curve(pt) and g2_mul(pt, R) is None

    def chain() -> Tuple[bool, str]:
        for i, c in enumerate(mpc.contributions):
            if not (g1_ok(c.delta_after) and g1_ok(c.pok_g1_s) and g1_ok(c.pok_g1_sx)):
                return False, f"contribution {i}: G1 point off-curve/infinity"
            if not g2_ok(c.pok_g2_spx):
                return False, f"contribution {i}: g2_spx off-curve or outside the r-torsion"
            if c.kind == 1 and not 0 <= c.beacon_iter_exp <= MAX_BEACON_ITER_EXP:
                return False, f"contribution {i}: beacon iter_exp {c.beacon_iter_exp} over cap"
        if not (g1_ok(zf.delta_1) and g2_ok(zf.delta_2)):
            return False, "final delta off-curve or outside the subgroup"

        # 2. the delta chain, with the proof-of-knowledge pairing checks
        delta_before = zi.delta_1
        for i, c in enumerate(mpc.contributions):
            challenge = _challenge(mpc, i)
            sp = hash_to_g2(challenge)
            # e(g1_sx, SP) == e(g1_s, g2_spx): the same delta' on both sides
            if not pairing_product_is_one([(c.pok_g1_sx, sp), (g1_neg(c.pok_g1_s), c.pok_g2_spx)]):
                return False, f"contribution {i}: proof of knowledge rejected"
            # e(deltaAfter, SP) == e(deltaBefore, g2_spx)
            if not pairing_product_is_one([(c.delta_after, sp), (g1_neg(delta_before), c.pok_g2_spx)]):
                return False, f"contribution {i}: deltaAfter != delta'*deltaBefore"
            expect = hashlib.blake2b(
                challenge + _g1_raw(c.delta_after) + _g1_raw(c.pok_g1_s) + _g1_raw(c.pok_g1_sx)
                + _g2_raw(c.pok_g2_spx),
                digest_size=64,
            ).digest()
            if expect != c.transcript:
                return False, f"contribution {i}: transcript hash mismatch"
            if c.kind == 1:
                if g1_mul(delta_before, beacon_delta(c.beacon_hash, c.beacon_iter_exp)) != c.delta_after:
                    return False, f"contribution {i}: beacon delta does not re-derive"
                log.append(f"contribution {i}: beacon re-derived (iter_exp={c.beacon_iter_exp})")
            else:
                log.append(f"contribution {i}: PoK + delta link verified")
            delta_before = c.delta_after
        if delta_before != zf.delta_1:
            return False, "final delta1 is not the chain head"
        # delta1 (G1) and delta2 (G2) carry the same scalar: e(delta1, G2) == e(G1, delta2)
        if not pairing_product_is_one([(zf.delta_1, G2_GENERATOR), (g1_neg(G1_GENERATOR), zf.delta_2)]):
            return False, "final delta1/delta2 inconsistent"
        return True, ""

    ok, why = _timed(stages, "chain", chain)
    if not ok:
        return fail(why)
    log.append("delta chain closed; delta1/delta2 consistent")

    # 3. the query scaling: for random rho, e(sum rho_i C_i^f, delta2^f) ==
    # e(sum rho_i C_i^0, delta2^0), the delta' factors cancelling
    def combo(points_f, points_i, tag: str) -> bool:
        # a length mismatch is a forgery vector of its own (circuit_hash
        # does not bind the domain size)
        if points_f[0].shape[0] != points_i[0].shape[0]:
            return False
        xf, yf, xi, yi = (torch.from_numpy(np.ascontiguousarray(c)).to(dev) for c in (*points_f, *points_i))
        hole = _holes(xf, yf)
        if not torch.equal(hole, _holes(xi, yi)):
            return False  # a hole on one side only
        live = ~hole
        xf, yf, xi, yi = (c[live] for c in (xf, yf, xi, yi))
        if not _on_curve(xf, yf):
            return False
        n = xf.shape[0]
        if not n:
            log.append(f"{tag} query empty on both sides")
            return True
        words = np.frombuffer(os.urandom(16 * n), dtype="<u2").reshape(n, 8).astype(np.int32)
        words[:, 7] &= (1 << (RHO_BITS - 112)) - 1  # 127 bits
        rho = torch.zeros((n, NUM_LIMBS), dtype=torch.int32)
        rho[:, :8] = torch.from_numpy(words)
        rho = rho.to(dev)
        pf, pi_ = _combination((xf, yf), rho), _combination((xi, yi), rho)
        if (pf is None) != (pi_ is None):
            return False  # infinity on one side only: the scalings cannot match
        if pf is None:
            return True  # both infinity under the same rho
        ok = pairing_product_is_one([(pf, zf.delta_2), (g1_neg(pi_), zi.delta_2)])
        if ok:
            log.append(f"{tag} query scaling verified (randomized)")
        return ok

    if not _timed(stages, "combo", lambda: combo(zf.c_query, zi.c_query, "C")):
        return fail("C query not a consistent delta-scaling of the initial key")
    if not _timed(stages, "combo", lambda: combo(zf.h_query, zi.h_query, "H")):
        return fail("H query not a consistent delta-scaling of the initial key")
    return True, log


def verify_chain(zkey_initial: str, zkey_final: str, device=None, stages=None) -> Tuple[bool, List[str]]:
    """``snarkjs zkey verify`` against a trusted initial key (the set-up
    key with no contributions).  Returns (ok, log).  A final key that does
    not parse (a truncated section) fails."""
    dev = resolve_device(device)

    def read_both():  # the two reads side by side
        with ThreadPoolExecutor(1) as pool:
            initial = pool.submit(read_zkey, zkey_initial)
            try:
                final = read_zkey(zkey_final)
            except (ValueError, KeyError, IndexError, struct.error) as e:
                final = e
            return initial.result(), final

    zi, zf = _timed(stages, "read", read_both)
    if isinstance(zf, Exception):
        return False, [f"FAIL: final zkey does not parse: {zf}"]
    return verify_zkeys(zi, zf, device=dev, stages=stages)
