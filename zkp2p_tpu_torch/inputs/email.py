"""Email -> circuit-input generation (the L4 crypto-helper layer).

Rebuild of `app/src/scripts/generate_input.ts:70-231` +
`app/src/helpers/{binaryFormat,shaHash,venmoHash}.ts`: takes a DKIM-signed
email, produces the witness seed for models.venmo plus the public signal
values (the `circuit/input.json` shape).

Includes a synthetic Venmo-style email signer so the whole pipeline is
testable hermetically (the reference's fixture email depends on a DNS key
fetch, `dkim/tools.ts:261-283`; zero-egress CI can't do that, so tests
sign with their own key — same trick as the hardcoded-Venmo-key comment).
"""

from __future__ import annotations

import hashlib
from base64 import b64encode
from dataclasses import dataclass
from typing import Dict, List

from ..gadgets.bigint import int_to_limbs_host
from ..gadgets.poseidon_params import poseidon_hash
from ..gadgets.rsa import DIGEST_INFO
from ..models.venmo import VenmoLayout, VenmoParams
from .sha_host import midstate, sha256_pad

SOFT_WRAP_AT = 14  # venmoHash.ts:19 inserts `=\r\n` after the 14th char


# ------------------------------------------------------------ packing


def pack_bytes_le(data: bytes, n_per: int = 7) -> List[int]:
    """Little-endian n_per-byte words (binaryFormat.ts packBytesIntoNBytes
    :177-199 / utils.circom Bytes2Packed)."""
    out = []
    for i in range(0, len(data), n_per):
        chunk = data[i : i + n_per]
        out.append(sum(b << (8 * j) for j, b in enumerate(chunk)))
    return out


def venmo_id_circuit_bytes(raw_id: str) -> bytes:
    """Insert the quoted-printable soft wrap and zero-pad to 28 — must equal
    the bytes the circuit reveals (venmoHash.ts initializeRawVenmoId)."""
    bs = bytearray(raw_id.encode())
    bs[SOFT_WRAP_AT:SOFT_WRAP_AT] = b"=\r\n"
    bs.extend(b"\x00" * (28 - len(bs)))
    return bytes(bs[:28])


def venmo_id_hash(raw_id: str) -> int:
    """generateVenmoIdHash (venmoHash.ts:3-44): pack + Poseidon."""
    return poseidon_hash(pack_bytes_le(venmo_id_circuit_bytes(raw_id)))


# ------------------------------------------------------- synthetic signer


@dataclass
class TestRsaKey:
    n: int
    d: int
    e: int = 65537

    def sign(self, message: bytes) -> int:
        digest = hashlib.sha256(message).digest()
        em = b"\x00\x01" + b"\xff" * 202 + b"\x00" + DIGEST_INFO.to_bytes(19, "big") + digest
        return pow(int.from_bytes(em, "big"), self.d, self.n)


def make_test_key(seed: int = 1) -> TestRsaKey:
    """Deterministic 2048-bit RSA key (Fermat-filtered pseudoprimes; fixed
    seed -> reproducible fixtures)."""
    import random

    rng = random.Random(seed)

    def rand_prime(bits):
        while True:
            c = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
            if all(pow(a, c - 1, c) == 1 for a in (2, 3, 5, 7)):
                return c

    p, q = rand_prime(1024), rand_prime(1024)
    n = p * q
    return TestRsaKey(n=n, d=pow(65537, -1, (p - 1) * (q - 1)))


@dataclass
class SyntheticEmail:
    """A circuit-facing email: canonicalized signed header + canonical
    body + RSA signature (synthetic OR parsed from a real .eml)."""

    header: bytes  # canonicalized, incl. dkim-signature header with bh=
    body: bytes
    signature: int
    raw_id: str
    amount: str
    modulus: int | None = None  # DKIM RSA modulus when resolved from a registry


def make_venmo_email(
    key: TestRsaKey,
    raw_id: str = "1234567891234567891",
    amount: str = "30",
    body_filler: int = 0,
    to_addr: str = "onramper@example.com",
) -> SyntheticEmail:
    body = (
        b"<html>receipt " + b"x" * body_filler + b"\r\n"
        b"<!-- recipient name -->\r\n"
        b'href=3D"https://venmo.com/code?user_id=3D'
        + raw_id[:SOFT_WRAP_AT].encode()
        + b"=\r\n"
        + raw_id[SOFT_WRAP_AT:].encode()
        + b'"\r\n</html>\r\n'
    )
    bh = b64encode(hashlib.sha256(body).digest())
    header_wo_sig = (
        b"to:" + to_addr.encode() + b"\r\n"
        b"from:venmo@venmo.com\r\n"
        b"subject:You paid Alice $" + amount.encode() + b".00\r\n"
    )
    dkim = b"dkim-signature:v=1; a=rsa-sha256; d=venmo.com; s=yzlavq3ml4jl4lt6dltbgmnoftxftkly; bh=" + bh + b"; b="
    header = header_wo_sig + dkim + b"\r\n"
    sig = key.sign(header)
    return SyntheticEmail(header=header, body=body, signature=sig, raw_id=raw_id, amount=amount)


# ------------------------------------------------- EmailVerify inputs


def make_twitter_email(key: TestRsaKey, handle: str = "zk_pranker", filler: int = 0) -> SyntheticEmail:
    """Synthetic twitter password-reset email (the TwitterResetRegex
    family, twitter_reset_regex.circom:5)."""
    body = (
        b"<html>" + b"y" * filler + b"\r\n"
        b"This email was meant for @" + handle.encode() + b" only.\r\n</html>\r\n"
    )
    from base64 import b64encode as _b64e

    bh = _b64e(hashlib.sha256(body).digest())
    header = (
        b"to:user@example.com\r\n"
        b"from:info@twitter.com\r\n"
        b"subject:Password reset request\r\n"
        b"dkim-signature:v=1; a=rsa-sha256; d=twitter.com; s=dkim; bh=" + bh + b"; b="
        b"\r\n"
    )
    return SyntheticEmail(header=header, body=body, signature=key.sign(header), raw_id=handle, amount="0")


def generate_email_verify_inputs(email: SyntheticEmail, modulus: int, params, layout):
    """Witness seed + public signals for models.email_verify."""
    header_padded, header_used = sha256_pad(email.header, params.max_header_bytes)
    body_padded_full, body_used = sha256_pad(email.body, ((len(email.body) + 9 + 63) // 64) * 64)
    marker = b"This email was meant for @"
    presel = email.body.find(marker)
    cut = (presel // 64) * 64 if presel >= 0 else 0
    prefix, suffix = body_padded_full[:cut], body_padded_full[cut:body_used]
    mid = midstate(prefix)
    body_suffix_padded = suffix + b"\x00" * (params.max_body_bytes - len(suffix))

    reveal_idx = body_suffix_padded.find(marker) + len(marker)
    handle = email.raw_id.encode()
    reveal_bytes_ = handle + b"\x00" * (params.reveal_len - len(handle))
    reveal_words = pack_bytes_le(reveal_bytes_, 7)

    mod_limbs = int_to_limbs_host(modulus, params.n, params.k)
    sig_limbs = int_to_limbs_host(email.signature, params.n, params.k)
    public_signals = mod_limbs + (reveal_words if params.body_regex else [])

    seed: Dict[int, int] = {}
    for w, b in zip(layout.header, header_padded):
        seed[w] = b
    seed[layout.header_blocks] = header_used // 64
    for w, v in zip(layout.signature, sig_limbs):
        seed[w] = v
    for w, b in zip(layout.body, body_suffix_padded):
        seed[w] = b
    seed[layout.body_blocks] = len(suffix) // 64
    for i, word in enumerate(mid):
        for b in range(32):
            seed[layout.midstate_bits[32 * i + b]] = (word >> b) & 1
    seed[layout.body_hash_idx] = email.header.find(b"bh=") + 3
    if params.body_regex:
        seed[layout.reveal_idx] = reveal_idx
    return VenmoInputs(public_signals=public_signals, seed=seed)


# ------------------------------------------------------------ real emails


def _verified_eml(raw_eml: bytes, keys, allow_unverified: bool = False):
    """Shared .eml preamble: registry default, canonicalize, check body
    hash + the RSA signature.  An unknown signing key is an ERROR by
    default — silently returning unverified email objects from the
    documented parse entry points would let a forged email flow into
    input generation with only a None modulus as the tell.  Pass
    allow_unverified=True for body-hash-only parsing (tests, tooling)."""
    from .dkim import extract_and_verify

    if keys is None:
        from .known_keys import default_registry

        keys = default_registry()
    v = extract_and_verify(raw_eml, keys)
    if not v.body_hash_ok:
        raise ValueError("DKIM body hash mismatch")
    if v.signature_ok is False:
        raise ValueError("DKIM signature invalid")
    if v.signature_ok is None and not allow_unverified:
        raise ValueError(
            f"unknown DKIM key {v.sig.domain}/{v.sig.selector}; add it to "
            "inputs.known_keys or pass allow_unverified=True"
        )
    return v


def email_from_eml(raw_eml: bytes, keys=None, allow_unverified: bool = False) -> SyntheticEmail:
    """Real .eml -> the circuit-facing email object: DKIM-canonicalized
    signed header data + canonical body + signature, with the Venmo id and
    amount located in the content (generate_input.ts:191-231 semantics).
    DKIM keys resolve from known_keys.default_registry when none given."""
    import re as _re

    v = _verified_eml(raw_eml, keys, allow_unverified)
    m = _re.search(rb"user_id=3D([0-9=\r\n]+)", v.body_canon)
    raw_id = m.group(1).replace(b"=\r\n", b"").decode() if m else ""
    # the subject may not be in the signed set (h=); fall back to the raw
    # header block for field location
    am = _re.search(rb"\$([0-9]+)\.", v.signed_data) or _re.search(rb"\$([0-9]+)\.", raw_eml)
    amount = am.group(1).decode() if am else "0"
    return SyntheticEmail(
        header=v.signed_data,
        body=v.body_canon,
        signature=v.signature,
        raw_id=raw_id,
        amount=amount,
        modulus=v.modulus,
    )


def email_verify_from_eml(raw_eml: bytes, keys=None, allow_unverified: bool = False):
    """Real .eml -> (email object, modulus) for the EmailVerify family:
    DKIM verify against the key registry (known_keys.default_registry
    when none given), extract the @handle the TwitterResetRegex reveals
    (`twitter_reset_regex.circom:5`).  Validated against the reference
    fixture `app/src/__fixtures__/email/zktestemail.test-eml`."""
    import re as _re

    v = _verified_eml(raw_eml, keys, allow_unverified)
    m = _re.search(rb"meant for @([A-Za-z0-9_]+)", v.body_canon)
    handle = m.group(1).decode() if m else ""
    email = SyntheticEmail(
        header=v.signed_data,
        body=v.body_canon,
        signature=v.signature,
        raw_id=handle,
        amount="0",
        modulus=v.modulus,
    )
    return email, v.modulus


# --------------------------------------------------------- input generation


@dataclass
class VenmoInputs:
    public_signals: List[int]
    seed: Dict[int, int]


def _bits_le_byte(b: int) -> List[int]:
    return [(b >> i) & 1 for i in range(8)]


def generate_inputs(
    email: SyntheticEmail,
    modulus: int,
    order_id: int,
    claim_id: int,
    params: VenmoParams,
    layout: VenmoLayout,
) -> VenmoInputs:
    """getCircuitInputs (generate_input.ts:70-189) for our layout: pad the
    header, cut the body at the preselector's 64-byte boundary, compute the
    SHA midstate checkpoint, locate the three indices, pack the outputs."""
    header_padded, header_used = sha256_pad(email.header, params.max_header_bytes)
    n_header_blocks = header_used // 64

    # Body cut: largest 64-boundary at or before the preselector
    # (generate_input.ts:110-124, STRING_PRESELECTOR constants.ts:22).
    presel = email.body.find(b"<!-- recipient name -->")
    # No preselector -> no midstate cut, whole body hashed in-circuit
    # (the preselector is a Venmo-email artifact, constants.ts:22).
    cut = (presel // 64) * 64 if presel >= 0 else 0
    body_padded_full, body_used = sha256_pad(email.body, ((len(email.body) + 9 + 63) // 64) * 64)
    prefix, suffix = body_padded_full[:cut], body_padded_full[cut:body_used]
    mid = midstate(prefix)
    body_suffix_padded = suffix + b"\x00" * (params.max_body_bytes - len(suffix))
    assert len(suffix) <= params.max_body_bytes
    n_body_blocks = len(suffix) // 64

    # Indices.
    bh_pos = email.header.find(b"bh=") + 3
    body_hash_idx = bh_pos
    amount_idx = email.header.find(b"$") + 1
    id_marker = b"user_id=3D"
    id_pos = body_suffix_padded.find(id_marker) + len(id_marker)
    id_idx = id_pos

    # Public outputs.
    hashed_id = venmo_id_hash(email.raw_id)
    amt_revealed = (email.amount + ".").encode()
    amt_bytes = amt_revealed + b"\x00" * (params.amount_len - len(amt_revealed))
    amount_words = pack_bytes_le(amt_bytes, 7)
    sig_limbs = int_to_limbs_host(email.signature, params.n, params.k)
    mod_limbs = int_to_limbs_host(modulus, params.n, params.k)
    nullifier = sig_limbs[:3]
    public_signals = [hashed_id] + amount_words + nullifier + mod_limbs + [order_id, claim_id]

    # Witness seed.
    seed: Dict[int, int] = {}
    for w, b in zip(layout.header, header_padded):
        seed[w] = b
    seed[layout.header_blocks] = n_header_blocks
    for w, v in zip(layout.signature, sig_limbs):
        seed[w] = v
    for w, b in zip(layout.body, body_suffix_padded):
        seed[w] = b
    seed[layout.body_blocks] = n_body_blocks
    for i, word in enumerate(mid):
        for b in range(32):
            seed[layout.midstate_bits[32 * i + b]] = (word >> b) & 1
    seed[layout.body_hash_idx] = body_hash_idx
    seed[layout.amount_idx] = amount_idx
    seed[layout.id_idx] = id_idx
    return VenmoInputs(public_signals=public_signals, seed=seed)
