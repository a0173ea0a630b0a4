"""DKIM email parsing + canonicalization + signature extraction.

Rebuild of the reference's vendored mailauth subset
(`app/src/helpers/dkim/*`, ~1.8 kLoC): MIME header/body split
(`message-parser.js:13`), simple/relaxed canonicalization
(`body/relaxed.js:16`, `body/simple.js`, `header/*`), DKIM-Signature tag
parsing (`parse-dkim-headers.js`) and signed-data assembly
(`dkim-verifier.js:147-320`).

The DNS key fetch (`tools.ts:261-283`, DNS TXT / DoH) becomes an explicit
KeyRegistry — zero-egress environments supply keys directly, mirroring
the reference's own hardcoded-Venmo-key fallback comment.

Output: the exact byte string whose SHA-256 the mailserver signed (header
signed-data) plus the canonicalized body — the two inputs the circuit
hashes (`generate_input.ts:191-231`).
"""

from __future__ import annotations

import hashlib
import re
from base64 import b64decode
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass
class ParsedEmail:
    headers: List[Tuple[str, bytes]]  # (lowercase name, full raw header line incl name, no trailing CRLF)
    body: bytes


def parse_eml(raw: bytes) -> ParsedEmail:
    raw = raw.replace(b"\n", b"\r\n").replace(b"\r\r\n", b"\r\n")  # insert13Before10 fixup
    if b"\r\n\r\n" in raw:
        head, body = raw.split(b"\r\n\r\n", 1)
    else:
        head, body = raw, b""
    lines = head.split(b"\r\n")
    headers: List[Tuple[str, bytes]] = []
    cur: Optional[bytes] = None
    for line in lines:
        if line[:1] in (b" ", b"\t") and cur is not None:
            cur = cur + b"\r\n" + line  # folded continuation
            headers[-1] = (headers[-1][0], cur)
            continue
        if b":" in line:
            name = line.split(b":", 1)[0].strip().lower().decode()
            cur = line
            headers.append((name, cur))
    return ParsedEmail(headers=headers, body=body)


# ----------------------------------------------------- canonicalization


def canon_body_simple(body: bytes) -> bytes:
    while body.endswith(b"\r\n\r\n"):
        body = body[:-2]
    if body and not body.endswith(b"\r\n"):
        body += b"\r\n"
    return body or b"\r\n"


def canon_body_relaxed(body: bytes) -> bytes:
    lines = body.split(b"\r\n")
    out = []
    for line in lines:
        line = re.sub(rb"[ \t]+", b" ", line).rstrip()
        out.append(line)
    while out and out[-1] == b"":
        out.pop()
    return b"".join(l + b"\r\n" for l in out)


def canon_header_relaxed(raw: bytes) -> bytes:
    name, value = raw.split(b":", 1)
    value = re.sub(rb"\r\n[ \t]+", b" ", value)
    value = re.sub(rb"[ \t]+", b" ", value).strip()
    return name.strip().lower() + b":" + value


def canon_header_simple(raw: bytes) -> bytes:
    return raw


# ------------------------------------------------------- DKIM signature


@dataclass
class DkimSignature:
    domain: str
    selector: str
    algo: str
    header_canon: str
    body_canon: str
    bh: bytes  # decoded body hash
    b: int  # RSA signature as int
    signed_headers: List[str]
    raw_header: bytes  # the full dkim-signature header line


def _strip_b_tag(dkim_raw: bytes) -> bytes:
    """Empty the b= tag's value in a raw DKIM-Signature header (RFC 6376
    §3.7), locating it positionally at tag level — ';' delimits tags, and a
    tag name is the bytes before the first '=' modulo folding whitespace.
    A regex over the folded raw value can misfire on a 'b=' byte sequence
    inside another tag's value (e.g. a bh= base64 value whose final chars
    fold to '\\r\\n b='), blanking the wrong tag."""
    header, _, value = dkim_raw.partition(b":")
    segs = value.split(b";")
    for i, seg in enumerate(segs):
        name = re.sub(rb"[\s\r\n]+", b"", seg.split(b"=", 1)[0])
        if name == b"b" and b"=" in seg:
            prefix = seg[: seg.index(b"=") + 1]
            segs[i] = prefix
            break
    return header + b":" + b";".join(segs)


def parse_dkim_signature(raw: bytes) -> DkimSignature:
    value = raw.split(b":", 1)[1]
    unfolded = re.sub(rb"\r\n[ \t]+", b" ", value).decode()
    tags: Dict[str, str] = {}
    for part in unfolded.split(";"):
        part = part.strip()
        if not part or "=" not in part:
            continue
        k, v = part.split("=", 1)
        tags[k.strip()] = v.strip()
    canon = tags.get("c", "simple/simple")
    hc, _, bc = canon.partition("/")
    bc = bc or "simple"
    return DkimSignature(
        domain=tags.get("d", ""),
        selector=tags.get("s", ""),
        algo=tags.get("a", "rsa-sha256"),
        header_canon=hc,
        body_canon=bc,
        bh=b64decode(re.sub(r"\s", "", tags.get("bh", ""))),
        b=int.from_bytes(b64decode(re.sub(r"\s", "", tags.get("b", ""))), "big") if tags.get("b") else 0,
        signed_headers=[h.strip().lower() for h in tags.get("h", "").split(":") if h.strip()],
        raw_header=raw,
    )


class KeyRegistry:
    """selector._domainkey.domain -> RSA modulus (the DNS TXT / DoH layer
    of dkim/tools.ts:261-283, made explicit for zero-egress operation)."""

    def __init__(self):
        self._keys: Dict[Tuple[str, str], int] = {}

    def add(self, domain: str, selector: str, modulus: int) -> None:
        self._keys[(domain.lower(), selector.lower())] = modulus

    def get(self, domain: str, selector: str) -> Optional[int]:
        return self._keys.get((domain.lower(), selector.lower()))


@dataclass
class DkimVerification:
    signed_data: bytes  # what the mailserver's RSA signature covers
    body_canon: bytes
    signature: int
    modulus: Optional[int]
    body_hash_ok: bool
    signature_ok: Optional[bool]  # None when no key available
    sig: DkimSignature


def extract_and_verify(raw_eml: bytes, keys: Optional[KeyRegistry] = None) -> DkimVerification:
    """Parse, canonicalize and (when a key is known) verify the DKIM
    signature; returns the circuit-facing byte strings either way."""
    email = parse_eml(raw_eml)
    dkim_raw = next((h for n, h in email.headers if n == "dkim-signature"), None)
    if dkim_raw is None:
        raise ValueError("no dkim-signature header")
    sig = parse_dkim_signature(dkim_raw)

    body = canon_body_relaxed(email.body) if sig.body_canon == "relaxed" else canon_body_simple(email.body)
    body_hash_ok = hashlib.sha256(body).digest() == sig.bh

    hc = canon_header_relaxed if sig.header_canon == "relaxed" else canon_header_simple
    # select signed headers bottom-up per name occurrence (RFC 6376 §5.4.2)
    pools: Dict[str, List[bytes]] = {}
    for name, raw in email.headers:
        pools.setdefault(name, []).append(raw)
    picked: List[bytes] = []
    for name in sig.signed_headers:
        pool = pools.get(name, [])
        if pool:
            picked.append(pool.pop())
    stripped = _strip_b_tag(dkim_raw)
    parts = [hc(h) + b"\r\n" for h in picked]
    parts.append(hc(stripped))
    signed_data = b"".join(parts)

    modulus = keys.get(sig.domain, sig.selector) if keys else None
    signature_ok: Optional[bool] = None
    if modulus is not None and sig.b:
        from ..gadgets.rsa import DIGEST_INFO

        em_len = (modulus.bit_length() + 7) // 8
        digest = hashlib.sha256(signed_data).digest()
        pad_len = em_len - 3 - 19 - 32
        em = b"\x00\x01" + b"\xff" * pad_len + b"\x00" + DIGEST_INFO.to_bytes(19, "big") + digest
        signature_ok = pow(sig.b, 65537, modulus) == int.from_bytes(em, "big")

    return DkimVerification(
        signed_data=signed_data,
        body_canon=body,
        signature=sig.b,
        modulus=modulus,
        body_hash_ok=body_hash_ok,
        signature_ok=signature_ok,
        sig=sig,
    )
