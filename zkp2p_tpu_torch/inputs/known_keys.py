"""Known DKIM RSA public keys (production constants).

The reference pins these same keys: the browser fetches them over
DNS/DoH at run time (`app/src/helpers/dkim/tools.js:261-283`) with the
values also hardcoded for offline use (`tools.js:284-286`), and the Ramp
contract stores the Venmo modulus limbs on-chain
(`scripts/deploy.js:23-47`).  Zero-egress environments (CI, air-gapped
provers) resolve from this registry instead of DNS.
"""

from __future__ import annotations

import base64

from .dkim import KeyRegistry


def _der_read(der: bytes, off: int):
    """One TLV at `off` -> (tag, value_start, value_len)."""
    tag = der[off]
    ln = der[off + 1]
    if ln < 0x80:
        return tag, off + 2, ln
    n = ln & 0x7F
    return tag, off + 2 + n, int.from_bytes(der[off + 2 : off + 2 + n], "big")


def _modulus_from_spki_b64(b64: str) -> int:
    """RSA modulus from a base64 SubjectPublicKeyInfo (the DNS TXT `p=`
    payload shape, RFC 6376 §3.6.1).  A proper structural DER walk —
    byte-pattern scanning can lock onto modulus bytes that happen to look
    like an INTEGER header."""
    der = base64.b64decode(b64)
    tag, off, _ = _der_read(der, 0)  # SPKI SEQUENCE
    assert tag == 0x30, "not a SEQUENCE"
    tag, alg_start, alg_len = _der_read(der, off)  # AlgorithmIdentifier
    assert tag == 0x30
    tag, bits_start, _ = _der_read(der, alg_start + alg_len)  # BIT STRING
    assert tag == 0x03
    bits_start += 1  # skip unused-bits octet
    tag, rsa_off, _ = _der_read(der, bits_start)  # RSAPublicKey SEQUENCE
    assert tag == 0x30
    tag, mod_start, mod_len = _der_read(der, rsa_off)  # modulus INTEGER
    assert tag == 0x02
    return int.from_bytes(der[mod_start : mod_start + mod_len].lstrip(b"\x00"), "big")


# venmo.com yzlavq3ml4jl4lt6dltbgmnoftxftkly — `tools.js:284`; the same
# 1024-bit modulus whose 121-bit limbs Ramp stores (`scripts/deploy.js:24-42`).
VENMO_SPKI = (
    "MIGfMA0GCSqGSIb3DQEBAQUAA4GNADCBiQKBgQCoecgrbF4KMhqGMZK02Dv2vZgGnSAo9CDpYEZCpNDRBLXkfp/0Yzp3"
    "rgngm4nuiQWbhHO457vQ37nvc88I9ANuJKa3LIodD+QtOLCjwlzH+li2A81duY4fKLHcHYO3XKw+uYXKWd+bABQqps3A"
    "QP5KxoOgQ/P1EssOnvtQYBHjWQIDAQAB"
)

# twitter.com dkim-201406 — `tools.js:285`; signs the reference fixture
# email `app/src/__fixtures__/email/zktestemail.test-eml`.
TWITTER_SPKI = (
    "MIIBIjANBgkqhkiG9w0BAQEFAAOCAQ8AMIIBCgKCAQEAwe34ubzrMzM9sT0XVkcc3UXd7W+EHCyHoqn70l2AxXox52lA"
    "ZzH/UnKwAoO+5qsuP7T9QOifIJ9ddNH9lEQ95Y/GdHBsPLGdgSJIs95mXNxscD6MSyejpenMGL9TPQAcxfqY5xPViZ+1"
    "wA1qcryjdZKRqf1f4fpMY+x3b8k7H5Qyf/Smz0sv4xFsx1r+THNIz0rzk2LO3GvE0f1ybp6P+5eAelYU4mGeZQqsKw/e"
    "B20I3jHWEyGrXuvzB67nt6ddI+N2eD5K38wg/aSytOsb5O+bUSEe7P0zx9ebRRVknCD6uuqG3gSmQmttlD5OrMWSXzrP"
    "IXe8eTBaaPd+e/jfxwIDAQAB"
)


def default_registry() -> KeyRegistry:
    reg = KeyRegistry()
    reg.add("venmo.com", "yzlavq3ml4jl4lt6dltbgmnoftxftkly", _modulus_from_spki_b64(VENMO_SPKI))
    reg.add("twitter.com", "dkim-201406", _modulus_from_spki_b64(TWITTER_SPKI))
    return reg
