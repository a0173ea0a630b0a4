"""RSA-2048 signature verification in R1CS (e = 65537, PKCS#1 v1.5).

Rebuild of `zk-email-verify-circuits/rsa.circom`: `FpPow65537Mod` (:8-43,
16 squarings + 1 multiply), `RSAPad` (:45-122, the 0x01 FF..FF 00 ||
DigestInfo || SHA-256 padding with the DigestInfo constant
0x3031300d060960864801650304020105000420 at :85), and `RSAVerify65537`
(:124-156, sig < modulus + padded-message equality).

Limb parameterisation follows the reference: n x k with n=121, k=17
(`main` instantiation `circuit.circom:310`), which is what makes the
17-limb public modulus signals line up with `Ramp.sol`'s
`venmoMailserverKeys[17]` check (`Ramp.sol:253-293` signals [7:23]).
"""

from __future__ import annotations

from typing import List, Sequence

from ..snark.r1cs import LC, ConstraintSystem
from .bigint import big_less_than, big_mult_mod, range_check_limbs

# SHA-256 DigestInfo prefix (rsa.circom:85).
DIGEST_INFO = 0x3031300D060960864801650304020105000420


def pkcs1v15_pad_limbs_lc(digest_bits: Sequence[int], n: int, k: int, key_bits: int = 2048) -> List[LC]:
    """The padded message EM = 0x00 01 FF..FF 00 || DigestInfo || H as k
    n-bit limb LCs over the 256 digest bit wires (everything else constant).

    digest_bits: 256 wires, bit i of SHA word j at index 32j + i (our
    sha256 gadget's output order: words big-endian in the message, bits
    little-endian per word).  The integer value of H is
    Σ_j word_j · 2^(32·(7-j))."""
    # Constant part of EM as an integer.
    pad_len = key_bits // 8 - 3 - 19 - 32  # 0x00,0x01,0x00 + DigestInfo(19) + H(32)
    em = bytearray(key_bits // 8)
    em[0] = 0x00
    em[1] = 0x01
    for i in range(2, 2 + pad_len):
        em[i] = 0xFF
    em[2 + pad_len] = 0x00
    di = DIGEST_INFO.to_bytes(19, "big")
    em[3 + pad_len : 3 + pad_len + 19] = di
    em_int = int.from_bytes(bytes(em), "big")  # digest area (last 32 bytes) zero

    # Bit weight of digest bit (word j, bit i) inside EM: the digest's
    # byte 4j+b (big-endian) sits at EM byte offset key_bits/8 - 32 + 4j+b.
    lcs: List[LC] = []
    for limb in range(k):
        terms: dict = {}
        lo = n * limb
        hi = n * (limb + 1)
        const_part = (em_int >> lo) & ((1 << n) - 1)
        if const_part:
            terms[0] = const_part
        for j in range(8):
            word_weight = 32 * (7 - j)  # bit position of word j's LSB in H
            for i in range(32):
                pos = word_weight + i  # bit position within H
                if lo <= pos < hi:
                    w = digest_bits[32 * j + i]
                    terms[w] = terms.get(w, 0) + (1 << (pos - lo))
        lcs.append(LC(terms))
    return lcs


def rsa_verify_65537(
    cs: ConstraintSystem,
    signature: Sequence[int],
    modulus: Sequence[int],
    digest_bits: Sequence[int],
    n: int = 121,
    k: int = 17,
    tag: str = "rsa",
) -> None:
    """Enforce signature^65537 mod modulus == PKCS1v15-pad(digest).

    signature/modulus: k n-bit limb wires (range-checked here, matching
    RSAVerify65537's own checks); digest_bits: 256 bit wires from the
    header SHA gadget."""
    range_check_limbs(cs, signature, n, f"{tag}.sig")
    range_check_limbs(cs, modulus, n, f"{tag}.mod")
    lt = big_less_than(cs, signature, modulus, n, f"{tag}.ltmod")
    cs.enforce_eq(LC.of(lt), LC.const(1), f"{tag}/sig_lt_mod")

    acc = list(signature)
    for s in range(16):
        acc = big_mult_mod(cs, acc, acc, modulus, n, f"{tag}.sq{s}")
    acc = big_mult_mod(cs, acc, signature, modulus, n, f"{tag}.fin")

    padded = pkcs1v15_pad_limbs_lc(digest_bits, n, k)
    for i in range(k):
        cs.enforce_eq(LC.of(acc[i]), padded[i], f"{tag}/pad{i}")
