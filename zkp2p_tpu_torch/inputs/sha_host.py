"""Host SHA-256 with exposed internal state (midstate checkpointing).

Twin of the reference's `app/src/helpers/fast-sha256.ts` (a SHA-256 whose
`cacheState()` exports the chaining value) and `shaHash.ts:7-36`
(`partialSha`, `sha256Pad`).  The exported midstate feeds the in-circuit
`Sha256Partial` resume (gadgets/sha256.sha256_blocks init_state) so the
parallelisable body prefix is hashed outside the circuit.
"""

from __future__ import annotations

from typing import Tuple

from ..gadgets.sha256 import H0, K

MASK32 = 0xFFFFFFFF


def _rotr(x: int, r: int) -> int:
    return ((x >> r) | (x << (32 - r))) & MASK32


def compress(state: Tuple[int, ...], block: bytes) -> Tuple[int, ...]:
    assert len(block) == 64
    w = [int.from_bytes(block[4 * i : 4 * i + 4], "big") for i in range(16)]
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((s1 + w[t - 7] + s0 + w[t - 16]) & MASK32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + S1 + ch + K[t] + w[t]) & MASK32
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        mj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (S0 + mj) & MASK32
        a, b, c, d, e, f, g, h = (t1 + t2) & MASK32, a, b, c, (d + t1) & MASK32, e, f, g
    return tuple((s + v) & MASK32 for s, v in zip(state, (a, b, c, d, e, f, g, h)))


def midstate(prefix: bytes, init: Tuple[int, ...] = tuple(H0)) -> Tuple[int, ...]:
    """Chaining value after hashing `prefix` (length must be 64-aligned) —
    `partialSha` (shaHash.ts:11)."""
    assert len(prefix) % 64 == 0
    state = tuple(init)
    for off in range(0, len(prefix), 64):
        state = compress(state, prefix[off : off + 64])
    return state


def sha256_pad(msg: bytes, max_len: int) -> Tuple[bytes, int]:
    """MD-pad to a fixed max length; returns (padded, used_bytes) where
    used = message + padding (a 64 multiple) — `sha256Pad` (shaHash.ts:17-36).
    The region [used:max_len] is zero filler the circuit never selects."""
    assert max_len % 64 == 0
    length_bits = len(msg) * 8
    padded = bytearray(msg) + b"\x80"
    while (len(padded) + 8) % 64:
        padded.append(0)
    padded += length_bits.to_bytes(8, "big")
    used = len(padded)
    if used > max_len:
        raise ValueError(f"message needs {used} bytes > max {max_len}")
    padded += b"\x00" * (max_len - used)
    return bytes(padded), used


def digest_from_state(state: Tuple[int, ...]) -> bytes:
    return b"".join(s.to_bytes(4, "big") for s in state)


def sha256_full(msg: bytes) -> bytes:
    padded, used = sha256_pad(msg, ((len(msg) + 9 + 63) // 64) * 64)
    return digest_from_state(midstate(padded[:used]))
