"""DFA regex matching as R1CS: one-hot state recurrence over bytes.

Our rebuild of the generated regex circuits (`venmo_offramper_id_regex
.circom:29-217`, `dkim_header_regex.circom`, `body_hash_regex.circom`,
`gen.py:64-163` codegen): instead of emitting circom source per regex, ONE
generic gadget consumes the compiled DFA table (regexc.compiler.DFA).

Per byte t:   s_{t+1}[d] = Σ_{(s,d,cls)} s_t[s] · ind_cls(byte_t)
where ind_cls is a char-class membership indicator built from range /
equality tests against constants (the lt/eq component pattern of
`gen.py:64-163`), memoised per (byte, class) so overlapping regexes and
shared classes pay once.

Outputs mirror the reference templates: per-step one-hot state wires, a
match count (`out === 2` style checks, `circuit.circom:106,119`), and
reveal masks `reveal[i] = in[i] * states[i+1][j]` (`gen.py:214-217`).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Sequence, Tuple

from ..regexc.compiler import DFA
from ..snark.r1cs import LC, ConstraintSystem
from .core import lc_sum, num2bits


def _ranges(chars: FrozenSet[int]) -> List[Tuple[int, int]]:
    xs = sorted(chars)
    out = []
    lo = prev = xs[0]
    for c in xs[1:]:
        if c == prev + 1:
            prev = c
            continue
        out.append((lo, prev))
        lo = prev = c
    out.append((lo, prev))
    return out


class CharClassCache:
    """Shared per-byte machinery for char-class membership tests.

    Each byte gets lazily-built NIBBLE one-hots (24 constraints per nibble,
    48 per byte, shared by every class of every regex on that byte).  A
    class indicator then groups its chars by high nibble: the low-nibble
    part is a free LC over the low one-hot, so the indicator costs ONE
    multiplication per populated high nibble (<= 4 for the email classes)
    plus one closing sum.  This is what keeps multi-regex scans at
    reference-level constraint counts (the naive lt/eq-per-range form was
    ~25 constraints per class per byte — 60% of the whole circuit)."""

    def __init__(self, cs: ConstraintSystem):
        self.cs = cs
        self._bits: Dict[int, List[int]] = {}
        self._nib: Dict[int, Tuple[List[int], List[int]]] = {}  # byte -> (lo16, hi16)
        self._cls: Dict[Tuple[int, FrozenSet[int]], int] = {}

    def register_bits(self, byte: int, bits: List[int]) -> None:
        """Reuse an existing 8-bit decomposition (e.g. from assert_bytes)."""
        self._bits.setdefault(byte, bits)

    def _nibble_onehot(self, bits4: List[int], tag: str) -> List[int]:
        """One-hot of a 4-bit value via two 2-bit one-hots; all 24 wires
        witnessed by ONE BlockHook (equality against arange)."""
        import numpy as np

        cs = self.cs
        pair0: List[int] = []  # one-hot of bits4[0:2]
        for v in range(4):
            w = cs.new_wire(f"{tag}.p{v}")
            a = LC.of(bits4[0]) if v & 1 else LC.const(1) - LC.of(bits4[0])
            b = LC.of(bits4[1]) if v & 2 else LC.const(1) - LC.of(bits4[1])
            cs.enforce(a, b, LC.of(w), f"{tag}/p")
            cs.set_width(w, 1)
            pair0.append(w)
        pair1: List[int] = []  # one-hot of bits4[2:4]
        for v in range(4):
            w = cs.new_wire(f"{tag}.q{v}")
            a = LC.of(bits4[2]) if v & 1 else LC.const(1) - LC.of(bits4[2])
            b = LC.of(bits4[3]) if v & 2 else LC.const(1) - LC.of(bits4[3])
            cs.enforce(a, b, LC.of(w), f"{tag}/q")
            cs.set_width(w, 1)
            pair1.append(w)
        out: List[int] = []
        for v in range(16):
            w = cs.new_wire(f"{tag}.n{v}")
            cs.enforce(LC.of(pair0[v & 3]), LC.of(pair1[v >> 2]), LC.of(w), f"{tag}/n")
            cs.set_width(w, 1)
            out.append(w)

        def vfn(m):
            lo = m[0] + 2 * m[1]  # (K,)
            hi = m[2] + 2 * m[3]
            p0 = (lo[None, :] == np.arange(4)[:, None]).astype(np.int64)
            p1 = (hi[None, :] == np.arange(4)[:, None]).astype(np.int64)
            n = (p1[:, None, :] * p0[None, :, :]).reshape(16, -1)  # n[v] = p0[v&3]*p1[v>>2]
            return np.concatenate([p0, p1, n], axis=0)

        cs.compute_block(pair0 + pair1 + out, vfn, list(bits4))
        return out

    def _nibbles(self, byte: int) -> Tuple[List[int], List[int]]:
        if byte not in self._nib:
            bits = self._bits.get(byte)
            if bits is None:
                bits = num2bits(self.cs, byte, 8, "re.bits")
                self._bits[byte] = bits
            lo = self._nibble_onehot(bits[0:4], "re.lo")
            hi = self._nibble_onehot(bits[4:8], "re.hi")
            self._nib[byte] = (lo, hi)
        return self._nib[byte]

    def eq_const(self, byte: int, c: int) -> int:
        return self.indicator(byte, frozenset([c]))

    def in_range(self, byte: int, lo: int, hi: int) -> int:
        return self.indicator(byte, frozenset(range(lo, hi + 1)))

    def indicator(self, byte: int, chars: FrozenSet[int]) -> int:
        key = (byte, chars)
        if key in self._cls:
            return self._cls[key]
        import numpy as np

        cs = self.cs
        lo16, hi16 = self._nibbles(byte)
        by_hi: Dict[int, List[int]] = {}
        for c in chars:
            by_hi.setdefault(c >> 4, []).append(c & 0xF)
        parts: List[int] = []
        full_his: List[int] = []
        ins: List[int] = []
        group_rows: List[List[int]] = []  # per part: [hi idx, lo idxs...] into ins
        for h, los in sorted(by_hi.items()):
            if len(los) == 16:
                full_his.append(hi16[h])  # whole row: no product needed
                continue
            p = cs.new_wire("re.cls.p")
            cs.set_width(p, 1)  # hi-lane x (disjoint lo-lane sum) is bool
            mask = lc_sum([lo16[l] for l in los])
            cs.enforce(LC.of(hi16[h]), mask, LC.of(p), "re.cls/p")
            row = [len(ins)]
            ins.append(hi16[h])
            for l in los:
                row.append(len(ins))
                ins.append(lo16[l])
            group_rows.append(row)
            parts.append(p)
        if not parts and len(full_his) == 1:
            out = full_his[0]
        elif len(parts) == 1 and not full_his:
            out = parts[0]
            self._register_indicator_block(parts, None, ins, group_rows, full_his)
            self._cls[key] = out
            return out
        else:
            out = cs.new_wire("re.cls")
            cs.set_width(out, 1)  # disjoint bool parts sum to 0/1
            cs.enforce_eq(lc_sum(parts + full_his), LC.of(out), "re.cls/sum")
        if parts:
            self._register_indicator_block(
                parts, out if out not in parts and out not in full_his else None,
                ins, group_rows, full_his,
            )
        elif out not in full_his:
            # sum-of-full-rows only: one block for the closing sum
            fh = list(full_his)
            self.cs.compute_block(
                [out], lambda m: m.sum(axis=0, keepdims=True), fh
            )
        self._cls[key] = out
        return out

    def indicator_bulk(self, byte_wires: Sequence[int], chars: FrozenSet[int]) -> List[int]:
        """indicator(byte, chars) for MANY byte wires with ONE BlockHook
        covering every cache miss — the per-(byte, class) block tier left
        ~20k small blocks on the mini circuit; a scan calls this once per
        distinct class instead (same wires, same constraints, same cache
        entries — later scans still hit the per-byte cache)."""
        import numpy as np

        cs = self.cs
        missing = [b for b in byte_wires if (b, chars) not in self._cls]
        # Group structure is identical for every byte (it depends only on
        # `chars`), so the miss block vectorizes over bytes.
        by_hi: Dict[int, List[int]] = {}
        for c in chars:
            by_hi.setdefault(c >> 4, []).append(c & 0xF)
        groups = sorted((h, los) for h, los in by_hi.items() if len(los) < 16)
        fulls = sorted(h for h, los in by_hi.items() if len(los) == 16)
        if missing and groups:
            outs: List[int] = []
            ins: List[int] = []
            g_sizes = [1 + len(los) for _, los in groups]
            stride = sum(g_sizes) + len(fulls)
            n_parts = len(groups)
            needs_sum = n_parts + len(fulls) > 1
            for b in missing:
                lo16, hi16 = self._nibbles(b)
                parts = []
                for h, los in groups:
                    p = cs.new_wire("re.cls.p")
                    cs.set_width(p, 1)  # hi-lane x (disjoint lo-lane sum)
                    cs.enforce(LC.of(hi16[h]), lc_sum([lo16[l] for l in los]), LC.of(p), "re.cls/p")
                    ins.append(hi16[h])
                    ins.extend(lo16[l] for l in los)
                    parts.append(p)
                ins.extend(hi16[h] for h in fulls)
                if needs_sum:
                    o = cs.new_wire("re.cls")
                    cs.set_width(o, 1)  # disjoint bool parts sum to 0/1
                    cs.enforce_eq(lc_sum(parts + [hi16[h] for h in fulls]), LC.of(o), "re.cls/sum")
                else:
                    o = parts[0]
                outs.extend(parts)
                if needs_sum:
                    outs.append(o)
                self._cls[(b, chars)] = o

            starts = np.cumsum([0] + g_sizes[:-1])

            def vfn(m, starts=starts, g_sizes=g_sizes, stride=stride,
                    n_parts=n_parts, n_full=len(fulls), needs_sum=needs_sum):
                nb = m.shape[0] // stride
                mm = m.reshape(nb, stride, -1)
                parts = [
                    mm[:, s] * mm[:, s + 1 : s + g].sum(axis=1)
                    for s, g in zip(starts, g_sizes)
                ]
                pv = np.stack(parts, axis=1)  # (nb, n_parts, K)
                if not needs_sum:
                    return pv.reshape(-1, m.shape[1])
                tot = pv.sum(axis=1) + mm[:, stride - n_full :].sum(axis=1)
                return np.concatenate([pv, tot[:, None, :]], axis=1).reshape(-1, m.shape[1])

            cs.compute_block(outs, vfn, ins)
        elif missing:  # pure full-row classes: indicator is an existing wire or a sum
            for b in missing:
                self.indicator(b, chars)
        return [self._cls[(b, chars)] for b in byte_wires]

    def _register_indicator_block(self, parts, out, ins, group_rows, full_his):
        """ONE BlockHook for an indicator's part products (+ closing sum):
        parts[i] = hi * sum(los); out = sum(parts) + sum(full_his)."""
        import numpy as np

        cs = self.cs
        n_ins = len(ins)
        all_ins = ins + list(full_his)
        outs = list(parts) + ([out] if out is not None else [])
        rows = group_rows
        n_fh = len(full_his)

        def vfn(m, rows=rows, n_ins=n_ins, n_fh=n_fh, has_out=out is not None):
            res = [m[r[0]] * m[r[1:]].sum(axis=0) for r in rows]
            if has_out:
                total = res[0] * 0
                for p in res:
                    total = total + p
                if n_fh:
                    total = total + m[n_ins:].sum(axis=0)
                res.append(total)
            return np.stack(res)

        cs.compute_block(outs, vfn, all_ins)


def dfa_scan(
    cs: ConstraintSystem,
    byte_wires: Sequence[int],
    dfa: DFA,
    cache: CharClassCache | None = None,
    tag: str = "re",
) -> List[List[int]]:
    """Run the DFA over byte wires; returns states[t][s] one-hot wires for
    t in 0..T (states[0] pinned to start).  Dead state is implicit: when no
    transition fires, all lanes go 0 (Σ state can drop to 0 and stays 0)."""
    cache = cache or CharClassCache(cs)
    S = dfa.n_states
    trans = dfa.transitions()

    import numpy as np

    s0 = []
    for j in range(S):
        w = cs.new_wire(f"{tag}.s0.{j}")
        cs.enforce_eq(LC.of(w), LC.const(1 if j == 0 else 0), f"{tag}/init")
        cs.set_width(w, 1)
        s0.append(w)
    init = np.asarray([1] + [0] * (S - 1), dtype=np.int64)
    cs.compute_block(s0, lambda m, c=init: np.broadcast_to(c[:, None], (S, m.shape[1])), [])
    states = [s0]

    # All class indicators for the whole scan up front: one BlockHook per
    # distinct class covering every byte position (vs one per (byte,
    # class) — ~20k tiny blocks on the mini circuit).
    class_cols = {
        chars: cache.indicator_bulk(byte_wires, chars)
        for chars in {c for _, _, c in trans}
    }

    for t, byte in enumerate(byte_wires):
        prev = states[-1]
        # Per-step BlockHook: every transition product AND every next-state
        # sum from one numpy program (ins: S prev states + the step's
        # indicator wires) — the per-wire hook tier here was ~20% of the
        # whole witness (r1cs.witness_batch).
        prods: List[int] = []
        srcs: List[int] = []
        ind_ins: List[int] = []
        dst_mat_rows: List[Tuple[int, int]] = []  # (dst, prod_idx)
        for src, dst, chars in trans:
            ind = class_cols[chars][t]
            p = cs.new_wire(f"{tag}.t{t}.{src}.{dst}.out")
            cs.enforce(LC.of(prev[src]), LC.of(ind), LC.of(p), f"{tag}.t{t}")
            cs.set_width(p, 1)  # one-hot state x class indicator
            prods.append(p)
            srcs.append(src)
            ind_ins.append(ind)
            dst_mat_rows.append((dst, len(prods) - 1))
        nxt = []
        terms_by_dst: Dict[int, List[int]] = {}
        for dst, pi in dst_mat_rows:
            terms_by_dst.setdefault(dst, []).append(prods[pi])
        for j in range(S):
            w = cs.new_wire(f"{tag}.s{t + 1}.{j}")
            cs.enforce_eq(lc_sum(terms_by_dst.get(j, [])), LC.of(w), f"{tag}/step")
            cs.set_width(w, 1)  # deterministic DFA: at most one product fires
            nxt.append(w)
        src_idx = np.asarray(srcs)
        dst_onehot = np.zeros((S, len(prods)), dtype=np.int64)
        for dst, pi in dst_mat_rows:
            dst_onehot[dst, pi] = 1

        def vfn(m, src_idx=src_idx, dst=dst_onehot, S=S):
            pv = m[src_idx] * m[S:]  # (n_trans, K)
            return np.concatenate([pv, dst @ pv], axis=0)

        cs.compute_block(prods + nxt, vfn, list(prev) + ind_ins)
        states.append(nxt)
    return states


def match_count(cs: ConstraintSystem, states: List[List[int]], accept: FrozenSet[int], tag: str = "re.cnt") -> int:
    """Number of steps landing in an accept state (the template's `out`
    signal; main circuit asserts exact counts, `circuit.circom:106,119`)."""
    import numpy as np

    out = cs.new_wire(tag)
    acc_wires = [states[t][a] for t in range(1, len(states)) for a in accept]
    for w in acc_wires:  # count-by-sum assumes 0/1 lanes
        cs.require_width(w, 1, f"{tag}/match_count.lane")
    cs.enforce_eq(lc_sum(acc_wires), LC.of(out), tag)
    cs.set_width(out, max(1, len(acc_wires).bit_length()))
    cs.compute_block([out], lambda m: m.sum(axis=0, keepdims=True), acc_wires)
    return out


def reveal_bytes(
    cs: ConstraintSystem,
    byte_wires: Sequence[int],
    states: List[List[int]],
    reveal_states: Sequence[int],
    tag: str = "re.rev",
) -> List[int]:
    """reveal[i] = byte[i] * (state_{i+1} in reveal_states)
    (`gen.py:214-217`: the extraction mask for payee ID / amount).
    All mask sums + products witnessed by ONE BlockHook."""
    import numpy as np

    T = len(byte_wires)
    nr = len(reveal_states)
    out = []
    block_outs: List[int] = []
    for i, byte in enumerate(byte_wires):
        mask_wires = [states[i + 1][s] for s in reveal_states]
        for w in mask_wires:  # mask-by-sum assumes disjoint 0/1 lanes
            cs.require_width(w, 1, f"{tag}/reveal.lane")
        if len(mask_wires) == 1:
            mask = mask_wires[0]
        else:
            mask = cs.new_wire(f"{tag}.m{i}")
            cs.enforce_eq(lc_sum(mask_wires), LC.of(mask), f"{tag}/mask")
            cs.set_width(mask, 1)  # disjoint one-hot state lanes
            block_outs.append(mask)
        p = cs.new_wire(f"{tag}.{i}.out")
        cs.enforce(LC.of(byte), LC.of(mask), LC.of(p), f"{tag}.{i}")
        cs.set_width(p, max(cs.wire_width.get(byte, 254), 1))  # byte x bool mask
        block_outs.append(p)
        out.append(p)

    # ins: bytes (T) then the reveal-state wires per position (T, nr)
    state_ins = [states[i + 1][s] for i in range(T) for s in reveal_states]

    def vfn(m, T=T, nr=nr):
        bytes_v = m[0:T]
        masks = m[T:].reshape(T, nr, -1).sum(axis=1)  # (T, K)
        pv = bytes_v * masks
        if nr == 1:
            return pv  # no mask wires were created
        return np.stack([masks, pv], axis=1).reshape(2 * T, -1)

    cs.compute_block(block_outs, vfn, list(byte_wires) + state_ins)
    return out
