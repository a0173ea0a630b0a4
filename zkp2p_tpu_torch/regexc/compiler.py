"""regex -> NFA -> minimized DFA compiler (the L0 tool).

Our rebuild of `regex_to_circom/` (`lexical.js:63+` parse/NFA/DFA,
`gen.py:64-163` codegen): one Python pipeline, no JS subprocess, emitting
DFA *tables* consumed by (a) the R1CS DFA gadget (gadgets/regex.py) and
(b) the vectorised JAX DFA scan (witness tracers) — instead of circom
source text.

Supported syntax (the subset the reference's catalog uses,
`lexical.js:9-40`): literals, escapes (\\r \\n \\t \\xNN and escaped
metachars), char classes [a-z0-9_] (ranges + literals), alternation `|`,
grouping `(...)`, postfix `* + ?`, and concatenation.  `.` is a literal
dot (email regexes), matching the reference's convention.  `\\x80` is the
header-start sentinel the DKIM regexes rely on
(`dkim_header_regex.circom:11-14`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

ALPHABET = 256
DEAD = -1


# ------------------------------------------------------------------ parsing


class _Parser:
    """Recursive descent: alt -> cat -> postfix -> atom."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def take(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    def parse(self):
        node = self.alt()
        if self.i != len(self.p):
            raise ValueError(f"unexpected '{self.peek()}' at {self.i}")
        return node

    def alt(self):
        branches = [self.cat()]
        while self.peek() == "|":
            self.take()
            branches.append(self.cat())
        return ("alt", branches) if len(branches) > 1 else branches[0]

    def cat(self):
        parts = []
        while self.peek() not in (None, "|", ")"):
            parts.append(self.postfix())
        if not parts:
            return ("eps",)
        return ("cat", parts) if len(parts) > 1 else parts[0]

    def postfix(self):
        node = self.atom()
        while self.peek() in ("*", "+", "?"):
            op = self.take()
            node = ({"*": "star", "+": "plus", "?": "opt"}[op], node)
        return node

    def atom(self):
        ch = self.take()
        if ch == "(":
            node = self.alt()
            if self.take() != ")":
                raise ValueError("unbalanced group")
            return node
        if ch == "[":
            return ("set", self._char_class())
        if ch == "\\":
            return ("set", frozenset([self._escape()]))
        if ch in "*+?)":
            raise ValueError(f"dangling '{ch}'")
        return ("set", frozenset([ord(ch)]))

    def _escape(self) -> int:
        ch = self.take()
        table = {"r": 13, "n": 10, "t": 9, "0": 0, "f": 12, "v": 11}
        if ch in table:
            return table[ch]
        if ch == "x":
            return int(self.take() + self.take(), 16)
        return ord(ch)

    def _char_class(self) -> FrozenSet[int]:
        chars: Set[int] = set()
        negate = False
        if self.peek() == "^":
            self.take()
            negate = True
        while self.peek() != "]":
            if self.peek() is None:
                raise ValueError("unterminated class")
            ch = self.take()
            lo = self._escape() if ch == "\\" else ord(ch)
            if self.peek() == "-" and self.p[self.i + 1 : self.i + 2] != "]":
                self.take()
                hi_ch = self.take()
                hi = self._escape() if hi_ch == "\\" else ord(hi_ch)
                chars.update(range(lo, hi + 1))
            else:
                chars.add(lo)
        self.take()
        if negate:
            chars = set(range(ALPHABET)) - chars
        return frozenset(chars)


# ---------------------------------------------------------------- NFA / DFA


@dataclass
class _NFA:
    # state -> list of (charset or None-for-eps, next_state)
    edges: List[List[Tuple[Optional[FrozenSet[int]], int]]] = field(default_factory=list)

    def new_state(self) -> int:
        self.edges.append([])
        return len(self.edges) - 1


def _build_nfa(node, nfa: _NFA) -> Tuple[int, int]:
    """Thompson construction; returns (start, accept)."""
    kind = node[0]
    if kind == "eps":
        s = nfa.new_state()
        return s, s
    if kind == "set":
        s, t = nfa.new_state(), nfa.new_state()
        nfa.edges[s].append((node[1], t))
        return s, t
    if kind == "cat":
        start, acc = _build_nfa(node[1][0], nfa)
        for part in node[1][1:]:
            s2, a2 = _build_nfa(part, nfa)
            nfa.edges[acc].append((None, s2))
            acc = a2
        return start, acc
    if kind == "alt":
        s, t = nfa.new_state(), nfa.new_state()
        for br in node[1]:
            bs, ba = _build_nfa(br, nfa)
            nfa.edges[s].append((None, bs))
            nfa.edges[ba].append((None, t))
        return s, t
    if kind in ("star", "opt", "plus"):
        inner_s, inner_a = _build_nfa(node[1], nfa)
        s, t = nfa.new_state(), nfa.new_state()
        nfa.edges[s].append((None, inner_s))
        nfa.edges[inner_a].append((None, t))
        if kind in ("star", "opt"):
            nfa.edges[s].append((None, t))
        if kind in ("star", "plus"):
            nfa.edges[inner_a].append((None, inner_s))
        return s, t
    raise AssertionError(kind)


@dataclass
class DFA:
    """Dense DFA: next[state, byte] (DEAD = -1 = reject sink), start = 0."""

    next: np.ndarray  # (n_states, 256) int16
    accept: FrozenSet[int]

    @property
    def n_states(self) -> int:
        return self.next.shape[0]

    def run(self, data: bytes) -> List[int]:
        """States AFTER each byte (host oracle for the scan/gadget)."""
        out = []
        s = 0
        for b in data:
            s = int(self.next[s, b]) if s != DEAD else DEAD
            out.append(s)
        return out

    def matches(self, data: bytes) -> bool:
        states = self.run(data)
        final = states[-1] if states else 0
        return final in self.accept

    def lookup_rows(self) -> List[Tuple[int, int, int]]:
        """Dense (src, dst, byte) transition triples, DEAD edges omitted —
        the lookup-argument artifact of the reference's regex compiler
        (`regex_to_circom/gen.py` OUTPUT_HALO2 path): a lookup proof
        system shows each scan step's (state, char, state') row is in
        this table instead of compiling per-transition constraints."""
        return [
            (int(s), int(self.next[s, c]), int(c))
            for s, c in np.argwhere(self.next != DEAD)
        ]

    def emit_lookup_table(self, path: str) -> None:
        """Write the lookup artifact in the reference's file format
        (`halo2_regex_lookup.txt`, gen.py:41-51): line 1 = the accept
        states, then one `src dst char` row per dense transition."""
        with open(path, "w") as f:
            f.write(" ".join(str(a) for a in sorted(self.accept)) + " \n")
            for src, dst, c in self.lookup_rows():
                f.write(f"{src} {dst} {c}\n")

    def transitions(self) -> List[Tuple[int, int, FrozenSet[int]]]:
        """(src, dst, charset) triples, DEAD edges omitted — the gadget's
        sparse view."""
        out = []
        for s in range(self.n_states):
            by_dst: Dict[int, Set[int]] = {}
            for c in range(ALPHABET):
                d = int(self.next[s, c])
                if d != DEAD:
                    by_dst.setdefault(d, set()).add(c)
            for d, chars in sorted(by_dst.items()):
                out.append((s, d, frozenset(chars)))
        return out


def _eps_closure(nfa: _NFA, states: FrozenSet[int]) -> FrozenSet[int]:
    stack = list(states)
    seen = set(states)
    while stack:
        s = stack.pop()
        for chars, t in nfa.edges[s]:
            if chars is None and t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


def compile_regex(pattern: str) -> DFA:
    """regex string -> minimized dense DFA."""
    nfa = _NFA()
    start, accept = _build_nfa(_Parser(pattern).parse(), nfa)

    init = _eps_closure(nfa, frozenset([start]))
    subsets: Dict[FrozenSet[int], int] = {init: 0}
    order = [init]
    rows: List[List[int]] = []
    i = 0
    while i < len(order):
        cur = order[i]
        row = [DEAD] * ALPHABET
        # group reachable-by-char
        move: Dict[int, Set[int]] = {}
        for s in cur:
            for chars, t in nfa.edges[s]:
                if chars is None:
                    continue
                for c in chars:
                    move.setdefault(c, set()).add(t)
        closures: Dict[FrozenSet[int], FrozenSet[int]] = {}
        for c, tgts in move.items():
            key = frozenset(tgts)
            if key not in closures:
                closures[key] = _eps_closure(nfa, key)
            clo = closures[key]
            if clo not in subsets:
                subsets[clo] = len(order)
                order.append(clo)
            row[c] = subsets[clo]
        rows.append(row)
        i += 1

    accepting = frozenset(i for sub, i in subsets.items() if accept in sub)
    dfa = DFA(np.array(rows, dtype=np.int16), accepting)
    return _minimize(dfa)


def _minimize(dfa: DFA) -> DFA:
    """Moore partition refinement (dead sink handled implicitly)."""
    n = dfa.n_states
    # block id per state; start with accept / non-accept (+ implicit dead).
    block = [1 if s in dfa.accept else 0 for s in range(n)]
    while True:
        # signature: (block, tuple of next-blocks per char)
        sigs: Dict[Tuple, int] = {}
        new_block = [0] * n
        for s in range(n):
            sig = (
                block[s],
                tuple(
                    block[dfa.next[s, c]] if dfa.next[s, c] != DEAD else -1
                    for c in range(ALPHABET)
                ),
            )
            if sig not in sigs:
                sigs[sig] = len(sigs)
            new_block[s] = sigs[sig]
        if new_block == block:
            break
        block = new_block

    # Re-number so the start state's block is 0, preserving reachability order.
    remap: Dict[int, int] = {}
    new_next_rows = []
    queue = [block[0]]
    remap[block[0]] = 0
    reps: Dict[int, int] = {}
    for s in range(n):
        reps.setdefault(block[s], s)
    while queue:
        b = queue.pop(0)
        rep = reps[b]
        row = []
        for c in range(ALPHABET):
            d = int(dfa.next[rep, c])
            if d == DEAD:
                row.append(DEAD)
                continue
            db = block[d]
            if db not in remap:
                remap[db] = len(remap)
                queue.append(db)
            row.append(remap[db])
        new_next_rows.append((remap[b], row))
    new_n = len(remap)
    next_arr = np.full((new_n, ALPHABET), DEAD, dtype=np.int16)
    for idx, row in new_next_rows:
        next_arr[idx] = row
    new_accept = frozenset(remap[block[s]] for s in range(n) if s in dfa.accept and block[s] in remap)
    return DFA(next_arr, new_accept)


# ------------------------------------------------------- reference catalog

# The regex catalog the reference ships (regex_to_circom/lexical.js:9-40 and
# the generated circuits' header comments), expressed in our syntax.
# ANY_STAR prefixes a pattern for substring-search automata (the generated
# circuits get the same effect from their catch-all start loop).
ANY_STAR = "[\\0-\\xff]*"
WORD_CHAR = "[0-9A-Za-z_]"
VENMO_OFFRAMPER_ID = r"user_id=3D[0-9A-Za-z_\r\n=]+"
VENMO_AMOUNT = r"\$[0-9A-Za-z_]+\."
VENMO_ACTOR_ID = r"actor_id=3D[0-9]+"
VENMO_MM_ID = r"user_id=3D[0-9A-Za-z_\r\n=]+"
# Legacy custom-message extractor (`circuit/legacy/venmo_message_regex.circom:8`:
# `<p>(0|1|2|3|4|5|6|7|8|9)+`) — the digits following the first HTML <p> tag.
VENMO_MESSAGE = r"<p>[0-9]+"
DKIM_HEADER = r"(\x80|\r\n)(to|from):[^\r\n]+\r\n"
BODY_HASH = r"\r\ndkim-signature:([a-z]+=[^;]+; )+bh=[0-9A-Za-z+/=]+; "
TWITTER_RESET = r"This email was meant for @[0-9A-Za-z_]+"


def search_dfa(pattern: str) -> DFA:
    """Substring-search automaton: accept fires at every position where a
    match of `pattern` ends (the counting semantics the generated circuits
    rely on, e.g. `out === 2` for two to/from headers)."""
    return compile_regex(ANY_STAR + pattern)


def reveal_circuit(pattern: str, n_bytes: int, reveal_len: int, name: str = "regex_reveal"):
    """Mint a payment-extraction circuit from a bare regex — the
    reference's regex_to_circom L0 path (gen.py:64-217), but straight to
    R1CS: scan `pattern` over `n_bytes` private data bytes, reveal the
    regex-masked match bytes, one-hot shift them to a fixed
    `reveal_len` window anchored on a real revealed char (the venmo
    vid/nonzero trick: an all-zero mask cannot forge the window), and
    pack them into 7-byte public words.

    This is how the registry (models.registry) mints new payment
    circuits; the static soundness audit (snark.analysis) is their
    admission gate, so a minted circuit never reaches the prover
    unaudited.  Returns (cs, layout dict)."""
    # lazy imports: gadgets.regex imports this module (cycle-free at call time)
    from ..field.bn254 import R
    from ..gadgets import core
    from ..gadgets.regex import CharClassCache, dfa_scan, reveal_bytes
    from ..models import common
    from ..snark.r1cs import LC, ConstraintSystem

    assert 0 < reveal_len < n_bytes
    n_words = (reveal_len + 6) // 7
    cs = ConstraintSystem(name)
    word_pubs = [cs.new_public(f"reveal[{i}]") for i in range(n_words)]
    data = cs.new_wires(n_bytes, "data")
    idx = cs.new_wire("reveal_idx")
    cs.mark_input(data + [idx])
    bits = core.assert_bytes(cs, data, "data")
    cache = CharClassCache(cs)
    for w, b in zip(data, bits):
        cache.register_bits(w, b)
    dfa = search_dfa(pattern)
    states = dfa_scan(cs, list(data), dfa, cache, "rx")
    reveal = reveal_bytes(cs, data, states, sorted(dfa.accept), "rx.rev")
    onehot = core.one_hot(cs, idx, n_bytes - reveal_len, "rx.idx")
    chars = common.shift_window(cs, reveal, onehot, reveal_len, "rx.shift")
    inv = cs.new_wire("rx.first_inv")
    cs.compute(inv, lambda v: pow(v, R - 2, R) if v else 0, [chars[0]])
    cs.enforce(LC.of(chars[0]), LC.of(inv), LC.const(1), "rx/nonzero")
    words = core.pack_bytes(cs, chars, 7, "rx.pack")
    for w, pub in zip(words, word_pubs):
        cs.enforce_eq(LC.of(w), LC.of(pub), "rx/out")
    return cs, {"data": data, "idx": idx, "publics": word_pubs, "dfa": dfa}
