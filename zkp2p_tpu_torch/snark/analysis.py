"""Static R1CS soundness auditor — the registry admission gate.

The product's security claim is an iff: "a proof exists ⟺ a real
DKIM-signed payment exists".  The programmatic frontend (snark.r1cs
gadget composition, replacing circom) can silently break the ⟸
direction with an under-constrained wire, and NO runtime test catches
it: witnesses built by the circuit's own hooks always satisfy the
circuit's own constraints.  This module analyzes the built
``ConstraintSystem`` itself, with the PR-13 lint discipline (every rule
proven able to fire, zero unwaived findings on shipped circuits, every
waiver carrying a written soundness argument).

Rules (docs/STATIC_ANALYSIS.md carries the full table with scars):

  unconstrained-wire    a wire appearing in no constraint — the prover
                        may substitute ANY value (worst when a
                        ComputeHook assigns it: the hook hides the hole
                        from every witness test).
  determinism           Picus-lite uniqueness fixpoint: propagate
                        "uniquely determined" from wire 0 + publics +
                        declared inputs through constraints with one
                        linearly-occurring unknown, IsZero-style case
                        pairs, boolean power-of-two decompositions, and
                        small linear-system rank closure (the
                        BigMultNoCarry Vandermonde pattern).  Wires
                        never reached are attacker-choosable.
  bool-width            every gadget width DEMAND (require_width: AND
                        gate operands, mux selectors, LessThan inputs,
                        packer bytes) must be dominated by a recorded
                        wire_width bound — the unbounded-comparator
                        forgery class.  The rule closes the MISSING-
                        annotation hole; wire_width itself is trusted
                        metadata under set_width's contract ("only call
                        where a constraint enforces it"), and a LYING
                        bound already fails closed at proof time (the
                        width-classed MSM emits a proof that fails
                        pairing verification, never a forged one).
  dead-constraint       0 = 0 and constant-only rows: wasted prover
                        work (QAP rows, MSM length), and a never-
                        satisfiable constant row is a broken circuit.
  duplicate-constraint  byte-identical rows (modulo a*b swap).
  hook-coverage         every constrained non-input wire assigned by
                        exactly one witness hook — the witness()-time
                        "unassigned wire" crash, caught statically.
  public-layout         n_public vs the declared on-chain signal layout
                        (and, where a VerifyingKey is at hand, the
                        exported verifier's IC length) — the
                        docs/EVM_PARITY.md loop, registry-wide.

The determinism pass is deliberately *sound but incomplete*: it only
ever marks a wire determined when every satisfying witness provably
agrees on it, so a "determined" verdict is trustworthy and an
"undetermined" one is a finding to fix or waive — exactly Picus's
one-sided contract (PAPERS.md; Picus = the circom ecosystem's
determinism checker).  It scales by working on flat numpy incidence
arrays with a frontier worklist, so the 4.9M-wire flagship audits in a
CI-tolerable budget; reports are cached under .bench_cache keyed by a
structural circuit digest and surfaced in run_manifest.
"""

from __future__ import annotations

import fnmatch
import hashlib
import json
import os
import re
import time
from array import array
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Tuple

from ..field.bn254 import R

AUDIT_VERSION = 2  # v2: hook-coverage also flags hook-assigned publics

RULES = (
    "unconstrained-wire",
    "determinism",
    "bool-width",
    "dead-constraint",
    "duplicate-constraint",
    "hook-coverage",
    "public-layout",
)

_NUM_RE = re.compile(r"\d+")


def label_class(label: str) -> str:
    """Collapse indices out of a wire label: 'rsa.sq3.qb.2.b[7]' ->
    'rsa.sq#.qb.#.b[#]'.  Findings aggregate by class (a 4.9M-wire
    circuit must report families, not four million lines), and witness
    errors reuse it as the allocation-site name."""
    return _NUM_RE.sub("#", label) if label else "?"


@dataclass
class CircuitFinding:
    rule: str
    where: str  # label class (wire rules) / tag class (constraint rules)
    count: int
    example: str  # one concrete wire or constraint, fully indexed
    msg: str

    def __str__(self) -> str:
        n = f" x{self.count}" if self.count > 1 else ""
        return f"[{self.rule}] {self.where}{n}: {self.msg} (e.g. {self.example})"


class CircuitAuditError(RuntimeError):
    """Raised by the admission gate when a circuit has unwaived findings."""


# ---------------------------------------------------------------------------
# determinism engine

_A_CNZ, _B_CNZ, _C_CNZ = 1, 2, 4


def _pow2_exp(v: int) -> Optional[int]:
    """Exponent k if v == ±2^k mod R (canonical residue), else None."""
    if v and v & (v - 1) == 0:
        return v.bit_length() - 1
    n = R - v
    if n and n & (n - 1) == 0:
        return n.bit_length() - 1
    return None


class _Extraction:
    """One pass over the constraints: flat incidence arrays for the
    fixpoint + everything the cheap rules need."""

    def __init__(self, cs, sources):
        import numpy as np

        n_con = len(cs.constraints)
        inc_con = array("q")
        inc_wire = array("q")
        inc_mask = array("b")
        n_unk = array("l")
        flags = array("b")
        self.pow2lin = set()
        self.bool_wires = set()
        self.dead: List[Tuple[int, str]] = []
        self.dup: List[Tuple[int, int]] = []
        zero_forms: Dict[bytes, List[int]] = {}
        inv_forms: Dict[bytes, List[int]] = {}
        seen: Dict[bytes, int] = {}
        constrained = np.zeros(cs.num_wires, dtype=bool)
        constrained[0] = True
        blake = hashlib.blake2b

        def side_bytes(d) -> bytes:
            buf = bytearray()
            for w in sorted(d):
                v = d[w] % R
                if v:
                    buf += w.to_bytes(8, "little") + v.to_bytes(32, "little")
            return bytes(buf)

        for idx, con in enumerate(cs.constraints):
            a, b, c = con.a, con.b, con.c
            masks: Dict[int, int] = {}
            for d, m in ((a, 1), (b, 2), (c, 4)):
                for w, v in d.items():
                    if w and v % R:
                        masks[w] = masks.get(w, 0) | m
            for w in masks:
                constrained[w] = True
            aw = [w for w, m in masks.items() if m & 1]
            bw = [w for w, m in masks.items() if m & 2]
            cw = [w for w, m in masks.items() if m & 4]
            av, bv, cv = a.get(0, 0) % R, b.get(0, 0) % R, c.get(0, 0) % R
            fl = 0
            if not aw and av:
                fl |= _A_CNZ
            if not bw and bv:
                fl |= _B_CNZ
            if not cw and cv:
                fl |= _C_CNZ
            # ---- dead / duplicate
            if not cw and not cv and ((not aw and not av) or (not bw and not bv)):
                self.dead.append((idx, "0 = 0 (one product side identically zero)"))
            elif not aw and not bw and not cw:
                if av * bv % R == cv:
                    self.dead.append((idx, "constant identity (no wires)"))
                else:
                    self.dead.append(
                        (idx, "constant constraint that is NEVER satisfiable")
                    )
            sa, sb, sc = side_bytes(a), side_bytes(b), side_bytes(c)
            key = blake(min(sa, sb) + b"\x00" + max(sa, sb) + b"\x00" + sc,
                        digest_size=16).digest()
            first = seen.setdefault(key, idx)
            if first != idx:
                self.dup.append((idx, first))
            # ---- booleanity pattern: w*(w-1) = 0
            if (
                aw
                and len(masks) == 1
                and aw == bw
                and not cw
                and not cv
                and not av
                and a.get(aw[0], 0) % R == 1
                and b.get(aw[0], 0) % R == 1
                and bv == R - 1
            ):
                self.bool_wires.add(aw[0])
            # ---- IsZero case pair (lemma A): L*out = 0  +  L*inv = 1 - out.
            # Case analysis makes `out` unique once L's wires are known
            # (L=0 forces out=1 via the inv row; L!=0 forces out=0 via the
            # zero row) — the one circomlib shape the linear rules miss.
            if len(bw) == 1 and b.get(bw[0], 0) % R == 1 and not bv:
                wb = bw[0]
                if not cw and not cv:
                    zero_forms.setdefault(sa, []).append(wb)
            if len(bw) == 1 and len(cw) == 1 and cv == 1 and c.get(cw[0], 0) % R == R - 1:
                inv_forms.setdefault(sa, []).append(cw[0])
            # ---- boolean power-of-two decomposition candidates (lemma B)
            if not bw and bv and not cw and aw:
                ok = True
                for w in aw:
                    if _pow2_exp(a[w] % R) is None:
                        ok = False
                        break
                if ok:
                    self.pow2lin.add(idx)
            # ---- incidence
            nk = 0
            for w, m in masks.items():
                inc_con.append(idx)
                inc_wire.append(w)
                inc_mask.append(m)
                if not sources[w]:
                    nk += 1
            n_unk.append(nk)
            flags.append(fl)

        # lemma A synthetic edges: target determined once all L wires are
        syn_rows: List[Tuple[int, List[int]]] = []
        for sa, outs in zero_forms.items():
            invs = inv_forms.get(sa)
            if not invs:
                continue
            for w_o in set(outs) & set(invs):
                # recover L's wires from the serialized side
                srcs = [
                    int.from_bytes(sa[i : i + 8], "little")
                    for i in range(0, len(sa), 40)
                ]
                srcs = [w for w in srcs if w]
                if w_o in srcs:
                    continue
                syn_rows.append((w_o, srcs))
        self.n_real = n_con
        for j, (w_o, srcs) in enumerate(syn_rows):
            idx = n_con + j
            nk = 0 if sources[w_o] else 1
            for w in srcs:
                inc_con.append(idx)
                inc_wire.append(w)
                inc_mask.append(1)
                if not sources[w]:
                    nk += 1
            inc_con.append(idx)
            inc_wire.append(w_o)
            inc_mask.append(4)
            n_unk.append(nk)
            flags.append(0)

        self.inc_con = np.frombuffer(inc_con, dtype=np.int64)
        self.inc_wire = np.frombuffer(inc_wire, dtype=np.int64)
        self.inc_mask = np.frombuffer(inc_mask, dtype=np.int8)
        self.n_unk = np.array(n_unk, dtype=np.int64)
        self.flags = np.array(flags, dtype=np.int8)
        self.constrained = constrained


def _determinism(cs, exc: "_Extraction", sources) -> "np.ndarray":
    """The fixpoint: returns the boolean `determined` array."""
    import numpy as np

    determined = sources.copy()
    inc_con, inc_wire, inc_mask = exc.inc_con, exc.inc_wire, exc.inc_mask
    n_unk, flags = exc.n_unk, exc.flags
    n_total = n_unk.shape[0]

    order_w = np.argsort(inc_wire, kind="stable")
    ws = inc_wire[order_w]
    w_start = np.searchsorted(ws, np.arange(cs.num_wires))
    w_end = np.searchsorted(ws, np.arange(cs.num_wires), side="right")
    order_c = np.argsort(inc_con, kind="stable")
    csort = inc_con[order_c]
    c_start = np.searchsorted(csort, np.arange(n_total))
    c_end = np.searchsorted(csort, np.arange(n_total), side="right")

    newly: List[int] = []

    def try_determine(con: int) -> None:
        w = -1
        m = 0
        for r in order_c[c_start[con] : c_end[con]]:
            wr = inc_wire[r]
            if not determined[wr]:
                w, m = int(wr), int(inc_mask[r])
                break
        if w < 0:
            return
        f = flags[con]
        if m == 4:
            ok = True  # linear in C (also the lemma-A synthetic target)
        elif m == 1:
            ok = bool(f & (_B_CNZ | _C_CNZ))
        elif m == 2:
            ok = bool(f & (_A_CNZ | _C_CNZ))
        else:
            ok = False  # occurs quadratically (e.g. booleanity) — no
        if ok:
            determined[w] = True
            newly.append(w)

    bool_wires = exc.bool_wires

    def try_pow2(con: int) -> None:
        a = cs.constraints[con].a
        unk = [(w, v % R) for w, v in a.items() if w and v % R and not determined[w]]
        if not unk:
            return
        exps = set()
        for w, v in unk:
            if w not in bool_wires:
                return
            e = _pow2_exp(v)
            if e is None or e > 252 or e in exps:
                return
            exps.add(e)
        # distinct ±2^k coefficients over boolean unknowns: any two
        # assignments differ at the highest differing bit, so the linear
        # form is injective — all unknowns uniquely determined.
        for w, _ in unk:
            determined[w] = True
            newly.append(w)

    def gather_rows(front: "np.ndarray") -> "np.ndarray":
        s = w_start[front]
        ln = w_end[front] - s
        tot = int(ln.sum())
        if not tot:
            return np.empty(0, dtype=np.int64)
        offs = np.cumsum(ln) - ln
        pos = np.arange(tot)
        within = pos - np.repeat(offs, ln)
        return order_w[np.repeat(s, ln) + within]

    def rank_closure(c_side_only: bool) -> None:
        """Lemma C: residual linear systems (the BigMultNoCarry
        Vandermonde shape).  Row scaling by a determined-nonzero factor
        never changes rank, so b-side values need not be known.  The
        c_side_only pass runs first: product-output systems (a,b fully
        determined) cluster tightly (one Vandermonde block per bigmul),
        while the general pass lets ripple-carry rows union everything
        into one oversized — skipped — cluster."""
        stalled = np.flatnonzero(n_unk[: exc.n_real] > 0)
        eqs: List[Dict[int, int]] = []
        for con in stalled:
            rec = cs.constraints[int(con)]
            a, b, c = rec.a, rec.b, rec.c
            ua = [w for w, v in a.items() if w and v % R and not determined[w]]
            ub = [w for w, v in b.items() if w and v % R and not determined[w]]
            uc = [w for w, v in c.items() if w and v % R and not determined[w]]
            f = flags[con]
            if uc and not ua and not ub:
                eqs.append({w: c[w] % R for w in uc})
            elif c_side_only:
                continue
            elif ua and not ub and not uc and (f & (_B_CNZ | _C_CNZ)):
                eqs.append({w: a[w] % R for w in ua})
            elif ub and not ua and not uc and (f & (_A_CNZ | _C_CNZ)):
                eqs.append({w: b[w] % R for w in ub})
        if not eqs:
            return
        parent: Dict[int, int] = {}

        def find(x: int) -> int:
            r = x
            while parent.get(r, r) != r:
                r = parent[r]
            while parent.get(x, x) != x:
                parent[x], x = r, parent[x]
            return r

        for eq in eqs:
            it = iter(eq)
            first = find(next(it))
            for w in it:
                parent[find(w)] = first
        clusters: Dict[int, List[Dict[int, int]]] = {}
        wires_of: Dict[int, set] = {}
        for eq in eqs:
            root = find(next(iter(eq)))
            clusters.setdefault(root, []).append(eq)
            wires_of.setdefault(root, set()).update(eq)
        for root, rows in clusters.items():
            wires = wires_of[root]
            if len(wires) > 96 or len(rows) < len(wires):
                continue
            # sparse forward elimination mod R.  Every pivot row is
            # stored under its minimum wire, so reducing a row at its
            # smallest pivot-overlapping wire only introduces larger
            # wires — the row's smallest overlap strictly increases and
            # the loop terminates.  Each surviving row is nonzero after
            # reduction by ALL current pivots, hence independent of
            # them: len(pivots) == column count proves full rank.
            pivots: Dict[int, Dict[int, int]] = {}
            for eq in rows:
                row = dict(eq)
                while row:
                    common = [w for w in row if w in pivots]
                    if not common:
                        break
                    w = min(common)
                    piv = pivots[w]
                    factor = row[w] * pow(piv[w], R - 2, R) % R
                    for pw, pv in piv.items():
                        nv = (row.get(pw, 0) - factor * pv) % R
                        if nv:
                            row[pw] = nv
                        else:
                            row.pop(pw, None)
                if row:
                    pivots[min(row)] = row
                if len(pivots) == len(wires):
                    break
            if len(pivots) == len(wires):  # full column rank: unique solve
                for w in wires:
                    if not determined[w]:
                        determined[w] = True
                        newly.append(w)

    # round 0: everything already single-unknown or decomposition-ready
    for con in np.flatnonzero(n_unk == 1):
        try_determine(int(con))
    for con in sorted(exc.pow2lin):
        if n_unk[con] > 0:
            try_pow2(con)
    frontier = np.array(sorted(set(newly)), dtype=np.int64)
    newly = []
    pow2lin = exc.pow2lin
    while True:
        while frontier.size:
            rows = gather_rows(frontier)
            cons = inc_con[rows]
            np.subtract.at(n_unk, cons, 1)
            uniq = np.unique(cons)
            for con in uniq[n_unk[uniq] == 1]:
                try_determine(int(con))
            for con in uniq:
                ci = int(con)
                if ci in pow2lin and n_unk[ci] > 0:
                    try_pow2(ci)
            frontier = np.array(sorted(set(newly)), dtype=np.int64)
            newly = []
        rank_closure(c_side_only=True)
        if not newly:
            rank_closure(c_side_only=False)
        if not newly:
            break
        frontier = np.array(sorted(set(newly)), dtype=np.int64)
        newly = []
    return determined


# ---------------------------------------------------------------------------
# digest + cache

def circuit_digest(cs) -> str:
    """Structural digest of a built circuit: constraints, public count,
    width bounds + demands, declared inputs, hook wiring, and the waiver
    table (a waiver edit must invalidate cached reports).  16 hex."""
    h = hashlib.sha256()
    h.update(f"v{AUDIT_VERSION}|{cs.num_wires}|{cs.num_public}|".encode())
    for con in cs.constraints:
        for d in (con.a, con.b, con.c):
            for w in sorted(d):
                v = d[w] % R
                if v:
                    h.update(w.to_bytes(8, "little"))
                    h.update(v.to_bytes(32, "little"))
            h.update(b"\xfe")
        # the tag IS audit-relevant structure: dead/duplicate waivers
        # match on it, so a tag edit must invalidate cached verdicts
        h.update(con.tag.encode())
        h.update(b"\xff")
    # labels likewise: waiver globs and finding attribution key on them,
    # so a label-only rename must rebuild (a stale cached "clean" would
    # otherwise ADMIT a circuit whose waivers no longer match)
    for w in sorted(cs.labels):
        h.update(f"L{w}:{cs.labels[w]};".encode())
    for w in sorted(cs.wire_width):
        h.update(f"W{w}:{cs.wire_width[w]};".encode())
    for w, bits, site in cs.width_demands:
        h.update(f"D{w}:{bits}:{site};".encode())
    for w in sorted(cs.input_wires):
        h.update(f"I{w};".encode())
    for hook in cs.hooks:
        h.update(type(hook).__name__.encode())
        h.update(array("q", hook.outs).tobytes())
        h.update(b"<")
        h.update(array("q", hook.ins).tobytes())
    for (rule, glob), why in sorted(cs.audit_waivers.items()):
        h.update(f"X{rule}|{glob}|{why};".encode())
    return h.hexdigest()[:16]


def _cache_dir() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, ".bench_cache")


def _cache_path(name: str, digest: str, cache_dir: Optional[str]) -> str:
    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", name)
    return os.path.join(cache_dir or _cache_dir(), f"circuit_audit_{safe}_{digest}.json")


# ---------------------------------------------------------------------------
# the audit

def analyze(cs, declared_n_public: Optional[int] = None, vk=None) -> Tuple[
    List[Tuple[str, str, str, str]], Dict[str, int]
]:
    """Run every rule; returns (raw findings, stats).  Raw findings are
    (rule, match_text, example_desc, family_msg) per wire/constraint —
    waiver resolution and aggregation happen in audit_circuit."""
    import numpy as np

    sources = np.zeros(cs.num_wires, dtype=bool)
    sources[0] = True
    sources[1 : 1 + cs.num_public] = True
    for w in cs.input_wires:
        sources[w] = True

    exc = _Extraction(cs, sources)
    raw: List[Tuple[str, str, str]] = []
    labels = cs.labels

    def wdesc(w: int) -> str:
        return f"wire {w} '{labels.get(w, '')}'"

    # unconstrained-wire (wire 0 and an untouched tail would both be
    # allocator bugs; every allocated wire must appear somewhere)
    hooked = np.zeros(cs.num_wires, dtype=np.int32)
    for hook in cs.hooks:
        for o in hook.outs:
            hooked[o] += 1
    unconstrained = np.flatnonzero(~exc.constrained)
    for w in unconstrained:
        w = int(w)
        kind = (
            "assigned by a witness hook"
            if hooked[w]
            else ("a public signal" if w <= cs.num_public else
                  ("a declared input" if w in cs.input_wires else "never assigned"))
        )
        raw.append((
            "unconstrained-wire",
            labels.get(w, ""),
            f"{wdesc(w)} ({kind})",
            "appears in no constraint — the prover may substitute any value",
        ))

    # determinism
    determined = _determinism(cs, exc, sources)
    undet = np.flatnonzero(~determined & exc.constrained)
    for w in undet:
        w = int(w)
        raw.append((
            "determinism",
            labels.get(w, ""),
            wdesc(w),
            "not uniquely determined by the inputs — an attacker may "
            "choose it freely among satisfying witnesses",
        ))

    # bool-width
    for w, bits, site in cs.width_demands:
        bound = cs.wire_width.get(w, 254)
        if bound > bits:
            raw.append((
                "bool-width",
                labels.get(w, ""),
                f"{wdesc(w)} demanded at site '{site}'",
                f"assumed < 2^{bits} but the strongest recorded bound is "
                f"2^{bound} — the unbounded-comparator forgery class",
            ))

    # dead / duplicate (match on the constraint TAG)
    for idx, msg in exc.dead:
        tag = cs.constraints[idx].tag
        raw.append(("dead-constraint", tag, f"constraint {idx} ({tag!r})", msg))
    for idx, first in exc.dup:
        tag = cs.constraints[idx].tag
        raw.append((
            "duplicate-constraint",
            tag,
            f"constraint {idx} ({tag!r}) == constraint {first} "
            f"({cs.constraints[first].tag!r})",
            "byte-identical constraint — wasted prover work",
        ))

    # hook-coverage
    for w in np.flatnonzero(exc.constrained):
        w = int(w)
        if w == 0:
            continue
        n = int(hooked[w])
        if w <= cs.num_public:
            # publics are seeded from public_inputs BEFORE hooks run: a
            # hook here overwrites the verifier-supplied value and every
            # proof fails pairing verification with no attribution
            if n:
                raw.append((
                    "hook-coverage",
                    labels.get(w, ""),
                    f"{wdesc(w)} (public, {n} hooks)",
                    "a public signal assigned by a witness hook — the hook "
                    "silently overwrites the verifier-supplied value",
                ))
            continue
        if w in cs.input_wires:
            if n:
                raw.append((
                    "hook-coverage",
                    labels.get(w, ""),
                    f"{wdesc(w)} (input, {n} hooks)",
                    "both a declared input and hook-assigned — the hook "
                    "silently overwrites the seed",
                ))
            continue
        if n == 0:
            raw.append((
                "hook-coverage",
                labels.get(w, ""),
                wdesc(w),
                "constrained but no hook or input seed assigns it — "
                "witness() would fail at runtime",
            ))
        elif n > 1:
            raw.append((
                "hook-coverage",
                labels.get(w, ""),
                f"{wdesc(w)} ({n} hooks)",
                "assigned by multiple hooks — later hooks silently "
                "overwrite earlier ones",
            ))

    # public-layout
    if declared_n_public is not None and cs.num_public != declared_n_public:
        raw.append((
            "public-layout",
            "n_public",
            f"built n_public = {cs.num_public}",
            f"the declared on-chain layout expects {declared_n_public} "
            "public signals (docs/EVM_PARITY.md)",
        ))
    if vk is not None:
        n_ic = len(vk.ic)
        if n_ic != cs.num_public + 1:
            raw.append((
                "public-layout",
                "vk.ic",
                f"len(vk.IC) = {n_ic}",
                f"exported verifier bakes {n_ic} IC points for "
                f"{cs.num_public} publics (IC must be n_public+1)",
            ))

    stats = {
        "n_wires": cs.num_wires,
        "n_public": cs.num_public,
        "n_constraints": len(cs.constraints),
        "n_hooks": len(cs.hooks),
        "determined": int(determined.sum()),
        "undetermined": int(undet.shape[0]),
        "width_demands": len(cs.width_demands),
    }
    return raw, stats


def _resolve_waivers(cs, raw) -> Tuple[List[CircuitFinding], List[Dict]]:
    """Split raw findings into aggregated unwaived findings and per-
    waiver usage records (pattern, why, count)."""
    pats: Dict[str, List[List]] = {}
    for (rule, glob), why in cs.audit_waivers.items():
        pats.setdefault(rule, []).append(
            [re.compile(fnmatch.translate(glob)), glob, why, 0]
        )
    agg: Dict[Tuple[str, str], CircuitFinding] = {}
    for rule, match_text, example, msg in raw:
        entries = pats.get(rule)
        hit = None
        if entries:
            for e in entries:
                if e[0].match(match_text):
                    hit = e
                    break
            if hit is not None:
                hit[3] += 1
                # move-to-front: waived families are huge and homogeneous
                if entries[0] is not hit:
                    entries.remove(hit)
                    entries.insert(0, hit)
                continue
        cls = label_class(match_text)
        key = (rule, cls)
        cur = agg.get(key)
        if cur is None:
            agg[key] = CircuitFinding(rule, cls, 1, example, msg)
        else:
            cur.count += 1
    findings = sorted(agg.values(), key=lambda f: (f.rule, f.where))
    waived = [
        {"rule": rule, "pattern": e[1], "why": e[2], "count": e[3]}
        for rule, entries in sorted(pats.items())
        for e in sorted(entries, key=lambda x: x[1])
        if e[3]
    ]
    return findings, waived


# audits performed in this process, surfaced by utils.metrics.run_manifest
# (the precomp_manifest pattern): name -> summary dict
_audit_log: Dict[str, Dict] = {}


def audit_manifest() -> Dict[str, Dict]:
    return dict(_audit_log)


def audit_circuit(
    cs,
    name: Optional[str] = None,
    declared_n_public: Optional[int] = None,
    vk=None,
    use_cache: bool = True,
    cache_dir: Optional[str] = None,
) -> Dict:
    """Audit a built circuit.  Returns the report dict (JSON-able); the
    report is cached under .bench_cache keyed by the structural circuit
    digest, so re-admitting an unchanged circuit costs one digest pass."""
    name = name or cs.name
    t0 = time.perf_counter()
    digest = circuit_digest(cs)
    path = _cache_path(name, digest, cache_dir)
    if vk is not None:
        use_cache = False  # the vk IC check is not part of the digest key
    if use_cache and os.path.exists(path):
        try:
            with open(path) as f:
                report = json.load(f)
        except (OSError, ValueError):
            report = None
        if (
            report is not None
            and report.get("digest") == digest
            and report.get("audit_version") == AUDIT_VERSION
            and report.get("declared_n_public") == declared_n_public
        ):
            report["source"] = "cache"
            _audit_log[name] = _summary(report)
            return report
    raw, stats = analyze(cs, declared_n_public=declared_n_public, vk=vk)
    findings, waived = _resolve_waivers(cs, raw)
    report = {
        "circuit": name,
        "digest": digest,
        "audit_version": AUDIT_VERSION,
        "declared_n_public": declared_n_public,
        **stats,
        "findings": [asdict(f) for f in findings],
        "unwaived": sum(f.count for f in findings),
        "waived": sum(w["count"] for w in waived),
        "waivers_used": waived,
        "audit_s": round(time.perf_counter() - t0, 3),
        "source": "fresh",
    }
    if use_cache:
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(report, f, indent=1)
            os.replace(tmp, path)
        except OSError:
            pass  # cache is best-effort; the report itself is the product
    _audit_log[name] = _summary(report)
    return report


def _summary(report: Dict) -> Dict:
    return {
        "digest": report["digest"],
        "unwaived": report["unwaived"],
        "waived": report["waived"],
        "audit_s": report["audit_s"],
        "source": report["source"],
    }


def require_clean(report: Dict) -> Dict:
    """The admission gate: raise (naming the findings) unless the audit
    reports zero unwaived findings."""
    if report["unwaived"]:
        lines = "\n  ".join(
            str(CircuitFinding(**f)) for f in report["findings"][:10]
        )
        err = CircuitAuditError(
            f"circuit {report['circuit']!r} REFUSED admission: "
            f"{report['unwaived']} unwaived audit finding(s) "
            f"({len(report['findings'])} families):\n  {lines}"
        )
        err.report = report  # machine consumers (lint --json) keep the evidence
        raise err
    return report
