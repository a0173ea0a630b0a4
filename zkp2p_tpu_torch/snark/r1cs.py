"""R1CS constraint-system builder — the framework's circuit frontend.

This replaces the circom language layer of the reference (circuit/*.circom,
zk-email-verify-circuits/*.circom).  Where the reference writes

    template P2POnrampVerify(...) { signal input ...; component ... }

our circuits are built programmatically: gadgets (zkp2p_tpu_torch.gadgets) allocate
wires, emit rank-1 constraints  <A,w> * <B,w> = <C,w>, and register witness
computation hooks.  Witness generation therefore lives *with* the circuit
definition (as circom's generated WASM/C++ witness calculators do for the
reference, dizkus-scripts/2_gen_wtns.sh).  Measured at the full-size
flagship circuit (4.9M wires) the hook program runs in ~14 s on one core
— vs the reference's 60 s compiled witness generator on 48 cores
(docs/SCALE.md) — because hook values are small ints and the loop is
allocation-free.

Wire layout follows the Groth16/snarkjs convention: wire 0 is the constant
``1``, wires 1..n_pub are public, the rest private.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

from ..field.bn254 import R


Coeffs = Dict[int, int]  # wire index -> Fr coefficient


class Witness(list):
    """A witness vector (Fr ints) that also carries ``u64``: the prover's
    standard-form (n, 4) little-endian u64 serialization, emitted at build
    time so the per-prove ``witness_convert`` stage collapses to an array
    hand-off (docs/NEXT.md lever 3, gated by ``ZKP2P_WITNESS_U64``)."""

    u64 = None


_WITNESS_ROW_CLS = None


def _witness_row_cls():
    """Object-dtype ndarray subclass used for batch witness rows, lazy so
    the frontend keeps importing without numpy."""
    global _WITNESS_ROW_CLS
    if _WITNESS_ROW_CLS is None:
        import numpy as np

        class WitnessRow(np.ndarray):
            """Batch witness column carrying the build-time ``u64``
            standard-form serialization (see :class:`Witness`)."""

            u64 = None

            def __array_finalize__(self, obj):
                u = getattr(obj, "u64", None)
                # Propagate only through same-shape views; a slice or
                # reduction must not inherit a stale serialization.
                self.u64 = (
                    u
                    if u is not None and getattr(obj, "shape", None) == self.shape
                    else None
                )

        _WITNESS_ROW_CLS = WitnessRow
    return _WITNESS_ROW_CLS


def _std_u64(vals, out=None):
    """Serialize reduced Fr values to the prover's standard form: (n, 4)
    uint64 little-endian limb rows.  Bulk numpy assign covers the sub-2^64
    common case (>99% of wires at the bench shape); a chunk that overflows
    falls back to exact 32-byte serialization — mirroring
    ``native_prove._witness_std_u64`` so builder-emitted and prove-time
    serializations are byte-identical."""
    import numpy as np

    n = len(vals)
    arr = np.zeros((n, 4), dtype=np.uint64) if out is None else out
    col = arr[:, 0]
    CH = 8192
    for lo in range(0, n, CH):
        hi = min(n, lo + CH)
        try:
            col[lo:hi] = vals[lo:hi]
        except (OverflowError, TypeError, ValueError):
            arr[lo:hi] = np.frombuffer(
                b"".join((int(v) % R).to_bytes(32, "little") for v in vals[lo:hi]),
                dtype="<u8",
            ).reshape(hi - lo, 4)
    return arr


class LC:
    """Linear combination of wires over Fr."""

    __slots__ = ("terms",)

    def __init__(self, terms: Optional[Coeffs] = None):
        self.terms: Coeffs = dict(terms) if terms else {}

    @classmethod
    def const(cls, c: int) -> "LC":
        c %= R
        return cls({0: c} if c else {})

    @classmethod
    def of(cls, wire: int, coeff: int = 1) -> "LC":
        coeff %= R
        return cls({wire: coeff} if coeff else {})

    def __add__(self, other: "LCLike") -> "LC":
        other = as_lc(other)
        out = dict(self.terms)
        for w, c in other.terms.items():
            nc = (out.get(w, 0) + c) % R
            if nc:
                out[w] = nc
            else:
                out.pop(w, None)
        return LC(out)

    def __sub__(self, other: "LCLike") -> "LC":
        return self + (as_lc(other) * (R - 1))

    def __mul__(self, scalar: int) -> "LC":
        scalar %= R
        if scalar == 0:
            return LC()
        return LC({w: (c * scalar) % R for w, c in self.terms.items()})

    __rmul__ = __mul__

    def __neg__(self) -> "LC":
        return self * (R - 1)

    def eval(self, assignment: Sequence[int]) -> int:
        return sum(c * assignment[w] for w, c in self.terms.items()) % R

    def is_const(self) -> bool:
        return all(w == 0 for w in self.terms)

    def __repr__(self):
        return f"LC({self.terms})"


LCLike = Union["LC", int]


def as_lc(x: LCLike) -> LC:
    if isinstance(x, LC):
        return x
    return LC.const(x)


@dataclass
class Constraint:
    a: Coeffs
    b: Coeffs
    c: Coeffs
    tag: str = ""


@dataclass
class ComputeHook:
    """Witness computation step: outs <- fn(*wire values of ins)."""

    outs: List[int]
    fn: Callable[..., Union[int, Sequence[int]]]
    ins: List[int]


@dataclass
class BlockHook:
    """Coarse witness step: a whole gadget block's wires from one numpy
    program.  vfn maps an (n_ins, K) int64 matrix to an (n_outs, K)
    integer matrix — vectorized over the batch axis K AND whatever
    internal structure the block has (time steps, rounds, lanes), which
    is what `witness_batch` needs to amortize numpy dispatch (per-hook
    object columns pay ~µs per op; a block pays it once per thousands of
    wires).  The scalar `witness` path runs the same vfn with K=1, so
    there is exactly ONE witness implementation per block — no
    scalar/vector drift.

    Contract (int64=True, the default): every input and output value fits
    int64 (bits, bytes, u32 words, bounded sums — the SHA/DFA/packing
    domains).  A violating value raises OverflowError at the numpy
    boundary, loudly.  int64=False hands vfn the raw OBJECT matrix
    (Python ints — exact field arithmetic; for blocks like one-hot lane
    inverses that need full-width values)."""

    outs: List[int]
    vfn: Callable
    ins: List[int]
    int64: bool = True


class ConstraintSystem:
    """Mutable R1CS under construction + witness program."""

    def __init__(self, name: str = "circuit"):
        self.name = name
        self.num_wires = 1  # wire 0 == 1
        self.num_public = 0  # not counting wire 0
        self.constraints: List[Constraint] = []
        self.hooks: List[ComputeHook] = []
        self._public_frozen = False
        self.labels: Dict[int, str] = {0: "one"}
        # Static value-width bounds (bits), PROVEN by constraints for any
        # satisfying witness (booleanity, num2bits recomposition, ...).
        # The prover's width-classed MSM drops the provably-zero scalar
        # digit planes of narrow wires — ~90% of venmo wires are bits
        # (SHA/DFA), so this is the structured-scalar analog of
        # rapidsnark's bit-concentrated-digit fast path.  Absent = 254.
        self.wire_width: Dict[int, int] = {0: 1}
        # Demand-side width metadata (snark.analysis bool/width rule):
        # gadgets whose soundness ASSUMES an input bound — comparators,
        # boolean gates, packers — record (wire, bits, site) here and the
        # static auditor checks every demand against a constraint-backed
        # wire_width bound.  An unbounded comparator input is the classic
        # circom forgery (e.g. LessThan on an unconstrained signal).
        self.width_demands: List[tuple] = []
        # Prover-seeded input wires (witness() private_inputs keys),
        # declared by the circuit builder via mark_input: the soundness
        # analysis treats them — with wire 0 and the publics — as the
        # "given" wires every other wire must be determined from.
        self.input_wires: set = set()
        # Audit waivers: (rule, label-glob) -> written soundness argument.
        # Declared INLINE at the gadget/model site that creates the waived
        # structure (the PR-13 discipline: every exception greppable,
        # justified where it lives).  An empty argument raises.
        self.audit_waivers: Dict[tuple, str] = {}

    # ---------------------------------------------------------- allocation

    def new_public(self, label: str = "") -> int:
        if self._public_frozen:
            raise RuntimeError("public inputs must be allocated before private wires")
        idx = self.num_wires
        self.num_wires += 1
        self.num_public += 1
        if label:
            self.labels[idx] = label
        return idx

    def new_wire(self, label: str = "") -> int:
        self._public_frozen = True
        idx = self.num_wires
        self.num_wires += 1
        if label:
            self.labels[idx] = label
        return idx

    def new_wires(self, n: int, label: str = "") -> List[int]:
        return [self.new_wire(f"{label}[{i}]" if label else "") for i in range(n)]

    # ---------------------------------------------------------- constraints

    def enforce(self, a: LCLike, b: LCLike, c: LCLike, tag: str = "") -> None:
        """<a,w> * <b,w> = <c,w>."""
        self.constraints.append(
            Constraint(as_lc(a).terms, as_lc(b).terms, as_lc(c).terms, tag)
        )

    def enforce_eq(self, a: LCLike, b: LCLike, tag: str = "") -> None:
        """<a,w> = <b,w>  encoded as  (a-b) * 1 = 0."""
        self.enforce(as_lc(a) - as_lc(b), LC.const(1), LC(), tag)

    def enforce_zero(self, a: LCLike, tag: str = "") -> None:
        self.enforce(as_lc(a), LC.const(1), LC(), tag)

    def enforce_bool(self, w: int, tag: str = "") -> None:
        """w * (w - 1) = 0."""
        self.enforce(LC.of(w), LC.of(w) - 1, LC(), tag or "bool")
        self.set_width(w, 1)

    def set_width(self, w: int, bits: int) -> None:
        """Record a constraint-backed value-width bound for wire `w`.

        ONLY call where a constraint actually enforces value < 2^bits for
        every satisfying witness — the width-classed MSM silently drops
        the digit planes above the bound (a wrong tag would emit a proof
        that fails verification, never a wrong-but-verifying one, since
        pi stays on the curve but differs from the honest proof)."""
        cur = self.wire_width.get(w, 254)
        if bits < cur:
            self.wire_width[w] = bits

    def require_width(self, w: int, bits: int, site: str) -> None:
        """Record that a gadget's soundness ASSUMES wire `w` < 2^bits
        (bits=1: boolean).  Checked statically by snark.analysis: every
        demand must be dominated by a constraint-backed set_width /
        enforce_bool / num2bits bound, or the audit reports bool-width."""
        self.width_demands.append((w, bits, site))

    def mark_input(self, wires) -> None:
        """Declare prover-seeded input wires (the witness()
        private_inputs keys).  The soundness auditor propagates
        determinism from wire 0 + publics + these; the hook-coverage
        rule exempts them from needing a ComputeHook."""
        if isinstance(wires, int):
            wires = [wires]
        self.input_wires.update(wires)

    def waive(self, rule: str, label_glob: str, why: str) -> None:
        """Waive an audit rule for wires whose label matches `label_glob`
        (constraint rules match the tag instead).  `why` is a REQUIRED
        written soundness argument — it lands verbatim in the audit
        report, and an empty one is refused loudly."""
        if not why or not why.strip():
            raise ValueError(
                f"audit waiver for ({rule}, {label_glob}) needs a written "
                "soundness argument — an unjustified waiver is a review failure"
            )
        self.audit_waivers[(rule, label_glob)] = why

    # ---------------------------------------------------------- witness gen

    def compute(self, outs, fn, ins) -> None:
        """Register a witness hook.  fn receives int values of `ins` and
        returns the value(s) for `outs` (single int or sequence)."""
        outs = [outs] if isinstance(outs, int) else list(outs)
        ins = [ins] if isinstance(ins, int) else list(ins)
        self.hooks.append(ComputeHook(outs, fn, ins))

    def compute_block(self, outs, vfn, ins, int64: bool = True) -> None:
        """Register a BlockHook: all of `outs` from one numpy program
        over `ins` (see BlockHook for the vfn contract)."""
        self.hooks.append(BlockHook(list(outs), vfn, list(ins), int64))

    def wire_desc(self, i: int) -> str:
        """Human description of a wire: index, label, and allocation site
        (the gadget family = the auditor's label class, so witness-time
        errors and static audit findings name wires the same way)."""
        label = self.labels.get(i)
        if not label:
            return f"wire {i} (unlabelled)"
        from .analysis import label_class

        cls = label_class(label)
        site = f", allocated by '{cls}'" if cls != label else ""
        return f"wire {i} ('{label}'{site})"

    def witness(self, public_inputs: Sequence[int], private_inputs: Dict[int, int] | None = None) -> List[int]:
        """Run the witness program.  `public_inputs` fills wires 1..n_pub;
        `private_inputs` optionally pre-seeds private wires (for inputs that
        are not computed from anything, e.g. the email bytes)."""
        if len(public_inputs) != self.num_public:
            raise ValueError(
                f"expected {self.num_public} public inputs, got {len(public_inputs)}"
            )
        w: List[Optional[int]] = [None] * self.num_wires
        w[0] = 1
        for i, v in enumerate(public_inputs):
            w[1 + i] = v % R
        if private_inputs:
            for idx, v in private_inputs.items():
                w[idx] = v % R
        for hook in self.hooks:
            if isinstance(hook, BlockHook):
                import numpy as np

                mat = np.empty(
                    (len(hook.ins), 1), dtype=np.int64 if hook.int64 else object
                )
                for j, i in enumerate(hook.ins):
                    if w[i] is None:
                        raise RuntimeError(
                            f"witness block reads unassigned {self.wire_desc(i)}"
                        )
                    mat[j, 0] = w[i]
                res = np.asarray(hook.vfn(mat))
                if res.shape[0] != len(hook.outs):
                    raise RuntimeError(
                        f"block produced {res.shape[0]} rows for {len(hook.outs)} outs"
                    )
                for o, v in zip(hook.outs, res[:, 0]):
                    w[o] = int(v) % R
                continue
            args = []
            for i in hook.ins:
                if w[i] is None:
                    raise RuntimeError(
                        f"witness hook reads unassigned {self.wire_desc(i)}"
                    )
                args.append(w[i])
            vals = hook.fn(*args)
            if isinstance(vals, int):
                vals = [vals]
            if len(vals) != len(hook.outs):
                raise RuntimeError(
                    f"hook produced {len(vals)} values for {len(hook.outs)} outs"
                )
            for o, v in zip(hook.outs, vals):
                w[o] = v % R
        missing = [i for i, v in enumerate(w) if v is None]
        if missing:
            raise RuntimeError(
                f"{len(missing)} unassigned wires (no hook or input seed "
                "assigns them; `zkp2p-tpu lint --circuits` reports this "
                "statically as hook-coverage), first: "
                + "; ".join(self.wire_desc(i) for i in missing[:5])
            )
        out = Witness(w)
        out.u64 = _std_u64(out)
        return out

    def witness_batch(
        self, inputs: Sequence[tuple], stats: Optional[Dict[str, int]] = None
    ) -> List[Sequence[int]]:
        """Vectorized witness generation: run the hook program ONCE over K
        independent inputs ([(public_inputs, private_inputs), ...]).

        Each wire holds a K-element numpy OBJECT column (Python ints inside
        a C loop), so every elementwise hook — xor/and/sum/product chains,
        the whole SHA-256 / DFA-scan / packing tier — evaluates with exact
        bigint semantics at C dispatch cost, amortising the interpreter's
        per-hook overhead across the batch.  Hooks whose lambdas are not
        array-safe (data-dependent branches: modular inverses, equality
        selects) are detected by the throw and replayed per-element — the
        scalar `witness` path stays the oracle, and the two are bit-exact
        by construction (differentially tested in tests/test_witness_batch).

        This is the batch tier of SURVEY §2.2's witness generator (the
        reference compiles witness gen to C++/WASM, dizkus-scripts/
        1_compile.sh; our batch=K service shape needs K witnesses per
        prove round).  `stats`, when given, receives vectorized/fallback
        hook counts."""
        import numpy as np

        K = len(inputs)
        if K == 0:
            return []

        # Two parallel (n_wires, K) matrices back the wires: W64 (int64)
        # holds everything int64-typed blocks produce and consume — the
        # common case, zero conversions between blocks — and W (object,
        # exact Python ints) holds field-width values from object blocks
        # and per-wire hooks.  Rows migrate lazily in either direction
        # (has64/hasobj), the final extraction is one merged
        # transpose+tolist.  (A single object matrix spent ~30% of the
        # batch wall time converting at every int64-block boundary.)
        W = np.empty((self.num_wires, K), dtype=object)
        W64 = np.empty((self.num_wires, K), dtype=np.int64)
        assigned = np.zeros(self.num_wires, dtype=bool)
        hasobj = np.zeros(self.num_wires, dtype=bool)
        has64 = np.zeros(self.num_wires, dtype=bool)

        def to64(idx: np.ndarray) -> None:
            """Materialize int64 rows for `idx` (loud OverflowError if a
            value exceeds the BlockHook int64 contract)."""
            need = idx[~has64[idx]]
            if need.shape[0]:
                W64[need] = W[need].astype(np.int64)
                has64[need] = True

        def toobj(idx: np.ndarray) -> None:
            need = idx[~hasobj[idx]]
            if need.shape[0]:
                W[need] = W64[need].astype(object)
                hasobj[need] = True

        W[0] = 1
        assigned[0] = hasobj[0] = True
        for k, (pubs, _) in enumerate(inputs):
            if len(pubs) != self.num_public:
                raise ValueError(
                    f"input {k}: expected {self.num_public} public inputs, got {len(pubs)}"
                )
        for i in range(self.num_public):
            W[1 + i] = [inputs[k][0][i] % R for k in range(K)]
            assigned[1 + i] = hasobj[1 + i] = True
        seeded = set()
        for _, priv in inputs:
            seeded.update((priv or {}).keys())
        for idx in seeded:
            vals = []
            for k, (_, priv) in enumerate(inputs):
                if priv is None or idx not in priv:
                    raise ValueError(
                        f"wire {idx} ({self.labels.get(idx)}) seeded in some batch "
                        f"inputs but not input {k} — batch inputs must share a seed shape"
                    )
                vals.append(priv[idx] % R)
            W[idx] = vals
            assigned[idx] = hasobj[idx] = True

        def check_assigned(ins_idx, kind):
            if not assigned[ins_idx].all():
                bad = int(ins_idx[~assigned[ins_idx]][0])
                raise RuntimeError(
                    f"witness {kind} reads unassigned {self.wire_desc(bad)}"
                )

        # The hook program is static per circuit: index arrays are cached
        # on the hooks, and the assigned-order checks run only until one
        # full pass has validated the program (then every later batch
        # skips them — they were ~10% of the loop's time).
        validated = getattr(self, "_hooks_validated", False)
        n_vec = n_fb = n_block = 0
        for hook in self.hooks:
            if isinstance(hook, BlockHook):
                ins_idx = getattr(hook, "_ins_idx", None)
                if ins_idx is None:
                    ins_idx = hook._ins_idx = np.asarray(hook.ins, dtype=np.intp)
                    hook._outs_idx = np.asarray(hook.outs, dtype=np.intp)
                if not validated:
                    check_assigned(ins_idx, "block")
                if hook.int64:
                    to64(ins_idx)
                    mat = W64[ins_idx]
                else:
                    toobj(ins_idx)
                    mat = W[ins_idx]
                res = hook.vfn(mat)
                if not validated and res.shape != (len(hook.outs), K):
                    raise RuntimeError(
                        f"block produced shape {res.shape}, expected {(len(hook.outs), K)}"
                    )
                outs_idx = hook._outs_idx
                if res.dtype == object:
                    W[outs_idx] = res
                    hasobj[outs_idx] = True
                    has64[outs_idx] = False
                else:
                    W64[outs_idx] = res
                    has64[outs_idx] = True
                    hasobj[outs_idx] = False
                assigned[outs_idx] = True
                n_block += 1
                continue
            ins_idx = getattr(hook, "_ins_idx", None)
            if ins_idx is None:
                ins_idx = hook._ins_idx = np.asarray(hook.ins, dtype=np.intp)
            if not validated:
                check_assigned(ins_idx, "hook")
            toobj(ins_idx)
            args = [W[i] for i in hook.ins]
            try:
                vals = hook.fn(*args)
                if isinstance(vals, np.ndarray) or not isinstance(vals, (list, tuple)):
                    vals = [vals]
                if len(vals) != len(hook.outs):
                    raise RuntimeError("arity")
                for o, v in zip(hook.outs, vals):
                    if isinstance(v, np.ndarray) and v.shape == (K,):
                        W[o] = v % R
                    elif isinstance(v, int):  # batch-constant hook
                        W[o] = v % R
                    else:
                        raise TypeError("non-columnar hook result")
                    assigned[o] = hasobj[o] = True
                    has64[o] = False
                n_vec += 1
            except Exception:
                # Array-unsafe lambda: replay per element (exact scalar
                # semantics; mirrors witness()'s inner loop).
                for k in range(K):
                    a = [int(c[k]) for c in args]
                    vs = hook.fn(*a)
                    if isinstance(vs, int):
                        vs = [vs]
                    if len(vs) != len(hook.outs):
                        raise RuntimeError(
                            f"hook produced {len(vs)} values for {len(hook.outs)} outs"
                        )
                    for o, v in zip(hook.outs, vs):
                        W[o, k] = v % R
                for o in hook.outs:
                    assigned[o] = hasobj[o] = True
                    has64[o] = False
                n_fb += 1

        if not assigned.all():
            missing = np.flatnonzero(~assigned)
            raise RuntimeError(
                f"{len(missing)} unassigned wires (no hook or input seed "
                "assigns them; `zkp2p-tpu lint --circuits` reports this "
                "statically as hook-coverage), first: "
                + "; ".join(self.wire_desc(int(i)) for i in missing[:5])
            )
        if stats is not None:
            stats["vectorized_hooks"] = n_vec
            stats["fallback_hooks"] = n_fb
            stats["block_hooks"] = n_block
        toobj(np.flatnonzero(~hasobj))  # one merged materialization
        self._hooks_validated = True
        # Standard-form u64 serialization at the builder (docs/NEXT.md
        # lever 3), vectorized while the wires are still row-major per
        # wire: int64-backed rows are canonical and non-negative in the
        # common case and bulk-cast; object rows bulk-cast per chunk with
        # the same exact fallback as _std_u64.
        U = np.zeros((self.num_wires, K, 4), dtype=np.uint64)
        i64 = np.flatnonzero(has64)
        slow_rows = np.flatnonzero(~has64)
        if i64.size:
            neg = (W64[i64] < 0).any(axis=1)
            ok = i64[~neg]
            U[ok, :, 0] = W64[ok].astype(np.uint64)
            if neg.any():
                slow_rows = np.concatenate([slow_rows, i64[neg]])
        CH = 8192
        for lo in range(0, slow_rows.size, CH):
            idx = slow_rows[lo : lo + CH]
            try:
                U[idx, :, 0] = W[idx].astype(np.uint64)
            except (OverflowError, TypeError, ValueError):
                for i in idx:
                    try:
                        U[i, :, 0] = W[i].astype(np.uint64)
                    except (OverflowError, TypeError, ValueError):
                        U[i] = np.frombuffer(
                            b"".join(
                                (int(v) % R).to_bytes(32, "little") for v in W[i]
                            ),
                            dtype="<u8",
                        ).reshape(K, 4)
        # One contiguous transpose copy (per-row strided gathers cost ~4x
        # more), then row views: W/W64 and the flag arrays are released;
        # what stays referenced is exactly the K witness vectors.  (A
        # caller keeping ONE witness long-term keeps its K-batch block —
        # copy the row if that matters.)
        Wt = np.ascontiguousarray(W.T)
        row_cls = _witness_row_cls()
        out: List[Sequence[int]] = []
        for k in range(K):
            row = Wt[k].view(row_cls)
            row.u64 = np.ascontiguousarray(U[:, k])
            out.append(row)
        return out

    # ---------------------------------------------------------- checking

    def check_witness(self, w: Sequence[int]) -> None:
        """Assert every constraint is satisfied (the Az*Bz=Cz self-check —
        the ZK analog of the reference's `circom --inspect` lint, see
        SURVEY.md §5 race-detection), plus every wire_width tag (a wrong
        width tag would make the classed MSM drop nonzero digit planes —
        failing only at pairing verification; this localises it).

        The products and row sums run over numpy object arrays of the
        matrices (``_check_matrices``, built once a system), exact Python
        ints at C loop speed; the first unsatisfied row is reported as the
        row-at-a-time loop reports it."""
        import numpy as np

        n = len(self.constraints)
        wv = np.asarray(w, dtype=object)
        sums = []
        for rows, wires, coeffs, starts in self._check_matrices():
            s = np.zeros(n, dtype=object)
            if len(rows):
                s[rows[starts]] = np.add.reduceat(coeffs * wv[wires], starts)
            sums.append(s % R)
        bad = np.flatnonzero((sums[0] * sums[1] % R != sums[2]).astype(bool))
        if bad.size:
            idx = int(bad[0])
            con = self.constraints[idx]
            a = sum(c * w[i] for i, c in con.a.items()) % R
            b = sum(c * w[i] for i, c in con.b.items()) % R
            c_ = sum(c * w[i] for i, c in con.c.items()) % R
            raise AssertionError(
                f"constraint {idx} ({con.tag}) unsatisfied: {a}*{b} != {c_}"
            )
        self.check_widths(w)

    def _check_matrices(self):
        """(rows, wires, coefficients as Python ints, each row's first
        entry) of A, B and C in row order, for check_witness; built once
        and again when constraints were added since."""
        import itertools

        import numpy as np

        cached = getattr(self, "_check_coo", None)
        if cached is not None and cached[0] == len(self.constraints):
            return cached[1]
        mats = []
        for side in ("a", "b", "c"):
            ds = [getattr(con, side) for con in self.constraints]
            lens = np.fromiter(map(len, ds), dtype=np.int64, count=len(ds))
            nnz = int(lens.sum())
            rows = np.repeat(np.arange(len(ds), dtype=np.int64), lens)
            wires = np.fromiter(itertools.chain.from_iterable(ds), dtype=np.int64, count=nnz)
            coeffs = np.empty(nnz, dtype=object)
            coeffs[:] = list(itertools.chain.from_iterable(d.values() for d in ds))
            starts = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]]) if nnz else np.zeros(0, np.int64)
            mats.append((rows, wires, coeffs, starts))
        self._check_coo = (len(self.constraints), mats)
        return mats

    def check_widths(self, w: Sequence[int]) -> None:
        """Assert every constraint-backed width bound actually holds for
        this witness (prover.groth16_tpu width classing relies on it).
        Values reduce mod R first, matching the constraint loop — an
        unreduced-but-equivalent witness must not be rejected."""
        for i, bits in self.wire_width.items():
            v = w[i] % R
            if v >= (1 << bits):
                raise AssertionError(
                    f"wire {i} ({self.labels.get(i, '?')}): value {v} exceeds "
                    f"its tagged width bound of {bits} bits"
                )

    # ---------------------------------------------------------- stats

    @property
    def num_constraints(self) -> int:
        return len(self.constraints)

    def stats(self) -> Dict[str, int]:
        """Constraint-count profile — mirror of `snarkjs r1cs info`
        (circuit/scripts/circuit_stats.sh:2)."""
        by_tag: Dict[str, int] = {}
        for c in self.constraints:
            key = c.tag.split("/")[0] if c.tag else "untagged"
            by_tag[key] = by_tag.get(key, 0) + 1
        return {
            "wires": self.num_wires,
            "public": self.num_public,
            "constraints": self.num_constraints,
            **{f"tag:{k}": v for k, v in sorted(by_tag.items())},
        }
