"""Circuit registry: named builders + declared public layouts, with the
static soundness audit (snark.analysis) as the ADMISSION PRECONDITION.

A service that serves many circuits needs every circuit to pass an
automated soundness gate before it is served — a hand review per
minted regex circuit does not scale.  `audited()` is that gate: build -> audit (cached by structural
digest under .bench_cache) -> REFUSE on any unwaived finding.  The CLI
`setup` path and `zkp2p-tpu lint --circuits` / `make circuit-audit`
both route through here, and each in-process audit lands in
run_manifest (utils.metrics) beside the knob/gate arms.

Each spec declares its on-chain public-signal count (`n_public`) — the
audit's public-layout rule closes the docs/EVM_PARITY.md loop per
circuit: the venmo layout is the contract's uint[26]
(`Verifier.sol:360` / `Ramp.sol:253-293`), and a circuit whose built
n_public drifts from its declaration is refused before any key is cut.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..snark.analysis import audit_circuit, require_clean


@dataclass(frozen=True)
class CircuitSpec:
    name: str
    build: Callable[[], object]  # -> ConstraintSystem, inputs marked
    n_public: int  # declared on-chain signal layout (public-layout rule)
    description: str
    flagship: bool = False  # multi-minute build: slow tier only


def _build_venmo_mini():
    from .venmo import VenmoParams, build_venmo_circuit

    cs, _ = build_venmo_circuit(VenmoParams(max_header_bytes=256, max_body_bytes=192))
    return cs


def _build_venmo_full():
    from .venmo import VenmoParams, build_venmo_circuit

    cs, _ = build_venmo_circuit(VenmoParams())  # 1024/6400: the 4.9M flagship
    return cs


def _build_email_mini():
    from .email_verify import EmailVerifyParams, build_email_verify

    cs, _ = build_email_verify(
        EmailVerifyParams(max_header_bytes=256, max_body_bytes=128)
    )
    return cs


def _build_amount_demo():
    from .amount_demo import amount_circuit

    cs, _, _ = amount_circuit()
    return cs


def _build_dryrun_vid():
    from .amount_demo import dryrun_circuit

    cs, _, _ = dryrun_circuit()
    return cs


def build_sha2b() -> Tuple[object, List[int]]:
    """Two-block fixed SHA-256 over 128 padded private bytes — the
    tools/sharded_scale.py shape (the flagship's dominant gadget family
    at a 2^16 domain).  Returns (cs, digest bit wires); no publics (the
    scale harness compares the witness digest against hashlib)."""
    from ..gadgets import core, sha256
    from ..snark.r1cs import ConstraintSystem

    cs = ConstraintSystem("sharded-scale-sha2b")
    msg = cs.new_wires(128, "msg")
    cs.mark_input(msg)
    bits = core.assert_bytes(cs, msg, "msg")
    out = sha256.sha256_blocks(cs, bits, None)
    return cs, out


def _build_regex_actor():
    """Minted from regexc (the reference's regex_to_circom L0 layer):
    see regexc.compiler.reveal_circuit."""
    from ..regexc.compiler import VENMO_ACTOR_ID, reveal_circuit

    cs, _ = reveal_circuit(
        VENMO_ACTOR_ID, n_bytes=48, reveal_len=14, name="regex_actor"
    )
    return cs


SPECS: Dict[str, CircuitSpec] = {
    s.name: s
    for s in (
        CircuitSpec(
            "venmo", _build_venmo_mini, 26,
            "P2POnrampVerify at the CI shape (256/192 header/body)",
        ),
        CircuitSpec(
            "venmo-full", _build_venmo_full, 26,
            "the 4.94M-constraint production flagship (1024/6400)",
            flagship=True,
        ),
        CircuitSpec(
            "email_verify", _build_email_mini, 20,
            "generic DKIM EmailVerify at the CI shape (256/128)",
        ),
        CircuitSpec(
            "amount_demo", _build_amount_demo, 3,
            "Venmo amount block over a 32-byte subject slice",
        ),
        CircuitSpec(
            "dryrun_vid", _build_dryrun_vid, 1,
            "venmo-id packing + Poseidon (the multichip dryrun shape)",
        ),
        CircuitSpec(
            "sha2b", lambda: build_sha2b()[0], 0,
            "two-block SHA-256, the tools/sharded_scale.py scale shape",
        ),
        CircuitSpec(
            "regex_actor", _build_regex_actor, 2,
            "regexc-minted actor_id reveal circuit (the L0 minting path)",
        ),
    )
}


def circuit_ids(include_flagship: bool = False) -> List[str]:
    return [
        n for n, s in SPECS.items() if include_flagship or not s.flagship
    ]


def build(name: str):
    spec = SPECS.get(name)
    if spec is None:
        raise KeyError(
            f"unknown circuit {name!r}; registered: {', '.join(sorted(SPECS))}"
        )
    return spec.build()


def audited(name: str, use_cache: bool = True, cache_dir: Optional[str] = None):
    """The admission gate: build the named circuit, audit it (report
    cached by circuit digest), and REFUSE — CircuitAuditError — on any
    unwaived soundness finding.  Returns (cs, report)."""
    spec = SPECS.get(name)
    if spec is None:
        raise KeyError(
            f"unknown circuit {name!r}; registered: {', '.join(sorted(SPECS))}"
        )
    cs = spec.build()
    report = audit_circuit(
        cs,
        name=name,
        declared_n_public=spec.n_public,
        use_cache=use_cache,
        cache_dir=cache_dir,
    )
    require_clean(report)
    return cs, report
