"""Seeded, deterministic fault injection for the proving service (port of
the reference's ``utils/faults.py``).

Named injection sites sit on the service's paths at request-stage
granularity (``fault_point(site)``); a plan says which of them fail and
how.  The reference arms its plan from an environment variable; the port
reads none, so a plan is armed by ``arm(spec)`` and cleared by
``reset()``:

    faults.arm("prove:raise:p=0.2,emit:enospc:once,witness:hang=3")

Grammar (comma-separated entries), the reference's:

    entry   = "seed=" INT                 global RNG seed (default 0)
            | site ":" action (":" mod)*
    site    = witness | prove | verify | emit | claim | sink
              (any [a-z_]+ token; those above are the ones the service
              calls)
    action  = "raise"                     raise FaultInjected
            | "enospc"                    raise OSError(ENOSPC)
            | "hang=" SECONDS             sleep, then continue
    mod     = "p=" FLOAT                  fire probability (default 1)
            | "once"                      fire at most once  (= n=1)
            | "n=" INT                    fire at most n times
            | "after=" INT                skip the first n eligible hits

Every fault draws from its own ``random.Random`` seeded from (global
seed, site, entry index), so two processes with the same spec and the
same call sequence inject identically.  With no plan armed,
``fault_point`` is one attribute read.  The plan's digest (or "off") is
recorded as the ``faults`` gate's arm, so execution digests tell fault
runs from clean ones.

``FaultInjected`` subclasses RuntimeError: the service's retry logic
names it as transient; everything else treats it as an ordinary crash.
"""

from __future__ import annotations

import errno
import hashlib
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class FaultInjected(RuntimeError):
    """An injected (transient-classified) failure."""


@dataclass
class Fault:
    site: str
    action: str                  # raise | enospc | hang
    arg: float = 0.0             # hang seconds
    p: float = 1.0               # fire probability per eligible hit
    limit: Optional[int] = None  # max fires (None = unlimited; once = 1)
    after: int = 0               # eligible hits to skip before firing
    seed_key: str = ""           # rng derivation key (spec-stable)
    seen: int = 0
    fired: int = 0
    rng: random.Random = field(default_factory=random.Random, repr=False)


class FaultPlan:
    """A parsed spec: per-site fault lists and the spec's digest."""

    def __init__(self, spec: str, faults: List[Fault], seed: int):
        self.spec = spec
        self.seed = seed
        self.digest = hashlib.sha256(spec.encode()).hexdigest()[:8]
        self.by_site: Dict[str, List[Fault]] = {}
        for f in faults:
            f.rng = random.Random(f"{seed}:{f.seed_key}")
            self.by_site.setdefault(f.site, []).append(f)
        # the producer and the consumer thread both fire: the once/n
        # accounting must not double-fire on a race
        self._lock = threading.Lock()

    def fire(self, site: str) -> None:
        flist = self.by_site.get(site)
        if not flist:
            return
        for f in flist:
            with self._lock:
                f.seen += 1
                if f.limit is not None and f.fired >= f.limit:
                    continue
                if f.seen <= f.after:
                    continue
                if f.p < 1.0 and f.rng.random() >= f.p:
                    continue
                f.fired += 1
            if f.action == "hang":
                time.sleep(f.arg)
                continue  # a hang delays the stage, it does not fail it
            if f.action == "enospc":
                raise OSError(errno.ENOSPC, f"injected ENOSPC at {site} [faults:{self.digest}]")
            raise FaultInjected(f"injected fault at {site} [faults:{self.digest}]")


def parse_faults(spec: str) -> FaultPlan:
    """Parse a spec; raises ValueError naming the offending entry."""
    faults: List[Fault] = []
    seed = 0
    for idx, raw in enumerate(x.strip() for x in spec.split(",")):
        if not raw:
            continue
        if raw.startswith("seed="):
            try:
                seed = int(raw[len("seed="):])
            except ValueError:
                raise ValueError(f"faults: bad seed {raw!r}") from None
            continue
        parts = raw.split(":")
        if len(parts) < 2:
            raise ValueError(f"faults: entry {raw!r} needs site:action")
        site, action_s, mods = parts[0], parts[1], parts[2:]
        if not site or not site.replace("_", "").isalpha():
            raise ValueError(f"faults: bad site in {raw!r}")
        arg = 0.0
        if action_s.startswith("hang="):
            action = "hang"
            try:
                arg = float(action_s[len("hang="):])
            except ValueError:
                raise ValueError(f"faults: bad hang seconds in {raw!r}") from None
            if arg < 0:
                raise ValueError(f"faults: negative hang in {raw!r}")
        elif action_s in ("raise", "enospc"):
            action = action_s
        else:
            raise ValueError(f"faults: unknown action {action_s!r} in {raw!r} (have: raise, enospc, hang=SECONDS)")
        f = Fault(site=site, action=action, arg=arg, seed_key=f"{site}:{idx}:{action}")
        for mod in mods:
            if mod == "once":
                f.limit = 1
            elif mod.startswith("p="):
                try:
                    f.p = float(mod[2:])
                except ValueError:
                    raise ValueError(f"faults: bad probability in {raw!r}") from None
                if not 0.0 <= f.p <= 1.0:
                    raise ValueError(f"faults: p out of [0,1] in {raw!r}")
            elif mod.startswith("n="):
                try:
                    f.limit = int(mod[2:])
                except ValueError:
                    raise ValueError(f"faults: bad n= in {raw!r}") from None
                if f.limit < 0:
                    # n=-1 (a typo for n=1) would build a fault that never fires
                    raise ValueError(f"faults: negative n= in {raw!r}")
            elif mod.startswith("after="):
                try:
                    f.after = int(mod[len("after="):])
                except ValueError:
                    raise ValueError(f"faults: bad after= in {raw!r}") from None
                if f.after < 0:
                    raise ValueError(f"faults: negative after= in {raw!r}")
            else:
                raise ValueError(f"faults: unknown modifier {mod!r} in {raw!r} (have: p=FLOAT, once, n=INT, after=INT)")
        faults.append(f)
    return FaultPlan(spec, faults, seed)


# The armed plan.  Its once/n counters live on it, so they persist until
# the next arm() or reset().
_plan: Optional[FaultPlan] = None
_lock = threading.Lock()


def arm(spec: str) -> Optional[FaultPlan]:
    """Parse `spec` and make it the armed plan ("" clears it); records
    the ``faults`` gate's arm.  A malformed spec raises ValueError and
    leaves the armed plan as it was."""
    global _plan
    from .audit import record_arm

    plan = parse_faults(spec) if spec else None
    with _lock:
        _plan = plan
    record_arm("faults", "off" if plan is None else plan.digest)
    return plan


def fault_point(site: str) -> None:
    """Injection site: a no-op unless the armed plan names `site`.
    Raises FaultInjected / OSError(ENOSPC) or sleeps as the plan says."""
    plan = _plan
    if plan is not None:
        plan.fire(site)


def faults_arm() -> str:
    """Record the ``faults`` gate's arm without firing anything; returns
    it ("off" or the plan's digest)."""
    from .audit import record_arm

    plan = _plan
    return record_arm("faults", "off" if plan is None else plan.digest)


def reset() -> None:
    """Clear the armed plan."""
    global _plan
    with _lock:
        _plan = None
