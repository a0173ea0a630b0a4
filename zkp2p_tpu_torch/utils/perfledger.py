"""The perf-regression sentry: a stage-cost ledger keyed to the card
(port of the reference's ``utils/perfledger.py``).

  - an append-only JSON-lines ledger, ``<cache_dir>/perf_ledger_<key>.jsonl``
    (the key is ``hostprof.fingerprint_key``: the card and the host's
    CPU), of per-(circuit, stage, execution digest) p50 / p95 span costs;
    the service stamps one line a run;
  - per-stage budgets derived from it (the trailing window's upper median
    × tolerance), which the service checks every terminal request's spans
    against (``zkp2p_stage_budget_overruns_total``);
  - a baseline band frozen from the ledger (``write_baseline``) and the
    drift gate that replays the ledger's head against it (``gate_check``:
    rc 0 ok, 1 drift, 2 fail closed).

Every line carries the fingerprint key and a digest of its own body.  At
read time a line of another card or host (foreign) and a line whose body
was edited after it was signed (tampered) are refused and counted, never
blended into budgets, as are torn lines and lines of another schema.

The reference reads its settings from its environment; here they are
keywords whose defaults are the reference's (ledger on, window 8,
tolerance 1.5) and the cache directory is a keyword too (default
``<repo>/.bench_cache``; None turns persistence off).  The reference's
``backfill_bench`` (its committed TPU and CPU bench history, which must
not enter a ledger keyed to the card) and ``tune_stages`` (the native
tier's tune) are not ported.  The default baseline is
``PERF_BASELINE_GPU.json``, never the reference's ``PERF_BASELINE.json``.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import hostprof

SCHEMA_VERSION = 1
LEDGER_PREFIX = "perf_ledger_"
BASELINE_NAME = "PERF_BASELINE_GPU.json"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# where the ledger and the flame captures live unless a caller names another
# directory (the circuit audit's cache, snark/analysis.py)
DEFAULT_CACHE_DIR = os.path.join(_REPO, ".bench_cache")
# the reference's configuration defaults
DEFAULT_WINDOW = 8
DEFAULT_TOLERANCE = 1.5

_lock = threading.Lock()
# (path, mtime_ns, window, tolerance) -> budgets: the service checks every
# terminal request, and must not re-read and re-sort the ledger for each
_budget_memo: Optional[Tuple[Tuple, Dict]] = None


def ledger_path(cache_dir: Optional[str] = DEFAULT_CACHE_DIR, device=None) -> Optional[str]:
    """``<cache_dir>/perf_ledger_<key of device>.jsonl``; None when
    `cache_dir` is None (persistence off)."""
    if cache_dir is None:
        return None
    return os.path.join(cache_dir, LEDGER_PREFIX + hostprof.fingerprint_key(device=device) + ".jsonl")


def default_baseline_path() -> str:
    """``<repo>/PERF_BASELINE_GPU.json``: the band ``perf --gate`` replays
    the ledger's head against."""
    return os.path.join(_REPO, BASELINE_NAME)


def _entry_digest(body: Dict) -> str:
    """16 hex characters of SHA-256 over the entry's body (its
    entry_digest left out): a body edited after signing fails it."""
    blob = json.dumps({k: v for k, v in body.items() if k != "entry_digest"}, sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def stage_stats(ms_values: List[float]) -> Optional[Dict]:
    """Nearest-rank p50 / p95 over a sample of span costs (the convention
    of tools/trace_report.py, so that ledger lines and its tables agree)."""
    vals = sorted(float(v) for v in ms_values if v is not None)
    if not vals:
        return None

    def pct(p: float) -> float:
        i = max(0, min(len(vals) - 1, int(round(p / 100.0 * len(vals) + 0.5)) - 1))
        return vals[i]

    return {"p50_ms": round(pct(50), 3), "p95_ms": round(pct(95), 3), "n": len(vals)}


def make_entry(source: str, circuit: str, stages: Dict[str, Dict], run_id: Optional[str] = None,
               execution_digest: Optional[str] = None, device=None) -> Dict:
    """One signed ledger line of `device`'s key: source (service, bench,
    ...), stages = {name: {p50_ms, p95_ms, n}}; the execution digest is
    this process's unless given."""
    if execution_digest is None:
        from .audit import execution_digest as _xd

        execution_digest = _xd()
    body: Dict = {
        "schema": SCHEMA_VERSION,
        "ts": round(time.time(), 3),
        "source": source,
        "circuit": circuit,
        "fingerprint_key": hostprof.fingerprint_key(device=device),
        "execution_digest": execution_digest,
        "stages": {
            name: {"p50_ms": round(float(st["p50_ms"]), 3), "p95_ms": round(float(st.get("p95_ms", st["p50_ms"])), 3),
                   "n": int(st.get("n", 1))}
            for name, st in stages.items()
        },
    }
    if run_id:
        body["run_id"] = run_id
    body["entry_digest"] = _entry_digest(body)
    return body


def append_entry(entry: Dict, path: Optional[str]) -> Optional[str]:
    """Append one line with a single O_APPEND write (concurrent workers'
    lines interleave whole, never torn).  Returns the path; None when
    `path` is None (persistence off) or the write failed: observation
    never sinks the work it measures."""
    if not path:
        return None
    line = (json.dumps(entry, sort_keys=True, separators=(",", ":")) + "\n").encode()
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, line)
        finally:
            os.close(fd)
    except OSError:
        return None
    reset()
    return path


def perf_arm(perf_ledger: bool = True) -> str:
    """Record the perf_ledger gate's arm ("on" | "off") when it differs
    from this process's, so that a ledger-on run never shares an execution
    digest with a ledger-off one and an idle service's counters stay
    still."""
    from .audit import gate_arms, record_arm

    arm = "on" if perf_ledger else "off"
    if gate_arms().get("perf_ledger") != arm:
        record_arm("perf_ledger", arm)
    return arm


def record(source: str, circuit: str, stages: Dict[str, Dict], run_id: Optional[str] = None,
           perf_ledger: bool = True, cache_dir: Optional[str] = DEFAULT_CACHE_DIR, device=None) -> Optional[str]:
    """The producers' one entry point: append one entry to `device`'s
    ledger in `cache_dir` when the gate is on and there are stages."""
    if perf_arm(perf_ledger) != "on" or not stages:
        return None
    return append_entry(make_entry(source, circuit, stages, run_id=run_id, device=device),
                        ledger_path(cache_dir, device))


def load_entries(path: Optional[str], device=None) -> Tuple[List[Dict], Dict[str, int]]:
    """Every valid entry of the ledger at `path` in file order, and the
    refused lines' counts:
      unparseable  not one JSON object with a stages map
      schema       another schema version
      tampered     entry_digest does not match the body
      foreign      another fingerprint key than `device`'s
    """
    refused = {"unparseable": 0, "schema": 0, "foreign": 0, "tampered": 0}
    if not path:
        return [], refused
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError:
        return [], refused
    me = hostprof.fingerprint_key(device=device)
    out: List[Dict] = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            e = json.loads(line)
        except ValueError:
            refused["unparseable"] += 1
            continue
        if not isinstance(e, dict) or not isinstance(e.get("stages"), dict):
            refused["unparseable"] += 1
            continue
        if e.get("schema") != SCHEMA_VERSION:
            refused["schema"] += 1
            continue
        if e.get("entry_digest") != _entry_digest(e):
            refused["tampered"] += 1
            continue
        if e.get("fingerprint_key") != me:
            refused["foreign"] += 1
            continue
        out.append(e)
    return out, refused


def reset() -> None:
    """Drop the budget memo."""
    global _budget_memo
    with _lock:
        _budget_memo = None


def derive_budgets(entries: List[Dict], window: int = DEFAULT_WINDOW,
                   tolerance: float = DEFAULT_TOLERANCE) -> Dict[str, Dict[str, Dict]]:
    """{circuit: {stage: {budget_ms, median_ms, n, arm_skipped, tolerance,
    head_digest}}} from valid entries in ledger order.  For each (circuit,
    stage): the trailing `window` entries, of which only those sharing the
    head entry's execution digest count (two arms are two cost
    distributions), then budget = upper median of their p50 × tolerance.
    head_digest is the head entry's entry_digest: a flame capture that
    this budget triggers records it."""
    window = max(1, int(window))
    tolerance = float(tolerance)
    series: Dict[Tuple[str, str], List[Tuple[float, str, str]]] = {}
    for e in entries:
        circuit = str(e.get("circuit", "?"))
        digest = str(e.get("execution_digest", "?"))
        entry_d = str(e.get("entry_digest", "?"))
        for stage, st in e["stages"].items():
            try:
                p50 = float(st["p50_ms"])
            except (KeyError, TypeError, ValueError):
                continue
            series.setdefault((circuit, stage), []).append((p50, digest, entry_d))
    out: Dict[str, Dict[str, Dict]] = {}
    for (circuit, stage), rows in series.items():
        tail = rows[-window:]
        head_digest = tail[-1][1]
        vals = sorted(v for v, d, _ed in tail if d == head_digest)
        if not vals:
            continue
        # the upper median: a two-entry window must not flag the slower of
        # the two rounds that made it
        med = vals[len(vals) // 2]
        out.setdefault(circuit, {})[stage] = {
            "budget_ms": round(med * tolerance, 3),
            "median_ms": round(med, 3),
            "n": len(vals),
            "arm_skipped": len(tail) - len(vals),
            "tolerance": tolerance,
            "head_digest": tail[-1][2],
        }
    return out


class BudgetBook:
    """One circuit's stage budgets, loaded once and consulted a terminal
    request with dict lookups only."""

    def __init__(self, budgets: Dict[str, Dict]):
        self._budgets = dict(budgets)

    def __len__(self) -> int:
        return len(self._budgets)

    def budget_ms(self, stage: str) -> Optional[float]:
        b = self._budgets.get(stage)
        return None if b is None else b["budget_ms"]

    def head_digest(self, stage: str) -> Optional[str]:
        """The entry_digest of the ledger entry this stage's window is
        anchored to (None without a budget)."""
        b = self._budgets.get(stage)
        return None if b is None else b.get("head_digest")

    def over(self, stage: str, ms: Optional[float]) -> Optional[bool]:
        """True over budget, False within, None when the stage has no
        budget (a fresh card or a new stage must not page)."""
        if ms is None:
            return None
        b = self._budgets.get(stage)
        if b is None:
            return None
        return float(ms) > b["budget_ms"]

    @classmethod
    def load(cls, circuit: str, path: Optional[str], window: int = DEFAULT_WINDOW,
             tolerance: float = DEFAULT_TOLERANCE, perf_ledger: bool = True, device=None) -> "BudgetBook":
        """`circuit`'s budgets from the ledger at `path`; an empty book
        (every check None) when the gate is off, `path` is None or the
        ledger has no valid entry."""
        global _budget_memo

        if perf_arm(perf_ledger) != "on" or not path:
            return cls({})
        try:
            mtime = os.stat(path).st_mtime_ns
        except OSError:
            return cls({})
        key = (path, mtime, window, tolerance)
        with _lock:
            memo = _budget_memo
        if memo is not None and memo[0] == key:
            budgets = memo[1]
        else:
            entries, _refused = load_entries(path, device=device)
            budgets = derive_budgets(entries, window=window, tolerance=tolerance)
            with _lock:
                _budget_memo = (key, budgets)
        return cls(budgets.get(circuit, {}))


# ---------------------------------------------------------------------------
# The baseline band and the drift gate (`perf --rebaseline`, `perf --gate`).


def write_baseline(baseline_path: Optional[str] = None, ledger: Optional[str] = None,
                   window: int = DEFAULT_WINDOW, tolerance: float = DEFAULT_TOLERANCE,
                   device=None) -> Optional[Dict]:
    """Freeze the ledger's current budgets as the band (tmp + rename: a
    torn baseline must never judge a gate).  None when the ledger has no
    valid entry: an empty band would pass every later gate."""
    entries, _refused = load_entries(ledger, device=device)
    if not entries:
        return None
    budgets = derive_budgets(entries, window=window, tolerance=tolerance)
    if not budgets:
        return None
    doc = {
        "schema": SCHEMA_VERSION,
        "generated_ts": round(time.time(), 3),
        "fingerprint_key": hostprof.fingerprint_key(device=device),
        "window": int(window),
        "tolerance": float(tolerance),
        "bands": budgets,
    }
    baseline_path = baseline_path or default_baseline_path()
    tmp = f"{baseline_path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, baseline_path)
    except OSError:
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
        except OSError:
            pass
        return None
    return doc


def gate_check(baseline_path: Optional[str] = None, ledger: Optional[str] = None, log=None,
               device=None) -> Tuple[int, List[Dict]]:
    """Replay the ledger's head (the newest valid entry of each circuit and
    stage) against the band.  Returns (rc, verdict rows):

      rc 0  every head stage with a band is within budget (a row may read
            IMPROVED: its p50 × tolerance is under the band's median, a
            band gone loose that wants `perf --rebaseline`)
      rc 1  DRIFT: a head p50 over its band
      rc 2  fail closed: no readable baseline, or no valid ledger entry

    A stage on one side only reads `new` or `gone` and fails nothing.  A
    band frozen under another key is warned about and still compared."""
    log = log or (lambda m: None)
    baseline_path = baseline_path or default_baseline_path()
    try:
        with open(baseline_path) as f:
            base = json.load(f)
    except (OSError, ValueError):
        log(f"perf-gate: FAIL CLOSED — no readable baseline at {baseline_path}")
        return 2, []
    if not isinstance(base, dict) or base.get("schema") != SCHEMA_VERSION:
        log("perf-gate: FAIL CLOSED — baseline schema drift")
        return 2, []
    entries, refused = load_entries(ledger, device=device)
    if not entries:
        log(f"perf-gate: FAIL CLOSED — no valid ledger entries for this host (refused: {refused})")
        return 2, []
    me = hostprof.fingerprint_key(device=device)
    if base.get("fingerprint_key") != me:
        log(f"perf-gate: WARNING — baseline was frozen on different hardware ({base.get('fingerprint_key')} vs "
            f"{me}); comparing anyway, rebaseline with `perf --rebaseline`")
    head: Dict[Tuple[str, str], Dict] = {}
    for e in entries:
        for stage, st in e["stages"].items():
            head[(str(e.get("circuit", "?")), stage)] = {
                "p50_ms": st["p50_ms"], "source": e.get("source"), "execution_digest": e.get("execution_digest")}
    bands = base.get("bands") or {}
    verdicts: List[Dict] = []
    rc = 0
    tol = float(base.get("tolerance") or DEFAULT_TOLERANCE)
    for (circuit, stage), h in sorted(head.items()):
        band = (bands.get(circuit) or {}).get(stage)
        if band is None:
            verdicts.append({"circuit": circuit, "stage": stage, "verdict": "new", "p50_ms": h["p50_ms"]})
            continue
        drift = float(h["p50_ms"]) > float(band["budget_ms"])
        improved = (not drift) and float(h["p50_ms"]) * tol < float(band["median_ms"])
        verdicts.append({
            "circuit": circuit, "stage": stage, "verdict": "DRIFT" if drift else ("IMPROVED" if improved else "ok"),
            "p50_ms": h["p50_ms"], "budget_ms": band["budget_ms"], "median_ms": band["median_ms"],
            "execution_digest": h["execution_digest"],
        })
        if drift:
            rc = 1
    for circuit, stages in sorted(bands.items()):
        for stage in sorted(stages):
            if (circuit, stage) not in head:
                verdicts.append({"circuit": circuit, "stage": stage, "verdict": "gone"})
    return rc, verdicts
