"""Which code paths ran, and how much device memory they held (port of
the reference's ``utils/audit.py`` without its preflight).

``record_arm(gate, arm)`` reports, where a prover resolves one of its
gates, the arm it took: into the ``zkp2p_path_taken_total{gate,arm}``
counters and the process's gate -> arm map.  ``execution_digest`` hashes
the sorted map: two runs with the same digest ran the same arms.

``sample_device_memory(stage)`` reads the caching allocator's counters
(``torch.cuda.memory_stats``) into the ``zkp2p_hbm_*`` gauges, keeping a
per-stage peak.  It never resets the allocator's peak: a caller that
measures peaks owns those resets.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Any, Dict, Optional

from .metrics import REGISTRY

_arms: Dict[str, str] = {}
# (gate, arm) -> counter, valid for one registry generation
_counters: Dict[Any, Any] = {}
_counters_gen = -1
_peak_lock = threading.Lock()


def _arm_str(arm) -> str:
    if isinstance(arm, bool):
        return "on" if arm else "off"
    return str(arm)


def record_arm(gate: str, arm):
    """Report that `gate` took `arm` (bools read "on" / "off"); returns
    `arm`."""
    global _counters_gen
    s = _arm_str(arm)
    _arms[gate] = s
    if REGISTRY.generation != _counters_gen:
        _counters.clear()
        _counters_gen = REGISTRY.generation
    c = _counters.get((gate, s))
    if c is None:
        c = _counters[(gate, s)] = REGISTRY.counter("zkp2p_path_taken_total", {"gate": gate, "arm": s})
    c.inc()
    return arm


def gate_arms() -> Dict[str, str]:
    """The gate -> arm map seen so far in this process."""
    return dict(_arms)


def execution_digest(arms: Optional[Dict[str, str]] = None) -> str:
    """16 hex characters of SHA-256 over the sorted gate -> arm map (this
    process's when `arms` is None): independent of the order the gates
    were seen in, changed by any arm."""
    if arms is None:
        arms = _arms
    blob = json.dumps(sorted(arms.items()), separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def reset() -> None:
    """Clear the gate -> arm map."""
    _arms.clear()


def sample_device_memory(stage: str = "") -> Optional[Dict]:
    """Sample the device memory of each CUDA device this process has
    allocated on (and the current one) into gauges; return the device
    with the most bytes in use as {device, bytes_in_use (the allocator's
    ``allocated_bytes.all.current``), peak_bytes_in_use
    (``allocated_bytes.all.peak``), bytes_limit (the card's total from
    ``torch.cuda.mem_get_info``)}.  None when no CUDA device has been
    initialised in this process (on the CPU)."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    best = None
    current = torch.cuda.current_device()
    for i in range(torch.cuda.device_count()):
        st = torch.cuda.memory_stats(i)
        used = int(st.get("allocated_bytes.all.current", 0))
        peak = int(st.get("allocated_bytes.all.peak", used))
        if not peak and i != current:
            continue  # no context there: mem_get_info would make one
        limit = int(torch.cuda.mem_get_info(i)[1])
        lab = {"device": str(i)}
        REGISTRY.gauge("zkp2p_hbm_bytes_in_use", lab).set(used)
        REGISTRY.gauge("zkp2p_hbm_peak_bytes", lab).set(peak)
        REGISTRY.gauge("zkp2p_hbm_bytes_limit", lab).set(limit)
        if best is None or used > best["bytes_in_use"]:
            best = {"device": i, "bytes_in_use": used, "peak_bytes_in_use": peak, "bytes_limit": limit}
    if best is not None and stage:
        g = REGISTRY.gauge("zkp2p_hbm_stage_peak_bytes", {"stage": stage})
        with _peak_lock:  # a read-then-set by two samplers could lower the peak
            g.set(max(g.value, best["peak_bytes_in_use"]))
    return best
