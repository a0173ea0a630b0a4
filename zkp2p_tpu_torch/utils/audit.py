"""Which code paths ran, how much device memory they held, and the
preflight report of ``doctor`` (port of the reference's
``utils/audit.py``).

``record_arm(gate, arm)`` reports, where a prover resolves one of its
gates, the arm it took: into the ``zkp2p_path_taken_total{gate,arm}``
counters and the process's gate -> arm map.  ``execution_digest`` hashes
the sorted map: two runs with the same digest ran the same arms.

``sample_device_memory(stage)`` reads the caching allocator's counters
(``torch.cuda.memory_stats``) into the ``zkp2p_hbm_*`` gauges, keeping a
per-stage peak.  It never resets the allocator's peak: a caller that
measures peaks owns those resets.

``preflight`` reports the backend, the card, which kernel libraries are
built, every gate's arm and the digest, and runs one K1 launch against
its plain version (``python -m zkp2p_tpu_torch doctor``; the service logs
it before its first claim); ``last_preflight`` is the summary of the
latest one, which ``/status`` waits for.  It has no TPU probe, and no knobs or their
provenance: the port reads none, its arms are the keyword arguments of
its entry points, and a gate this process has not taken yet reports the
entry point's default.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional

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


# the summary of this process's latest preflight (None until one ran)
_preflight_report: Optional[Dict] = None


def last_preflight() -> Optional[Dict]:
    """{ts, backend, warnings (their count), execution_digest} of the
    latest preflight in this process, or None."""
    return _preflight_report


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


# the K1 launch preflight holds against K1's plain version
WORKLOAD_ELEMENTS = 4096


def _default(fn, name: str):
    return inspect.signature(fn).parameters[name].default


def _arm_gates() -> None:
    """Record every gate the port has: the fault plan armed in this
    process (or "off"), and each other gate this process has not taken
    yet at its entry point's default (prove_gpu's msm_affine and msm_h,
    prove_gpu_batch's chunk, the service's SLO objective, time-series
    interval, fleet membership, scheduler arm, worker tier, perf ledger
    and flame sampler, the supervisor's governor budgets)."""
    from ..pipeline.fleet import FleetSupervisor, fleet_member_arm, governor_arm
    from ..pipeline.sched import sched_arm, worker_tier_arm
    from ..pipeline.service import ProvingService
    from ..prover.groth16_gpu import prove_gpu, prove_gpu_batch
    from .faults import faults_arm
    from .flameprof import flame_arm
    from .perfledger import perf_arm
    from .slo import slo_arm, timeseries_arm

    faults_arm()
    svc, sup = ProvingService.__init__, FleetSupervisor.__init__
    defaults = {"msm_affine": lambda: record_arm("msm_affine", _default(prove_gpu, "msm_affine")),
                "msm_h": lambda: record_arm("msm_h", _default(prove_gpu, "msm_h")),
                "batch_chunk": lambda: record_arm("batch_chunk", _default(prove_gpu_batch, "chunk")),
                "service_slo": lambda: slo_arm(_default(svc, "slo_p95_s")),
                "service_timeseries": lambda: timeseries_arm(_default(svc, "ts_sample_s")),
                "service_fleet": lambda: fleet_member_arm(_default(svc, "worker_id")),
                "service_sched": lambda: sched_arm(_default(svc, "sched")),
                "worker_tier": lambda: worker_tier_arm(_default(svc, "worker_tier")),
                "perf_ledger": lambda: perf_arm(_default(svc, "perf_ledger")),
                "flame": lambda: flame_arm(_default(svc, "flame"), _default(svc, "flame_hz")),
                "fleet_governor": lambda: governor_arm(_default(sup, "rss_soft_mb"), _default(sup, "rss_hard_mb"))}
    for gate, arm in defaults.items():
        if gate not in _arms:
            arm()


def _workload(device) -> Optional[str]:
    """One K1 launch over WORKLOAD_ELEMENTS random canonical Fr elements,
    held bitwise against K1's plain version; None, or what went wrong."""
    import numpy as np
    import torch

    from ..field.tfield import FR
    from ..ops.cuda_mont import mont_mul, mont_mul_plain

    g = np.random.default_rng(0)
    x = g.integers(0, 1 << 16, size=(2, WORKLOAD_ELEMENTS, 16), dtype=np.int64)
    x[..., 15] %= 0x3064  # below r
    a, b = torch.from_numpy(x.astype(np.int32)).unbind(0)
    got = mont_mul(FR, a.to(device), b.to(device)).cpu()
    if not torch.equal(got, mont_mul_plain(FR, a, b)):
        return f"K1 (mont_mul) over {WORKLOAD_ELEMENTS} elements differs from its plain version"
    return None


def preflight(workload: bool = True, log: Optional[Callable[[str], None]] = None) -> Dict:
    """The doctor's report: {type "doctor", ts, run_id, backend ("cuda" or
    "unavailable"), device (name, compute capability, count; None without
    CUDA), kernels (each source of ``cuda_build.SOURCES``: its launchers
    and whether its library is built), workload_s (one K1 launch held
    against its plain version; left out when `workload` is False, None
    without CUDA), gates (every gate's arm: the one this process took, or
    its entry point's default), warnings, device_memory, execution_digest}.
    A warning is a CUDA device missing, a kernel whose workload fails or
    differs; `log` gets each."""
    import torch

    from ..ops import cuda_build
    from .metrics import run_id

    report: Dict[str, Any] = {"type": "doctor", "ts": round(time.time(), 3), "run_id": run_id()}
    warnings: List[str] = []
    cuda = torch.cuda.is_available()
    report["backend"] = "cuda" if cuda else "unavailable"
    if cuda:
        report["device"] = {"name": torch.cuda.get_device_name(0),
                            "capability": ".".join(map(str, torch.cuda.get_device_capability(0))),
                            "count": torch.cuda.device_count()}
    else:
        report["device"] = None
        warnings.append("no CUDA device: the port's entry points run only with device='cpu' (the kernels' "
                        "plain versions)")
    report["kernels"] = {stem: {"launchers": list(fns), "built": cuda_build._lib_path(stem).exists()}
                         for stem, fns in cuda_build.SOURCES.items()}
    _arm_gates()
    if workload:
        report["workload_s"] = None
        if cuda:
            t0 = time.perf_counter()
            try:
                bad = _workload(torch.device("cuda", torch.cuda.current_device()))
            except Exception as e:  # noqa: BLE001 — a kernel that cannot build or launch is a finding
                bad = f"K1 (mont_mul) workload failed: {e}"
            report["workload_s"] = round(time.perf_counter() - t0, 3)
            if bad:
                warnings.append(bad)
    report["gates"] = gate_arms()
    report["warnings"] = warnings
    report["device_memory"] = sample_device_memory("preflight")
    report["execution_digest"] = execution_digest()
    global _preflight_report
    _preflight_report = {"ts": report["ts"], "backend": report["backend"], "warnings": len(warnings),
                         "execution_digest": report["execution_digest"]}
    if log is not None:
        for msg in warnings:
            log(f"PREFLIGHT WARNING: {msg}")
    return report
