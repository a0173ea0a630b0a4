"""The hardware fingerprint that keys the perf ledger (port of the
fingerprint half of the reference's ``utils/hostprof.py``).

A stage's milliseconds depend on the card that ran its kernels and on
the host CPU that ran its Python: the fingerprint holds the card's name,
compute capability, SM count and memory (``torch.cuda.get_device_properties``)
and the host's CPU model.  Under ``device="cpu"`` (which only the tests
ask for) it holds ``platform: "cpu"`` and no card fields, so a ledger
written on the CPU never feeds a card's budgets, nor the other way round.

The reference's tune profile, cache sizes and IFMA tier belong to its
native CPU tier and are not ported.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Dict, Optional

from .device import resolve_device

# identity fields, in digest order: the fingerprint contract.  Append-only:
# dropping or reordering orphans every ledger keyed by the old digest.
FP_FIELDS = ("platform", "device_name", "capability", "sm_count", "total_memory", "cpu_model")

_lock = threading.Lock()
# device string -> fingerprint (the card and the host do not change under
# a running process)
_fp_memo: Dict[str, Dict] = {}


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def host_fingerprint(device=None) -> Dict:
    """The identity of `device` (None: the current CUDA card; raises when
    there is none) and of this host's CPU, memoized per device."""
    import torch

    d = resolve_device(device)
    k = str(d)
    with _lock:
        if k in _fp_memo:
            return dict(_fp_memo[k])
    if d.type == "cuda":
        p = torch.cuda.get_device_properties(d)
        fp = {"platform": "cuda", "device_name": p.name, "capability": f"{p.major}.{p.minor}",
              "sm_count": int(p.multi_processor_count), "total_memory": int(p.total_memory)}
    else:
        fp = {"platform": "cpu"}
    fp["cpu_model"] = _cpu_model()
    with _lock:
        _fp_memo[k] = dict(fp)
    return fp


def fingerprint_key(fp: Optional[Dict] = None, device=None) -> str:
    """16 hex characters of SHA-256 over the identity fields (of `fp`, or
    of `device`'s fingerprint): the ledger's file key and its check
    against foreign lines."""
    fp = host_fingerprint(device) if fp is None else fp
    blob = json.dumps([(k, fp.get(k)) for k in FP_FIELDS], separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]
