"""The worker side of the reference's proving fleet (``pipeline/fleet.py``)
that a single service needs: the drain signal handlers and the
service-time model of a slowed prover.  The supervisor, heartbeat and
governor are not ported yet."""

from __future__ import annotations

import os
import signal
import time


def install_drain_handlers(svc) -> bool:
    """SIGTERM / SIGINT -> svc.request_drain(): stop claiming, finish the
    batches in flight, flush, and leave run() with "drained".  A second
    signal while draining restores the default action and delivers itself
    again, so that a worker stuck in its drain stays killable.  Main
    thread only (a CPython rule): returns False elsewhere."""

    def _handler(signum, _frame):
        if svc.draining:
            print(f"[service] signal {signum} again while draining: exiting NOW", flush=True)
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        print(f"[service] signal {signum}: draining (finish in-flight, claim nothing)", flush=True)
        svc.request_drain()

    try:
        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)
        return True
    except ValueError:  # not the main thread
        return False


def slowed_prover(inner, per_request_s: float, batch_overhead_s: float = 0.0):
    """A batch prover with service time added: `batch_overhead_s +
    per_request_s * fill` seconds a call, then `inner`.  Keeps
    `reads_msm_knobs`, on which the degradation ladder gates."""
    if per_request_s <= 0 and batch_overhead_s <= 0:
        return inner

    def slowed(dpk, wits, **kw):
        time.sleep(batch_overhead_s + per_request_s * max(1, len(wits)))
        return inner(dpk, wits, **kw)

    slowed.reads_msm_knobs = getattr(inner, "reads_msm_knobs", False)
    return slowed
