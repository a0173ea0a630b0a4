"""Continuous profiling on the card: the flame sampler (port of the
reference's ``utils/flameprof.py``).

  - ``FlameSampler``: a daemon thread samples ``sys._current_frames()`` of
    every other thread at `hz` (47 by default: prime, so that it never
    locks in phase with periodic stage work) and folds each stack into
    collapsed-stack counts (flamegraph.pl's format, `root;child;leaf N`).
  - Frames for the card's work.  A thread that waits on the card (a
    synchronising copy to the host, a launch) shows one opaque Python
    frame.  Each sample window is bracketed by the deltas of the
    launchers' launch counters (``ops.cuda_build.LAUNCHES``); a thread
    whose leaf frame sits in a bridge file (``BRIDGE_SUFFIXES``: the
    launchers and the modules that wait on the card) gets a
    `gpu:<launcher>` frame under its leaf when launches moved in the
    window (the launcher whose count moved most), and, in a window
    without launches, while the card still runs what was enqueued (the
    default stream, which every launcher uses, is not idle: a
    non-blocking query), the frame of the last window with launches.  So
    a thread blocked in a copy that waits for the MSMs shows the kernel
    last launched beside it.  Launches in a window where no thread was
    seen parked fold under a `[gpu];gpu:<launcher>` root at the end, one
    count a launch, so that nothing counted is dropped.
  - ``CaptureController``: the perf sentry's hook.  A stage-budget
    overrun in the service triggers a capture over the next `capture_n`
    sweeps, written atomically as ``flame_<circuit>_<stage>_<ts>.json``
    (rate-limited by `cooldown_s`, counted in
    ``zkp2p_flame_captures_total{trigger}``, pointed to from the
    heartbeat's perf block), which records the ledger head entry_digest
    its budget was derived from.

Launches are not time.  A launch count says which kernels the card was
given in a window, not how long they ran: the `gpu:` frames attribute
samples (host time spent beside the card's work) to the kernel launched
most in the window or last launched, which need not be the one running,
and the `[gpu]` root's counts are launches, not samples.  The
capture carries the window's launches by launcher (``gpu_launches``) and
those no parked thread was seen waiting for (``gpu_unattributed_launches``)
where the reference carries its native nanoseconds.  The sampler clocks
its own work: ``sampler.self_ms`` (wall time, its waits for the
interpreter lock included) and ``sampler.cpu_ms`` (its thread's CPU
time).

The capture's schema is the reference's, so that the reference's
standalone ``tools/trace_report.py --flame`` reads a port capture.  The
sampler runs only when asked for (``ProvingService(flame=True)``, the
``flame`` command); its settings are keywords with the reference's
defaults (47 Hz, captures over 2 sweeps, 60 s cooldown).
"""

from __future__ import annotations

import glob
import json
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

CAPTURE_SCHEMA = 1
CAPTURE_KIND = "zkp2p_flame_capture"
CAPTURE_PREFIX = "flame_"

# the reference's configuration defaults
DEFAULT_HZ = 47.0
DEFAULT_CAPTURE_N = 2
DEFAULT_COOLDOWN_S = 60.0

# Path suffixes (with "/") of the files in which a thread waits on the card:
# the launchers and the modules that synchronise or copy to the host.  A
# thread whose leaf frame is in one while launches move earns a `gpu:`
# frame.  Module-level so that tests can monkeypatch the set.
BRIDGE_SUFFIXES = (
    "zkp2p_tpu_torch/ops/cuda_affine.py",
    "zkp2p_tpu_torch/ops/cuda_build.py",
    "zkp2p_tpu_torch/ops/cuda_curve.py",
    "zkp2p_tpu_torch/ops/cuda_fixed_base.py",
    "zkp2p_tpu_torch/ops/cuda_lane_tree.py",
    "zkp2p_tpu_torch/ops/cuda_matvec.py",
    "zkp2p_tpu_torch/ops/cuda_mont.py",
    "zkp2p_tpu_torch/ops/cuda_msm_fold.py",
    "zkp2p_tpu_torch/ops/cuda_msm_window.py",
    "zkp2p_tpu_torch/ops/cuda_ntt.py",
    "zkp2p_tpu_torch/ops/cuda_recode.py",
    "zkp2p_tpu_torch/ops/cuda_scale.py",
    "zkp2p_tpu_torch/prover/groth16_gpu.py",
    "zkp2p_tpu_torch/prover/setup_device.py",
    "zkp2p_tpu_torch/snark/ceremony.py",
    # the accumulators' copy to the host, where a proof waits for its MSMs
    "zkp2p_tpu_torch/curve/tcurve.py",
)

_MAX_DEPTH = 64  # frames kept a stack (the root-most dropped beyond it)


def flame_arm(flame: bool = False, hz: float = DEFAULT_HZ) -> str:
    """Record the flame gate's arm ("off" | "<hz>hz") when it differs from
    this process's: a sampler-on run never shares an execution digest with
    a sampler-off one, nor with one at another rate."""
    from .audit import gate_arms, record_arm

    arm = f"{float(hz):g}hz" if flame else "off"
    if gate_arms().get("flame") != arm:
        record_arm("flame", arm)
    return arm


def _is_bridge_file(filename: str) -> bool:
    return filename.replace(os.sep, "/").endswith(BRIDGE_SUFFIXES)


# code object -> "file.py:func" (keyed on the code object itself: ids
# recycle after collection)
_label_memo: Dict[object, str] = {}


def _fold(frame, depth: int = _MAX_DEPTH) -> List[str]:
    """One thread's stack as root-first `file.py:func` frames (the labels
    memoized a code object: the sampler's hot loop)."""
    out: List[str] = []
    while frame is not None and len(out) < depth:
        code = frame.f_code
        label = _label_memo.get(code)
        if label is None:
            label = f"{os.path.basename(code.co_filename)}:{code.co_name}"
            _label_memo[code] = label
        out.append(label)
        frame = frame.f_back
    out.reverse()
    return out


def _launch_counts() -> Dict[str, int]:
    """This process's launch counters (a copy: the launchers keep counting)."""
    from ..ops.cuda_build import LAUNCHES

    return dict(LAUNCHES)


def _card_busy() -> bool:
    """Whether the card still runs work enqueued on its default stream
    (every launcher's stream): a non-blocking query, and never the first
    CUDA call of a process."""
    import torch

    return torch.cuda.is_initialized() and not torch.cuda.default_stream().query()


class FlameSampler:
    """A background sampling profiler.  start() spawns the daemon thread;
    stop() joins it and takes the last window's launch deltas; result() is
    the capture's body (stacks, launches, the sampler's own cost).

    `counts_source` returns launcher -> launches so far (default: the
    launchers' counters) and `busy_source` whether the card still runs
    enqueued work (default: the default stream's query); tests drive
    their own.  `thread_filter` limits sampling to a set of thread
    idents."""

    def __init__(self, hz: float = DEFAULT_HZ, counts_source: Optional[Callable[[], Dict[str, int]]] = None,
                 thread_filter: Optional[set] = None, busy_source: Optional[Callable[[], bool]] = None):
        self.hz = max(0.001, float(hz))
        self._counts_source = counts_source or _launch_counts
        self._busy_source = busy_source or _card_busy
        # the frame of the last window with launches: what a thread parked
        # in a bridge file waits for while the card is busy
        self._last_gpu: Optional[str] = None
        self._filter = thread_filter
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._launches: Dict[str, int] = {}
        self._unattributed: Dict[str, int] = {}
        self._prev: Dict[str, int] = {}
        self.samples = 0
        self.windows = 0
        self._self_s = 0.0
        self._self_cpu_s = 0.0
        self._t_start: Optional[float] = None
        self.duration_s = 0.0

    # -- lifecycle ---------------------------------------------------

    def start(self) -> "FlameSampler":
        if self._thread is not None:
            return self
        self._prev = self._counts_source()
        self._t_start = time.perf_counter()
        self._thread = threading.Thread(target=self._loop, name="zkp2p-flame-sampler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop_evt.set()
        t.join(timeout=5.0)
        self._thread = None
        # the launches since the last tick: no thread was seen waiting for them
        self._account(self._deltas(), parked=False)
        if self._t_start is not None:
            self.duration_s = time.perf_counter() - self._t_start

    # -- sampling ----------------------------------------------------

    def _loop(self) -> None:
        interval = 1.0 / self.hz
        next_t = time.perf_counter()
        while not self._stop_evt.is_set():
            t0, c0 = time.perf_counter(), time.thread_time()
            try:
                self._sample_once()
            except Exception:  # noqa: BLE001 — the profiler never takes down what it observes
                pass
            self._self_s += time.perf_counter() - t0
            self._self_cpu_s += time.thread_time() - c0
            next_t += interval
            delay = next_t - time.perf_counter()
            if delay > 0:
                self._stop_evt.wait(delay)
            else:
                # behind (a long fold under load): re-anchor, never burst
                next_t = time.perf_counter()

    def _deltas(self) -> Dict[str, int]:
        """Launches by launcher since the previous window (a counter reset
        in between reads as no launches)."""
        now = self._counts_source()
        prev, self._prev = self._prev, now
        return {k: v - prev.get(k, 0) for k, v in now.items() if v - prev.get(k, 0) > 0}

    def _account(self, deltas: Dict[str, int], parked: bool) -> None:
        with self._lock:
            for k, n in deltas.items():
                self._launches[k] = self._launches.get(k, 0) + n
                if not parked:
                    self._unattributed[k] = self._unattributed.get(k, 0) + n

    def _sample_once(self) -> None:
        deltas = self._deltas()
        self.windows += 1
        if deltas:
            frame_gpu = self._last_gpu = f"gpu:{max(deltas, key=lambda k: (deltas[k], k))}"
        elif self._last_gpu is not None and self._busy_source():
            frame_gpu = self._last_gpu  # no launch, but the card still runs what was launched
        else:
            frame_gpu = None
        me = threading.get_ident()
        parked = False
        keys: List[str] = []
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            if self._filter is not None and tid not in self._filter:
                continue
            stack = _fold(frame)
            if not stack:
                continue
            if frame_gpu is not None and _is_bridge_file(frame.f_code.co_filename):
                stack.append(frame_gpu)
                parked = True
            keys.append(";".join(stack))
        # one lock a tick, after the frame walk
        with self._lock:
            for key in keys:
                self._counts[key] = self._counts.get(key, 0) + 1
            self.samples += len(keys)
        self._account(deltas, parked)

    # -- results -----------------------------------------------------

    def stacks(self) -> Dict[str, int]:
        """The folded counts, with `[gpu];gpu:<launcher>` for the launches
        no parked thread was seen waiting for (one count a launch)."""
        with self._lock:
            out = dict(self._counts)
            for k, n in self._unattributed.items():
                key = f"[gpu];gpu:{k}"
                out[key] = out.get(key, 0) + n
        return out

    def result(self) -> Dict:
        """The capture's body (all but the trigger's fields)."""
        with self._lock:
            launches = dict(self._launches)
            unattributed = dict(self._unattributed)
        return {
            "hz": self.hz,
            "samples": self.samples,
            "windows": self.windows,
            "duration_s": round(self.duration_s, 4),
            # self_ms is wall time a tick, waits for the interpreter lock
            # included; cpu_ms the sampler thread's own CPU time
            "sampler": {"self_ms": round(self._self_s * 1e3, 3), "cpu_ms": round(self._self_cpu_s * 1e3, 3)},
            "gpu_launches": launches,
            "gpu_unattributed_launches": unattributed,
            "stacks": self.stacks(),
        }


def collapsed_text(stacks: Dict[str, int]) -> str:
    """flamegraph.pl's format: `frame;frame;frame count` a line, heaviest
    first."""
    rows = sorted(stacks.items(), key=lambda kv: (-kv[1], kv[0]))
    return "\n".join(f"{k} {v}" for k, v in rows)


def profile_proves(prove_fn: Callable[[], object], duration_s: float,
                   hz: float = DEFAULT_HZ) -> Tuple[FlameSampler, List[float]]:
    """Call `prove_fn` under a started sampler until `duration_s` has
    passed (at least once); returns (the sampler, still running: stop it
    or hand it to write_capture; each call's seconds).  A failing call
    raises, and the sampler is stopped."""
    sampler = FlameSampler(hz=hz).start()
    seconds: List[float] = []
    t0 = time.perf_counter()
    try:
        while True:
            t = time.perf_counter()
            prove_fn()
            seconds.append(time.perf_counter() - t)
            if time.perf_counter() - t0 >= duration_s:
                break
    except BaseException:
        sampler.stop()
        raise
    return sampler, seconds


# -- capture files ---------------------------------------------------


def _safe_token(s: str) -> str:
    return "".join(c if (c.isalnum() or c in "-.") else "-" for c in str(s)) or "x"


def write_capture(sampler: FlameSampler, circuit: str, stage: str, trigger: str, out_dir: Optional[str],
                  entry_digest: Optional[str] = None, budget_ms: Optional[float] = None,
                  over_ms: Optional[float] = None, clock: Callable[[], float] = time.time) -> Optional[str]:
    """Stop `sampler` and write its capture into `out_dir` atomically (tmp
    + rename: a torn capture never parses).  Returns the path; None when
    `out_dir` is None (persistence off) or the write failed.  Counted in
    zkp2p_flame_captures_total{trigger} only once renamed."""
    from .audit import execution_digest
    from .metrics import REGISTRY

    sampler.stop()
    if out_dir is None:
        return None
    body = sampler.result()
    ts = int(clock())
    body.update({
        "schema": CAPTURE_SCHEMA, "kind": CAPTURE_KIND, "circuit": str(circuit), "stage": str(stage),
        "trigger": str(trigger), "ts": ts, "entry_digest": entry_digest, "budget_ms": budget_ms,
        "over_ms": over_ms, "execution_digest": execution_digest(),
    })
    path = os.path.join(out_dir, f"{CAPTURE_PREFIX}{_safe_token(circuit)}_{_safe_token(stage)}_{ts}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        os.makedirs(out_dir, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(body, f, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    except OSError:
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
        except OSError:
            pass
        return None
    REGISTRY.counter("zkp2p_flame_captures_total", {"trigger": trigger}).inc()
    return path


def load_capture(path: str) -> Optional[Dict]:
    """One JSON object of the capture's kind and schema with a str -> int
    stacks map, or None: a truncated or foreign file never renders."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict):
        return None
    if doc.get("kind") != CAPTURE_KIND or doc.get("schema") != CAPTURE_SCHEMA:
        return None
    stacks = doc.get("stacks")
    if not isinstance(stacks, dict) or not all(
            isinstance(k, str) and isinstance(v, int) and v >= 0 for k, v in stacks.items()):
        return None
    return doc


def captures_for(circuit: str, out_dir: Optional[str], stage: Optional[str] = None) -> List[Tuple[str, Dict]]:
    """The valid captures of `circuit` in `out_dir` (newest first),
    optionally of one stage; unparseable files are skipped."""
    if out_dir is None:
        return []
    out: List[Tuple[str, Dict]] = []
    for path in glob.glob(os.path.join(out_dir, f"{CAPTURE_PREFIX}{_safe_token(circuit)}_*.json")):
        doc = load_capture(path)
        if doc is None or doc.get("circuit") != circuit:
            continue
        if stage is not None and doc.get("stage") != stage:
            continue
        out.append((path, doc))
    out.sort(key=lambda pd: (-int(pd[1].get("ts", 0)), pd[0]))
    return out


# -- the sentry's hook -----------------------------------------------


class CaptureController:
    """Overrun-triggered captures.  trigger() (the service's perf check, on
    an overrun) starts a sampler unless one runs or the cooldown holds;
    sweep_tick() (the end of every service sweep) writes the capture after
    `capture_n` sweeps.  One a process (``controller()``), shared by the
    service's threads; the settings come with each trigger."""

    def __init__(self, clock: Callable[[], float] = time.monotonic, wall: Callable[[], float] = time.time):
        self._clock = clock
        self._wall = wall
        self._lock = threading.Lock()
        self._sampler: Optional[FlameSampler] = None
        self._meta: Optional[Dict] = None
        self._sweeps = 0
        self._need = 0
        self._last_mono: Optional[float] = None
        self._pointer: Optional[Dict] = None

    def trigger(self, circuit: str, stage: str, out_dir: Optional[str], entry_digest: Optional[str] = None,
                budget_ms: Optional[float] = None, over_ms: Optional[float] = None, hz: float = DEFAULT_HZ,
                capture_n: int = DEFAULT_CAPTURE_N, cooldown_s: float = DEFAULT_COOLDOWN_S) -> bool:
        """True when a capture started (into `out_dir`)."""
        with self._lock:
            if self._sampler is not None:
                return False  # one capture at a time
            now = self._clock()
            if self._last_mono is not None and cooldown_s > 0 and now - self._last_mono < cooldown_s:
                return False
            self._sampler = FlameSampler(hz=hz).start()
            self._meta = {"circuit": str(circuit), "stage": str(stage), "entry_digest": entry_digest,
                          "budget_ms": budget_ms, "over_ms": over_ms, "out_dir": out_dir}
            self._sweeps = 0
            self._need = max(1, int(capture_n))
        return True

    def sweep_tick(self) -> Optional[str]:
        """The end of a service sweep; the capture's path when this tick
        completed one."""
        with self._lock:
            if self._sampler is None:
                return None
            self._sweeps += 1
            if self._sweeps < self._need:
                return None
            sampler, meta = self._sampler, self._meta
            self._sampler, self._meta = None, None
            self._last_mono = self._clock()
        path = write_capture(sampler, meta["circuit"], meta["stage"], "overrun", meta["out_dir"],
                             entry_digest=meta["entry_digest"], budget_ms=meta["budget_ms"],
                             over_ms=meta["over_ms"], clock=self._wall)
        if path is not None:
            with self._lock:
                self._pointer = {"file": os.path.basename(path), "stage": meta["stage"], "ts": int(self._wall()),
                                 "samples": sampler.samples}
        return path

    def active(self) -> bool:
        with self._lock:
            return self._sampler is not None

    def pointer(self) -> Optional[Dict]:
        """The newest capture of this process: the heartbeat's perf block
        carries it to `top`."""
        with self._lock:
            return dict(self._pointer) if self._pointer else None

    def reset(self) -> None:
        """Abandon a capture in flight and clear the state."""
        with self._lock:
            sampler = self._sampler
            self._sampler = None
            self._meta = None
            self._sweeps = 0
            self._last_mono = None
            self._pointer = None
        if sampler is not None:
            sampler.stop()


_controller = CaptureController()


def controller() -> CaptureController:
    return _controller
