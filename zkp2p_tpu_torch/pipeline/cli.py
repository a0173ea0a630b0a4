"""The port's command line on one NVIDIA GPU (after the reference's
``pipeline/cli.py``): the dev setup of a circuit and the snarkjs /
rapidsnark drop-in prover.

  setup    build the circuit (--circuit venmo | email_verify | sha256 |
           toy, sized by --max-header / --max-body), audit it (the
           admission gate; --skip-audit bypasses it), run the development
           setup on the card (``setup_device``) and write
           <build-dir>/circuit_final.zkey, verification_key.json and
           verifier.sol; --chunks N also splits the zkey into N chunks
           (suffixes b..) beside it, --publish DIR uploads it to an
           artifact store as gzip chunks and a manifest
  prove    proof.json and public.json, through ``prove_gpu``: with
           --wtns, a .zkey and a circom .wtns in (no circuit is built);
           without, the circuit's witness from --eml (venmo,
           email_verify; the synthetic signed email when none is given)
           or --message (sha256, toy); --zkey-store DIR pulls the zkey
           from an artifact store through <build-dir>/zkey_cache
  verify   proof.json and public.json against
           <build-dir>/verification_key.json; prints OK (exit 0) or
           INVALID (exit 1).  Runs on the host, as snarkjs's does.
  batch    a directory of inputs against one .zkey, through
           ``prove_gpu_batch``; <name>.proof.json and <name>.public.json.
           It takes the directory's *.wtns files when it holds any (no
           circuit is built), else the inputs of --circuit's type: *.eml
           for venmo and email_verify, *.json ({"message": ...}) for
           sha256 and toy.
  service  the batched proving service over a spool directory
           (``pipeline.service.ProvingService``; venmo and email_verify):
           <name>.req.json in ({"eml_path": ...}, or for venmo the
           synthetic demo's {"raw_id", "amount", "order_id",
           "claim_id"}), <name>.proof.json and <name>.public.json or
           <name>.error.json out, request records in
           <spool>.metrics.jsonl.  SIGTERM or SIGINT drains it (claims
           nothing more, finishes what it holds) and it exits 0; exit 2
           when --max-seconds runs out.  --metrics-port N (or auto, a
           port the OS chooses) serves /metrics (Prometheus text),
           /status (JSON; 503 until the preflight has run), /healthz and
           /snapshot (the registry and SLO window as JSON) on
           --metrics-addr (default 127.0.0.1).  --sched adaptive hands
           admission and batching to the scheduler (``pipeline.sched``:
           priority lanes by the payload's `priority`, --priority-default
           bulk; shedding by predicted deadline miss; batches sized by
           --sched-amort 'S:sec,...' and --sched-target-fill 0.8 against
           the deadline or --slo-p95-s); --worker-tier is the tier its
           heartbeat advertises.  The perf sentry checks every terminal
           request's spans against the card's ledger budgets and stamps one
           ledger entry at exit (--no-perf-ledger turns it off;
           --perf-window 8, --perf-tolerance 1.5; the ledger and captures
           in --cache-dir, default <repo>/.bench_cache); --flame turns on the
           overrun-triggered flame captures (--flame-hz 47,
           --flame-capture-n 2 sweeps, --flame-cooldown-s 60).  It logs its
           kernels' launch counts at exit.
  fleet    N `service` workers on one spool under a supervisor
           (``pipeline.fleet``): restarts with backoff and a crash-loop
           breaker, SIGTERM drains every worker (SIGKILL past
           --drain-timeout-s), a watchdog on the workers' heartbeats, an
           RSS governor (--rss-soft-mb, --rss-hard-mb), and
           <fleet-dir>/status.json with each worker's state and metrics
           port.  Exit 0 clean, 3 a drain escalated, 4 every worker
           parked.  --worker-cmd JSON replaces the worker's argv ({wid}
           and {spool} substituted).  --fleet-metrics-port N (or auto)
           turns on the fleet plane (``pipeline.fleet_obs``): every
           --fleet-scrape-s (2.0) it scrapes each worker's /snapshot and
           serves the merged /metrics, /status (503 until every live
           worker has armed its gates; the merged SLO, the alerts) and
           /healthz; status.json then carries its body and its port.
           --workers-max N (> 0) autoscales the fleet between
           --workers-min and N on the plane's backlog trend and burn
           rates (--scale-up-s 10, --scale-down-s 30; the plane turns on);
           --sched ARM is appended to each worker's argv, and so are the
           service's perf flags below when given.
  top      the fleet plane's /status as a terminal view (--url, --port,
           or --fleet-dir DIR reading DIR/status.json's metrics_port;
           --interval 2, --once for one frame); an HTTP client, no card
  ceremony the phase-2 MPC over zkeys: contribute ZKEY_IN ZKEY_OUT
           [--entropy] [--name], beacon ZKEY_IN ZKEY_OUT --beacon-hash HEX
           [--iter-exp 10], verify ZKEY_INITIAL ZKEY_FINAL (prints the
           checks, then ZKEY OK, exit 0, or ZKEY INVALID, exit 1)
  doctor   the preflight report: backend, card, kernel libraries, every
           gate's arm and the execution digest, one K1 launch against its
           plain version (--no-workload skips it); --json for one JSON
           object; --strict exits 1 on a warning (no CUDA device among
           them)
  perf     the perf sentry (``utils.perfledger``) over the card's stage-cost
           ledger (<repo>/.bench_cache/perf_ledger_<key>.jsonl, or
           --ledger): a trendline and verdict a (circuit, stage) against the
           budgets (--window 8, --tolerance 1.5; --circuit, --stage filter;
           --json for the budgets and series), --rebaseline freezes the
           budgets as the band (--baseline, default PERF_BASELINE_GPU.json),
           --gate replays the ledger's head against it: exit 0 ok, 1 drift
           (a DRIFT row names the flame capture beside the ledger), 2 fail
           closed
  flame    ``prove_gpu`` on the card in a loop for --duration seconds under
           the flame sampler (``utils.flameprof``; --hz 47), after one
           warm-up proof outside it: the collapsed stacks on stdout (with
           `gpu:<launcher>` frames under the frames that waited on the
           card) and a trigger="manual" capture in --cache-dir (default
           <repo>/.bench_cache).  The
           key is --zkey's (or the build dir's); without one, the dev setup
           runs on the card

    python -m zkp2p_tpu_torch --circuit venmo --max-header 1024 --max-body 6400 setup
    python -m zkp2p_tpu_torch --circuit venmo --max-header 1024 --max-body 6400 prove --eml receipt.eml
    python -m zkp2p_tpu_torch prove --zkey build/circuit_final.zkey --wtns witness.wtns
    python -m zkp2p_tpu_torch verify
    python -m zkp2p_tpu_torch batch --indir inputs/ --outdir proofs/
    python -m zkp2p_tpu_torch --circuit venmo --max-header 1024 --max-body 6400 service --spool spool/
    python -m zkp2p_tpu_torch --circuit venmo --max-header 1024 --max-body 6400 fleet --spool spool/ --batch 2 \
        --fleet-metrics-port auto
    python -m zkp2p_tpu_torch --circuit venmo --max-header 1024 --max-body 6400 fleet --spool spool/ --batch 2 \
        --workers-min 1 --workers-max 2 --sched adaptive
    python -m zkp2p_tpu_torch top --fleet-dir spool/.fleet
    python -m zkp2p_tpu_torch ceremony contribute build/circuit_0.zkey build/circuit_1.zkey --entropy "..."
    python -m zkp2p_tpu_torch doctor --json
    python -m zkp2p_tpu_torch perf --gate
    python -m zkp2p_tpu_torch --circuit toy flame --duration 5

``setup``, ``prove``, ``batch``, ``service``, ``fleet`` (its workers),
``ceremony`` and ``flame`` run on the CUDA card, and ``perf`` reads that
card's ledger (``--device cuda``, the default); they
raise before they build a circuit or read a file when there is none;
``--device cpu`` runs the plain versions of the kernels.  A .wtns's
values are proved as their residues mod r, and public.json carries them
as the file holds them, as the reference does.
``--trace FILE`` appends the run's spans and its manifest (device,
versions, gate arms and their digest) to FILE, so that a caller reads
them from outside the process.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import resource
import sys
import time

from ..field.bn254 import R
from ..formats.circom_bin import read_wtns, reduce_rows, row_ints
from ..formats.proof_json import (dump, load, proof_from_json, proof_to_json, public_to_json, vkey_from_json,
                                  vkey_to_json)
from ..formats.solidity import export_verifier
from ..formats.zkey import read_zkey, split_zkey, write_zkey_data, zkey_from_key
from ..prover.groth16_gpu import device_pk_from_zkey, prove_gpu, prove_gpu_batch
from ..prover.setup_device import setup_device
from ..snark.groth16 import domain_size_for, verify
from ..ops import cuda_build
from ..utils.device import check_device, resolve_device
from ..utils.trace import dump_trace


def _log(*a):
    print("[zkp2p-tpu-torch]", *a, file=sys.stderr, flush=True)


def _peak_rss():
    """(GiB, source) of this process's peak resident memory: VmHWM where
    /proc has it, else ru_maxrss, which also counts the peak of a process
    that forked this one (a shell's is small)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 2**20, "VmHWM"  # kB
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20, "ru_maxrss"  # KiB on Linux


def _build_circuit(name: str, header: int, body: int):
    """(constraint system, what the circuit's witness builder needs)."""
    if name == "venmo":
        from ..models.venmo import VenmoParams, build_venmo_circuit

        params = VenmoParams(max_header_bytes=header, max_body_bytes=body)
        cs, lay = build_venmo_circuit(params)
        return cs, (params, lay)
    if name == "email_verify":
        from ..models.email_verify import EmailVerifyParams, build_email_verify

        params = EmailVerifyParams(max_header_bytes=header, max_body_bytes=body)
        cs, lay = build_email_verify(params)
        return cs, (params, lay)
    if name == "sha256":
        from ..gadgets import core, sha256
        from ..snark.r1cs import ConstraintSystem

        cs = ConstraintSystem("sha256")
        msg = cs.new_wires(header, "msg")
        cs.mark_input(msg)
        bits = core.assert_bytes(cs, msg)
        sha256.sha256_blocks(cs, bits, None)
        return cs, (None, msg)
    if name == "toy":
        # smoke-test circuit: public out = (x*y)^2 over two byte inputs
        from ..snark.r1cs import LC, ConstraintSystem

        cs = ConstraintSystem("toy")
        out = cs.new_public("out")
        x = cs.new_wire("x")
        y = cs.new_wire("y")
        z = cs.new_wire("z")
        cs.mark_input([x, y])
        cs.enforce(LC.of(x), LC.of(y), LC.of(z), "mul")
        cs.enforce(LC.of(z), LC.of(z), LC.of(out), "sq")
        cs.compute(z, lambda a, b: a * b % R, [x, y])
        return cs, (None, [x, y, out])
    raise SystemExit(f"unknown circuit {name!r} (have: venmo, email_verify, sha256, toy)")


def _circuit(args):
    t0 = time.perf_counter()
    _log(f"building circuit {args.circuit} ...")
    cs, meta = _build_circuit(args.circuit, args.max_header, args.max_body)
    _log(f"constraints={cs.num_constraints} wires={cs.num_wires} ({time.perf_counter() - t0:.2f}s)")
    return cs, meta


def cmd_setup(args):
    dev = resolve_device(args.device)
    os.makedirs(args.build_dir, exist_ok=True)
    t0 = time.perf_counter()
    cs, _ = _circuit(args)
    if not args.skip_audit:
        # the registry admission gate: no key material is cut for a
        # circuit with unwaived soundness findings.  Registered names
        # carry their declared on-chain public layout into the
        # public-layout rule.
        from ..models.registry import SPECS
        from ..snark.analysis import audit_circuit, require_clean

        spec = SPECS.get(args.circuit)
        rep = require_clean(audit_circuit(
            cs,
            name=f"{args.circuit}_{args.max_header}_{args.max_body}",
            declared_n_public=spec.n_public if spec else None,
        ))
        _log(
            f"soundness audit clean: 0 unwaived / {rep['waived']} waived "
            f"findings in {rep['audit_s']}s ({rep['source']}, digest {rep['digest']})"
        )
    _log(f"running development setup on {dev} (production: import a ceremony zkey instead)")
    t1 = time.perf_counter()
    key, vk = setup_device(cs, seed=args.seed, device=dev)
    _log(f"setup on {dev} in {time.perf_counter() - t1:.2f}s")
    zkey_path = os.path.join(args.build_dir, "circuit_final.zkey")
    write_zkey_data(zkey_path, zkey_from_key(key, vk))
    if args.chunks:
        split_zkey(zkey_path, args.chunks)
        _log(f"wrote {args.chunks} zkey chunks (b..) beside {zkey_path}")
    if args.publish:
        # gzip chunks, a manifest and the whole's hash into the artifact store
        from ..formats.artifact_store import DirBackend, upload_chunked

        with open(zkey_path, "rb") as f:
            blob = f.read()
        man = upload_chunked(DirBackend(args.publish), "circuit.zkey", blob)
        _log(f"published {len(man.chunks)} gzip chunks -> {args.publish} (sha256 {man.sha256[:16]}…)")
    dump(vkey_to_json(vk), os.path.join(args.build_dir, "verification_key.json"))
    with open(os.path.join(args.build_dir, "verifier.sol"), "w") as f:
        f.write(export_verifier(vk))
    _log(f"setup done in {time.perf_counter() - t0:.1f}s -> {args.build_dir}/")


def _load_zkey(args):
    """--zkey-store: the chunks pulled from that artifact store, each kept
    in <build-dir>/zkey_cache; --zkey: one path, or a glob of the chunks
    b..k taken in sorted order; the build dir's circuit_final.zkey by
    default."""
    if getattr(args, "zkey_store", None):
        from ..formats.artifact_store import DirBackend, download_chunked

        blob = download_chunked(DirBackend(args.zkey_store), "circuit.zkey",
                                cache_dir=os.path.join(args.build_dir, "zkey_cache"))
        return read_zkey(blob)
    if args.zkey:
        if any(c in args.zkey for c in "*?["):
            paths = sorted(glob.glob(args.zkey))
            if not paths:
                raise SystemExit(f"no zkey matches {args.zkey}")
            return read_zkey(paths)
        return read_zkey(args.zkey)
    return read_zkey(os.path.join(args.build_dir, "circuit_final.zkey"))


def _read_witness(path: str, zk):
    """(rows reduced mod r, the public inputs as the file holds them)."""
    raw = read_wtns(path)
    if len(raw) != zk.n_vars:
        raise SystemExit(f"witness has {len(raw)} wires, zkey expects {zk.n_vars}")
    return reduce_rows(raw), row_ints(raw[1 : zk.n_public + 1])


def _check_zkey_matches(zk, cs):
    """Fail fast on a key/circuit mismatch."""
    m = domain_size_for(cs.num_constraints + cs.num_public + 1)
    if zk.n_vars != cs.num_wires or zk.domain_size != m:
        raise SystemExit(
            f"zkey does not match circuit: zkey has {zk.n_vars} wires / domain "
            f"{zk.domain_size}, circuit has {cs.num_wires} / {m} "
            "(check --circuit/--max-header/--max-body against the setup)"
        )


def _witness_for(args, cs, meta, source=None):
    """(witness, public signals) for one input.  `source` is an input
    file path (.eml or .json); None falls back to --eml / --message or
    the synthetic signed email."""
    params, lay = meta
    if args.circuit == "venmo":
        from ..inputs.email import email_from_eml, generate_inputs, make_test_key, make_venmo_email

        src = source or getattr(args, "eml", None)
        if src:
            with open(src, "rb") as f:
                email = email_from_eml(f.read())  # unknown keys raise
            modulus = email.modulus
        else:
            key = make_test_key(1)
            email = make_venmo_email(key)
            modulus = key.n
        inputs = generate_inputs(email, modulus, args.order_id, args.claim_id, params, lay)
        return cs.witness(inputs.public_signals, inputs.seed), inputs.public_signals
    if args.circuit == "email_verify":
        from ..inputs.email import (email_verify_from_eml, generate_email_verify_inputs, make_test_key,
                                    make_twitter_email)

        src = source or getattr(args, "eml", None)
        if src:
            with open(src, "rb") as f:
                email, modulus = email_verify_from_eml(f.read())  # unknown keys raise
        else:
            key = make_test_key(1)
            email, modulus = make_twitter_email(key), key.n
        inputs = generate_email_verify_inputs(email, modulus, params, lay)
        return cs.witness(inputs.public_signals, inputs.seed), inputs.public_signals
    msg = args.message
    if source:
        with open(source) as f:
            msg = json.load(f)["message"]
    if args.circuit == "toy":
        data = (msg or "35").encode().ljust(2, b"\x00")[:2]
        x_v, y_v = data[0], data[1]
        out_v = pow(x_v * y_v, 2, R)
        x, y, _ = lay
        return cs.witness([out_v], {x: x_v, y: y_v}), [out_v]
    from ..inputs.sha_host import sha256_pad

    padded, _ = sha256_pad((msg or "zkp2p").encode(), len(lay))
    return cs.witness([], {w: b for w, b in zip(lay, padded)}), []


def _key(args, zk, dev):
    t0 = time.perf_counter()
    dpk = device_pk_from_zkey(zk, infer_widths=not args.no_infer_widths, device=dev)
    classes = " ".join(f"{q} {getattr(dpk, q + '_nsel').numel()}/{getattr(dpk, q + '_wsel').numel()}" for q in "abc")
    _log(f"key on {dev} in {time.perf_counter() - t0:.2f}s (narrow/wide lanes: {classes})")
    return dpk


def cmd_prove(args):
    dev = resolve_device(args.device)
    if args.wtns:
        t0 = time.perf_counter()
        zk = _load_zkey(args)
        w, pub = _read_witness(args.wtns, zk)
        _log(f"read the zkey and the witness in {time.perf_counter() - t0:.2f}s")
    else:
        cs, meta = _circuit(args)
        t0 = time.perf_counter()
        zk = _load_zkey(args)
        _log(f"read the zkey in {time.perf_counter() - t0:.2f}s")
        _check_zkey_matches(zk, cs)
    dpk = _key(args, zk, dev)
    del zk
    if not args.wtns:
        t0 = time.perf_counter()
        w, pub = _witness_for(args, cs, meta)
        pub = pub or w[1 : cs.num_public + 1]
        _log(f"witness in {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    proof = prove_gpu(dpk, w, device=dev)
    _log(f"proved in {time.perf_counter() - t0:.2f}s (incl. the first call's kernel loads)")
    dump(proof_to_json(proof), args.proof)
    dump(public_to_json(pub), args.public)
    _log(f"wrote {args.proof} {args.public}")


def cmd_verify(args):
    vk = vkey_from_json(load(os.path.join(args.build_dir, "verification_key.json")))
    proof = proof_from_json(load(args.proof))
    pub = [int(x) for x in load(args.public)]
    ok = verify(vk, proof, pub)
    print("OK" if ok else "INVALID")
    sys.exit(0 if ok else 1)


def cmd_batch(args):
    dev = resolve_device(args.device)
    files = sorted(glob.glob(os.path.join(args.indir, "*.wtns")))
    wits, pubs = [], []
    if files:
        zk = _load_zkey(args)
        for fp in files:
            w, pub = _read_witness(fp, zk)
            wits.append(w)
            pubs.append(pub)
    else:
        ext = "*.eml" if args.circuit in ("venmo", "email_verify") else "*.json"
        files = sorted(glob.glob(os.path.join(args.indir, ext)))
        if not files:
            raise SystemExit(f"no *.wtns inputs in {args.indir} (nor {ext} ones of --circuit {args.circuit})")
        cs, meta = _circuit(args)
        zk = _load_zkey(args)
        _check_zkey_matches(zk, cs)
        t0 = time.perf_counter()
        for fp in files:
            w, pub = _witness_for(args, cs, meta, source=fp)
            wits.append(w)
            pubs.append(pub)
        _log(f"{len(wits)} witnesses in {time.perf_counter() - t0:.2f}s")
    dpk = _key(args, zk, dev)
    del zk
    t0 = time.perf_counter()
    proofs = prove_gpu_batch(dpk, wits, chunk=args.chunk, device=dev)
    dt = time.perf_counter() - t0
    _log(f"batch of {len(wits)} proved in {dt:.2f}s -> {len(wits) / dt:.2f} proofs/s")
    os.makedirs(args.outdir, exist_ok=True)
    for fp, proof, pub in zip(files, proofs, pubs):
        base = os.path.basename(fp).rsplit(".", 1)[0]
        dump(proof_to_json(proof), os.path.join(args.outdir, base + ".proof.json"))
        dump(public_to_json(pub), os.path.join(args.outdir, base + ".public.json"))
    _log(f"wrote {len(proofs)} proofs to {args.outdir}")


def cmd_service(args):
    """The batched proving service over a spool directory, until drained
    (SIGTERM / SIGINT), --max-sweeps, --max-seconds or, with
    --exit-when-terminal, every request ended."""
    from .fleet import install_drain_handlers
    from .service import ProvingService

    dev = resolve_device(args.device)
    if args.circuit not in ("venmo", "email_verify"):
        raise SystemExit("service supports the email circuits (venmo, email_verify)")
    cs, meta = _circuit(args)
    zk = _load_zkey(args)
    _check_zkey_matches(zk, cs)
    dpk = _key(args, zk, dev)
    del zk
    vk = vkey_from_json(load(os.path.join(args.build_dir, "verification_key.json")))
    params, lay = meta
    svc_kw = dict(batch_size=args.batch, prefetch=args.prefetch, stale_claim_s=args.stale_claim_s,
                  deadline_s=args.deadline_s, spool_cap=args.spool_cap, slo_p95_s=args.slo_p95_s,
                  ts_sample_s=args.ts_sample_s, device=dev, metrics_port=args.metrics_port,
                  metrics_addr=args.metrics_addr, worker_id=args.worker_id, fleet_id=args.fleet_id,
                  fleet_dir=args.fleet_dir, sched=args.sched, sched_amort=args.sched_amort,
                  sched_target_fill=args.sched_target_fill, sched_priority_default=args.priority_default,
                  worker_tier=args.worker_tier, circuit=args.circuit, perf_ledger=not args.no_perf_ledger,
                  perf_window=args.perf_window, perf_tolerance=args.perf_tolerance, flame=args.flame,
                  flame_hz=args.flame_hz, flame_capture_n=args.flame_capture_n,
                  flame_cooldown_s=args.flame_cooldown_s, cache_dir=args.cache_dir)
    if args.circuit == "venmo":
        svc = ProvingService.for_venmo(cs, lay, params, dpk, vk, **svc_kw)
    else:

        def witness_fn(payload):
            from ..inputs.email import email_verify_from_eml, generate_email_verify_inputs

            with open(payload["eml_path"], "rb") as f:
                email, modulus = email_verify_from_eml(f.read())
            inputs = generate_email_verify_inputs(email, modulus, params, lay)
            return cs.witness(inputs.public_signals, inputs.seed)

        svc = ProvingService(cs, dpk, vk, witness_fn, lambda w: list(w[1 : cs.num_public + 1]), **svc_kw)
    os.makedirs(args.spool, exist_ok=True)
    install_drain_handlers(svc)
    _log(f"service sweeping {args.spool} (batch={args.batch}, sched={args.sched})")
    why = svc.run(args.spool, poll_s=args.poll, max_sweeps=args.max_sweeps, max_seconds=args.max_seconds,
                  exit_when_spool_terminal=args.exit_when_terminal)
    # which kernels this worker ran, in its log
    _log(f"service {args.worker_id or 'solo'} exiting ({why}): launches {_launches()}")
    # 0: drained, every request ended, or the sweeps done; 2: timeout
    sys.exit(0 if why in ("drained", "terminal", "sweeps") else 2)


def cmd_fleet(args):
    """N `service` workers on one spool under ``FleetSupervisor`` until a
    signal drains them, every worker ends, or --max-seconds."""
    from .fleet import FleetSupervisor

    if args.worker_cmd:
        template = json.loads(args.worker_cmd)
        if not isinstance(template, list) or not template:
            raise SystemExit("--worker-cmd must be a non-empty JSON argv list")

        def worker_cmd(wid):
            return [str(t).replace("{wid}", wid).replace("{spool}", args.spool) for t in template]
    else:
        # the workers would each raise without CUDA: say so once, before
        # anything is spawned or written (without initialising CUDA here)
        check_device(args.device)
        base = [sys.executable, "-m", "zkp2p_tpu_torch", "--build-dir", args.build_dir, "--circuit", args.circuit,
                "--max-header", str(args.max_header), "--max-body", str(args.max_body), "service",
                "--spool", args.spool, "--batch", str(args.batch), "--poll", str(args.poll),
                "--prefetch", str(args.prefetch), "--stale-claim-s", str(args.stale_claim_s),
                "--deadline-s", str(args.deadline_s), "--spool-cap", str(args.spool_cap),
                "--slo-p95-s", str(args.slo_p95_s), "--ts-sample-s", str(args.ts_sample_s),
                "--device", args.device]
        if args.zkey:
            base += ["--zkey", args.zkey]
        if args.no_infer_widths:
            base += ["--no-infer-widths"]

        def worker_cmd(_wid):
            return list(base)

    # the perf settings given, as the workers' flags (absent: their defaults)
    perf = {k: getattr(args, k) for k in ("perf_window", "perf_tolerance", "cache_dir", "flame_hz",
                                          "flame_capture_n", "flame_cooldown_s") if getattr(args, k) is not None}
    if args.no_perf_ledger:
        perf["perf_ledger"] = False
    if args.flame:
        perf["flame"] = True
    os.makedirs(args.spool, exist_ok=True)
    sup = FleetSupervisor(args.spool, worker_cmd, workers=args.workers, fleet_dir=args.fleet_dir,
                          drain_timeout_s=args.drain_timeout_s, breaker_k=args.breaker_k,
                          breaker_window_s=args.breaker_window_s, restart_backoff_s=args.restart_backoff_s,
                          rss_soft_mb=args.rss_soft_mb, rss_hard_mb=args.rss_hard_mb, liveness_s=args.liveness_s,
                          fleet_metrics_port=args.fleet_metrics_port, scrape_s=args.fleet_scrape_s,
                          workers_min=args.workers_min, workers_max=args.workers_max, scale_up_s=args.scale_up_s,
                          scale_down_s=args.scale_down_s, sched=args.sched, perf=perf,
                          log=lambda m: _log(f"fleet: {m}"))
    _log(f"fleet {sup.fleet_id}: {sup.n} worker(s) on {args.spool} (fleet dir {sup.fleet_dir}, drain timeout "
         f"{sup.drain_timeout_s:g}s)")
    sys.exit(sup.run(max_seconds=args.max_seconds))


def cmd_top(args):
    """The fleet plane's /status as a terminal frame, every --interval
    seconds (or once).  The endpoint is --url, --port on 127.0.0.1, or the
    port in --fleet-dir's status.json."""
    from .fleet_obs import discover_fleet_port, http_status_json, render_top

    if args.url:
        url = args.url.rstrip("/") + ("" if args.url.rstrip("/").endswith("/status") else "/status")
    else:
        port = args.port
        if port is None and args.fleet_dir:
            port = discover_fleet_port(args.fleet_dir)
            if port is None:
                raise SystemExit(f"{args.fleet_dir}/status.json has no metrics_port: is the fleet running with "
                                 "--fleet-metrics-port?")
        if port is None:
            raise SystemExit("top needs --url, --port or --fleet-dir")
        url = f"http://127.0.0.1:{port}/status"
    try:
        while True:
            # a 503 body renders (its reason is the point); no answer
            # renders as unreachable
            body = http_status_json(url, timeout=5) or {"ok": False, "reason": f"unreachable: {url}"}
            frame = render_top(body)
            if args.once:
                print(frame)
                return
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        print()  # the last frame stays on the screen


def _metrics_port(v: str) -> int:
    """--metrics-port: "auto" (or 0) for a port the OS chooses, else N."""
    if v == "auto":
        return 0
    try:
        port = int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(f"want a port, 'auto' or 0, not {v!r}") from None
    if not 0 <= port < 65536:
        raise argparse.ArgumentTypeError(f"port {port} out of range")
    return port


def _launches() -> str:
    """This process's kernel launches so far, as JSON."""
    return json.dumps({k[3:]: v for k, v in cuda_build.LAUNCHES.items() if v})


def _log_stages(what: str, stages: dict) -> None:
    _log(f"{what}: " + ", ".join(f"{k[2:]} {v:.2f}" for k, v in stages.items()) + f" s; launches {_launches()}")


def cmd_ceremony(args):
    """The phase-2 MPC over zkeys (snarkjs's zkey contribute / beacon /
    verify)."""
    from ..snark import ceremony

    if args.op == "beacon" and not args.beacon_hash:
        print("beacon requires --beacon-hash", file=sys.stderr)
        sys.exit(2)
    dev = resolve_device(args.device)
    stages = {}
    if args.op == "contribute":
        ceremony.contribute(args.zkey_in, args.zkey_out, args.entropy.encode(), name=args.name, device=dev,
                            stages=stages)
        _log_stages("contribute", stages)
        print(f"contributed -> {args.zkey_out}")
    elif args.op == "beacon":
        ceremony.beacon(args.zkey_in, args.zkey_out, bytes.fromhex(args.beacon_hash), iter_exp=args.iter_exp,
                        name=args.name or "final beacon", device=dev, stages=stages)
        _log_stages("beacon", stages)
        print(f"beacon applied -> {args.zkey_out}")
    else:
        ok, log = ceremony.verify_chain(args.zkey_in, args.zkey_out, device=dev, stages=stages)
        _log_stages("verify", stages)
        for line in log:
            print(line)
        print("ZKEY OK" if ok else "ZKEY INVALID")
        sys.exit(0 if ok else 1)


def cmd_doctor(args):
    """The preflight report (utils.audit.preflight): text on stderr, or
    with --json one JSON object on stdout; --strict exits 1 on any
    warning."""
    from ..utils.audit import WORKLOAD_ELEMENTS, preflight

    rep = preflight(workload=not args.no_workload)
    if args.json:
        print(json.dumps(rep))
    else:
        dev = rep["device"]
        _log(f"backend: {rep['backend']}" + (f"   device: {dev['name']} (compute capability "
                                                f"{dev['capability']}, {dev['count']} card(s))" if dev else ""))
        _log("kernels:")
        for stem, k in rep["kernels"].items():
            _log(f"  {stem:<12} {'built' if k['built'] else 'not built':<10} {', '.join(k['launchers'])}")
        _log("gates:")
        for gate, arm in sorted(rep["gates"].items()):
            _log(f"  {gate:<22} = {arm}")
        if rep.get("workload_s") is not None:
            _log(f"workload: K1 over {WORKLOAD_ELEMENTS} elements, checked against its plain version, in "
                 f"{rep['workload_s']}s")
        mem = rep.get("device_memory")
        if mem:
            _log(f"device memory: {mem['bytes_in_use'] / 2**30:.2f} GiB in use, peak "
                 f"{mem['peak_bytes_in_use'] / 2**30:.2f} GiB of {mem['bytes_limit'] / 2**30:.2f} GiB")
        _log(f"execution digest: {rep['execution_digest']}")
        for w in rep["warnings"]:
            _log(f"WARNING: {w}")
        if not rep["warnings"]:
            _log("no warnings")
    if args.strict and rep["warnings"]:
        sys.exit(1)


def cmd_perf(args):
    """The perf sentry over the card's stage-cost ledger: the trendlines and
    verdicts against the current budgets; --rebaseline freezes them as the
    band, --gate replays the ledger's head against the band (rc 1 drift,
    rc 2 fail closed).  A DRIFT or REGRESSED row names the newest flame
    capture of its stage beside the ledger."""
    from ..utils import flameprof
    from ..utils import perfledger as pl

    dev = resolve_device(args.device)
    ledger = args.ledger or pl.ledger_path(pl.DEFAULT_CACHE_DIR, dev)
    captures = os.path.dirname(os.path.abspath(ledger))
    did_action = False
    if args.rebaseline:
        did_action = True
        doc = pl.write_baseline(args.baseline or None, ledger, window=args.window, tolerance=args.tolerance,
                                device=dev)
        if doc is None:
            _log("perf: rebaseline FAILED — no valid ledger entries to freeze (run a service sweep first)")
            sys.exit(2)
        bands = sum(len(v) for v in doc["bands"].values())
        _log(f"perf: baseline frozen — {bands} band(s), window={doc['window']} tolerance={doc['tolerance']:g}")
    if args.gate:
        rc, verdicts = pl.gate_check(args.baseline or None, ledger, log=_log, device=dev)
        for v in verdicts:
            if v["verdict"] in ("new", "gone"):
                print(f"{v['verdict']:<8} {v['circuit']}/{v['stage']}")
                continue
            print(f"{v['verdict']:<8} {v['circuit']}/{v['stage']}: head p50 {v['p50_ms']:.1f} ms vs budget "
                  f"{v['budget_ms']:.1f} ms (band median {v['median_ms']:.1f} ms)")
            if v["verdict"] == "DRIFT":
                for cpath, cdoc in flameprof.captures_for(v["circuit"], captures, v["stage"])[:1]:
                    print(f"       capture: {cpath} (trigger {cdoc.get('trigger')}, entry {cdoc.get('entry_digest')})")
        drifts = sum(1 for v in verdicts if v["verdict"] == "DRIFT")
        improved = sum(1 for v in verdicts if v["verdict"] == "IMPROVED")
        print(f"perf-gate: {'DRIFT' if rc == 1 else 'FAIL CLOSED' if rc else 'ok'} "
              f"({drifts} drifting stage(s) of {len(verdicts)})")
        # a head well under its band: the band has gone loose
        if improved:
            print(f"perf-gate: {improved} IMPROVED stage(s) — band is stale-loose; freeze the new floor with "
                  "`zkp2p-tpu-torch perf --rebaseline`")
        sys.exit(rc)
    if did_action:
        return
    entries, refused = pl.load_entries(ledger, device=dev)
    if not entries:
        _log(f"perf: no valid ledger entries for this host (refused: {refused})")
        sys.exit(1)
    budgets = pl.derive_budgets(entries, window=args.window, tolerance=args.tolerance)
    series = {}
    for e in entries:
        circuit = str(e.get("circuit", "?"))
        if args.circuit_filter and circuit != args.circuit_filter:
            continue
        for stage, st in e["stages"].items():
            if args.stage and args.stage not in stage:
                continue
            series.setdefault((circuit, stage), []).append(float(st["p50_ms"]))
    if args.json:
        print(json.dumps({"budgets": budgets, "series": {f"{c}/{s}": v for (c, s), v in sorted(series.items())},
                          "refused": refused}, indent=1, sort_keys=True))
        return
    marks = "_.-=#"  # low .. high within each stage's own range
    for (circuit, stage), vals in sorted(series.items()):
        lo, hi = min(vals), max(vals)
        span = (hi - lo) or 1.0
        line = "".join(marks[int((v - lo) / span * (len(marks) - 1))] for v in vals[-48:])
        b = (budgets.get(circuit) or {}).get(stage)
        verdict = "no-budget" if b is None else ("REGRESSED" if vals[-1] > b["budget_ms"] else "ok")
        print(f"{circuit}/{stage:<28} [{line}] last {vals[-1]:.1f} ms "
              + (f"budget {b['budget_ms']:.1f} ms " if b else "") + f"(n={len(vals)}) {verdict}")
        if verdict == "REGRESSED":
            for cpath, cdoc in flameprof.captures_for(circuit, captures, stage)[:1]:
                print(f"    capture: {cpath} (trigger {cdoc.get('trigger')}, entry {cdoc.get('entry_digest')})")
    if any(refused.values()):
        _log(f"perf: refused entries: {refused} (window={args.window} tolerance={args.tolerance:g})")


def cmd_flame(args):
    """An on-demand flame profile: prove_gpu in a loop for --duration
    seconds under the sampler, after one warm-up proof outside it; the
    collapsed stacks on stdout, a trigger="manual" capture beside the perf
    ledger."""
    from ..utils import flameprof

    dev = resolve_device(args.device)
    _log(f"flame: arm {flameprof.flame_arm(True, args.hz)}")
    cs, meta = _circuit(args)
    try:
        zk = _load_zkey(args)
        _check_zkey_matches(zk, cs)
    except (OSError, SystemExit):
        # no zkey for this circuit: the dev setup keeps the command
        # self-contained (the profile's shape matters, not the key's origin)
        _log(f"flame: no zkey found — running the dev setup on {dev}")
        dpk, _vk = setup_device(cs, seed="flame-profile", device=dev)
    else:
        dpk = _key(args, zk, dev)
        del zk
    w, _pub = _witness_for(args, cs, meta)

    def prove():
        return prove_gpu(dpk, w, device=dev)

    prove()  # the first call's kernel loads and tables are not the steady state
    sampler, seconds = flameprof.profile_proves(prove, args.duration, hz=args.hz)
    path = flameprof.write_capture(sampler, args.circuit, "on-demand", "manual", args.cache_dir)
    body = sampler.result()
    _log(f"flame: {len(seconds)} prove(s) in {body['duration_s']:.1f}s — {body['samples']} samples over "
         f"{body['windows']} windows @ {args.hz:g} Hz, sampler self-cost {body['sampler']['self_ms']:.1f} ms; "
         f"launches {json.dumps(body['gpu_launches'], sort_keys=True)}")
    _log(f"flame: capture -> {path}" if path else "flame: capture NOT persisted")
    print(flameprof.collapsed_text(body["stacks"]))


def main(argv=None):
    from ..utils import flameprof, perfledger as pl

    ap = argparse.ArgumentParser("zkp2p-tpu-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--build-dir", default="build",
                    help="where setup writes its files, verify reads verification_key.json and prove the "
                         "default zkey")
    ap.add_argument("--circuit", default="sha256", help="venmo, email_verify, sha256 (default) or toy")
    ap.add_argument("--max-header", type=int, default=256)
    ap.add_argument("--max-body", type=int, default=192)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device_arg(s):
        s.add_argument("--device", default="cuda", help="cuda (default) or cpu (the kernels' plain versions)")

    def zkey_args(s):
        s.add_argument("--zkey", help="zkey path or chunk glob (default: BUILD_DIR/circuit_final.zkey)")
        s.add_argument("--no-infer-widths", action="store_true",
                       help="disable the zkey bit-constraint width inference (use when the circuit "
                            "contains x*(x-1)=y rows)")
        device_arg(s)
        s.add_argument("--trace", help="append this run's trace spans (gpu/prove, gpu/prove_batch), after a "
                                       "manifest line, to this JSON-lines file")
        s.add_argument("--order-id", type=int, default=1)
        s.add_argument("--claim-id", type=int, default=0)

    def perf_args(s, fleet):
        # the service's perf sentry and flame settings; a fleet's default
        # None leaves a worker its own (the service's defaults, below)
        def dflt(v):
            return None if fleet else v

        note = f" ({fleet})" if fleet else ""
        s.add_argument("--no-perf-ledger", action="store_true",
                       help="turn the perf sentry off: no budgets, no overrun checks, no ledger stamp" + note)
        s.add_argument("--perf-window", type=int, default=dflt(pl.DEFAULT_WINDOW),
                       help=f"ledger entries a stage budget's median is taken over (default {pl.DEFAULT_WINDOW})"
                            + note)
        s.add_argument("--perf-tolerance", type=float, default=dflt(pl.DEFAULT_TOLERANCE),
                       help=f"a stage budget's multiple of that median, >= 1 (default {pl.DEFAULT_TOLERANCE:g})"
                            + note)
        s.add_argument("--cache-dir", default=dflt(pl.DEFAULT_CACHE_DIR),
                       help="where the perf ledger and the flame captures live (default <repo>/.bench_cache)"
                            + note)
        s.add_argument("--flame", action="store_true",
                       help="a budget overrun starts a flame capture over the next sweeps" + note)
        s.add_argument("--flame-hz", type=float, default=dflt(flameprof.DEFAULT_HZ),
                       help=f"the flame sampler's rate in Hz (default {flameprof.DEFAULT_HZ:g})" + note)
        s.add_argument("--flame-capture-n", type=int, default=dflt(flameprof.DEFAULT_CAPTURE_N),
                       help=f"sweeps a triggered capture spans (default {flameprof.DEFAULT_CAPTURE_N})" + note)
        s.add_argument("--flame-cooldown-s", type=float, default=dflt(flameprof.DEFAULT_COOLDOWN_S),
                       help=f"least seconds between two triggered captures (default "
                            f"{flameprof.DEFAULT_COOLDOWN_S:g})" + note)

    s = sub.add_parser("setup", help="build the circuit, set it up on the card, write the zkey, vkey and "
                                     "verifier.sol")
    s.add_argument("--skip-audit", action="store_true",
                   help="bypass the circuit soundness audit (admission gate)")
    s.add_argument("--seed", default="zkp2p-tpu-dev")
    s.add_argument("--chunks", type=int, default=0, help="also split the zkey into N chunks (b..)")
    s.add_argument("--publish", help="artifact-store dir: upload gzip zkey chunks + manifest")
    device_arg(s)
    s.set_defaults(fn=cmd_setup)

    s = sub.add_parser("prove", help="prove one input (a .wtns, or the circuit's input) against a .zkey")
    zkey_args(s)
    s.add_argument("--zkey-store", help="artifact-store dir to pull the chunked zkey from")
    s.add_argument("--wtns", help="circom witness file (no circuit is built)")
    s.add_argument("--eml", help="email file (venmo / email_verify circuits)")
    s.add_argument("--demo", action="store_true", help="use the synthetic signed email")
    s.add_argument("--message", help="message (sha256, toy circuits)")
    s.add_argument("--proof", default="proof.json")
    s.add_argument("--public", default="public.json")
    s.set_defaults(fn=cmd_prove)

    s = sub.add_parser("verify", help="verify proof.json against the build dir's verification_key.json")
    s.add_argument("--proof", default="proof.json")
    s.add_argument("--public", default="public.json")
    s.set_defaults(fn=cmd_verify)

    s = sub.add_parser("batch", help="prove every input of a directory as one batch")
    zkey_args(s)
    s.add_argument("--indir", required=True)
    s.add_argument("--outdir", required=True)
    s.add_argument("--chunk", type=int, default=4, help="witnesses a device pass (0: all in one)")
    s.add_argument("--message", help=argparse.SUPPRESS)
    s.set_defaults(fn=cmd_batch)

    s = sub.add_parser("service", help="run the batched proving service over a spool directory")
    s.add_argument("--spool", required=True)
    s.add_argument("--batch", type=int, default=4)
    s.add_argument("--poll", type=float, default=1.0)
    s.add_argument("--max-sweeps", type=int, default=None)
    s.add_argument("--zkey", help="zkey path or chunk glob (default: BUILD_DIR/circuit_final.zkey)")
    s.add_argument("--no-infer-widths", action="store_true",
                   help="disable the zkey bit-constraint width inference")
    device_arg(s)
    s.add_argument("--prefetch", type=int, default=1, help="ready-batch queue depth")
    s.add_argument("--stale-claim-s", type=float, default=300.0,
                   help="claim age after which a dead worker's request is taken over")
    s.add_argument("--deadline-s", type=float, default=0.0,
                   help="default per-request deadline in s (a payload's deadline_s overrides it; 0 = none)")
    s.add_argument("--spool-cap", type=int, default=0,
                   help="pending requests admitted a sweep; the newest beyond it are shed as error-shed "
                        "(0 = unlimited)")
    s.add_argument("--slo-p95-s", type=float, default=0.0, help="p95 latency objective in s (0 = none)")
    s.add_argument("--ts-sample-s", type=float, default=10.0, help="time-series sampler interval in s (0 = off)")
    s.add_argument("--max-seconds", type=float, default=None, help="exit (rc 2) after this many seconds")
    s.add_argument("--exit-when-terminal", action="store_true",
                   help="exit 0 once every spool request has a terminal artifact")
    s.add_argument("--metrics-port", type=_metrics_port, default=None,
                   help="serve /metrics, /status, /healthz and /snapshot on this port ('auto' or 0: one the OS "
                        "chooses, logged and in the heartbeat; default: off)")
    s.add_argument("--metrics-addr", default="127.0.0.1", help="the endpoint's address (default 127.0.0.1)")
    s.add_argument("--worker-id", default="", help="this worker's id in a fleet (the supervisor sets it)")
    s.add_argument("--fleet-id", default="", help="the fleet's id (the supervisor sets it)")
    s.add_argument("--sched", choices=["off", "adaptive"], default="off",
                   help="admission and batching: off = the static batch_size slices and newest-first shed; adaptive "
                        "= batches sized against the deadline / objective, shedding by predicted miss, priority "
                        "lanes")
    s.add_argument("--sched-amort", default="",
                   help="the adaptive controller's batch cost curve 'S:seconds,...' (default: the built-in curve)")
    s.add_argument("--sched-target-fill", type=float, default=0.8,
                   help="the share of a request's deadline / objective its batch is planned to fill")
    s.add_argument("--priority-default", choices=["interactive", "bulk"], default="bulk",
                   help="the lane of a request whose payload names no valid priority")
    s.add_argument("--worker-tier", default="",
                   help="the tier this worker advertises to its peers: sharded or native (anything else)")
    s.add_argument("--fleet-dir", default="",
                   help="the fleet's heartbeat / control directory (the supervisor sets it; default: solo)")
    perf_args(s, None)
    s.set_defaults(fn=cmd_service)

    s = sub.add_parser("fleet", help="supervise N service workers on one spool (restarts, breaker, drain, "
                                     "RSS governor)")
    s.add_argument("--spool", required=True)
    s.add_argument("--workers", type=int, default=2)
    s.add_argument("--batch", type=int, default=4)
    s.add_argument("--poll", type=float, default=1.0)
    s.add_argument("--zkey", help="zkey path or chunk glob (default: BUILD_DIR/circuit_final.zkey)")
    s.add_argument("--no-infer-widths", action="store_true",
                   help="disable the zkey bit-constraint width inference")
    s.add_argument("--prefetch", type=int, default=1)
    s.add_argument("--stale-claim-s", type=float, default=300.0)
    s.add_argument("--deadline-s", type=float, default=0.0)
    s.add_argument("--spool-cap", type=int, default=0)
    s.add_argument("--slo-p95-s", type=float, default=0.0)
    s.add_argument("--ts-sample-s", type=float, default=10.0)
    s.add_argument("--fleet-dir", default=None, help="heartbeat / ctl / status directory (default: SPOOL/.fleet)")
    s.add_argument("--drain-timeout-s", type=float, default=30.0,
                   help="the wait between a drain's SIGTERM and its SIGKILL")
    s.add_argument("--liveness-s", type=float, default=60.0,
                   help="heartbeat age past which a live worker counts as hung")
    s.add_argument("--rss-soft-mb", type=int, default=0,
                   help="a worker's RSS over this gets the soft degrade (0: off)")
    s.add_argument("--rss-hard-mb", type=int, default=0,
                   help="a worker's RSS over this is drained and restarted (0: off)")
    s.add_argument("--breaker-k", type=int, default=5, help="failures inside the window that park a worker")
    s.add_argument("--breaker-window-s", type=float, default=60.0)
    s.add_argument("--restart-backoff-s", type=float, default=0.5, help="the exponential restart backoff's base")
    s.add_argument("--max-seconds", type=float, default=None, help="drain and exit after this long")
    s.add_argument("--worker-cmd", default=None,
                   help="each worker's argv as a JSON list ('{wid}' and '{spool}' substituted; the identity "
                        "flags appended); default: this CLI's service")
    s.add_argument("--fleet-metrics-port", type=_metrics_port, default=None,
                   help="serve the fleet plane's merged /metrics, /status and /healthz on this port ('auto' or 0: "
                        "one the OS chooses, in status.json; default: off)")
    s.add_argument("--sched", choices=["off", "adaptive"], default=None,
                   help="the workers' scheduler arm, appended to each worker's argv (default: theirs, off)")
    s.add_argument("--workers-min", type=int, default=0, help="the autoscaler's floor (at least 1 when it is on)")
    s.add_argument("--workers-max", type=int, default=0,
                   help="the autoscaler's ceiling; 0 = autoscaling off (on, it runs the fleet plane)")
    s.add_argument("--scale-up-s", type=float, default=10.0,
                   help="how long backlog growth or an SLO burn must hold before a worker is added")
    s.add_argument("--scale-down-s", type=float, default=30.0,
                   help="how long an empty backlog must hold before the newest worker is retired")
    s.add_argument("--fleet-scrape-s", type=float, default=2.0,
                   help="the fleet plane's interval between scrapes of the workers' /snapshot")
    perf_args(s, "appended to each worker's argv; default: the worker's")
    device_arg(s)
    s.set_defaults(fn=cmd_fleet)

    s = sub.add_parser("top", help="the fleet plane's /status as a live terminal view")
    s.add_argument("--url", help="the fleet's status URL (before --port and --fleet-dir)")
    s.add_argument("--port", type=int, default=None, help="the fleet plane's port on 127.0.0.1")
    s.add_argument("--fleet-dir", help="read the port from <fleet-dir>/status.json")
    s.add_argument("--interval", type=float, default=2.0, help="seconds between frames")
    s.add_argument("--once", action="store_true", help="print one frame and exit")
    s.set_defaults(fn=cmd_top)

    s = sub.add_parser("ceremony", help="phase-2 zkey MPC: contribute / beacon / verify")
    s.add_argument("op", choices=["contribute", "beacon", "verify"])
    s.add_argument("zkey_in", help="input zkey (for verify: the trusted initial zkey)")
    s.add_argument("zkey_out", help="output zkey (for verify: the final zkey to check)")
    s.add_argument("--entropy", default="", help="contributor entropy string (contribute)")
    s.add_argument("--name", default="", help="contributor name recorded in the transcript")
    s.add_argument("--beacon-hash", default="", help="public beacon value, hex (beacon)")
    s.add_argument("--iter-exp", type=int, default=10, help="beacon hash iterations = 2^n (beacon)")
    device_arg(s)
    s.set_defaults(fn=cmd_ceremony)

    s = sub.add_parser("doctor", help="preflight: backend, card, kernels, every gate's arm and the digest")
    s.add_argument("--json", action="store_true", help="machine-readable report on stdout")
    s.add_argument("--no-workload", action="store_true", help="skip the K1 launch")
    s.add_argument("--strict", action="store_true", help="exit 1 when the report has a warning")
    s.set_defaults(fn=cmd_doctor)

    s = sub.add_parser("perf", help="perf sentry: ledger trendlines, stage budgets, the baseline drift gate")
    s.add_argument("--ledger", default="", help="ledger path (default: the card's, in <repo>/.bench_cache)")
    s.add_argument("--baseline", default="", help="baseline path (default: PERF_BASELINE_GPU.json at the repo root)")
    s.add_argument("--circuit", dest="circuit_filter", default="", help="the trendlines of one circuit label only")
    s.add_argument("--stage", default="", help="a substring the stage names must hold")
    s.add_argument("--window", type=int, default=pl.DEFAULT_WINDOW,
                   help="the budgets' trailing window in ledger entries")
    s.add_argument("--tolerance", type=float, default=pl.DEFAULT_TOLERANCE,
                   help="the budgets' multiple of the window's median")
    s.add_argument("--json", action="store_true", help="the budgets, series and refused counts as JSON")
    s.add_argument("--rebaseline", action="store_true", help="freeze the current budgets as the baseline band")
    s.add_argument("--gate", action="store_true",
                   help="replay the ledger's head against the baseline band; rc 1 drift, rc 2 fail closed")
    device_arg(s)
    s.set_defaults(fn=cmd_perf)

    s = sub.add_parser("flame", help="a prove loop under the flame sampler: collapsed stacks on stdout and a "
                                     "capture beside the perf ledger")
    s.add_argument("--duration", type=float, default=30.0,
                   help="the prove loop's wall clock in s (at least one proof runs)")
    s.add_argument("--hz", type=float, default=flameprof.DEFAULT_HZ,
                   help=f"the sampling rate (default {flameprof.DEFAULT_HZ:g})")
    s.add_argument("--cache-dir", default=pl.DEFAULT_CACHE_DIR,
                   help="where the capture is written (default <repo>/.bench_cache)")
    s.add_argument("--zkey", help="zkey path or chunk glob (default: BUILD_DIR/circuit_final.zkey; none: the dev "
                                  "setup on the card)")
    s.add_argument("--no-infer-widths", action="store_true",
                   help="disable the zkey bit-constraint width inference")
    s.add_argument("--message", help=argparse.SUPPRESS)
    s.add_argument("--eml", help=argparse.SUPPRESS)
    s.add_argument("--order-id", type=int, default=1)
    s.add_argument("--claim-id", type=int, default=0)
    device_arg(s)
    s.set_defaults(fn=cmd_flame)

    args = ap.parse_args(argv)
    try:
        args.fn(args)
    finally:
        if getattr(args, "trace", None):
            dump_trace(args.trace)
    peak, source = _peak_rss()
    _log(f"peak host RSS {peak:.2f} GiB ({source})")
