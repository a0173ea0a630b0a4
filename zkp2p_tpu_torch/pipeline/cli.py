"""The port's command line: the snarkjs / rapidsnark drop-in prover on
one NVIDIA GPU (after the reference's ``pipeline/cli.py``).

  prove    a .zkey and a circom .wtns in, proof.json and public.json out
           (``snarkjs groth16 prove`` / rapidsnark), through ``prove_gpu``
  verify   proof.json and public.json against
           <build-dir>/verification_key.json; prints OK (exit 0) or
           INVALID (exit 1).  Runs on the host, as snarkjs's does.
  batch    every *.wtns of a directory against one .zkey, through
           ``prove_gpu_batch``; <name>.proof.json and <name>.public.json

    python -m zkp2p_tpu_torch prove --zkey build/circuit_final.zkey --wtns witness.wtns
    python -m zkp2p_tpu_torch verify
    python -m zkp2p_tpu_torch batch --indir wtns/ --outdir proofs/

``prove`` and ``batch`` run on the CUDA card (``--device cuda``, the
default) and raise before reading a file when there is none; ``--device
cpu`` runs the plain versions of the kernels.  The port builds no
circuit, so the witness comes as a .wtns: its values are proved as
their residues mod r, and public.json carries them as the file holds
them, as the reference does.  ``--trace FILE`` appends the run's spans
and its manifest (device, versions, gate arms and their digest) to FILE,
so that a caller reads them from outside the process.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

from ..formats.circom_bin import read_wtns, reduce_rows, row_ints
from ..formats.proof_json import dump, load, proof_from_json, proof_to_json, public_to_json, vkey_from_json
from ..formats.zkey import read_zkey
from ..prover.groth16_gpu import device_pk_from_zkey, prove_gpu, prove_gpu_batch
from ..snark.groth16 import verify
from ..utils.device import resolve_device
from ..utils.trace import dump_trace


def _log(*a):
    print("[zkp2p-tpu-torch]", *a, file=sys.stderr, flush=True)


def _load_zkey(args):
    """--zkey: one path, or a glob of the chunks b..k taken in sorted
    order; the build dir's circuit_final.zkey by default."""
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


def _key(args, zk, dev):
    t0 = time.perf_counter()
    dpk = device_pk_from_zkey(zk, infer_widths=not args.no_infer_widths, device=dev)
    _log(f"key on {dev} in {time.perf_counter() - t0:.2f}s")
    return dpk


def cmd_prove(args):
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    zk = _load_zkey(args)
    w, pub = _read_witness(args.wtns, zk)
    _log(f"read the zkey and the witness in {time.perf_counter() - t0:.2f}s")
    dpk = _key(args, zk, dev)
    del zk
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
    if not files:
        raise SystemExit(f"no *.wtns inputs in {args.indir}")
    zk = _load_zkey(args)
    wits, pubs = [], []
    for fp in files:
        w, pub = _read_witness(fp, zk)
        wits.append(w)
        pubs.append(pub)
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


def main(argv=None):
    ap = argparse.ArgumentParser("zkp2p-tpu-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--build-dir", default="build",
                    help="where verify reads verification_key.json and prove the default zkey")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def zkey_args(s):
        s.add_argument("--zkey", help="zkey path or chunk glob (default: BUILD_DIR/circuit_final.zkey)")
        s.add_argument("--no-infer-widths", action="store_true",
                       help="disable the zkey bit-constraint width inference (use when the circuit "
                            "contains x*(x-1)=y rows)")
        s.add_argument("--device", default="cuda", help="cuda (default) or cpu (the kernels' plain versions)")
        s.add_argument("--trace", help="append this run's trace spans (gpu/prove, gpu/prove_batch), after a "
                                       "manifest line, to this JSON-lines file")

    s = sub.add_parser("prove", help="prove one .wtns against a .zkey")
    zkey_args(s)
    s.add_argument("--wtns", required=True, help="circom witness file")
    s.add_argument("--proof", default="proof.json")
    s.add_argument("--public", default="public.json")
    s.set_defaults(fn=cmd_prove)

    s = sub.add_parser("verify", help="verify proof.json against the build dir's verification_key.json")
    s.add_argument("--proof", default="proof.json")
    s.add_argument("--public", default="public.json")
    s.set_defaults(fn=cmd_verify)

    s = sub.add_parser("batch", help="prove every *.wtns of a directory as one batch")
    zkey_args(s)
    s.add_argument("--indir", required=True)
    s.add_argument("--outdir", required=True)
    s.add_argument("--chunk", type=int, default=4, help="witnesses a device pass (0: all in one)")
    s.set_defaults(fn=cmd_batch)

    args = ap.parse_args(argv)
    try:
        args.fn(args)
    finally:
        if getattr(args, "trace", None):
            dump_trace(args.trace)
