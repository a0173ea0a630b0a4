"""Variants of K19 (csrc/scale.cu) timed on one CUDA card beside the
kernel as built, at the ceremony's shape: what its square, its called
products and its blocks an SM buy, and what the GLV ladder buys over the
full-scalar NAF ladder of the same kernel.

    python3 -m zkp2p_tpu_torch.tools.scale_variants   # from the root of a checkout, one H100

The points are the ceremony's 13,305,359 C and H points, made on the card
as K17 multiples of the generator and normalised by K15.  Each variant is
csrc/scale.cu with one change, built with the port's nvcc flags into
zkp2p_tpu_torch/_build/variants/ (all at once), held bitwise against the
kernel as built and timed in two turns (variants, then the same in
reverse) with CUDA events, one warm-up launch before each timed one.
"as built, every point off the curve" runs the kernel on the same points
with y + 1: every point takes the full-scalar NAF ladder.

Prints the card's name and power limit, each variant's ptxas registers
and spills as it builds, then one JSON line: {variant: [ms, ms]}.  About
3 minutes.
"""

from __future__ import annotations

import ctypes
import json
import random
import subprocess

import torch

from ..curve import host
from ..field.tfield import FQ
from ..ops import cuda_build
from ..ops.cuda_fixed_base import fixed_base, fixed_base_table
from ..ops.cuda_mont import field_consts
from ..ops.cuda_scale import g1_scale, op_block
from ..ops.msm_affine import jac_to_affine_batch

N_POINTS = 4916751 + 8388608  # the flagship's C and H queries

# an inlined policy, and a called one whose square is a product
POLICIES = '''
struct MulInlineCC {
  __device__ __forceinline__ static Fe mul(const Fe& a, const Fe& b, const FieldConst& c) { return fe_mul_cc(a, b, c); }
  __device__ __forceinline__ static Fe sqr(const Fe& a, const FieldConst& c) { return fe_sqr_cc(a, c); }
};
struct MulCallNoSqr {
  __device__ __forceinline__ static Fe mul(const Fe& a, const Fe& b, const FieldConst&) { return scale_mul(a, b); }
  __device__ __forceinline__ static Fe sqr(const Fe& a, const FieldConst&) { return scale_mul(a, a); }
};
'''

# variant -> (product policy of k_g1_scale, its blocks an SM)
VARIANTS = {
    "calls, no square": ("MulCallNoSqr", 4),
    "calls, 3 blocks": ("MulCallCC", 3),
    "calls, 2 blocks": ("MulCallCC", 2),
    "inlined, 2 blocks": ("MulInlineCC", 2),
    "inlined, 1 block": ("MulInlineCC", 1),
}


def variant_source(src: str, policy: str, blocks: int) -> str:
    out = src.replace("struct ScaleOps {", POLICIES + "\nstruct ScaleOps {", 1)
    out = out.replace("SCALE_MIN_BLOCKS = 4;", f"SCALE_MIN_BLOCKS = {blocks};", 1)
    head, kernel = out.split("k_g1_scale(const", 1)
    kernel, tail = kernel.split("// The comparator", 1)
    return head + "k_g1_scale(const" + kernel.replace("<MulCallCC>", f"<{policy}>") + "// The comparator" + tail


def build_variants():
    """name -> its library's zk_g1_scale; the ptxas lines of k_g1_scale printed."""
    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (cuda_build.CSRC_DIR / "scale.cu").read_text()
    procs = {}
    for k, (name, (policy, blocks)) in enumerate(VARIANTS.items()):
        cu = out_dir / f"scale_v{k}.cu"
        cu.write_text(variant_source(src, policy, blocks))
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC_DIR), "-o",
               str(cu.with_suffix(".so")), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), cu.with_suffix(".so"))
    fns = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        lines = log.splitlines()
        at = next(i for i, line in enumerate(lines) if "k_g1_scaleP" in line and "properties" in line)
        print(f"{name}: " + "; ".join(line.strip() for line in lines[at + 1:at + 3]), flush=True)
        fn = ctypes.CDLL(str(lib)).zk_g1_scale
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def event_ms(fn) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    cuda_build.build_all(["scale", "fixed_base", "batch_inv"])
    fns = build_variants()
    gen = torch.Generator(device=dev).manual_seed(19)
    k_pts = torch.randint(0, 1 << 16, (N_POINTS, 16), generator=gen, device=dev, dtype=torch.int32)
    k_pts[:, 15] &= 0x0FFF  # below r
    x, y = jac_to_affine_batch(FQ, fixed_base(False, fixed_base_table(False, host.G1_GENERATOR, dev), k_pts))
    del k_pts
    y_off = FQ.add(y, FQ.const("one", dev).int().expand_as(y))
    k = random.Random(19).randrange(1, FQ.modulus)
    block, consts = op_block(k), field_consts(FQ)
    want = [c.clone() for c in g1_scale((x, y), k)]
    out = tuple(torch.empty_like(x) for _ in range(3))

    def launch(fn):
        def run():
            err = fn(x.data_ptr(), y.data_ptr(), *(c.data_ptr() for c in out), N_POINTS, block.ctypes.data,
                     consts.ctypes.data, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"cudaError {err}")
        return run

    runs = {"as built": lambda: g1_scale((x, y), k), **{name: launch(fn) for name, fn in fns.items()},
            "as built, every point off the curve": lambda: g1_scale((x, y_off), k)}
    times = {}
    for name in list(runs) + list(runs)[::-1]:
        times.setdefault(name, []).append(event_ms(runs[name]))
        if name in fns and not all(torch.equal(a, b) for a, b in zip(out, want)):
            raise AssertionError(f"variant {name} differs from the kernel as built")
    print(json.dumps({"k19_variants_ms": times, "points": N_POINTS, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
