#!/usr/bin/env python3
"""Variants of the PyTorch port's K17 and K18 designs, timed on one CUDA
card beside the kernels as built: what their product, geometry and
cooperative add buy.

    python3 tools/kernel_variants.py     # from the root of a checkout, one H100

1. The Montgomery product and the point add: mont.cuh's fe_mul (MulC)
   against mont_cc.cuh's PTX product (MulCC), in a chain of dependent
   products or adds run by one warp (its latency) and by 132 x 2,048
   (products) or 132 x 1,024 (adds) threads (throughput), G1 and G2; then
   point_coop.cuh's cooperative add (three threads an add, as K10, K11
   and K18 run it) in a chain run by one group of 96 threads.  Each
   variant's output is held equal to the others'.
2. K17 at the setup's two launches (19,825,624 G1 scalars, 1,603,487 G2)
   built from csrc/fixed_base.cu with other threads a block and blocks an
   SM (FbGeom) and with MulC in place of MulCC, each held bitwise against
   the kernel as built and timed in two rounds beside it.

Prints the card's name and power limit, then one JSON line a part.  The
variants build with the port's nvcc flags into
zkp2p_tpu_torch/_build/variants/.  About 3 minutes.
"""

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its timing and input helpers)

# (G1 threads, min blocks), (G2 threads, min blocks), product
K17_VARIANTS = {
    "g1 256 threads, g2 256 threads": ((256, 1), (256, 1), "MulCC"),
    "g1 128 threads, g2 64 threads": ((128, 1), (64, 1), "MulCC"),
    "g1 256 x 2 blocks, g2 128 x 3 blocks": ((256, 2), (128, 3), "MulCC"),
    "g1 128 x 4 blocks, g2 128 x 4 blocks": ((128, 4), (128, 4), "MulCC"),
    "as built, MulC": (None, None, "MulC"),
}
K17_SIZES = {False: 19825624, True: 1603487}

MICRO = r'''
#include "mont_cc.cuh"
#include "point_coop.cuh"

template <class M>
__global__ void k_mul_chain(int32_t* io, int iters, FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  Fe x = fe_load(io + i * 32), y = fe_load(io + i * 32 + 16);
#pragma unroll 1
  for (int k = 0; k < iters; ++k) x = M::mul(x, y, c);
  fe_store(io + i * 32, x);
}

// p, q = p + q, p: a chain of dependent adds
template <class M, class E>
__global__ void __launch_bounds__(128) k_add_chain(int32_t* io, int iters, FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const E* tag = nullptr;
  int32_t* b = io + i * 6 * (sizeof(E) / 2);
  Jac<E> p{f_load(tag, b, 0), f_load(tag, b, 1), f_load(tag, b, 2)};
  Jac<E> q{f_load(tag, b, 3), f_load(tag, b, 4), f_load(tag, b, 5)};
#pragma unroll 1
  for (int k = 0; k < iters; ++k) {
    Jac<E> r = pt_add<M>(p, q, c);
    q = p;
    p = r;
  }
  f_store(b, 0, p.x);
  f_store(b, 1, p.y);
  f_store(b, 2, p.z);
}

template <class E>
struct SlotRef {
  const E (*S)[32];
  int ln;
  __device__ __forceinline__ E at(int coord) const { return S[N_SLOTS + coord][ln]; }
};

// the same chain by coop_add, 32 lanes in one group of 96 threads: the
// addend q kept in three slots past the add's own
template <class M, class E>
__global__ void __launch_bounds__(96) k_coop_chain(int32_t* io, int iters, FieldConst c) {
  __shared__ E S[N_SLOTS + 3][32];
  const int ln = threadIdx.x & 31, role = threadIdx.x >> 5;
  const E* tag = nullptr;
  int32_t* b = io + (long long)ln * 6 * (sizeof(E) / 2);
  S[SX + role][ln] = f_load(tag, b, role);
  S[N_SLOTS + role][ln] = f_load(tag, b, 3 + role);
  __syncthreads();
#pragma unroll 1
  for (int k = 0; k < iters; ++k) {
    const E p = S[SX + role][ln];
    coop_add<M>(S, ln, role, SlotRef<E>{S, ln}, c);
    S[N_SLOTS + role][ln] = p;
    __syncthreads();
  }
  f_store(b, role, S[SX + role][ln]);
}

template <class M, class E>
static void add_chain_of(int coop, int32_t* io, unsigned g, int block, int iters, const FieldConst& c) {
  if (coop) {
    k_coop_chain<M, E><<<1, 96>>>(io, iters, c);
  } else {
    k_add_chain<M, E><<<g, block>>>(io, iters, c);
  }
}

extern "C" {
int mul_chain(int cc, void* io, long long threads, int block, int iters, const void* consts) {
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  unsigned g = (unsigned)(threads / block);
  if (cc) k_mul_chain<MulCC><<<g, block>>>((int32_t*)io, iters, c);
  else k_mul_chain<MulC><<<g, block>>>((int32_t*)io, iters, c);
  return (int)cudaGetLastError();
}
int add_chain(int cc, int g2, int coop, void* io, long long threads, int block, int iters, const void* consts) {
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  unsigned g = (unsigned)(threads / block);
  if (g2 && cc) add_chain_of<MulCC, Fe2>(coop, (int32_t*)io, g, block, iters, c);
  if (g2 && !cc) add_chain_of<MulC, Fe2>(coop, (int32_t*)io, g, block, iters, c);
  if (!g2 && cc) add_chain_of<MulCC, Fe>(coop, (int32_t*)io, g, block, iters, c);
  if (!g2 && !cc) add_chain_of<MulC, Fe>(coop, (int32_t*)io, g, block, iters, c);
  return (int)cudaGetLastError();
}
}
'''


def ptxas(log: str):
    return [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]


def build(cuda_build, out_dir: Path, name: str, source: str):
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}.cu"
    src.write_text(source)
    lib = out_dir / f"{name}.so"
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC_DIR), "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib


def micro(torch, lib, consts, device):
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 90)
    VP, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.mul_chain.argtypes = [I32, VP, I64, I32, I32, VP]
    lib.add_chain.argtypes = [I32, I32, I32, VP, I64, I32, I32, VP]
    out = {}

    def turns(label, make, call, iters, per):
        io0 = make()
        ios, times = {}, {0: [], 1: []}
        for cc in (0, 1, 1, 0):
            io = io0.clone()
            ms, _ = chip_smoke.cuda_ms(torch, lambda: call(cc, io), 1)
            times[cc].append(ms)
            ios[cc] = io
        if not torch.equal(ios[0], ios[1]):
            raise AssertionError(f"{label}: MulC and MulCC differ")
        out[label] = {name: dict(ms=times[cc], us_each=min(times[cc]) * 1e3 / iters,
                                 g_per_s=per * iters / min(times[cc]) / 1e6)
                      for cc, name in ((0, "MulC"), (1, "MulCC"))}

    for label, threads, block, iters in (("product, one warp", 32, 32, 4096),
                                         ("product, 132 x 2048 threads", 132 * 2048, 256, 512)):
        turns(label, lambda: chip_smoke.rand_canon(torch, gen, (threads, 2), device).reshape(threads, 32).contiguous(),
              lambda cc, io: lib.mul_chain(cc, io.data_ptr(), threads, block, iters, consts), iters, threads)
    for g2 in (0, 1):
        g = "G2" if g2 else "G1"
        w = 6 * (32 if g2 else 16)
        for label, threads, block, iters in ((f"{g} add, one warp", 32, 32, 256),
                                             (f"{g} add, 132 x 1024 threads", 132 * 1024, 128, 32)):
            turns(label, lambda: chip_smoke.rand_canon(torch, gen, (threads, w // 16), device)
                  .reshape(threads, w).contiguous(),
                  lambda cc, io: lib.add_chain(cc, g2, 0, io.data_ptr(), threads, block, iters, consts),
                  iters, threads)
        # the cooperative chain from the one-warp chain's inputs: the same
        # sums (its first three coordinates), 32 lanes
        io0 = chip_smoke.rand_canon(torch, gen, (32, w // 16), device).reshape(32, w).contiguous()
        res = {}
        for way in ("one thread an add", "coop_add"):
            times = []
            for cc in (0, 1, 1, 0):
                io = io0.clone()
                ms, _ = chip_smoke.cuda_ms(torch, lambda: lib.add_chain(
                    cc, g2, int(way == "coop_add"), io.data_ptr(), 32, 32, 256, consts), 1)
                times.append((cc, ms, io))
            res[way] = times
        ref = res["one thread an add"][0][2]
        for way, times in res.items():
            if any(not torch.equal(io[:, :w // 2], ref[:, :w // 2]) for _, _, io in times):
                raise AssertionError(f"{g} {way} chain differs")
        out[f"{g} add chain, 32 lanes"] = {
            f"{way}, {name}": dict(ms=[ms for c, ms, _ in times if c == cc],
                                   us_each=min(ms for c, ms, _ in times if c == cc) * 1e3 / 256)
            for way, times in res.items() for cc, name in ((0, "MulC"), (1, "MulCC"))}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    from zkp2p_tpu_torch.curve import host
    from zkp2p_tpu_torch.field.tfield import FQ
    from zkp2p_tpu_torch.ops import cuda_build, cuda_fixed_base as fb
    from zkp2p_tpu_torch.ops.cuda_mont import field_consts

    device = torch.device("cuda", 0)
    print(chip_smoke.smi("name,power.limit"), flush=True)
    consts = field_consts(FQ).ctypes.data
    out_dir = cuda_build.BUILD_DIR / "variants"
    shutil.rmtree(out_dir, ignore_errors=True)
    procs = {"micro": build(cuda_build, out_dir, "micro", MICRO)}
    base = (cuda_build.CSRC_DIR / "fixed_base.cu").read_text()
    geom = {False: "struct FbGeom<Fe> {\n  static constexpr int threads = %d, min_blocks = %d;",
            True: "struct FbGeom<Fe2> {\n  static constexpr int threads = %d, min_blocks = %d;"}
    built = {}
    for g2 in (False, True):
        at = base.index(geom[g2].split("%")[0])
        line = base[at:base.index(";", at) + 1]
        built[g2] = tuple(int(v.split("=")[1]) for v in line.split("int ")[1].rstrip(";").split(","))
    for i, (name, (g1, g2, prod)) in enumerate(K17_VARIANTS.items()):
        src = base
        for is_g2, want in ((False, g1), (True, g2)):
            if want is not None:
                src = src.replace(geom[is_g2] % built[is_g2], geom[is_g2] % want)
        src = src.replace("pt_add_mixed_q<MulCC>", f"pt_add_mixed_q<{prod}>")
        procs[name] = build(cuda_build, out_dir, f"fixed_base_v{i}", src)
    try:
        libs = cuda_build.build_all(["fixed_base"])
    finally:  # every build waited for, then any failure raised
        outs = {name: proc.communicate()[0].decode(errors="replace") for name, (proc, _) in procs.items()}
    failed = [f"{name}: nvcc failed\n{outs[name]}" for name, (proc, _) in procs.items() if proc.returncode]
    if failed:
        raise RuntimeError("\n".join(failed))
    logs = {name: ptxas(log) for name, log in outs.items()}
    print(json.dumps({"micro": micro(torch, ctypes.CDLL(str(procs["micro"][1])), consts, device),
                      "ptxas": logs["micro"]}), flush=True)

    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 91)
    k17 = {"as built": {"geometry": {"g1": built[False], "g2": built[True]},
                        "ptxas": ptxas(libs["fixed_base"].with_suffix(".log").read_text())}}
    fns = {}
    for i, name in enumerate(K17_VARIANTS):
        lib = ctypes.CDLL(str(procs[name][1]))
        for fn in ("zk_g1_fixed_base", "zk_g2_fixed_base"):
            getattr(lib, fn).argtypes = list(cuda_build.SOURCES["fixed_base"][fn])
            getattr(lib, fn).restype = ctypes.c_int
        fns[name] = lib
        k17[name] = {"ptxas": logs[name]}
    for g2, n in K17_SIZES.items():
        g = "g2" if g2 else "g1"
        table = fb.fixed_base_table(g2, host.G2_GENERATOR if g2 else host.G1_GENERATOR, device)
        k = chip_smoke.rand_canon(torch, gen, (n,), device)
        elem = (2, 16) if g2 else (16,)
        for _ in range(2):
            ms, ref = chip_smoke.cuda_ms(torch, lambda: fb.fixed_base(g2, table, k), 3)
            k17["as built"].setdefault(f"{g}_ms", []).append(ms)
            for name, lib in fns.items():
                fn = getattr(lib, f"zk_{g}_fixed_base")
                res = tuple(torch.empty((n,) + elem, dtype=torch.int32, device=device) for _ in range(3))

                def call():
                    err = fn(table[0].data_ptr(), table[1].data_ptr(), k.data_ptr(), *(o.data_ptr() for o in res),
                             n, consts, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: cudaError {err}")

                vms, _ = chip_smoke.cuda_ms(torch, call, 3)
                if chip_smoke.max_abs_err(torch, res, ref):
                    raise AssertionError(f"K17 variant {name} ({g}) differs from the kernel as built")
                k17[name].setdefault(f"{g}_ms", []).append(vms)
                del res
        del k, ref
    print(json.dumps({"k17": k17, "scalars": {"g1": K17_SIZES[False], "g2": K17_SIZES[True]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
