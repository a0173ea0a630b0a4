"""Build and bind the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface (``extern "C"`` launchers that take
device pointers, element counts and the stream, and return
``cudaGetLastError()``), loaded with ``ctypes``.  The libraries land in
``zkp2p_tpu_torch/_build/`` under a name keyed by the content of the
sources they were built from, so an edited source rebuilds and an
unchanged one is reused.  Nothing is built when a module is imported:
the first launch builds, and ``build_all`` builds every source at once
(one ``nvcc`` per source, all started together).

A build that fails raises; there is no fallback.  Every launcher has a
plain integer launch counter in ``LAUNCHES``, bumped by its wrapper only
where the kernel is launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_VP = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int

# source stem -> {launcher: argtypes}
SOURCES = {
    "mont_mul": {
        # a, b, out, n, a_stride, b_stride, field consts (host), stream
        "zk_mont_mul": (_VP, _VP, _VP, _I64, _I32, _I32, _VP, _VP),
    },
    "mont_pow": {
        # a, out, n, exponent words (host), nbits, field consts (host), stream
        "zk_mont_pow": (_VP, _VP, _I64, _VP, _I32, _VP, _VP),
    },
    "point_ops": {
        # inputs..., outputs x/y/z, n, field consts (host), stream
        "zk_g1_add": (_VP,) * 9 + (_I64, _VP, _VP),
        "zk_g1_add_mixed": (_VP,) * 8 + (_I64, _VP, _VP),
        "zk_g1_double": (_VP,) * 6 + (_I64, _VP, _VP),
        "zk_g2_add": (_VP,) * 9 + (_I64, _VP, _VP),
        "zk_g2_add_mixed": (_VP,) * 8 + (_I64, _VP, _VP),
        "zk_g2_double": (_VP,) * 6 + (_I64, _VP, _VP),
    },
    "msm_window": {
        # bases x/y, table x/y/z, n, lanes, n_table, field consts (host), stream
        "zk_g1_window_table": (_VP,) * 5 + (_I64, _I32, _I32, _VP, _VP),
        # acc x/y/z, table x/y/z, mags, negs, out x/y/z, batch, n_digits,
        # lanes, lanes_per_block, n_table, steps, s0, plane strides (4 + 4),
        # consts, stream
        "zk_g1_window_accumulate": (_VP,) * 11 + (_I32,) * 6 + (_I64,) * 9 + (_VP, _VP),
        # the G2 table: as zk_g1_window_table
        "zk_g2_window_table": (_VP,) * 5 + (_I64, _I32, _I32, _VP, _VP),
        # as zk_g1_window_accumulate without lanes_per_block
        "zk_g2_window_accumulate": (_VP,) * 11 + (_I32,) * 5 + (_I64,) * 9 + (_VP, _VP),
    },
    "msm_fold": {
        # init x/y/z, planes x/y/z, out x/y/z, lanes, n_planes, window, consts, stream
        "zk_g1_horner_fold": (_VP,) * 9 + (_I64, _I32, _I32, _VP, _VP),
        "zk_g2_horner_fold": (_VP,) * 9 + (_I64, _I32, _I32, _VP, _VP),
    },
    "ntt": {
        # in, out, twiddles, factor (or null), rows, log_m, s0, k, bitrev,
        # factor stride, consts, stream
        "zk_fr_ntt_pass": (_VP,) * 4 + (_I64,) + (_I32,) * 5 + (_VP, _VP),
    },
    "matvec": {
        # coeff, wire, offsets, w, out, rows, n_wires, batch, consts, stream
        "zk_fr_matvec": (_VP,) * 5 + (_I64, _I64, _I32, _VP, _VP),
    },
    "recode": {
        # limbs, mags, negs, n, window, stream
        "zk_signed_recode": (_VP,) * 3 + (_I64, _I32, _VP),
    },
    "batch_inv": {
        # x, out, n, deg, field consts (host), R^3 words (host), stream
        "zk_batch_inverse": (_VP, _VP, _I64, _I32, _VP, _VP, _VP),
        # X, Y, Z, out x/y, n, deg, consts, R^3 words, stream
        "zk_jac_to_affine": (_VP,) * 5 + (_I64, _I32, _VP, _VP, _VP),
    },
    "affine_add": {
        # a x/y/inf and its row strides, b the same, out x/y/inf, rows,
        # inner, consts, R^3 words, stream
        "zk_g1_affine_add": ((_VP,) * 3 + (_I64,) * 2) * 2 + (_VP,) * 3 + (_I64,) * 2 + (_VP,) * 3,
        "zk_g2_affine_add": ((_VP,) * 3 + (_I64,) * 2) * 2 + (_VP,) * 3 + (_I64,) * 2 + (_VP,) * 3,
        # acc x/y/inf, table x/y, mags, negs, out x/y/inf, n_digits, lanes,
        # n_table, steps, s0, plane strides (3 + 3), consts, R^3 words, stream
        "zk_g1_affine_accumulate": (_VP,) * 10 + (_I32,) * 4 + (_I64,) * 7 + (_VP,) * 3,
        "zk_g2_affine_accumulate": (_VP,) * 10 + (_I32,) * 4 + (_I64,) * 7 + (_VP,) * 3,
    },
    "fixed_base": {
        # table x/y, scalars (standard form), out x/y/z, n, field consts (host), stream
        "zk_g1_fixed_base": (_VP,) * 6 + (_I64, _VP, _VP),
        "zk_g2_fixed_base": (_VP,) * 6 + (_I64, _VP, _VP),
    },
    "lane_tree": {
        # points x/y/z, scratch x/y/z, counters, out x/y/z, batch, lanes,
        # levels_a, per_block, blocks, levels_b, field consts (host), stream
        "zk_g1_lane_tree": (_VP,) * 10 + (_I32,) * 6 + (_VP, _VP),
        "zk_g2_lane_tree": (_VP,) * 10 + (_I32,) * 6 + (_VP, _VP),
    },
    "scale": {
        # points x/y, out x/y/z, n, digits (host), field consts (host), stream
        "zk_g1_scale": (_VP,) * 5 + (_I64, _VP, _VP, _VP),
    },
}

LAUNCHERS = tuple(name for fns in SOURCES.values() for name in fns)

# launcher -> kernel launches since the last reset_launches()
LAUNCHES: Dict[str, int] = dict.fromkeys(LAUNCHERS, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(stem: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{stem}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build_all(stems=None) -> Dict[str, Path]:
    """Compile every source whose library is missing, one nvcc process
    each, all started together.  Raises with the compiler's output if any
    build fails.  Returns stem -> library path; the compiler's log (with
    ptxas register and spill counts) is beside each library as .log."""
    stems = list(SOURCES) if stems is None else list(stems)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {s: _lib_path(s) for s in stems}
    todo = {s: p for s, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for s, p in todo.items():
        tmp = p.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{s}.cu")]
        procs[s] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp)
    failed = []
    for s, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        log = out.decode(errors="replace")
        paths[s].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{s}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, paths[s])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            path = build_all([stem])[stem]
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SOURCES[stem].items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _libs[stem] = lib
        return lib


_fns: Dict[str, object] = {}


def launch(stem: str, name: str, *args) -> None:
    """Call one launcher on the current stream; a nonzero cudaError_t
    raises.  Counts the launch."""
    import torch

    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = getattr(library(stem), name)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    LAUNCHES[name] += 1
