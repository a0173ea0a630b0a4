"""Boundaries of the port (zkp2p_tpu_torch) and of chip_smoke.py: neither
imports JAX or the reference package; an entry point asked for CUDA where
there is none raises instead of falling back; a kernel wrapper takes its
plain version only for CPU tensors and then counts no launch; a kernel
build that fails raises."""

import ast
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zkp2p_tpu_torch.curve import tcurve
from zkp2p_tpu_torch.field.tfield import FQ, FQ2, FR
from zkp2p_tpu_torch.ops import (cuda_affine, cuda_build, cuda_curve, cuda_fixed_base, cuda_lane_tree, cuda_matvec,
                                  cuda_mont, cuda_msm_fold, cuda_msm_window, cuda_ntt, cuda_recode, cuda_scale, msm,
                                  msm_affine, ntt)
from zkp2p_tpu_torch.prover.groth16_gpu import key_from_numpy, prove_gpu, prove_gpu_batch
from zkp2p_tpu_torch.prover.vector import VECTOR_PATH, load_vector
from zkp2p_tpu_torch.utils.device import resolve_device

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "zkp2p_tpu_torch"


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "zkp2p_tpu"


def test_import_loads_no_jax_and_no_reference_package():
    mods = sorted(
        "zkp2p_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'zkp2p_tpu')]\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_ast_scan_finds_no_forbidden_import():
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                bad += [(f.name, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                if _forbidden(node.module):
                    bad.append((f.name, node.module))
    assert len(files) > 10 and bad == []


def test_entry_points_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    arrays, meta, witness, r, s, _ = load_vector(VECTOR_PATH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        key_from_numpy(arrays, meta)
    key = key_from_numpy(arrays, meta, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prove_gpu(key, witness, r=r, s=s)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prove_gpu_batch(key, [witness, witness], rs=[(r, s)] * 2)


def test_key_entry_points_without_cuda_raise(monkeypatch, tmp_path):
    """setup_device, setup_from_rows, load_dpk, device_pk and
    device_pk_from_zkey put the key on CUDA unless given device="cpu":
    without CUDA they raise before any work, and run on the CPU when
    asked."""
    from zkp2p_tpu_torch.formats.zkey import ZkeyData
    from zkp2p_tpu_torch.prover import keycache
    from zkp2p_tpu_torch.prover.groth16_gpu import device_pk, device_pk_from_zkey
    from zkp2p_tpu_torch.prover.setup_device import setup_device, setup_from_rows

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cs = SimpleNamespace(constraints=[SimpleNamespace(a={1: 1}, b={1: 1}, c={1: 1})], num_public=1, num_wires=2,
                         wire_width={})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        setup_device(cs)
    coo = (np.zeros((1, 16), np.int32), np.zeros(1, np.int64), np.zeros(1, np.int64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        setup_from_rows(coo, coo, coo, 2, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        keycache.load_dpk(str(tmp_path / "absent.npz"))
    key, vk = setup_device(cs, device="cpu")
    assert key.device == torch.device("cpu") and vk.n_public == 1
    keycache.save_dpk(str(tmp_path / "k.npz"), key, vk)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        keycache.load_dpk(str(tmp_path / "k.npz"))
    assert keycache.load_dpk(str(tmp_path / "k.npz"), device="cpu")[0].device == torch.device("cpu")
    pk = SimpleNamespace(n_public=1, alpha_1=None, beta_1=None, beta_2=None, delta_1=None, delta_2=None,
                         a_query=[None, None], b1_query=[None, None], b2_query=[None, None], c_query=[None, None],
                         h_query=[None] * 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_pk(pk, cs)
    z = np.zeros((0, 16), np.int32)
    zk = ZkeyData(n_vars=2, n_public=1, domain_size=4, alpha_1=None, beta_1=None, beta_2=None, gamma_2=None,
                  delta_1=None, delta_2=None, ic=[None, None], coeff_matrix=np.zeros(0, np.int64),
                  coeff_row=np.zeros(0, np.int64), coeff_wire=np.zeros(0, np.int64), coeff_value=z,
                  a_query=(np.zeros((2, 16), np.int32),) * 2, b1_query=(np.zeros((2, 16), np.int32),) * 2,
                  b2_query=(np.zeros((2, 2, 16), np.int32),) * 2, c_query=(z, z),
                  h_query=(np.zeros((4, 16), np.int32),) * 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_pk_from_zkey(zk)
    assert device_pk_from_zkey(zk, device="cpu").device == torch.device("cpu")


def test_cli_without_cuda_raises_before_reading_a_file(monkeypatch, tmp_path):
    """setup, prove and batch without --device cpu (or with --device
    cuda) raise on a machine with no CUDA device before they build a
    circuit or read a file."""
    from zkp2p_tpu_torch.pipeline import cli

    def no_read(*a, **k):
        raise AssertionError("read a file or built a circuit")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(cli, "read_zkey", no_read)
    monkeypatch.setattr(cli, "read_wtns", no_read)
    monkeypatch.setattr(cli, "_build_circuit", no_read)
    (tmp_path / "w.wtns").write_bytes(b"wtns")
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "m.json").write_text("{}")
    files = ["--zkey", str(tmp_path / "k.zkey"), "--wtns", str(tmp_path / "w.wtns")]
    toy = ["--build-dir", str(tmp_path / "build"), "--circuit", "toy"]
    for argv in (["prove"] + files, ["prove", "--device", "cuda"] + files,
                 ["batch", "--indir", str(tmp_path), "--outdir", str(tmp_path / "out")],
                 toy + ["setup"], toy + ["prove", "--message", "57"],
                 toy + ["batch", "--indir", str(tmp_path / "in"), "--outdir", str(tmp_path / "out")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    assert not (tmp_path / "out").exists() and not (tmp_path / "build").exists()
    out = subprocess.run([sys.executable, "-m", "zkp2p_tpu_torch", "prove"] + files, cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and "no CUDA device" in out.stderr and out.stdout == ""


def test_ceremony_without_cuda_raises_before_reading_a_file(monkeypatch, tmp_path):
    """contribute, beacon and verify_chain, and the CLI's ceremony, run on
    CUDA unless given device="cpu" (--device cpu): without CUDA they raise
    before they read a zkey."""
    from zkp2p_tpu_torch.pipeline import cli
    from zkp2p_tpu_torch.snark import ceremony

    def no_read(*a, **k):
        raise AssertionError("read a file")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ceremony, "read_zkey", no_read)
    a, b = str(tmp_path / "a.zkey"), str(tmp_path / "b.zkey")
    for call in (lambda: ceremony.contribute(a, b, b"e"), lambda: ceremony.beacon(a, b, b"h"),
                 lambda: ceremony.verify_chain(a, b), lambda: cli.main(["ceremony", "contribute", a, b]),
                 lambda: cli.main(["ceremony", "verify", a, b, "--device", "cuda"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not os.path.exists(b)


def test_chip_smoke_without_cuda_exits_nonzero_and_prints_nothing():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""


def _rand(shape, seed):
    g = np.random.default_rng(seed)
    x = g.integers(0, 1 << 16, size=shape + (16,), dtype=np.int64)
    x[..., 15] = g.integers(0, 0x3064, size=shape)
    return torch.from_numpy(x.astype(np.int32))


def test_wrappers_on_cpu_take_the_plain_path_and_count_nothing():
    cuda_build.reset_launches()
    a, b = _rand((5,), 1), _rand((5,), 2)
    assert torch.equal(cuda_mont.mont_mul(FR, a, b), cuda_mont.mont_mul_plain(FR, a, b))
    assert torch.equal(FQ.inv_fused(a), cuda_mont.mont_pow_plain(FQ, a, FQ.modulus - 2))
    for g2, C in ((False, tcurve.G1C), (True, tcurve.G2C)):
        shape = (5, 2) if g2 else (5,)
        p = tuple(_rand(shape, 10 + k) for k in range(3))
        q = tuple(_rand(shape, 20 + k) for k in range(3))
        assert all(torch.equal(x, y) for x, y in zip(C.add(p, q), cuda_curve.point_op_plain("add", g2, *p, *q)))
        assert all(torch.equal(x, y) for x, y in zip(C.add_mixed(p, q[:2]),
                                                      cuda_curve.point_op_plain("add_mixed", g2, *p, *q[:2])))
        assert all(torch.equal(x, y) for x, y in zip(C.double(p), cuda_curve.point_op_plain("double", g2, *p)))
    W = cuda_msm_window
    for elem, table_of, table_plain, accumulate, accumulate_plain in (
        ((), W.g1_window_table, W.g1_window_table_plain, W.g1_window_accumulate, W.g1_window_accumulate_plain),
        ((2,), W.g2_window_table, W.g2_window_table_plain, W.g2_window_accumulate, W.g2_window_accumulate_plain),
    ):
        bases = (_rand((2, 3) + elem, 30), _rand((2, 3) + elem, 31))
        table = table_of(bases, 4)
        assert all(torch.equal(x, y) for x, y in zip(table, table_plain(bases, 4)))
        acc = tuple(_rand((2, 3) + elem, 40 + k) for k in range(3))
        mags = torch.from_numpy(np.random.default_rng(5).integers(0, 5, size=(2, 4, 3)).astype(np.int32))
        negs = mags % 2 == 1
        got = accumulate(acc, table, mags, negs, 1)
        want = accumulate_plain(acc, table, mags, negs, 1)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        acc_b = tuple(torch.stack([c, c]) for c in acc)  # a batch of two witnesses
        planes_b = (torch.stack([mags, mags.flip(-1)], 1), torch.stack([negs, negs.flip(-1)], 1))
        got = accumulate(acc_b, table, *planes_b, 1)
        assert all(torch.equal(x, y) for x, y in zip(got, accumulate_plain(acc_b, table, *planes_b, 1)))
    F = cuda_msm_fold
    for elem, fold, fold_plain in (((), F.g1_horner_fold, F.g1_horner_fold_plain),
                                   ((2,), F.g2_horner_fold, F.g2_horner_fold_plain)):
        init = tuple(_rand((2,) + elem, 50 + k) for k in range(3))
        planes = tuple(_rand((2, 2) + elem, 60 + k) for k in range(3))
        got = fold(init, planes, 2)
        assert all(torch.equal(x, y) for x, y in zip(got, fold_plain(init, planes, 2)))
    tw = ntt.domain(3, torch.device("cpu"))["tw"]
    x = _rand((2, 8), 70)
    for s0, k, bitrev, factor in ((0, 2, True, _rand((8,), 71)), (2, 1, False, _rand((), 72))):
        assert torch.equal(cuda_ntt.ntt_pass(x, tw, s0, k, bitrev, factor),
                           cuda_ntt.ntt_pass_plain(x, tw, s0, k, bitrev, factor))
    coeff, w = _rand((6,), 80), _rand((4,), 81)
    csr = cuda_matvec.csr_from_rows(coeff, torch.tensor([0, 3, 1, 3, 0, 2]), torch.tensor([2, 0, 2, 1, 0, 3]), 5)
    assert torch.equal(cuda_matvec.fr_matvec(*csr, w), cuda_matvec.fr_matvec_plain(*csr, w))
    wb = torch.stack([w, w.flip(0)])
    assert torch.equal(cuda_matvec.fr_matvec(*csr, wb), cuda_matvec.fr_matvec_plain(*csr, wb))
    std = _rand((7,), 82)
    for window in (4, 16):
        got = msm.signed_digit_planes(std, window)
        assert all(torch.equal(x, y) for x, y in zip(got, msm.signed_digit_planes_from_limbs(std, window)))
    # K15/K16's dispatchers: the plain routes on CPU tensors
    x = _rand((5,), 90)
    assert torch.equal(msm_affine.batch_inverse(FQ, x), msm_affine._batch_inverse_steps(FQ, x))
    x2 = _rand((5, 2), 91)
    assert torch.equal(msm_affine.batch_inverse(FQ2, x2), msm_affine._batch_inverse_steps(FQ2, x2))
    for g2, C in ((False, tcurve.G1C), (True, tcurve.G2C)):
        shape = (5, 2) if g2 else (5,)
        jac = tuple(_rand(shape, 92 + k) for k in range(3))
        assert all(torch.equal(x, y) for x, y in zip(msm_affine.jac_to_affine_batch(C.F, jac),
                                                      msm_affine._jac_to_affine_steps(C.F, jac)))
        a = (_rand(shape, 95), _rand(shape, 96), torch.tensor([True, False, False, True, False]))
        b = (_rand(shape, 97), _rand(shape, 98), torch.tensor([False, False, True, True, False]))
        assert all(torch.equal(x, y) for x, y in zip(msm_affine.affine_add_complete(C.F, a, b),
                                                      msm_affine._affine_add_steps(C.F, a, b)))
        acc = tuple(c.reshape((1,) + c.shape) for c in a)
        table = tuple(_rand((2, 4) + shape, 99 + k) for k in range(2))
        mags = torch.from_numpy(np.random.default_rng(6).integers(0, 5, size=(1, 3, 5)).astype(np.int32))
        negs = mags % 2 == 0
        assert all(torch.equal(x, y) for x, y in zip(msm_affine.affine_accumulate(C, acc, table, mags, negs, 1),
                                                      msm_affine._affine_accumulate_steps(C.F, acc, table, mags,
                                                                                         negs, 1)))
    # K17's dispatcher: the plain comb on CPU tensors
    for g2 in (False, True):
        table = tuple(_rand((cuda_fixed_base.WINDOWS * cuda_fixed_base.ROWS,) + ((2,) if g2 else ()), 100 + k)
                      for k in range(2))
        k = _rand((3,), 102)
        assert all(torch.equal(x, y) for x, y in zip(cuda_fixed_base.fixed_base(g2, table, k),
                                                      cuda_fixed_base.fixed_base_plain(g2, table, k)))
    # K18's dispatcher: the level loop on CPU tensors, whatever the batch
    for g2, C in ((False, tcurve.G1C), (True, tcurve.G2C)):
        shape = (2, 5, 2) if g2 else (2, 5)
        pts = tuple(_rand(shape, 103 + k) for k in range(3))
        got = msm.tree_reduce(C, pts, 5)
        assert all(torch.equal(x, y) for x, y in zip(got, msm.tree_reduce_steps(C, pts, 5)))
        assert all(torch.equal(x, y) for x, y in zip(got, cuda_lane_tree.lane_tree_plain(g2, pts)))
    # K19's dispatcher: the plain digit loop on CPU tensors
    pts = (_rand((3,), 104), _rand((3,), 105))
    got = cuda_scale.g1_scale(pts, 12345)
    assert all(torch.equal(x, y) for x, y in zip(got, cuda_scale.g1_scale_plain(pts, 12345)))
    assert set(cuda_build.LAUNCHES) == set(cuda_build.LAUNCHERS) and len(cuda_build.LAUNCHERS) == 28
    assert {"batch_inv", "affine_add", "fixed_base", "lane_tree", "scale"} <= set(cuda_build.SOURCES)
    assert all((cuda_build.CSRC_DIR / f"{stem}.cu").is_file() for stem in cuda_build.SOURCES)
    assert all(v == 0 for v in cuda_build.LAUNCHES.values())


def test_kernel_sources_include_their_headers():
    """Each library's name hashes every header, so an edited header
    rebuilds every kernel; K17, K18 and K19 run mont_cc.cuh's product, K18
    point_coop.cuh's cooperative add (K10/K11's)."""
    headers = {p.name for p in cuda_build.CSRC_DIR.glob("*.cuh")}
    assert {"mont.cuh", "mont_cc.cuh", "point.cuh", "point_coop.cuh", "affine.cuh"} <= headers
    assert '#include "point_coop.cuh"' in (cuda_build.CSRC_DIR / "lane_tree.cu").read_text()
    for stem in ("fixed_base", "lane_tree", "scale"):
        src = (cuda_build.CSRC_DIR / f"{stem}.cu").read_text()
        assert '#include "mont_cc.cuh"' in src and "<MulCC>" in src, stem
    # K19 over the called product and Montgomery square (its comparator
    # keeps <MulCC>)
    src = (cuda_build.CSRC_DIR / "scale.cu").read_text()
    assert "<MulCallCC>" in src and "fe_sqr_cc" in src and "fe_mul_cc" in src
    before = cuda_build._lib_path("lane_tree")
    assert cuda_build._lib_path("fixed_base") != before
    assert before.parent == cuda_build.BUILD_DIR and before.suffix == ".so"


def test_scale_comparator_is_reached_only_from_chip_smoke():
    """csrc/scale.cu keeps the NAF-only kernel as a second entry for
    chip_smoke.py's same-call comparison: no module of the port names it,
    it is no launcher of the build table, and K19's wrapper on CPU tensors
    counts no launch."""
    name = "zk_g1_scale_naf"
    assert f"int {name}(" in (cuda_build.CSRC_DIR / "scale.cu").read_text()
    assert name in (ROOT / "chip_smoke.py").read_text()
    assert not [p for p in PKG.rglob("*.py") if name in p.read_text()]
    assert name not in cuda_build.LAUNCHERS and cuda_build.SOURCES["scale"] == {
        "zk_g1_scale": cuda_build.SOURCES["scale"]["zk_g1_scale"]}
    cuda_build.reset_launches()
    pts = (_rand((4,), 106), _rand((4,), 107))
    cuda_scale.g1_scale(pts, (1 << 256) - 1)
    assert all(v == 0 for v in cuda_build.LAUNCHES.values())


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
@pytest.mark.parametrize("lanes", [1, 17, 572, 16384])
def test_lane_tree_launches_once_a_tree(monkeypatch, g2, lanes):
    """K18's wrapper on a device other than the CPU: one launch of its
    launcher a tree, whatever its stages and batch, counted once; tree_plan's
    stages and the batch are what it passes."""
    name = f"zk_{'g2' if g2 else 'g1'}_lane_tree"
    calls = []
    monkeypatch.setattr(cuda_lane_tree, "_device_of", lambda what, ts: torch.device("meta"))
    monkeypatch.setitem(cuda_build._fns, name, lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: SimpleNamespace(cuda_stream=0))
    elem = (2, 16) if g2 else (16,)
    pts = tuple(torch.empty((4, lanes) + elem, dtype=torch.int32, device="meta") for _ in range(3))
    cuda_build.reset_launches()
    out = cuda_lane_tree.lane_tree(g2, pts)
    assert all(c.shape == (4,) + elem for c in out)
    assert cuda_build.LAUNCHES[name] == 1 and sum(cuda_build.LAUNCHES.values()) == 1
    (args,) = calls
    plan = cuda_lane_tree.tree_plan(lanes)
    assert args[10:16] == (4, lanes, plan.levels_a, plan.per_block, plan.blocks, plan.levels_b)
    cuda_build.reset_launches()


def test_wrappers_refuse_other_devices():
    a = torch.zeros(3, 16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        cuda_mont.mont_mul(FQ, a, a)
    with pytest.raises(ValueError):
        FQ.inv_fused(a)
    with pytest.raises(ValueError):
        tcurve.G1C.double((a, a, a))
    planes = torch.zeros(2, 1, 3, dtype=torch.int32, device="meta")
    W = cuda_msm_window
    for elem, table_of, accumulate in (((), W.g1_window_table, W.g1_window_accumulate),
                                       ((2,), W.g2_window_table, W.g2_window_accumulate)):
        b = torch.zeros((1, 3) + elem + (16,), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError):
            table_of((b, b), 8)
        table = torch.zeros((1, 8, 3) + elem + (16,), dtype=torch.int32, device="meta")
        acc = torch.zeros((2, 3) + elem + (16,), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError):
            accumulate((acc,) * 3, (table,) * 3, planes, planes.bool(), 0)
    for g2, C in ((False, tcurve.G1C), (True, tcurve.G2C)):
        pts = (torch.zeros((2, 3) + C.elem, dtype=torch.int32, device="meta"),) * 3
        for call in (lambda: msm.tree_reduce(C, pts, 3), lambda: cuda_lane_tree.lane_tree(g2, pts)):
            with pytest.raises(ValueError):
                call()
    for elem, fold in (((), cuda_msm_fold.g1_horner_fold), ((2,), cuda_msm_fold.g2_horner_fold)):
        init = torch.zeros((3,) + elem + (16,), dtype=torch.int32)
        stacked = torch.zeros((2, 3) + elem + (16,), dtype=torch.int32)
        for i, p in ((init, stacked.to("meta")), (init.to("meta"), stacked), (init.to("meta"), stacked.to("meta"))):
            with pytest.raises(ValueError):
                fold((i,) * 3, (p,) * 3, 4)


def test_affine_wrappers_refuse_other_devices():
    """K15/K16's dispatchers send a tensor that is not on the CPU to the
    kernel, whose wrapper takes CUDA tensors only."""
    for g2, C in ((False, tcurve.G1C), (True, tcurve.G2C)):
        elem = (2, 16) if g2 else (16,)
        z = torch.zeros((3,) + elem, dtype=torch.int32, device="meta")
        inf = torch.zeros(3, dtype=torch.bool, device="meta")
        with pytest.raises(ValueError):
            msm_affine.batch_inverse(C.F, z)
        with pytest.raises(ValueError):
            msm_affine.jac_to_affine_batch(C.F, (z, z, z))
        with pytest.raises(ValueError):
            msm_affine.affine_add_complete(C.F, (z, z, inf), (z, z, inf))
        with pytest.raises(ValueError):  # one operand on the CPU, one elsewhere
            cpu = (torch.zeros(z.shape, dtype=torch.int32), torch.zeros(z.shape, dtype=torch.int32),
                   torch.zeros(3, dtype=torch.bool))
            msm_affine.affine_add_complete(C.F, cpu, (z, z, inf))
        acc = (z[None], z[None], inf[None])
        table = (torch.zeros((1, 8, 3) + elem, dtype=torch.int32, device="meta"),) * 2
        planes = torch.zeros(1, 2, 3, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError):
            msm_affine.affine_accumulate(C, acc, table, planes, planes.bool(), 0)
    x = torch.zeros(3, 16, dtype=torch.int32)
    for call in (lambda: cuda_affine.batch_inverse(FQ, x, 1), lambda: cuda_affine.jac_to_affine((x, x, x), 1)):
        with pytest.raises(ValueError):  # the launch wrappers take CUDA tensors only
            call()


def test_fixed_base_refuses_other_devices():
    for g2 in (False, True):
        elem = (2, 16) if g2 else (16,)
        table = torch.zeros((cuda_fixed_base.WINDOWS * cuda_fixed_base.ROWS,) + elem, dtype=torch.int32)
        k = torch.zeros(3, 16, dtype=torch.int32)
        for t, kk in ((table.to("meta"), k), (table, k.to("meta")), (table.to("meta"), k.to("meta"))):
            with pytest.raises(ValueError):
                cuda_fixed_base.fixed_base(g2, (t, t), kk)
        with pytest.raises(ValueError):  # a table of the wrong shape
            cuda_fixed_base.fixed_base(g2, (table[:-1], table[:-1]), k)


def test_ntt_pass_refuses_other_devices():
    x = torch.zeros(2, 8, 16, dtype=torch.int32)
    tw = torch.zeros(4, 16, dtype=torch.int32)
    for xs, tws in ((x.to("meta"), tw.to("meta")), (x, tw.to("meta")), (x.to("meta"), tw)):
        with pytest.raises(ValueError):
            cuda_ntt.ntt_pass(xs, tws, 0, 3, bitrev=True)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_pass(x, tw, 0, 3, factor=torch.zeros(16, dtype=torch.int32, device="meta"))


def test_witness_side_wrappers_refuse_other_devices():
    coeff, w = torch.zeros(3, 16, dtype=torch.int32), torch.zeros(2, 16, dtype=torch.int32)
    csr = cuda_matvec.csr_from_rows(coeff, torch.tensor([0, 1, 1]), torch.tensor([0, 0, 2]), 4)
    for i in range(4):
        args = [t.to("meta") if k == i else t for k, t in enumerate((*csr, w))]
        with pytest.raises(ValueError):
            cuda_matvec.fr_matvec(*args)
    with pytest.raises(ValueError):
        cuda_matvec.fr_matvec(*csr, w, out=torch.zeros(4, 16, dtype=torch.int32, device="meta"))
    std = torch.zeros(3, 16, dtype=torch.int32)
    with pytest.raises(ValueError):
        msm.signed_digit_planes(std.to("meta"), 4)
    for x in (std, std.to("meta")):  # the launch wrapper takes CUDA tensors only
        with pytest.raises(ValueError):
            cuda_recode.signed_recode(x, 4)


def test_failed_build_raises(tmp_path, monkeypatch):
    (tmp_path / "broken.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="CUDA kernel build failed"):
        cuda_build.build_all(["broken"])
    assert not list((tmp_path / "_build").glob("*.so"))


def test_ast_scan_finds_no_environment_read():
    """The port takes its settings as arguments: nothing in it reads
    os.environ or os.getenv (the reference's service was driven by its
    environment)."""
    bad = []
    for f in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Attribute) and node.attr in ("environ", "environb", "getenv", "getenvb"):
                bad.append((f.name, node.lineno, node.attr))
            elif isinstance(node, ast.ImportFrom) and node.module == "os":
                bad += [(f.name, node.lineno, a.name) for a in node.names if a.name.startswith(("environ", "getenv"))]
    assert bad == []


def test_service_without_cuda_raises(monkeypatch, tmp_path):
    """ProvingService runs its default prover on CUDA unless given
    device="cpu"; the service command raises without CUDA before it reads
    the spool or a file, and refuses a circuit other than venmo and
    email_verify as the reference does."""
    from zkp2p_tpu.pipeline import cli as ref_cli

    from zkp2p_tpu_torch.pipeline import cli
    from zkp2p_tpu_torch.pipeline.service import ProvingService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProvingService(None, None, None, None, None)
    assert ProvingService(None, None, None, None, None, device="cpu").device == torch.device("cpu")

    def no_read(*a, **k):
        raise AssertionError("read a file or built a circuit")

    monkeypatch.setattr(cli, "read_zkey", no_read)
    monkeypatch.setattr(cli, "_build_circuit", no_read)
    spool = tmp_path / "spool"
    for argv in (["--circuit", "venmo", "service", "--spool", str(spool)],
                 ["--circuit", "venmo", "service", "--spool", str(spool), "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--build-dir", str(tmp_path / "build")] + argv)
    assert not spool.exists()
    out = subprocess.run([sys.executable, "-m", "zkp2p_tpu_torch", "--circuit", "venmo", "service", "--spool",
                          str(spool)], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and "no CUDA device" in out.stderr and not spool.exists()
    toy = ["--circuit", "toy", "service", "--spool", str(spool)]
    with pytest.raises(SystemExit) as want:
        ref_cli.main(toy)
    with pytest.raises(SystemExit) as got:
        cli.main(toy + ["--device", "cpu"])
    assert str(got.value) == str(want.value) == "service supports the email circuits (venmo, email_verify)"
    assert not spool.exists()


def test_service_run_on_cuda_builds_every_kernel_before_claiming(monkeypatch, tmp_path):
    """run() on a CUDA device builds and loads every kernel before its
    first sweep: a failed build raises out of run() with the spool
    untouched."""
    from zkp2p_tpu_torch.pipeline.service import ProvingService

    spool = tmp_path / "spool"
    spool.mkdir()
    (spool / "r0.req.json").write_text("{}")
    svc = ProvingService(None, None, None, None, None, device="cpu", cache_dir=None)
    svc.device = torch.device("cuda", 0)

    def failed_build(stems=None):
        raise RuntimeError("CUDA kernel build failed:\nmont_mul.cu (nvcc exit 1)")

    monkeypatch.setattr(cuda_build, "build_all", failed_build)
    with pytest.raises(RuntimeError, match="CUDA kernel build failed"):
        svc.run(str(spool), max_sweeps=1)
    assert sorted(os.listdir(spool)) == ["r0.req.json"] and not (tmp_path / "spool.metrics.jsonl").exists()
    loaded = []
    monkeypatch.setattr(cuda_build, "build_all", lambda stems=None: {s: None for s in cuda_build.SOURCES})
    monkeypatch.setattr(cuda_build, "library", loaded.append)
    svc.prover_fn = lambda dpk, wits: []  # nothing proves: the request is bad input
    svc.witness_fn = lambda payload: (_ for _ in ()).throw(ValueError("bad payload"))
    assert svc.run(str(spool), max_sweeps=1) == "sweeps"
    assert loaded == list(cuda_build.SOURCES)
    assert (spool / "r0.error.json").exists()


def test_fleet_without_cuda_raises_before_spawning_or_writing(monkeypatch, tmp_path):
    """The fleet command's default workers run on CUDA unless --device cpu:
    without CUDA it raises before it spawns a worker or makes the spool
    (each worker would raise before reading a file, as `service` does)."""
    from zkp2p_tpu_torch.pipeline import cli
    from zkp2p_tpu_torch.pipeline import fleet

    def no_spawn(*a, **k):
        raise AssertionError("spawned a worker")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(fleet.FleetSupervisor, "_spawn", no_spawn)
    spool = tmp_path / "spool"
    for argv in (["fleet", "--spool", str(spool)], ["fleet", "--spool", str(spool), "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--build-dir", str(tmp_path / "build"), "--circuit", "venmo"] + argv)
    assert not spool.exists()
    out = subprocess.run([sys.executable, "-m", "zkp2p_tpu_torch", "--circuit", "venmo", "fleet", "--spool",
                          str(spool)], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and "no CUDA device" in out.stderr and not spool.exists()


def test_the_supervisor_never_initialises_cuda(monkeypatch, tmp_path):
    """A supervisor only spawns processes: the fleet command (its device
    check included) and a toy fleet run without a call that would
    initialise CUDA in this process."""
    from zkp2p_tpu_torch.pipeline import cli
    from zkp2p_tpu_torch.utils.device import check_device

    def no_init(*a, **k):
        raise AssertionError("initialised CUDA")

    monkeypatch.setattr(torch.cuda, "_lazy_init", no_init)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert check_device() == torch.device("cuda")
    with pytest.raises(SystemExit) as rc:
        cli.main(["fleet", "--spool", str(tmp_path / "spool"), "--workers", "2", "--worker-cmd",
                  json.dumps([sys.executable, "-c", "pass"])])
    assert rc.value.code == 0 and not torch.cuda.is_initialized()


def test_plane_alerts_top_and_chaos_load_no_jax():
    """The fleet plane, the alert engine, the SLO merge and the chaos
    harness import neither JAX nor the reference package."""
    mods = ["zkp2p_tpu_torch.pipeline.fleet_obs", "zkp2p_tpu_torch.utils.alerts", "zkp2p_tpu_torch.utils.slo",
            "zkp2p_tpu_torch.tools.chaos", "zkp2p_tpu_torch.pipeline.cli"]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print([m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'zkp2p_tpu')])\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_the_plane_and_top_never_initialise_cuda(monkeypatch, tmp_path, capsys):
    """The fleet command with its plane on, and `top` against a plane,
    run without a call that would initialise CUDA in this process."""
    from zkp2p_tpu_torch.pipeline import cli
    from zkp2p_tpu_torch.pipeline.fleet import FleetSupervisor

    def no_init(*a, **k):
        raise AssertionError("initialised CUDA")

    monkeypatch.setattr(torch.cuda, "_lazy_init", no_init)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    fleet_dir = tmp_path / "state"
    with pytest.raises(SystemExit) as rc:
        cli.main(["fleet", "--spool", str(tmp_path / "spool"), "--workers", "1", "--fleet-dir", str(fleet_dir),
                  "--fleet-metrics-port", "auto", "--fleet-scrape-s", "0.1",
                  "--worker-cmd", json.dumps([sys.executable, "-c", "import time; time.sleep(1)"])])
    status = json.loads((fleet_dir / "status.json").read_text())
    assert rc.value.code == 0 and status["metrics_port"] and status["scrape"]["cycles"] >= 1

    sup = FleetSupervisor(str(tmp_path / "spool2"), lambda wid: [sys.executable, "-c", "import time; time.sleep(30)"],
                          workers=1, fleet_metrics_port=0, scrape_s=0.1, log=lambda m: None)
    t = threading.Thread(target=lambda: sup.run(poll_s=0.05, max_seconds=60, install_signals=False))
    t.start()
    try:
        deadline = time.time() + 30
        while time.time() < deadline and (sup.plane is None or sup.plane.bound_port is None):
            time.sleep(0.02)
        capsys.readouterr()
        cli.main(["top", "--port", str(sup.plane.bound_port), "--once"])
        frame = capsys.readouterr().out
    finally:
        sup.stop()
        t.join(timeout=60)
    assert f"fleet {sup.fleet_id}  NOT READY" in frame and "w0" in frame
    assert not torch.cuda.is_initialized()


def test_chaos_without_cuda_raises_before_spawning(monkeypatch, tmp_path):
    """The chaos harness proves on CUDA unless --device cpu: without CUDA
    its parent raises before it writes a request or spawns a process, and
    a worker raises before it builds anything."""
    from zkp2p_tpu_torch.tools import chaos

    def no_spawn(*a, **k):
        raise AssertionError("spawned a process")

    spool = tmp_path / "spool"
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        m.setattr(subprocess, "Popen", no_spawn)
        m.setattr(chaos, "_build_world", no_spawn)
        for argv in (["--spool", str(spool)], ["--spool", str(spool), "--fleet", "2"],
                     ["--worker", "--spool", str(spool)]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                chaos.main(argv)
    assert not spool.exists()
    out = subprocess.run([sys.executable, "-m", "zkp2p_tpu_torch.tools.chaos", "--spool", str(spool)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and "no CUDA device" in out.stderr and not spool.exists()


def test_scheduler_and_loadgen_load_no_jax():
    """The scheduler and the load generator import neither JAX nor the
    reference package."""
    mods = ["zkp2p_tpu_torch.pipeline.sched", "zkp2p_tpu_torch.tools.loadgen"]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print([m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'zkp2p_tpu')])\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_loadgen_without_cuda_raises_before_writing_or_spawning(monkeypatch, tmp_path):
    """The load generator serves on CUDA unless --device cpu: without CUDA
    it raises before it writes a request, builds a world or spawns a
    fleet, in process and from its entry point."""
    from zkp2p_tpu_torch.tools import loadgen

    def no_spawn(*a, **k):
        raise AssertionError("spawned a process or built a world")

    spool = tmp_path / "spool"
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        m.setattr(subprocess, "Popen", no_spawn)
        m.setattr(loadgen, "toy_world", no_spawn)
        m.setattr(loadgen, "build_venmo", no_spawn)
        for argv in (["--spool", str(spool)], ["--spool", str(spool), "--fleet", "1", "--fleet-max", "2"],
                     ["--spool", str(spool), "--circuit", "venmo"], ["--spool", str(spool), "--device", "cuda"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                loadgen.main(argv)
    assert not spool.exists()
    out = subprocess.run([sys.executable, "-m", "zkp2p_tpu_torch.tools.loadgen", "--spool", str(spool)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and "no CUDA device" in out.stderr and not spool.exists()


SENTRY_MODULES = ("hostprof", "perfledger", "flameprof")


def test_the_sentry_and_the_sampler_load_no_jax_and_read_no_knob():
    """The fingerprint, the perf ledger and the flame sampler import
    neither JAX nor the reference package, and name no ZKP2P_* variable
    outside their docstrings (their settings are keywords)."""
    mods = [f"zkp2p_tpu_torch.utils.{m}" for m in SENTRY_MODULES]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print([m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'zkp2p_tpu')])\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr
    bad = []
    for name in SENTRY_MODULES:
        tree = ast.parse((PKG / "utils" / f"{name}.py").read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
                and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
        bad += [(name, n.lineno) for n in ast.walk(tree) if isinstance(n, ast.Constant) and id(n) not in docs
                and isinstance(n.value, str) and "ZKP2P_" in n.value]
    assert bad == []


def test_flame_and_perf_without_cuda_raise_before_any_work(monkeypatch, tmp_path):
    """`flame` and `perf` run on (and key their ledger to) the card unless
    --device cpu: without CUDA they raise before they build a circuit or
    read a ledger, in process and from the entry point, and write no
    capture."""
    from zkp2p_tpu_torch.pipeline import cli
    from zkp2p_tpu_torch.utils import perfledger

    def no_work(*a, **k):
        raise AssertionError("built a circuit or read a ledger")

    captures = set(Path(perfledger.DEFAULT_CACHE_DIR).glob("flame_*.json"))
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        m.setattr(cli, "_build_circuit", no_work)
        m.setattr(perfledger, "load_entries", no_work)
        for argv in (["--circuit", "toy", "flame", "--duration", "0"],
                     ["--circuit", "toy", "flame", "--device", "cuda"],
                     ["perf", "--ledger", str(tmp_path / "l.jsonl")], ["perf", "--gate"], ["perf", "--json"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli.main(argv)
    out = subprocess.run([sys.executable, "-m", "zkp2p_tpu_torch", "--circuit", "toy", "--build-dir",
                          str(tmp_path / "b"), "flame", "--duration", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and "no CUDA device" in out.stderr and out.stdout == ""
    assert set(Path(perfledger.DEFAULT_CACHE_DIR).glob("flame_*.json")) <= captures
