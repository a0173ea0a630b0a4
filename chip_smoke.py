#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zkp2p_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each of which raises on failure (the script then exits nonzero
and prints no result line):

1. Build: every kernel source under zkp2p_tpu_torch/csrc/ with nvcc for
   sm_90a, one process per source, all started together, timed as
   set-up.
2. Kernels against plain: each of the twenty-five launchers (K1
   mont_mul; K2 add, K3 add_mixed, K4 double for G1 and G2; K5 mont_pow;
   K6/K8 the G1 and G2 window tables, K7/K9 the G1 and G2 window
   accumulates; K10/K11 the G1 and G2 Horner folds; K12 the NTT pass;
   K13 the CSR sparse matvec over Fr; K14 the signed digit recode; K15
   batch_inverse and jac_to_affine; K16 the G1 and G2 affine add and
   affine accumulate; K17 the G1 and G2 fixed-base batch) on
   random canonical inputs with the special cases (zero, one, p-1; P+P,
   P+(-P), infinity, the (0, 0) affine sentinel; for K7/K9 also acc
   equal to its entry and to its negation, and e = 16 digits) at batches
   1, 257 and one large batch, held bitwise against its plain torch
   version on the card; a sample against Python ints and the host curve.
   Then each at the main path's shape (K5 also at 2^16; K6/K7 at each
   chunk shape the path gives them: the h MSM's 64 planes x 4,096 lanes
   x 170 steps, the narrow classes' 3 x 16,384 x 42 and the wide
   classes' 64 x 2,088 x 17; K8/K9 at the b2 MSM's narrow chunk 3 x 4,096
   x 85 and wide chunk 64 x 572 x 17, with the special lanes): timed, its
   plain version timed on the same inputs, and the two outputs held
   bitwise.  The whole G1 MSM through K6/K7, at 2^16 points with 64 digit
   planes and at 2^18 with the narrow class's 3 (16,384 lanes), and the
   whole G2 MSM through K8/K9, at 2^16 points with 64 planes (2,048
   lanes) and with 3 (4,096 lanes), are held bitwise against the step
   loop over K2/K3 and against host discrete logs.  K10/K11 at (lanes,
   planes, window) (1, 3, 4), (257, 64, 4) and (1, 16, 16) and at each
   fold the paths give them (G1: the h MSM's 4,096 x 64 x 4, the wide
   classes' 2,088 and 572 lanes x 64 x 4, the narrow classes' 16,384 x 3
   x 4, the bucket h MSM's 1 x 16 x 16; G2: b2 wide 572 x 64 x 4 and b2
   narrow 4,096 x 3 x 4), with the special lanes (init at infinity,
   partials at infinity, a partial equal to 2^w * acc and to -2^w * acc):
   timed, with the operation bound and the chain floor, and held bitwise
   against one plain run over all the lanes of the same (planes, window).
   K12 on three random canonical rows with 0, 1, r-1 and the Montgomery
   one at log m 1, 2, 11, 12 and 16, at every pass of each size's plan
   (the first pass bit-reversed, with no factor, the 1/m constant and the
   g^i / m table; the later ones also in place), held bitwise against
   ntt_pass_plain, and ntt, intt and coset_ladder there against the
   stage-at-a-time _ntt_core compositions; then each pass of the 2^23
   plan at the H ladder's shape (3 rows): timed with its bound, its plain
   version timed on the same inputs, both held bitwise; and ntt and intt
   of one 2^23 row against _ntt_core (K1 products, plain add/sub).
   K13 on random CSR matrices of 1, 257 and 2^20 rows (an empty row, a
   wire repeated in a row, coefficients and witness values 0, 1, r-1, and
   in the 257-row one a row of 100,001 nonzeros), held bitwise against
   fr_matvec_plain and sample rows against Python ints; K14 at 1, 257 and
   2^20 scalars at w = 4 and w = 16 with the carry-chain scalars, held
   bitwise (mags and negs) against the Kogge-Stone recode and a sample
   against a serial recode over Python ints; K14 then at the path's
   shapes (the witness at w = 4, 2^23 at w = 4 and w = 16), timed with
   its bound and its plain version, held bitwise.
   The batch prover's kernels over a batch of witnesses: K7 and K9 at
   B = 2 and 3 on cut shapes (257 lanes x 64 and 3 planes x 3 steps) and
   K13 at B = 2 and 3 on the 257-row and 2^20-row matrices, each held
   bitwise against its plain version and against the unbatched kernel
   run once a witness; then K7 at 4 witnesses of the h MSM's chunk (64 x
   4,096 x 170) and K9 at 4 of the b2 narrow chunk (3 x 4,096 x 85), the
   plain version over their first 8 steps held bitwise, the whole chunk
   timed against the unbatched kernel a witness (bitwise equal); K13 at 4
   witnesses on the key's A (phase 4), timed, held bitwise against both.
   K15 batch_inverse at 1, 257 and 2^16 elements of Fq, Fr and Fq2 with
   0, 1, p-1 and the Montgomery one, held bitwise against the kernels'
   grouping in plain torch (batch_inverse_blocked) and, on its nonzero
   lanes, against the grid-wide plain route, K5 and Python pow (a zero
   gives 0); K15 jac_to_affine and K16's add and accumulate, G1 and G2,
   at 1, 257 and 2^16 with the special lanes (a first add from infinity,
   an addend at infinity, P + P, P + (-P), the same x with another y, a
   doubling with y = 0, zero digits, a (0, 0) base) and on strided and
   broadcast operands, held bitwise against their plain versions.  Then
   K15 at batch 1 against K5 in turns (K5, K15, K15, K5), timed with its
   chain floor; batch_inverse and jac_to_affine at each table chunk of
   the affine path (narrow 42 x 8 x 16,384, a wide 17 x 8 x 2,048, b1
   wide 18 x 8 x 512, b2 narrow 85 x 8 x 4,096 and b2 wide 18 x 8 x 512
   in Fq2) and batch_inverse at a bucket level (2^22 x 16); the K16
   accumulate at each chunk (3 x 16,384 x 42, 64 x 2,048 x 17, 64 x 512
   x 18, 3 x 4,096 x 85 and 64 x 512 x 18 in Fq2), its plain version
   over the first 4 steps; the G1 add at a bucket level (2^22 x 16
   planes, the strided halves of 2^23 x 16) and the G2 add at 2^16:
   each timed with its bound and its plain version (over the first 2^16
   elements above that), held bitwise.  The whole affine MSMs through
   K6/K8 + K15 + K16 at 2^16 (G1 and G2, 64 planes and the narrow 3) and
   the bucket MSM at w = 16 through the grouped planes, held bitwise
   against the old routes (_affine_steps; the bucket a plane at a time)
   and against host discrete logs.
   K17 (the G1 and G2 fixed-base batch of the setup) at 1, 257 and 2^20
   scalars with 0, 1, 2, r-1, r-2, 2^8k and scalars with runs of zero
   windows, held bitwise against fixed_base_plain (over the first 2^16)
   and a sample against the host curve; then at the setup's two launches
   (the a, b1, c and h queries together in G1: 19,825,624 scalars; b2 in
   G2: 1,603,487) and at each G1 query's size, timed with its bound (one
   mixed add a nonzero window) and its plain version, held bitwise.
3. Test vector: prove_gpu on zkp2p_tpu_torch/data/port_vector.npz gives
   the committed proof byte for byte, with the default (Jacobian) MSM
   arms and with the affine ones (msm_affine=True, msm_h="bucket").
   setup_from_rows on the vector's rows (A and B from port_vector.npz, C
   and the widths, seed, VK and public inputs from setup_vector.npz) gives
   its key arrays, blinding points and VK byte for byte and proves its
   proof; verify accepts the proof and rejects a tampered one and a wrong
   public input.
4. Real size, Jacobian path: a seeded synthetic key and witness of the
   flagship circuit's shape (venmo 1024/6400: the counts in VENMO below),
   one warm-up and three timed proofs through prove_gpu.  Every base is
   t_j*G from a small host table, so each of the five MSMs is checked
   against (sum_i s_i t_idx(i) mod r)*G computed from the scalars the
   prover used.  K13 on the key's A and B (their CSR forms; the CSR's
   extra bytes and longest row logged), timed with its bound and its
   plain version, held bitwise.  The witness side at real size (witness
   upload, matvec, ladder and planes as prove_gpu runs them) in turns:
   new (u64 upload, K13, K14), old (host widen, gathered K1 products and
   segment sums, Kogge-Stone), new; abc and the planes held bitwise
   equal (the witness_same_run line).  h_evals is held against the plain
   path (CPU) at 2^16,
   and at real size through K12 against the stage-at-a-time ladder
   (ntt._ladder_steps) in turns (K12, ladder steps, K12; bitwise equal).
   Then the h MSM at real size (2^23 bases, 64 planes) once each way in
   turns (step loops, kernels, kernels, step loops: the accumulate by
   _accumulate_steps and the fold by _fold_steps, or by K6/K7 and K10),
   the four results held bitwise equal, and one more through the kernels
   split into its accumulate, Horner fold and lane tree, the fold timed
   both ways in turns on the same partials (_fold_steps, K10, K10,
   _fold_steps; bitwise equal); the b2 MSM at real size (its narrow and
   wide classes and their join) the same way (step loops, K8/K9 and K11,
   twice, step loops), and its wide fold both ways in turns (_fold_steps,
   K11, K11, _fold_steps); then four proofs with the same r and s, their
   bytes held equal: the G1 and G2 MSMs through the step loops (accumulate
   and fold), with only the fold through _fold_steps, through the
   kernels, and through the kernels with the old witness side.
   Then the batch phase: 8 distinct seeded witnesses of the same key,
   one warm-up chunk, then in turns with the same (r, s):
   prove_gpu_batch (chunk 4, launches counted), prove_gpu on each
   witness, prove_gpu_batch again; all proof bytes equal, each batch
   proof's accumulators equal to the looped proof's and its five MSMs
   checked against their discrete-log values; launches a chunk: the
   tables, accumulates, folds and lane trees (K2, K6-K11) as many as one
   proof's, K13 and K14 2, K12 6; the peak device memory of one chunk of
   1, 2 and 4 witnesses, and the key's resident bytes.
5. Real size, affine path: the same key and witness, one warm-up and
   three timed proofs with msm_affine=True, msm_h="bucket" (the
   batch-affine accumulate through K6/K8, K15 and K16, and the w=16
   sorted-prefix bucket h MSM, its planes in groups of PLANE_GROUP,
   every add K16), the first's five MSMs checked the same way; then
   proofs with the same r and s, their bytes held equal: the affine path
   through the kernels, through the kernels with the bucket's planes in
   groups of 1, 2, 4, 8 and 16 (PLANE_GROUPS), and the Jacobian path,
   each with its peak device memory (the affine_same_run line).
6. Real size, the key: a satisfying synthetic R1CS with the flagship's
   counts made on the card (A covers every private wire, B's wires are
   the synthetic b_sel, C_j = {0: (Aw)_j (Bw)_j} with w_0 = 1), its
   setup through setup_from_rows with every stage timed and its launches
   counted (K17, K15's batch_inverse and jac_to_affine, K13 over the
   transposed A, B and C, twice for C, whose wire 0 row is cut into
   chunks, K1), the selections' sizes checked,
   sampled bases of each query against the host curve at scalars
   computed in Python ints; K13 over A^T and K15's batch_inverse at the
   setup's (2, 2^23) timed with their bounds and plain versions; one
   prove_gpu proof under the key, which verify accepts (and rejects with
   a wrong public input); save_dpk / load_dpk of the key at full size
   into .chip_scratch/ (timed, the file's size logged, deleted after), the
   loaded key proving the same bytes (the real_size_setup line).

The launch counts are reset just before the first timed proof of each
path and read just after it; every kernel of a path must have launched in
its run (on the Jacobian path K1, K2 and K6-K14; on the affine path K1,
K2, K6, K8, K10-K14, K15's jac_to_affine, K16's G1 add and both
accumulates; in the setup of phase 6, counted from just before it to just
after it, K1, K13 (once a matrix, twice for one with a long row), K15's
batch_inverse and jac_to_affine and K17), the launchers of OFF_PATH (K3, K4, K5, K16's G2 add) on no path and
K15's batch_inverse and K17 on no proof's path; K12 launches once a pass of the
iNTT and of the NTT on each path, K13 and K14 twice a proof on each path,
and K1 at most 5 times a proof on each path (printed); on the batch path,
besides the per-chunk counts above, nothing of OFF_PATH or the affine
path.

Before the last line it prints the card's name and power limit, a
profile each of one more Jacobian and one more affine proof, run after
every timed proof (the device's busy share and the ops with the most
device time, from torch.profiler), one JSON line with the
twenty-five kernels (checks, launches on each path, times and bounds),
one each with the two paths' per-stage times, launches and peak device
memory, and one each with the same-run comparisons of the witness side
(witness_same_run), the H ladder (ntt_same_run), the h MSM, the b2 MSM,
the proof, the affine MSMs at 2^16 (affine_msm_same_run) and the affine
proof at each plane group beside the Jacobian one (affine_same_run), and the batch phase's lines: real_size_batch (proofs/s,
per-chunk stage seconds, peak memory a chunk size) and batch_same_run
(the batch against prove_gpu in a loop), the test vector's setup
(setup_vector) and the real-size key (real_size_setup: stage seconds,
launches, selections, the proof's and the verifier's seconds, the
cache's).  The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import random
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

# The flagship circuit's prover shape, read once from
# zkp2p_tpu.models.venmo.build_venmo_circuit(VenmoParams()) (see PERF.md
# for the command).  Narrow = wires with width bound <= 11 bits.
VENMO = dict(
    constraints=4939112, n_public=26, n_wires=4916778, rows=4939139, log_m=23,
    nnz_a=11736979, nnz_b=9823884,
    b_narrow=1594332, b_wide=9155, c_narrow=4883364, c_wide=33387,
)
SEED = 20261017
K1_BATCHES = (1, 257, 1 << 20)
POINT_BATCHES = (1, 257, 1 << 18)
K5_BATCHES = (1, 257, 1 << 16)
# K17: scalars held bitwise against the plain comb, before the setup's shapes
FIXED_BASE_BATCHES = (1, 257, 1 << 20)
# phase 6: the real-size setup's seed, and the random samples of each query
# checked against the host curve (besides the first and last ones)
SETUP_SEED = "chip-smoke-setup"
SETUP_SAMPLES = 4
# K5 at the main path's shape (one element: the total of a batch
# inversion) and at a batch that fills the card
K5_TIMED = (1, 1 << 16)
G1_TABLE = 1024
G2_TABLE = 256
HOLES = 16  # (0, 0) infinity bases placed in the a and h queries
JACOBIAN_TIMED = 3  # timed real-size proofs of the Jacobian path
AFFINE_ARMS = {"msm_affine": True, "msm_h": "bucket"}
# the bucket h MSM's plane group sizes timed against the default in one call
PLANE_GROUPS = (1, 2, 4, 8, 16)
H_CHECK_LOG_M = 16
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
INT_MULS_PER_SM_CLK = 64  # 32-bit integer multiply-adds per SM per clock (Hopper: 64 INT32 lanes per SM)
# 32-bit multiplies of one 8x32-bit CIOS Montgomery product: 64 + 64
# wide products (lo and hi halves) and 8 low products
MULS_PER_MONT = 2 * 64 + 2 * 64 + 8
# Montgomery products per point op on a generic lane (Fq2 product = 3)
MONTS = {"add": 16, "add_mixed": 11, "double": 7}
# limb bytes read + written per element: operands in, three coordinates out
COORDS = {"add": (6, 3), "add_mixed": (5, 3), "double": (3, 3)}
# The dependent chain of one CIOS product (mont.cuh): 8 outer steps, each
# 8 multiply-adds for a*b[i], one for m and 8 for m*N, each step waiting
# on the last; at an assumed 4-clock latency of a 32-bit multiply-add
CHAIN_MADS_PER_MONT = 8 * (8 + 1 + 8)
MAD_LATENCY_CLK = 4
# Montgomery products on the critical path of a doubling and of an add
# (csrc/msm_fold.cu's count from point.cuh; an Fq2 product is one deep)
CHAIN_MONTS = {"double": 3, "add": 5}

REPLACES = {
    "mont_mul": "zkp2p_tpu/ops/pallas_mont.py:201",
    "mont_pow": "zkp2p_tpu/ops/pallas_mont.py:155",
    "g1_add": "zkp2p_tpu/ops/pallas_curve.py:351",
    "g1_add_mixed": "zkp2p_tpu/ops/pallas_curve.py:358",
    "g1_double": "zkp2p_tpu/ops/pallas_curve.py:364",
    "g2_add": "zkp2p_tpu/ops/pallas_curve.py:369",
    "g2_add_mixed": "zkp2p_tpu/ops/pallas_curve.py:375",
    "g2_double": "zkp2p_tpu/ops/pallas_curve.py:380",
    "g1_window_table": "zkp2p_tpu/ops/pallas_curve.py:358",
    "g1_window_accumulate": "zkp2p_tpu/ops/pallas_curve.py:351",
    "g2_window_table": "zkp2p_tpu/ops/pallas_curve.py:375",
    "g2_window_accumulate": "zkp2p_tpu/ops/pallas_curve.py:369",
    "g1_horner_fold": "zkp2p_tpu/ops/pallas_curve.py:364",
    "g2_horner_fold": "zkp2p_tpu/ops/pallas_curve.py:380",
    "fr_ntt_pass": "zkp2p_tpu/ops/pallas_mont.py:201",
    "fr_matvec": "zkp2p_tpu/ops/pallas_mont.py:201 (segment sum: zkp2p_tpu/field/jfield.py:431)",
    "signed_recode": "zkp2p_tpu/ops/msm.py:129 (XLA, no Pallas row)",
    "batch_inverse": "zkp2p_tpu/ops/pallas_mont.py:155 (in zkp2p_tpu/ops/msm_affine.py:69 batch_inverse)",
    "jac_to_affine": "zkp2p_tpu/ops/pallas_mont.py:155 (in zkp2p_tpu/ops/msm_affine.py:104 jac_to_affine_batch)",
    "g1_affine_add": "zkp2p_tpu/ops/pallas_mont.py:201 (XLA around it: zkp2p_tpu/ops/msm_affine.py:163)",
    "g2_affine_add": "zkp2p_tpu/ops/pallas_mont.py:201 (XLA around it: zkp2p_tpu/ops/msm_affine.py:163)",
    "g1_affine_accumulate": "zkp2p_tpu/ops/pallas_mont.py:201 (XLA around it: zkp2p_tpu/ops/msm_affine.py:221)",
    "g2_affine_accumulate": "zkp2p_tpu/ops/pallas_mont.py:201 (XLA around it: zkp2p_tpu/ops/msm_affine.py:221)",
    "g1_fixed_base": "csrc/zkp2p_native.cpp:904 (native C++ g1_fixed_base_batch_mont, no Pallas row)",
    "g2_fixed_base": "csrc/zkp2p_native.cpp:973 (native C++ g2_fixed_base_batch_mont, no Pallas row)",
}
WINDOW_KERNELS = ("g1_window_table", "g1_window_accumulate", "g2_window_table", "g2_window_accumulate")
FOLD_KERNELS = ("g1_horner_fold", "g2_horner_fold")
# K15 and K16, and the ones the affine path runs (K15's jac_to_affine,
# K16's G1 add for the bucket MSM, both accumulates)
AFFINE_KERNELS = ("batch_inverse", "jac_to_affine", "g1_affine_add", "g2_affine_add", "g1_affine_accumulate",
                  "g2_affine_accumulate")
AFFINE_PATH_KERNELS = ("jac_to_affine", "g1_affine_add", "g1_affine_accumulate", "g2_affine_accumulate")
SOURCE = {"mont_mul": "mont_mul.cu", "mont_pow": "mont_pow.cu",
          **dict.fromkeys(AFFINE_KERNELS[:2], "batch_inv.cu"), **dict.fromkeys(AFFINE_KERNELS[2:], "affine_add.cu"),
          **dict.fromkeys(WINDOW_KERNELS, "msm_window.cu"),
          **dict.fromkeys(FOLD_KERNELS, "msm_fold.cu"), "fr_ntt_pass": "ntt.cu",
          "fr_matvec": "matvec.cu", "signed_recode": "recode.cu",
          "g1_fixed_base": "fixed_base.cu", "g2_fixed_base": "fixed_base.cu"}  # the rest: point_ops.cu
# the launchers each real-size path must have launched, and must not have
_POINT_KERNELS = ("g1_add", "g2_add") + FOLD_KERNELS
# the witness side: K13 (Az, Bz) and K14 (the witness's planes, H's)
WITNESS_KERNELS = ("fr_matvec", "signed_recode")
PATH_KERNELS = {
    "jacobian": ("mont_mul", "fr_ntt_pass") + WITNESS_KERNELS + _POINT_KERNELS + WINDOW_KERNELS,
    "batch": ("mont_mul", "fr_ntt_pass") + WITNESS_KERNELS + _POINT_KERNELS + WINDOW_KERNELS,
    "affine": ("mont_mul", "fr_ntt_pass") + WITNESS_KERNELS + _POINT_KERNELS
    + ("g1_window_table", "g2_window_table") + AFFINE_PATH_KERNELS,
}
# the setup path (phase 6): K17 for the query points, K15's batch_inverse
# for the Lagrange denominators and jac_to_affine for the points, K13 over
# the transposed A, B and C (C's long wire-0 row in two passes), K1 for the
# powers, products and from_mont
FIXED_BASE_KERNELS = ("g1_fixed_base", "g2_fixed_base")
SETUP_KERNELS = FIXED_BASE_KERNELS + ("batch_inverse", "jac_to_affine", "fr_matvec", "mont_mul")
PATH_KERNELS["setup"] = SETUP_KERNELS
# K1's launches left on a proof, either path: to_mont of the witness, Cz =
# Az*Bz, a*b after the ladder, from_mont of the witness and of H
K1_JACOBIAN_MAX = 5
# held against their plain versions in phase 2, launched on no path: K3
# and K4 (K6/K8 build every path's tables, K10/K11 do the doublings), K5,
# K16's G2 add (the bucket MSM is G1-only)
OFF_PATH = ("g1_add_mixed", "g2_add_mixed", "g1_double", "g2_double", "mont_pow", "g2_affine_add")
# the proofs run neither K17 nor K15's batch_inverse (the affine path
# inverts inside K15's jac_to_affine and K16): those are the setup's
NOT_ON_JACOBIAN = OFF_PATH + AFFINE_PATH_KERNELS + FIXED_BASE_KERNELS + ("batch_inverse",)
NOT_ON_AFFINE = OFF_PATH + ("g1_window_accumulate", "g2_window_accumulate") + FIXED_BASE_KERNELS + ("batch_inverse",)
# K6-K9: (lanes, digit planes, steps) held bitwise against plain, before
# the path's chunk shapes
WINDOW_BATCHES = ((1, 64, 3), (257, 64, 3), (257, 3, 3))
N_TABLE = 8  # window 4
# K15/K16: batches held bitwise against plain; the elements that share
# one inversion in K15 (256 threads x 4), K16's block (the accumulate's
# thread owns one lane; the add's takes K16_PER elements)
AFFINE_BATCHES = (1, 257, 1 << 16)
INV_BLOCK = 1024
K16_BLOCK = {False: 256, True: 128}
K16_PER = 4
# above this many elements the plain versions run over the first ones
# (each output depends on its own element's inputs alone), and the K16
# accumulate's over a chunk's first AFFINE_PLAIN_STEPS steps
PLAIN_SLICE = 1 << 16
AFFINE_PLAIN_STEPS = 4
# a w = 16 bucket h MSM's first prefix level: 2^22 pairs in each of 16 planes
BUCKET_LEVEL = (1 << 22, 16)
# the dependent chain of one Euclid round (csrc/affine.cuh: fe_inv): the
# 8-word compare-subtract, the x subtract and add-back, one strip (8
# multiply-adds, a shift)
CHAIN_OPS_PER_ROUND = 8 + 16 + 10
# the whole affine MSMs held against the old route and the host: (name,
# log2 of the points, digit planes, lane cap as the prover sets it), and
# the bucket MSM at w = 16 at 2^AFFINE_MSM_LOG
AFFINE_MSMS = {False: (("64 planes", 16, 64, 4096), ("narrow", 16, 3, 16384)),
               True: (("64 planes", 16, 64, 2048), ("narrow", 16, 3, 4096))}
AFFINE_MSM_LOG = 16
AFFINE_TIMED = 3  # timed real-size proofs of the affine path
# the whole MSM through K6/K7 (G1) and K8/K9 (G2) against the step loop:
# (name, log2 of the points, digit planes, lane cap as the prover sets it)
WINDOW_MSMS = {
    False: (("64 planes", 16, 64, 4096), ("3 planes", 18, 3, 16384)),
    True: (("64 planes", 16, 64, 2048), ("3 planes", 16, 3, 4096)),
}
# K10/K11: (lanes, planes, window) held bitwise against plain, before the
# paths' fold shapes
FOLD_CASES = ((1, 3, 4), (257, 64, 4), (1, 16, 16))
# K12: log2 of the domains held bitwise against plain at every pass of
# their plans (11: one pass of 64 KB of shared memory a block), before the
# 2^23 plan's passes at the H ladder's shape (three rows)
NTT_CHECK_LOGS = (1, 2, 11, 12, 16)
LADDER_ROWS = 3
# K13: rows of the random CSR matrices held bitwise against plain (about
# three nonzeros a row, special rows; the 257-row one also holds a row of
# MATVEC_LONG_ROW nonzeros), before the synthetic key's A and B
MATVEC_BATCHES = (1, 257, 1 << 20)
MATVEC_LONG_ROW = 100_001
# K14: scalars held bitwise against plain at each window, before the
# path's shapes (the witness at w = 4, H at w = 4 and w = 16)
RECODE_BATCHES = (1, 257, 1 << 20)
RECODE_WINDOWS = (4, 16)
# The batch prover: K7/K9 and K13 over B witnesses held bitwise against
# their plain versions at these B on cut shapes (K7/K9 at WINDOW_BATCHES'
# last two (lanes, planes, steps); K13 at MATVEC_BATCHES' last two row
# counts), then at the chunk BATCH_CHUNK of the real size (K7/K9 at the h
# MSM's and the b2 narrow MSM's chunk, the plain version over the first
# BATCH_PLAIN_STEPS steps; K13 on the key's A)
BATCH_SIZES = (2, 3)
BATCH_CHUNK = 4
BATCH_PLAIN_STEPS = 8
# the batch phase: BATCH_WITNESSES real-size witnesses at chunk BATCH_CHUNK,
# and the peak device memory of one chunk at each of PEAK_CHUNKS
BATCH_WITNESSES = 8
PEAK_CHUNKS = (1, 2, 4)
# the launchers whose launches a batch chunk makes as often as one proof:
# the tables once a chunk of steps, the accumulates once for the chunk's
# witnesses, the folds and the lane trees once over the chunk's lanes
PER_CHUNK_AS_ONE_PROOF = WINDOW_KERNELS + FOLD_KERNELS + ("g1_add", "g2_add")


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ inputs


def rand_canon(torch, gen, shape, device):
    """Random limbs below both BN254 moduli (top limb < 0x3064)."""
    x = torch.randint(0, 1 << 16, tuple(shape) + (16,), generator=gen, device=device, dtype=torch.int32)
    x[..., 15] = torch.randint(0, 0x3064, tuple(shape), generator=gen, device=device, dtype=torch.int32)
    return x


def k1_inputs(torch, gen, n, mod, device):
    """Random canonical operands for K1, with 0, 1 and p-1 in the first lanes."""
    from zkp2p_tpu_torch.ops import cuda_mont

    a = rand_canon(torch, gen, (n,), device)
    b = rand_canon(torch, gen, (n,), device)
    if n >= 3:
        for k, (x, y) in enumerate(((0, mod - 1), (1, 0), (mod - 1, 1))):
            a[k] = torch.tensor(cuda_mont.limbs_of(x), device=device)
            b[k] = torch.tensor(cuda_mont.limbs_of(y), device=device)
    return a, b


def point_inputs(torch, gen, op, g2, n, device):
    """Random coordinates for one point op, with the special lanes."""
    from zkp2p_tpu_torch.field.tfield import FQ

    elem = (n, 2) if g2 else (n,)
    p = [rand_canon(torch, gen, elem, device) for _ in range(3)]
    if op == "double":
        if n >= 2:
            p[2][0] = 0  # infinity
        return p
    one = FQ.const("one", device).int()
    if op == "add":
        q = [rand_canon(torch, gen, elem, device) for _ in range(3)]
        if n >= 5:
            for c in range(3):
                p[c][0] = 0  # inf + q
                q[c][1] = p[c][1]  # P + P
                q[c][3] = 0  # p + inf
                p[c][4] = q[c][4] = 0  # inf + inf
            q[0][2], q[2][2] = p[0][2], p[2][2]
            q[1][2] = FQ.neg(p[1][2])  # P + (-P)
        return p + q
    a = [rand_canon(torch, gen, elem, device) for _ in range(2)]
    if n >= 5:
        for c in range(3):
            p[c][0] = 0  # inf + a
        if g2:
            one = torch.stack([one, torch.zeros_like(one)])
        p[2][1] = p[2][2] = one  # Z = 1 so that a = (X, Y) and (X, -Y) meet p
        a[0][1], a[1][1] = p[0][1], p[1][1]  # P + P
        a[0][2], a[1][2] = p[0][2], FQ.neg(p[1][2])  # P + (-P)
        a[0][3] = a[1][3] = 0  # (0, 0) sentinel
        a[0][4] = a[1][4] = 0
        for c in range(3):
            p[c][4] = 0  # inf + (0, 0)
    return p + a


# ------------------------------------------------------------------ timing


def cuda_ms(torch, fn, reps: int, warmup: bool = True):
    """(ms per call of fn, the last call's result), after one warm-up
    call unless warmup is False."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def wall_s(torch, fn):
    """(host seconds of fn, its result), around work that ends in a
    synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def chunked(torch, fn, args, chunk):
    """fn over the leading axis in chunks (bounds the plain versions'
    int64 temporaries on large batches)."""
    n = args[0].shape[0]
    outs = [fn(*(a[i:i + chunk] for a in args)) for i in range(0, n, chunk)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat([o[k] for o in outs]) for k in range(len(outs[0])))
    return torch.cat(outs)


def max_abs_err(torch, got, want) -> int:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0 for g, w in zip(got, want))


# --------------------------------------------------------------- phase 2


def check_kernels(torch, geometry, peak_muls_per_s, device):
    """Every launcher against its plain version (bitwise), a sample
    against the host, and its time at the main path's shape."""
    from zkp2p_tpu_torch.curve import host
    from zkp2p_tpu_torch.curve.tcurve import G1C, G2C, g1_jac_to_host, g1_to_affine_arrays, g2_jac_to_host, g2_to_affine_arrays
    from zkp2p_tpu_torch.field.bn254 import MONT_R, P, R
    from zkp2p_tpu_torch.field.tfield import FQ, FR, limbs_to_int
    from zkp2p_tpu_torch.ops import cuda_curve, cuda_mont

    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = {}

    # K1 on Fr and Fq
    for field, mod in ((FR, R), (FQ, P)):
        for n in K1_BATCHES:
            a, b = k1_inputs(torch, gen, n, mod, device)
            got = cuda_mont.mont_mul(field, a, b)
            want = chunked(torch, lambda x, y: cuda_mont.mont_mul_plain(field, x, y), (a, b), 1 << 18)
            err = max_abs_err(torch, got, want)
            if err:
                raise AssertionError(f"mont_mul ({field.name}, n={n}) differs from its plain version")
            rinv = pow(MONT_R, -1, mod)
            ga, gb, gg = (t[:64].cpu().numpy() for t in (a, b, got))
            for i in range(len(gg)):
                if limbs_to_int(gg[i]) != limbs_to_int(ga[i]) * limbs_to_int(gb[i]) * rinv % mod:
                    raise AssertionError(f"mont_mul ({field.name}) lane {i} differs from Python ints")
        # a broadcast (stride-0) operand, as to_mont multiplies by R^2
        a = rand_canon(torch, gen, (257,), device)
        r2 = FR.const("r2", device).int()
        if max_abs_err(torch, cuda_mont.mont_mul(field, a, r2), cuda_mont.mont_mul_plain(field, a, r2)):
            raise AssertionError(f"mont_mul ({field.name}) broadcast operand differs from its plain version")
    rows["mont_mul"] = dict(max_abs_err=0)
    log("K1 mont_mul: bitwise equal to plain on Fr and Fq")

    # K2-K4 on G1 and G2
    wrappers = {
        (False, "add"): cuda_curve.g1_add, (False, "add_mixed"): cuda_curve.g1_add_mixed,
        (False, "double"): cuda_curve.g1_double, (True, "add"): cuda_curve.g2_add,
        (True, "add_mixed"): cuda_curve.g2_add_mixed, (True, "double"): cuda_curve.g2_double,
    }

    def call(g2, op, coords):
        fn = wrappers[(g2, op)]
        if op == "double":
            return fn(coords)
        k = 3
        return fn(tuple(coords[:k]), tuple(coords[k:]))

    for (g2, op) in wrappers:
        name = f"{'g2' if g2 else 'g1'}_{op}"
        for n in POINT_BATCHES:
            coords = point_inputs(torch, gen, op, g2, n, device)
            got = call(g2, op, coords)
            want = chunked(torch, lambda *c: cuda_curve.point_op_plain(op, g2, *c), coords, 1 << 15)
            if max_abs_err(torch, got, want):
                raise AssertionError(f"{name} (n={n}) differs from its plain version")
        rows[name] = dict(max_abs_err=0)

    # sample against the host curve on points of the group
    ks = [random.Random(SEED + i).randrange(1, R) for i in range(8)]
    for g2, curve, to_arr, to_host, gmul, gadd, gneg, G in (
        (False, G1C, g1_to_affine_arrays, g1_jac_to_host, host.g1_mul, host.g1_add, host.g1_neg, host.G1_GENERATOR),
        (True, G2C, g2_to_affine_arrays, g2_jac_to_host, host.g2_mul, host.g2_add, host.g2_neg, host.G2_GENERATOR),
    ):
        ps = [gmul(G, k) for k in ks[:6]] + [None, gmul(G, ks[6])]
        qs = [gmul(G, k) for k in ks[2:8]] + [gmul(G, ks[7]), None]
        qs[0], qs[1] = ps[0], gneg(ps[1])  # P + P, P + (-P)
        pa, qa = to_arr(ps, device), to_arr(qs, device)
        pj, qj = curve.from_affine(pa), curve.from_affine(qa)
        want_add = [gadd(x, y) for x, y in zip(ps, qs)]
        checks = (
            ("add", to_host(curve.add(pj, qj)), want_add),
            ("add_mixed", to_host(curve.add_mixed(pj, qa)), want_add),
            ("double", to_host(curve.double(pj)), [gadd(x, x) for x in ps]),
        )
        for op, got, want in checks:
            if got != want:
                raise AssertionError(f"{'g2' if g2 else 'g1'}_{op} differs from the host curve")
    log("K2-K4: bitwise equal to plain on G1 and G2; sample equal to the host curve")

    # at the main path's shapes: each launcher timed, its plain version
    # timed on the same inputs, and the two outputs held bitwise
    n_k1 = geometry["mont_mul"]
    for field, mod in ((FR, R), (FQ, P)):
        a, b = k1_inputs(torch, gen, n_k1, mod, device)
        ms, got = cuda_ms(torch, lambda: cuda_mont.mont_mul(field, a, b), 20)
        plain_ms, want = cuda_ms(torch, lambda: chunked(
            torch, lambda x, y: cuda_mont.mont_mul_plain(field, x, y), (a, b), 1 << 20), 2)
        if max_abs_err(torch, got, want):
            raise AssertionError(f"mont_mul ({field.name}, n={n_k1}) differs from its plain version")
        if field is FR:  # a*b over the domain, the shape the main path gives K1
            rows["mont_mul"].update(shape=[n_k1], ms=ms, plain_ms=plain_ms, **bound(n_k1, 1, 192, peak_muls_per_s))
    for (g2, op) in wrappers:
        name = f"{'g2' if g2 else 'g1'}_{op}"
        n = geometry[name]
        coords = point_inputs(torch, gen, op, g2, n, device)
        ms, got = cuda_ms(torch, lambda: call(g2, op, coords), 10)
        plain_ms, want = cuda_ms(torch, lambda: chunked(
            torch, lambda *c: cuda_curve.point_op_plain(op, g2, *c), coords, 1 << 15), 1)
        if max_abs_err(torch, got, want):
            raise AssertionError(f"{name} (n={n}) differs from its plain version")
        monts = MONTS[op] * (3 if g2 else 1)
        nbytes = sum(COORDS[op]) * 64 * (2 if g2 else 1)
        rows[name].update(shape=[n], ms=ms, plain_ms=plain_ms, **bound(n, monts, nbytes, peak_muls_per_s))
    log("all seven launchers: bitwise equal to plain at the main path's shapes")
    return rows


def check_mont_pow(torch, peak_muls_per_s, sm_clock_hz, device):
    """K5 against its plain version (bitwise) on Fq with e = p - 2 and on
    Fr with e = 5 and e = 1, lanes 0, 1 and p - 1 included; a sample
    against Python pow; timed at batch 1 (the main path's shape) and
    2^16, each time held bitwise against its plain version."""
    from zkp2p_tpu_torch.field.bn254 import MONT_R, P, R
    from zkp2p_tpu_torch.field.tfield import FQ, FR, limbs_to_int
    from zkp2p_tpu_torch.ops import cuda_mont

    gen = torch.Generator(device=device).manual_seed(SEED + 6)

    def inputs(n, mod):
        a = rand_canon(torch, gen, (n,), device)
        if n >= 3:
            for k, x in enumerate((0, 1, mod - 1)):
                a[k] = torch.tensor(cuda_mont.limbs_of(x), device=device)
        return a

    for field, mod, e in ((FQ, P, P - 2), (FR, R, 5), (FR, R, 1)):
        rinv = pow(MONT_R, -1, mod)
        for n in K5_BATCHES:
            a = inputs(n, mod)
            got = cuda_mont.mont_pow(field, a, e)
            if max_abs_err(torch, got, cuda_mont.mont_pow_plain(field, a, e)):
                raise AssertionError(f"mont_pow ({field.name}, e={e}, n={n}) differs from its plain version")
            ga, gg = (t[:64].cpu().numpy() for t in (a, got))
            for i in range(len(gg)):
                # Montgomery in and out: from_mont(out) = from_mont(a)^e
                if limbs_to_int(gg[i]) * rinv % mod != pow(limbs_to_int(ga[i]) * rinv % mod, e, mod):
                    raise AssertionError(f"mont_pow ({field.name}, e={e}) lane {i} differs from Python pow")
    log("K5 mont_pow: bitwise equal to plain on Fq (e = p-2) and Fr (e = 5, 1); sample equal to Python pow")

    # timed on the path's case, a Fermat inversion in Fq
    e = P - 2
    products = (e.bit_length() - 1) + bin(e).count("1")  # squarings + multiplies
    row = dict(max_abs_err=0, shape=[K5_TIMED[0]], exponent="p-2 (Fq)", products_per_element=products)
    for n in K5_TIMED:
        a = inputs(n, P)
        ms, got = cuda_ms(torch, lambda: cuda_mont.mont_pow(FQ, a, e), 50 if n == 1 else 10)
        plain_ms, want = cuda_ms(torch, lambda: cuda_mont.mont_pow_plain(FQ, a, e), 1)
        if max_abs_err(torch, got, want):
            raise AssertionError(f"mont_pow (n={n}) differs from its plain version at its timed shape")
        b = bound(n, products, 128, peak_muls_per_s)
        if n == K5_TIMED[0]:
            # one element: the squarings form one dependent chain of products
            chain_ms = (e.bit_length() - 1) * CHAIN_MADS_PER_MONT * MAD_LATENCY_CLK / sm_clock_hz * 1e3
            row.update(ms=ms, plain_ms=plain_ms, chain_floor_ms=chain_ms, **b)
        else:
            row.update({f"ms_{n}": ms, f"plain_ms_{n}": plain_ms, f"bound_ms_{n}": b["bound_ms"],
                        f"bound_by_{n}": b["bound_by"]})
    log(f"K5 mont_pow: {row['ms']:.4f} ms at batch 1, {row[f'ms_{K5_TIMED[1]}']:.4f} ms at {K5_TIMED[1]}; "
        "bitwise equal to plain at both")
    return row


# ------------------------------------------------------- K17 (fixed base)


def fixed_base_scalars(torch, gen, n, device):
    """n random standard-form Fr scalars, the special ones first when n
    holds them all: 0, 1, 2, r-1, r-2, 2^8k, a top byte alone, scalars
    with runs of zero windows."""
    from zkp2p_tpu_torch.field.bn254 import R
    from zkp2p_tpu_torch.ops import cuda_mont

    k = rand_canon(torch, gen, (n,), device)
    rng = random.Random(SEED + 60)
    zero_runs = [int.from_bytes(bytes(b if (j // 4) % 2 else 0 for j, b in enumerate(rng.randbytes(32))), "little")
                 % R for _ in range(3)]
    specials = [0, 1, 2, R - 1, R - 2, 1 << 8, 1 << 128, 1 << 248, 0x30 << 248, 0xFF << 240] + zero_runs
    if n >= len(specials):
        for i, v in enumerate(specials):
            k[i] = torch.tensor(cuda_mont.limbs_of(v), device=device)
    return k


def fixed_base_bound(torch, g2, k, peak_muls_per_s):
    """K17's bound on these scalars: one mixed add (11 products, 3x in
    Fq2) for each nonzero 8-bit window, against the scalars read once,
    the Jacobian points written once and the table read once."""
    from zkp2p_tpu_torch.ops.cuda_fixed_base import DIGITS, WINDOWS

    n = k.shape[0]
    adds = int((torch.stack([(k >> 8) & 0xFF, k & 0xFF]) != 0).sum())
    muls = adds * MONTS["add_mixed"] * (3 if g2 else 1) * MULS_PER_MONT
    coord = 128 if g2 else 64
    nbytes = n * (64 + 3 * coord) + WINDOWS * DIGITS * 2 * coord
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, muls / peak_muls_per_s
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes > t_ops else "operations",
                adds=adds)


def check_fixed_base_kernels(torch, sizes, peak_muls_per_s, device):
    """K17 (G1 and G2) against fixed_base_plain, bitwise, at
    FIXED_BASE_BATCHES scalars with the special ones (the plain version
    over the first PLAIN_SLICE), a sample of the points against the host
    curve; then at each query size of the real setup (`sizes`: name ->
    (G2?, scalars); the first of each group is the setup's launch),
    timed with its bound and its plain version, held bitwise."""
    from zkp2p_tpu_torch.curve import host
    from zkp2p_tpu_torch.curve.tcurve import g1_jac_to_host, g2_jac_to_host
    from zkp2p_tpu_torch.field.tfield import limbs_to_int
    from zkp2p_tpu_torch.ops.cuda_fixed_base import fixed_base, fixed_base_plain, fixed_base_table

    gen = torch.Generator(device=device).manual_seed(SEED + 61)
    rows = {}
    for g2 in (False, True):
        name = f"{'g2' if g2 else 'g1'}_fixed_base"
        base = host.G2_GENERATOR if g2 else host.G1_GENERATOR
        table = fixed_base_table(g2, base, device)
        mul, to_host = (host.g2_mul, g2_jac_to_host) if g2 else (host.g1_mul, g1_jac_to_host)
        for n in FIXED_BASE_BATCHES:
            k = fixed_base_scalars(torch, gen, n, device)
            got = fixed_base(g2, table, k)
            m = min(n, PLAIN_SLICE)
            if max_abs_err(torch, tuple(c[:m] for c in got), fixed_base_plain(g2, table, k[:m])):
                raise AssertionError(f"{name} (n={n}) differs from its plain version")
            idx = sorted({*range(min(n, 16)), n - 1})
            ks = [limbs_to_int(v) for v in k[idx].cpu().numpy()]
            if to_host(tuple(c[idx] for c in got)) != [mul(base, v) for v in ks]:
                raise AssertionError(f"{name} (n={n}) differs from the host curve")
        rows[name] = dict(max_abs_err=0, at_shapes={}, check=(
            f"bitwise equal to plain at {list(FIXED_BASE_BATCHES)} scalars (0, 1, 2, r-1, r-2, 2^8k, zero windows; "
            f"plain over the first {PLAIN_SLICE}) and at every query size of the setup; sample equal to the host "
            f"curve"), library_ms_reason="no PyTorch call multiplies a curve point")
    log(f"K17 fixed_base: bitwise equal to plain on G1 and G2 at {FIXED_BASE_BATCHES}; sample equal to the host")
    for label, (g2, n) in sizes.items():
        name = f"{'g2' if g2 else 'g1'}_fixed_base"
        base = host.G2_GENERATOR if g2 else host.G1_GENERATOR
        table = fixed_base_table(g2, base, device)
        k = rand_canon(torch, gen, (n,), device)
        ms, got = cuda_ms(torch, lambda: fixed_base(g2, table, k), 3)
        m = min(n, PLAIN_SLICE)
        plain_ms, want = cuda_ms(torch, lambda: fixed_base_plain(g2, table, k[:m]), 1, warmup=False)
        if max_abs_err(torch, tuple(c[:m] for c in got), want):
            raise AssertionError(f"{name} at {label} ({n}) differs from its plain version")
        entry = dict(shape=[n], ms=ms, plain_ms=plain_ms, plain_over=m,
                     **fixed_base_bound(torch, g2, k, peak_muls_per_s))
        del got, want, k
        if "shape" not in rows[name]:  # the setup's launch: the row's numbers
            rows[name].update(entry, at=label)
        rows[name]["at_shapes"][label] = entry
        log(f"K17 {name} at {label} ({n} scalars): {ms:.3f} ms, bound {entry['bound_ms']:.3f} ms "
            f"({entry['bound_by']}), plain {plain_ms:.1f} ms over {m}")
    return rows


# ---------------------------------------------------- K15, K16 (affine arm)


def inverse_inputs(torch, gen, n, mod, deg, device):
    """Random canonical elements (n,) or Fq2 (n, 2), with 0, 1, p-1 and the
    Montgomery one in the first lanes (Fq2: in both parts, and (p-1, 0))."""
    from zkp2p_tpu_torch.field.bn254 import MONT_R
    from zkp2p_tpu_torch.ops import cuda_mont

    x = rand_canon(torch, gen, (n, 2) if deg == 2 else (n,), device)
    if n >= 5:
        for k, v in enumerate((0, 1, mod - 1, MONT_R % mod)):
            x[k] = torch.tensor(cuda_mont.limbs_of(v), device=device)
        if deg == 2:
            x[4, 0], x[4, 1] = torch.tensor(cuda_mont.limbs_of(mod - 1), device=device), 0
    return x


def affine_points(torch, gen, g2, shape, device):
    """One affine triple of random canonical coordinates, about 1 in 16
    at infinity with (0, 0) coordinates."""
    elem = (2,) if g2 else ()
    x, y = (rand_canon(torch, gen, tuple(shape) + elem, device) for _ in range(2))
    inf = torch.randint(0, 16, tuple(shape), generator=gen, device=device) == 0
    x[inf] = 0
    y[inf] = 0
    return x, y, inf


def affine_inputs(torch, gen, g2, shape, device):
    """Two affine triples of random canonical coordinates (about 1 in 16
    at infinity, with (0, 0) coordinates) and, from 8 elements up, the
    special lanes of the first axis: a at infinity (lane 0), P + P (1),
    P + (-P) (2), b at infinity (3), both (4), the same x with another y
    (5), the doubling of a point with y = 0 (6)."""
    from zkp2p_tpu_torch.field.tfield import FQ

    elem = (2,) if g2 else ()
    a = [rand_canon(torch, gen, tuple(shape) + elem, device) for _ in range(2)]
    b = [rand_canon(torch, gen, tuple(shape) + elem, device) for _ in range(2)]
    ainf = torch.randint(0, 16, tuple(shape), generator=gen, device=device) == 0
    binf = torch.randint(0, 16, tuple(shape), generator=gen, device=device) == 0
    if shape[0] >= 8:
        ainf[:7], binf[:7] = False, False
        ainf[0] = binf[3] = ainf[4] = binf[4] = True
        b[0][1], b[1][1] = a[0][1], a[1][1]
        b[0][2], b[1][2] = a[0][2], FQ.neg(a[1][2])
        b[0][5] = a[0][5]
        a[1][6] = 0
        b[0][6], b[1][6] = a[0][6], a[1][6]
    for c in a:
        c[ainf] = 0
    for c in b:
        c[binf] = 0
    return (a[0], a[1], ainf), (b[0], b[1], binf)


def affine_table_case(torch, gen, g2, steps, lanes, n_digits, device):
    """K16 accumulate inputs: affine partials (n_digits, lanes) and a
    random affine table (steps, N_TABLE, lanes), digit-minor planes of
    steps + 2 steps read from step 1, and, from 5 lanes up, the special
    lanes: acc equal to the entry its digit picks (lane 0, the doubling)
    and to that entry negated (lane 1, infinity), a (0, 0) base (lane 2),
    acc at infinity (lane 3), zero digits (lane 4)."""
    from zkp2p_tpu_torch.field.tfield import FQ

    elem = (2,) if g2 else ()
    table = [rand_canon(torch, gen, (steps, N_TABLE, lanes) + elem, device) for _ in range(2)]
    mags, negs = digit_planes(torch, gen, n_digits, steps + 2, lanes, device)
    (ax, ay, ainf), _ = affine_inputs(torch, gen, g2, (n_digits, lanes), device)
    s0 = 1
    if lanes >= 5 and n_digits >= 2:
        mags[0, s0, 0], negs[0, s0, 0] = 3, False
        mags[1, s0, 1], negs[1, s0, 1] = 5, False
        ainf[:2, :2] = False
        ax[0, 0], ay[0, 0] = table[0][0, 2, 0], table[1][0, 2, 0]
        ax[1, 1], ay[1, 1] = table[0][0, 4, 1], FQ.neg(table[1][0, 4, 1])
        table[0][:, :, 2] = table[1][:, :, 2] = 0
        ainf[:, 3] = True
        ax[:, 3] = ay[:, 3] = 0
        mags[:, :, 4], negs[:, :, 4] = 0, True
    return (ax, ay, ainf), tuple(table), mags, negs, s0


def check_affine_kernels(torch, shapes, peak_muls_per_s, sm_clock_hz, device):
    """K15 (batch inversion, Jacobian -> affine) and K16 (the affine add
    and accumulate, G1 and G2) against their plain versions, bitwise:
    K15 against the grid-wide plain route (nonzero lanes; zero gives 0)
    and the kernels' grouping (every lane), at AFFINE_BATCHES over Fq, Fr
    and Fq2 with the special values, its nonzero lanes against K5 and a
    sample against Python pow; K16 at AFFINE_BATCHES with the special
    lanes, also on strided and broadcast operands.  Then each at the
    shapes the path gives it (`shapes`), timed with its bound and plain
    version (on the first PLAIN_SLICE elements, or the accumulate's first
    AFFINE_PLAIN_STEPS steps, above them), and K15 at batch 1 against K5
    in turns."""
    from zkp2p_tpu_torch.curve.tcurve import G1C, G2C
    from zkp2p_tpu_torch.field.bn254 import MONT_R, P, R
    from zkp2p_tpu_torch.field.tfield import FQ, FQ2, FR, limbs_to_int
    from zkp2p_tpu_torch.ops import cuda_affine, cuda_mont
    from zkp2p_tpu_torch.ops import msm_affine as MA

    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    pyr = random.Random(SEED + 31)
    fields = {"fq": (FQ, P, 1), "fr": (FR, R, 1), "fq2": (FQ2, P, 2)}

    def inv_check(F, mod, deg, x):
        got = MA.batch_inverse(F, x)
        z = F.is_zero(x)
        m = min(x.shape[0], PLAIN_SLICE)
        blocked = MA.batch_inverse_blocked(F, x[:m], INV_BLOCK)
        glob = MA._batch_inverse_steps(MA.plain_ops(F), x[:m])
        err = max_abs_err(torch, got[:m], blocked)
        err = max(err, max_abs_err(torch, got[:m][~z[:m]], glob[~z[:m]]))
        if err or got[z].any():
            raise AssertionError(f"batch_inverse ({deg}, n={x.shape[0]}) differs from its plain versions")
        if deg == 1:
            k5 = cuda_mont.mont_pow(F, x[:m], mod - 2)
            if max_abs_err(torch, got[:m][~z[:m]], k5[~z[:m]]):
                raise AssertionError(f"batch_inverse (n={x.shape[0]}) differs from K5")
            rinv = pow(MONT_R, -1, mod)
            gx, gg = x[:32].cpu().numpy(), got[:32].cpu().numpy()
            for i in range(len(gg)):
                v = limbs_to_int(gx[i]) * rinv % mod
                if limbs_to_int(gg[i]) * rinv % mod != pow(v, mod - 2, mod):
                    raise AssertionError(f"batch_inverse lane {i} differs from Python pow")

    for F, mod, deg in fields.values():
        for n in AFFINE_BATCHES:
            inv_check(F, mod, deg, inverse_inputs(torch, gen, n, mod, deg, device))
    log("K15 batch_inverse: bitwise equal to both plain versions on Fq, Fr and Fq2 at "
        f"{AFFINE_BATCHES}; equal to K5 and to Python pow")

    curves = {False: G1C, True: G2C}
    for g2, curve in curves.items():
        P_F = MA.plain_ops(curve.F)
        for n in AFFINE_BATCHES:
            elem = (2,) if g2 else ()
            X, Y, Z = (rand_canon(torch, gen, (n,) + elem, device) for _ in range(3))
            Z[::7] = 0
            got = MA.jac_to_affine_batch(curve.F, (X, Y, Z))
            if max_abs_err(torch, got, MA._jac_to_affine_steps(P_F, (X, Y, Z))):
                raise AssertionError(f"jac_to_affine ({'G2' if g2 else 'G1'}, n={n}) differs from its plain version")
            a, b = affine_inputs(torch, gen, g2, (n,), device)
            got = MA.affine_add_complete(curve.F, a, b)
            if max_abs_err(torch, got, MA._affine_add_steps(P_F, a, b)):
                raise AssertionError(f"{'g2' if g2 else 'g1'}_affine_add (n={n}) differs from its plain version")
        # strided halves and a broadcast row, as the bucket MSM gives them
        a, _ = affine_inputs(torch, gen, g2, (514, 3), device)
        ev, od = tuple(c[0::2] for c in a), tuple(c[1::2] for c in a)
        for x, y in ((ev, od), (tuple(c[-1:].expand_as(e) for c, e in zip(od, ev)), ev)):
            if max_abs_err(torch, MA.affine_add_complete(curve.F, x, y), MA._affine_add_steps(P_F, x, y)):
                raise AssertionError(f"{'g2' if g2 else 'g1'}_affine_add on strided operands differs from plain")
        for lanes, n_digits, steps in ((1, 64, 3), (257, 64, 3), (257, 3, 3)):
            acc, table, mags, negs, s0 = affine_table_case(torch, gen, g2, steps, lanes, n_digits, device)
            got = MA.affine_accumulate(curve, acc, table, mags, negs, s0)
            want = MA._affine_accumulate_steps(P_F, acc, table, mags, negs, s0)
            got_c = MA.affine_accumulate(curve, acc, table, mags.contiguous(), negs.contiguous(), s0)
            if max(max_abs_err(torch, got, want), max_abs_err(torch, got_c, want)):
                raise AssertionError(f"{'g2' if g2 else 'g1'}_affine_accumulate ({n_digits} x {lanes}) differs "
                                     "from its plain version")
    log(f"K15 jac_to_affine, K16 affine add and accumulate (G1, G2): bitwise equal to plain at {AFFINE_BATCHES}, "
        "special lanes, strided and broadcast operands included")

    # the dependent chain of one inversion (csrc/affine.cuh: fe_inv): its
    # rounds on this card's inputs, as inv_model counts them
    rounds = [cuda_affine.inv_model(pyr.randrange(1, P), P)[1] for _ in range(64)]
    avg_rounds = statistics.mean(rounds)

    def chain_ms(products, n_rounds):
        return (products * CHAIN_MADS_PER_MONT + n_rounds * CHAIN_OPS_PER_ROUND) * MAD_LATENCY_CLK / sm_clock_hz * 1e3

    def plain_ms(fn):
        return cuda_ms(torch, fn, 1, warmup=False)

    rows = {}
    # K15 at batch 1 against K5, in turns (K5, K15, K15, K5)
    x1 = inverse_inputs(torch, gen, 1, P, 1, device)
    x1[0, 0] |= 1  # nonzero
    k5_fn = lambda: cuda_mont.mont_pow(FQ, x1, P - 2)  # noqa: E731
    k15_fn = lambda: MA.batch_inverse(FQ, x1)  # noqa: E731
    t = [cuda_ms(torch, fn, 50)[0] for fn in (k5_fn, k15_fn, k15_fn, k5_fn)]
    if max_abs_err(torch, k5_fn(), k15_fn()):
        raise AssertionError("batch_inverse at batch 1 differs from K5")
    n_rounds = cuda_affine.inv_model(limbs_to_int(x1[0].cpu().numpy()), P)[1]
    p_ms, _ = plain_ms(lambda: MA.batch_inverse_blocked(FQ, x1, INV_BLOCK))
    rows["batch_inverse"] = dict(
        max_abs_err=0, shape=[1], ms=min(t[1], t[2]), plain_ms=p_ms, ms_turns_k5_k15_k15_k5=t,
        chain_floor_ms=chain_ms(1, n_rounds), rounds=n_rounds, avg_rounds_random=avg_rounds,
        **bound(1, 1, 128, peak_muls_per_s))
    log(f"K15 at batch 1: {min(t[1], t[2]):.4f} ms against K5 {min(t[0], t[3]):.4f} ms (turns {t}); "
        f"{n_rounds} Euclid rounds")

    def timed_inverse(label, F, mod, deg, n):
        x = inverse_inputs(torch, gen, n, mod, deg, device)
        ms, got = cuda_ms(torch, lambda: MA.batch_inverse(F, x), 5)
        m = min(n, PLAIN_SLICE)
        p_ms, want = plain_ms(lambda: MA.batch_inverse_blocked(F, x[:m], INV_BLOCK))
        if max_abs_err(torch, got[:m], want):
            raise AssertionError(f"batch_inverse at {label} differs from its plain version")
        monts = 3 + (4 if deg == 2 else 0) + 1 / INV_BLOCK
        return dict(shape=[n] + ([2] if deg == 2 else []), ms=ms, plain_ms=p_ms, plain_elements=m, max_abs_err=0,
                    **bound(n, monts, 128 * deg, peak_muls_per_s))

    at = rows["batch_inverse"].setdefault("at_shapes", {})
    at["2^16"] = timed_inverse("2^16", FQ, P, 1, 1 << 16)
    for name, (n_digits, steps, lanes, g2) in shapes.items():
        at[f"{name} table"] = timed_inverse(name, FQ2 if g2 else FQ, P, 2 if g2 else 1, steps * N_TABLE * lanes)
    at["bucket level"] = timed_inverse("bucket level", FQ, P, 1, BUCKET_LEVEL[0] * BUCKET_LEVEL[1])
    log("K15 batch_inverse timed at " + ", ".join(f"{k} {v['ms']:.4f} ms" for k, v in at.items()))

    # K15 jac_to_affine at the path's table chunks
    first = True
    for name, (n_digits, steps, lanes, g2) in shapes.items():
        curve = curves[g2]
        elem = (2,) if g2 else ()
        X, Y, Z = (rand_canon(torch, gen, (steps, N_TABLE, lanes) + elem, device) for _ in range(3))
        Z[:, :, 2] = 0
        ms, got = cuda_ms(torch, lambda: MA.jac_to_affine_batch(curve.F, (X, Y, Z)), 5)
        m = min(steps, max(1, PLAIN_SLICE // (N_TABLE * lanes)))
        p_ms, want = plain_ms(lambda: MA._jac_to_affine_steps(MA.plain_ops(curve.F), (X[:m], Y[:m], Z[:m])))
        if max_abs_err(torch, tuple(c[:m] for c in got), want):
            raise AssertionError(f"jac_to_affine at the {name} table differs from its plain version")
        n = steps * N_TABLE * lanes
        monts = 7 if not g2 else 3 + 4 + 12
        row = dict(shape=[steps, N_TABLE, lanes] + list(elem), ms=ms, plain_ms=p_ms, plain_steps=m, max_abs_err=0,
                   **bound(n, monts, 5 * 64 * (2 if g2 else 1), peak_muls_per_s))
        if first:
            rows["jac_to_affine"] = dict(row, chunk=name)
            first = False
        else:
            rows["jac_to_affine"].setdefault("at_shapes", {})[name] = row
        log(f"K15 jac_to_affine at the {name} table {row['shape']}: {ms:.4f} ms (plain {p_ms:.1f} over {m} "
            f"steps, bound {row['bound_ms']:.4f})")

    # K16 accumulate at the path's chunks
    for name, (n_digits, steps, lanes, g2) in shapes.items():
        curve = curves[g2]
        kname = f"{'g2' if g2 else 'g1'}_affine_accumulate"
        acc, table, mags, negs, s0 = affine_table_case(torch, gen, g2, steps, lanes, n_digits, device)
        ms, got = cuda_ms(torch, lambda: MA.affine_accumulate(curve, acc, table, mags, negs, s0), 3)
        S = min(steps, AFFINE_PLAIN_STEPS)
        part = tuple(c[:S] for c in table)
        got_s = MA.affine_accumulate(curve, acc, part, mags, negs, s0)
        p_ms, want = plain_ms(lambda: MA._affine_accumulate_steps(MA.plain_ops(curve.F), acc, part, mags, negs, s0))
        if max_abs_err(torch, got_s, want):
            raise AssertionError(f"{kname} at the {name} chunk differs from its plain version")
        fq = 3 if g2 else 1  # Fq products an Fq(2) product
        elem_bytes = 64 * (2 if g2 else 1)
        chunk = mags[:, s0:s0 + steps]
        live = int(torch.count_nonzero(chunk))
        # the table entries this run's digits read: the distinct nonzero
        # magnitudes at each (step, lane)
        entries = int(torch.nn.functional.one_hot(chunk.long(), N_TABLE + 1).any(0)[..., 1:].sum())
        threads = n_digits * lanes * steps
        ops = (threads * (3 + (4 if g2 else 0)) + live * 3 * fq) * MULS_PER_MONT
        nbytes = 2 * (2 * elem_bytes + 1) * n_digits * lanes + 2 * elem_bytes * entries + 5 * threads
        t_ops, t_bytes = ops / peak_muls_per_s, nbytes / HBM_BYTES_PER_S
        block = K16_BLOCK[g2]
        depth = 2 * block.bit_length() + 3 + (2 if g2 else 0)  # tree up and down, apply, Fq2 norm and conjugate
        row = dict(shape=[n_digits, steps, N_TABLE, lanes] + ([2] if g2 else []), ms=ms, plain_ms=p_ms,
                   plain_steps=S, max_abs_err=0, live_adds=live, table_entries_read=entries,
                   us_per_step=ms * 1e3 / steps,
                   chain_floor_ms_per_step=chain_ms(depth, avg_rounds),
                   bound_ms=max(t_ops, t_bytes) * 1e3, bound_by="bytes" if t_bytes > t_ops else "operations")
        if kname not in rows:
            rows[kname] = dict(row, chunk=name)
        else:
            rows[kname].setdefault("at_shapes", {})[name] = row
        log(f"K16 {kname} at the {name} chunk ({n_digits} x {lanes} x {steps} steps): {ms:.4f} ms, "
            f"{row['us_per_step']:.1f} us a step (chain floor {row['chain_floor_ms_per_step'] * 1e3:.1f} us), "
            f"bound {row['bound_ms']:.4f}; plain {p_ms:.1f} ms over {S} steps, bitwise equal")

    # K16 add: a bucket level (G1, the path's) and 2^16 (G2, on no path)
    for g2, (rows_n, inner) in ((False, BUCKET_LEVEL), (True, (1 << 16, 1))):
        curve = curves[g2]
        kname = f"{'g2' if g2 else 'g1'}_affine_add"
        pts = affine_points(torch, gen, g2, (2 * rows_n, inner), device)
        ev, od = tuple(c[0::2] for c in pts), tuple(c[1::2] for c in pts)
        ms, got = cuda_ms(torch, lambda: MA.affine_add_complete(curve.F, ev, od), 3)
        m = max(1, PLAIN_SLICE // inner)
        p_ms, want = plain_ms(lambda: MA._affine_add_steps(MA.plain_ops(curve.F), tuple(c[:m] for c in ev),
                                                            tuple(c[:m] for c in od)))
        if max_abs_err(torch, tuple(c[:m] for c in got), want) or max_abs_err(
                torch, tuple(c[-m:] for c in got),
                MA._affine_add_steps(MA.plain_ops(curve.F), tuple(c[-m:] for c in ev), tuple(c[-m:] for c in od))):
            raise AssertionError(f"{kname} at {rows_n} x {inner} differs from its plain version")
        fq = 3 if g2 else 1  # Fq products an Fq(2) product
        elem_bytes = 64 * (2 if g2 else 1)
        n = rows_n * inner
        # the accumulate's chain and each thread's walk along its values
        depth = 2 * K16_BLOCK[g2].bit_length() + 3 + (2 if g2 else 0) + 2 * (K16_PER - 1)
        rows[kname] = dict(shape=[rows_n, inner] + ([2] if g2 else []), ms=ms, plain_ms=p_ms, plain_elements=m * inner,
                           max_abs_err=0, chain_floor_ms=chain_ms(depth, avg_rounds),
                           **bound(n, 3 + (4 if g2 else 0) + 3 * fq, 3 * (2 * elem_bytes + 1), peak_muls_per_s))
        log(f"K16 {kname} at {rows_n} x {inner}: {ms:.4f} ms (bound {rows[kname]['bound_ms']:.4f}, plain "
            f"{p_ms:.1f} over {m * inner} elements), bitwise equal")
        del pts, ev, od, got
    for k in ("batch_inverse", "jac_to_affine", "g1_affine_add", "g2_affine_add", "g1_affine_accumulate",
              "g2_affine_accumulate"):
        rows[k]["check"] = ("bitwise equal to plain at batches " + ", ".join(map(str, AFFINE_BATCHES))
                            + " with the special values and lanes, and at the shapes timed; K15 also to K5 and "
                              "Python pow")
    return rows


def check_affine_msm(torch, device):
    """The windowed affine MSM through K6/K8 + K15 + K16 against the old
    route (_affine_steps: K3 tables, K1 products and K5 inversions) and
    against host discrete logs, G1 and G2, at 2^16 with 64 planes and
    with the narrow class's 3 (lanes as the prover caps them); the bucket
    MSM (w = 16) through the grouped planes and K16 against the per-plane
    old route and the host, at 2^16."""
    from zkp2p_tpu_torch.curve import host
    from zkp2p_tpu_torch.curve.tcurve import G1C, G2C, g1_jac_to_host, g1_to_affine_arrays, g2_jac_to_host, g2_to_affine_arrays
    from zkp2p_tpu_torch.field.bn254 import R
    from zkp2p_tpu_torch.ops import msm, msm_affine, msm_bucket

    out = {}
    for g2 in (False, True):
        gen = torch.Generator(device=device).manual_seed(SEED + (38 if g2 else 32))
        pyr = random.Random(SEED + (39 if g2 else 33))
        curve, to_arr, to_host, gmul, G = ((G2C, g2_to_affine_arrays, g2_jac_to_host, host.g2_mul, host.G2_GENERATOR)
                                           if g2 else
                                           (G1C, g1_to_affine_arrays, g1_jac_to_host, host.g1_mul, host.G1_GENERATOR))
        rows = 16 if g2 else 64
        t = [pyr.randrange(1, R) for _ in range(rows)]
        T = to_arr([gmul(G, v) for v in t] + [None], device)
        cases = [(name, log_n, planes, cap, 4) for name, log_n, planes, cap in AFFINE_MSMS[g2]]
        if not g2:
            cases.append(("bucket w16", AFFINE_MSM_LOG, 16, None, 16))
        for name, log_n, planes, cap, window in cases:
            n = 1 << log_n
            idx = torch.randint(0, rows + 1, (n,), generator=gen, device=device)  # row `rows`: the (0, 0) hole
            bases = tuple(c[idx] for c in T)
            scalars = rand_canon(torch, gen, (n,), device)
            if window == 4 and planes < 64:
                scalars = torch.zeros_like(scalars)
                scalars[:, 0] = torch.randint(0, 1 << (4 * planes - 1), (n,), generator=gen, device=device,
                                              dtype=torch.int32)
            mags, negs = msm.signed_digit_planes(scalars, window)
            mags, negs = mags[-planes:], negs[-planes:]
            if window == 16:
                new_s, got = wall_s(torch, lambda: msm_bucket.msm_bucket_affine(curve, bases, mags, negs, window=16))
                old_s, want = wall_s(torch, lambda: msm_bucket.msm_bucket_affine_steps(curve, bases, mags, negs,
                                                                                      window=16))
            else:
                lanes = msm.default_lanes(n, cap=cap)
                new_s, got = wall_s(torch, lambda: msm_affine.msm_windowed_affine(curve, bases, mags, negs,
                                                                                 lanes=lanes, window=4))
                old_s, want = wall_s(torch, lambda: msm_affine._windowed_affine(
                    curve, bases, mags, negs, lanes, 4, msm_affine._affine_steps))
            label = f"{'G2' if g2 else 'G1'} {name} at 2^{log_n}"
            if max_abs_err(torch, got, want):
                raise AssertionError(f"the affine MSM ({label}) differs from the old route")
            if to_host(got) != [gmul(G, expected_msm(torch, scalars, idx, t, rows))]:
                raise AssertionError(f"the affine MSM ({label}) differs from its discrete-log value")
            out[label] = {"kernels_s": new_s, "old_route_s": old_s}
            log(f"affine MSM {label}: kernels {new_s:.3f} s, old route {old_s:.3f} s; bitwise equal, equal to the "
                "host")
    return out


def digit_planes(torch, gen, n_digits, steps, lanes, device):
    """Random signed digits (n_digits, steps, lanes): magnitudes in
    [0, N_TABLE] and signs, laid out digit-minor (a lane's digits
    adjacent) as signed_digit_planes_from_limbs gives them."""
    mags = torch.randint(0, N_TABLE + 1, (steps, lanes, n_digits), generator=gen, device=device, dtype=torch.int32)
    negs = torch.randint(0, 2, (steps, lanes, n_digits), generator=gen, device=device).bool()
    return mags.permute(2, 0, 1), negs.permute(2, 0, 1)


def window_case(torch, gen, g2, steps, lanes, n_digits, device):
    """K6/K7 (G1) or K8/K9 (G2) inputs: random bases (steps, lanes) and
    partials, digit-minor digit planes of steps + 2 steps read from step
    1, and, from 5 lanes up, the special lanes: a (0, 0) base (lane 2),
    acc equal to the entry its digit picks (lane 0, the doubling) and to
    that entry negated (lane 1, infinity), acc at infinity (lane 3),
    e = 16 digits (lane 4)."""
    from zkp2p_tpu_torch.field.tfield import FQ
    from zkp2p_tpu_torch.ops import cuda_msm_window

    elem = (2,) if g2 else ()
    bases = [rand_canon(torch, gen, (steps, lanes) + elem, device) for _ in range(2)]
    mags, negs = digit_planes(torch, gen, n_digits, steps + 2, lanes, device)
    acc = [rand_canon(torch, gen, (n_digits, lanes) + elem, device) for _ in range(3)]
    s0 = 1
    if lanes >= 5 and n_digits >= 2:
        bases[0][:, 2] = bases[1][:, 2] = 0
        table_plain = cuda_msm_window.g2_window_table_plain if g2 else cuda_msm_window.g1_window_table_plain
        table = table_plain(tuple(b[:1] for b in bases), N_TABLE)
        mags[0, s0, 0], negs[0, s0, 0] = 3, False
        mags[1, s0, 1], negs[1, s0, 1] = 5, False
        for c in range(3):
            acc[c][0, 0] = table[c][0, 2, 0]
            acc[c][1, 1] = FQ.neg(table[c][0, 4, 1]) if c == 1 else table[c][0, 4, 1]
            acc[c][:, 3] = 0
        mags[:, :, 4], negs[:, :, 4] = 0, True
    return tuple(bases), tuple(acc), mags, negs, s0


def check_window_kernels(torch, g2, shapes, peak_muls_per_s, device):
    """K6 and K7 (G1), or K8 and K9 (G2), against their plain versions
    (bitwise) at WINDOW_BATCHES and at each chunk shape the main path
    gives them (`shapes`: name -> (digit planes, steps, lanes); the first
    is the row's own, the rest go under at_shapes), where each and its
    plain version are timed on the same inputs."""
    from zkp2p_tpu_torch.ops import cuda_msm_window as W

    gen = torch.Generator(device=device).manual_seed(SEED + (17 if g2 else 7))
    g = "g2" if g2 else "g1"
    name_t, name_a = f"{g}_window_table", f"{g}_window_accumulate"
    table_of, accumulate = getattr(W, name_t), getattr(W, name_a)
    table_plain_of, accumulate_plain = getattr(W, name_t + "_plain"), getattr(W, name_a + "_plain")
    ks = "K8/K9" if g2 else "K6/K7"

    def table_plain(bases):
        # a step at a time in chunks of steps (bounds the int64 temporaries)
        return chunked(torch, lambda x, y: table_plain_of((x, y), N_TABLE), bases, 16 // (1 + g2))

    def check(steps, lanes, n_digits, timed=False):
        bases, acc, mags, negs, s0 = window_case(torch, gen, g2, steps, lanes, n_digits, device)
        times = {}
        if timed:
            times["table"], table = cuda_ms(torch, lambda: table_of(bases, N_TABLE), 5)
            times["table_plain"], want = cuda_ms(torch, lambda: table_plain(bases), 1, warmup=False)
        else:
            table, want = table_of(bases, N_TABLE), table_plain(bases)
        err_t = max_abs_err(torch, table, want)
        if err_t:
            raise AssertionError(f"{name_t} ({steps} x {lanes}) differs from its plain version")
        if timed:
            times["acc"], got = cuda_ms(torch, lambda: accumulate(acc, table, mags, negs, s0), 3)
            times["acc_plain"], want = cuda_ms(
                torch, lambda: accumulate_plain(acc, table, mags, negs, s0), 1, warmup=False)
        else:
            got = accumulate(acc, table, mags, negs, s0)
            want = accumulate_plain(acc, table, mags, negs, s0)
        # the same digits laid out contiguously
        got_c = accumulate(acc, table, mags.contiguous(), negs.contiguous(), s0)
        err_a = max(max_abs_err(torch, got, want), max_abs_err(torch, got_c, want))
        if err_a:
            raise AssertionError(f"{name_a} ({n_digits} x {lanes}, {steps} steps) differs from its plain version")
        return times, (err_t, err_a), mags[:, s0:s0 + steps]

    for steps, n, n_digits in WINDOW_BATCHES:
        check(steps, n, n_digits)
    log(f"{ks}: bitwise equal to plain at {WINDOW_BATCHES} (lanes, planes, steps), special lanes included")

    fq = 3 if g2 else 1  # Fq products an Fq2 product
    elem_bytes = 64 * (2 if g2 else 1)

    def bounds(steps, lanes, mags):
        n = steps * lanes
        table_bytes = 3 * N_TABLE * elem_bytes * n
        b_t = bound(n, (N_TABLE - 1) * MONTS["add_mixed"] * fq, (2 + 3 * N_TABLE) * elem_bytes, peak_muls_per_s)
        # the accumulate adds only where the digit is nonzero
        adds = int(torch.count_nonzero(mags))
        n_digits = mags.shape[0]
        nbytes = 6 * elem_bytes * n_digits * lanes + table_bytes + 5 * n_digits * n
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = adds * MONTS["add"] * fq * MULS_PER_MONT / peak_muls_per_s
        b_a = dict(bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes > t_ops else "operations")
        return b_t, b_a, adds

    rows = {name_t: {}, name_a: {}}
    for k, (name, (n_digits, steps, lanes)) in enumerate(shapes.items()):
        times, (err_t, err_a), mags = check(steps, lanes, n_digits, timed=True)
        b_t, b_a, adds = bounds(steps, lanes, mags)
        at = {
            name_t: dict(shape=[steps, N_TABLE, lanes], max_abs_err=err_t, ms=times["table"],
                         plain_ms=times["table_plain"], **b_t),
            name_a: dict(shape=[n_digits, steps, N_TABLE, lanes], max_abs_err=err_a, ms=times["acc"],
                         plain_ms=times["acc_plain"], adds=adds, ns_per_add=times["acc"] * 1e6 / max(adds, 1), **b_a),
        }
        for kernel, row in at.items():
            if k == 0:
                rows[kernel].update(row, chunk=name)
            else:
                rows[kernel].setdefault("at_shapes", {})[name] = row
        log(f"{ks} at the {name} chunk ({n_digits} planes x {lanes} lanes x {steps} steps): bitwise equal to plain; "
            f"table {times['table']:.4f} ms (plain {times['table_plain']:.1f}, bound {b_t['bound_ms']:.4f}), "
            f"accumulate {times['acc']:.4f} ms (plain {times['acc_plain']:.1f}, bound {b_a['bound_ms']:.4f}, "
            f"{at[name_a]['ns_per_add']:.3f} ns an add)")
    for row in rows.values():
        row["check"] = (f"bitwise equal to plain at (lanes, planes, steps) {list(WINDOW_BATCHES)} and at the "
                        f"path's chunk shapes (shape, at_shapes), special lanes included; the {g.upper()} MSM "
                        f"through it equal to the step loop")
    return rows


def batch_window_case(torch, gen, g2, batch, steps, lanes, n_digits, device):
    """K7/K9 inputs for `batch` witnesses against one set of bases: the
    first witness is window_case's (with its special lanes), the others
    random partials and digits; the planes (n_digits, batch, steps + 2,
    lanes) laid out as K14 gives a batch's, each scalar's digits adjacent."""
    elem = (2,) if g2 else ()
    bases, acc0, mags0, negs0, s0 = window_case(torch, gen, g2, steps, lanes, n_digits, device)
    accs = [acc0] + [tuple(rand_canon(torch, gen, (n_digits, lanes) + elem, device) for _ in range(3))
                     for _ in range(batch - 1)]
    acc = tuple(torch.stack([a[c] for a in accs]) for c in range(3))
    mags = torch.empty((batch, steps + 2, lanes, n_digits), dtype=torch.int32, device=device)
    negs = torch.empty((batch, steps + 2, lanes, n_digits), dtype=torch.bool, device=device)
    mags[0], negs[0] = mags0.permute(1, 2, 0), negs0.permute(1, 2, 0)
    for b in range(1, batch):
        m, n = digit_planes(torch, gen, n_digits, steps + 2, lanes, device)
        mags[b], negs[b] = m.permute(1, 2, 0), n.permute(1, 2, 0)
    return bases, acc, mags.permute(3, 0, 1, 2), negs.permute(3, 0, 1, 2), s0


def check_window_batch(torch, g2, shape, peak_muls_per_s, device):
    """K7 (G1) or K9 (G2) over a batch of witnesses against one table:
    at BATCH_SIZES on the cut shapes, held bitwise against the plain
    version and against the unbatched kernel run once a witness; then at
    BATCH_CHUNK witnesses of the path's chunk `shape` (digit planes, steps,
    lanes): the plain version over the first BATCH_PLAIN_STEPS steps held
    bitwise, and the whole chunk timed against the unbatched kernel run
    once a witness on the same inputs, bitwise equal.  Returns the row's
    "batch" entry."""
    from zkp2p_tpu_torch.ops import cuda_msm_window as W

    gen = torch.Generator(device=device).manual_seed(SEED + (27 if g2 else 26))
    g = "g2" if g2 else "g1"
    name_a = f"{g}_window_accumulate"
    table_of, accumulate = getattr(W, f"{g}_window_table"), getattr(W, name_a)
    accumulate_plain = getattr(W, name_a + "_plain")
    ks = "K9" if g2 else "K7"

    def each(acc, table, mags, negs, s0):
        outs = [accumulate(tuple(c[b] for c in acc), table, mags[:, b], negs[:, b], s0) for b in range(mags.shape[1])]
        return tuple(torch.stack([o[c] for o in outs]) for c in range(3))

    cut = WINDOW_BATCHES[1:]
    for batch in BATCH_SIZES:
        for lanes, n_digits, steps in cut:
            bases, acc, mags, negs, s0 = batch_window_case(torch, gen, g2, batch, steps, lanes, n_digits, device)
            table = table_of(bases, N_TABLE)
            got = accumulate(acc, table, mags, negs, s0)
            if max_abs_err(torch, got, accumulate_plain(acc, table, mags, negs, s0)) or max_abs_err(
                    torch, got, each(acc, table, mags, negs, s0)):
                raise AssertionError(f"{name_a} at batch {batch} ({n_digits} x {lanes}, {steps} steps) differs from "
                                     f"its plain version or from the unbatched kernel")
    log(f"{ks} batched: bitwise equal to plain and to the unbatched kernel at B {BATCH_SIZES} x {cut} "
        f"(lanes, planes, steps)")

    n_digits, steps, lanes = shape
    bases, acc, mags, negs, s0 = batch_window_case(torch, gen, g2, BATCH_CHUNK, steps, lanes, n_digits, device)
    table = table_of(bases, N_TABLE)
    cut_table = tuple(c[:BATCH_PLAIN_STEPS] for c in table)
    got = accumulate(acc, cut_table, mags, negs, s0)
    if max_abs_err(torch, got, accumulate_plain(acc, cut_table, mags, negs, s0)):
        raise AssertionError(f"{name_a} at batch {BATCH_CHUNK} ({n_digits} x {lanes}, {BATCH_PLAIN_STEPS} steps) "
                             f"differs from its plain version")
    del got, cut_table
    ms, got = cuda_ms(torch, lambda: accumulate(acc, table, mags, negs, s0), 3)
    each_ms, want = cuda_ms(torch, lambda: each(acc, table, mags, negs, s0), 3)
    if max_abs_err(torch, got, want):
        raise AssertionError(f"{name_a} at batch {BATCH_CHUNK} ({n_digits} x {lanes}, {steps} steps) differs from "
                             f"the unbatched kernel")
    fq = 3 if g2 else 1
    elem_bytes = 64 * (2 if g2 else 1)
    adds = int(torch.count_nonzero(mags[:, :, s0:s0 + steps]))
    n = steps * lanes
    # partials in and out a witness, the table once, the planes a witness
    nbytes = BATCH_CHUNK * (6 * elem_bytes * n_digits * lanes + 5 * n_digits * n) + 3 * N_TABLE * elem_bytes * n
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = adds * MONTS["add"] * fq * MULS_PER_MONT / peak_muls_per_s
    row = dict(batch=BATCH_CHUNK, shape=[n_digits, BATCH_CHUNK, steps, N_TABLE, lanes], max_abs_err=0, ms=ms,
               unbatched_ms=each_ms, plain_steps=BATCH_PLAIN_STEPS, adds=adds, ns_per_add=ms * 1e6 / max(adds, 1),
               bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes > t_ops else "operations",
               cut_batches=list(BATCH_SIZES))
    log(f"{ks} at {BATCH_CHUNK} witnesses of the {n_digits} x {lanes} x {steps} chunk: bitwise equal to plain "
        f"({BATCH_PLAIN_STEPS} steps) and to the unbatched kernel; {ms:.4f} ms (unbatched, one launch a witness: "
        f"{each_ms:.4f}; bound {row['bound_ms']:.4f} by {row['bound_by']})")
    return row


def check_window_msm(torch, g2, device):
    """The G1 MSM through K6/K7, or the G2 MSM through K8/K9, against the
    step loop over K2/K3 (bitwise) and against host discrete logs (bases
    are multiples of a host table), at each of WINDOW_MSMS[g2]: 64 digit
    planes of full scalars, and the narrow class's 3 at its lane width."""
    from zkp2p_tpu_torch.curve import host
    from zkp2p_tpu_torch.curve.tcurve import G1C, G2C, g1_jac_to_host, g1_to_affine_arrays, g2_jac_to_host, g2_to_affine_arrays
    from zkp2p_tpu_torch.field.bn254 import R
    from zkp2p_tpu_torch.ops import msm

    gen = torch.Generator(device=device).manual_seed(SEED + (18 if g2 else 8))
    pyr = random.Random(SEED + (19 if g2 else 9))
    curve, to_arr, to_host, gmul, G = ((G2C, g2_to_affine_arrays, g2_jac_to_host, host.g2_mul, host.G2_GENERATOR) if g2
                                       else (G1C, g1_to_affine_arrays, g1_jac_to_host, host.g1_mul, host.G1_GENERATOR))
    ks = "K8/K9" if g2 else "K6/K7"
    rows = 16 if g2 else 64  # host G2 multiplications are slow
    t = [pyr.randrange(1, R) for _ in range(rows)]
    T = to_arr([gmul(G, v) for v in t] + [None], device)
    for name, log_n, planes, cap in WINDOW_MSMS[g2]:
        n = 1 << log_n
        idx = torch.randint(0, rows + 1, (n,), generator=gen, device=device)  # row `rows` is the (0, 0) hole
        bases = tuple(c[idx] for c in T)
        scalars = rand_canon(torch, gen, (n,), device)
        if planes < 64:  # below 2^(4 planes - 1), as the narrow class's width guard keeps them
            scalars = torch.zeros_like(scalars)
            scalars[:, 0] = torch.randint(0, 1 << (4 * planes - 1), (n,), generator=gen, device=device,
                                          dtype=torch.int32)
        mags, negs = msm.signed_digit_planes_from_limbs(scalars, 4)
        mags, negs = mags[-planes:], negs[-planes:]
        lanes = msm.default_lanes(n, cap=cap)
        got = msm.msm_windowed_signed(curve, bases, mags, negs, lanes=lanes, window=4)
        want = msm._windowed(curve, bases, mags, negs, lanes, 4, msm._accumulate_steps)
        if max_abs_err(torch, got, want):
            raise AssertionError(f"the {'G2' if g2 else 'G1'} MSM through {ks} ({name}) differs from the step loop")
        if to_host(got) != [gmul(G, expected_msm(torch, scalars, idx, t, rows))]:
            raise AssertionError(f"the {'G2' if g2 else 'G1'} MSM through {ks} ({name}) differs from its "
                                 f"discrete-log value")
        log(f"{'G2' if g2 else 'G1'} MSM at 2^{log_n} ({name}, {lanes} lanes): {ks} bitwise equal to the step loop "
            f"and to the host")


def fold_case(torch, gen, g2, lanes, n_planes, window, device):
    """K10/K11 inputs: random init (lanes, *elem) and planes (n_planes,
    lanes, *elem) x3 with the special lanes: init at infinity (lane 0);
    from 6 lanes up, plane 0 equal to 2^w * init in another Jacobian
    representation (X l^2, Y l^3, Z l for a random l; lane 2, the add's
    doubling branch) and to its negation (lane 3, infinity), plane 1 at
    infinity (lane 4), every plane at infinity (lane 5); at fewer lanes,
    plane 1 at infinity in lane 0."""
    from zkp2p_tpu_torch.field.tfield import FQ
    from zkp2p_tpu_torch.ops.cuda_curve import point_op_plain
    from zkp2p_tpu_torch.ops.cuda_mont import mont_mul_plain

    elem = (2,) if g2 else ()
    init = [rand_canon(torch, gen, (lanes,) + elem, device) for _ in range(3)]
    planes = [rand_canon(torch, gen, (n_planes, lanes) + elem, device) for _ in range(3)]
    for c in range(3):
        init[c][0] = 0
        if n_planes >= 2:
            planes[c][1, 4 if lanes >= 6 else 0] = 0
    if lanes >= 6:
        d = tuple(c[2] for c in init)
        for _ in range(window):
            d = point_op_plain("double", g2, *d)
        lam = rand_canon(torch, gen, elem, device)
        if g2:
            lam[1] = lam[0]  # an Fq scalar on both components
        lam2 = mont_mul_plain(FQ, lam, lam)
        lam3 = mont_mul_plain(FQ, lam2, lam)
        x, y, z = (mont_mul_plain(FQ, a, b) for a, b in ((d[0], lam2), (d[1], lam3), (d[2], lam)))
        for c, (v, w) in enumerate(((x, x), (y, FQ.neg(y)), (z, z))):
            planes[c][0, 2], planes[c][0, 3] = v, w
            planes[c][:, 5] = 0
    return tuple(init), tuple(planes)


def check_fold_kernels(torch, g2, shapes, peak_muls_per_s, sm_clock_hz, device):
    """K10 (G1) or K11 (G2) against its plain version (bitwise) at
    FOLD_CASES and at each fold the paths give it (`shapes`: name ->
    (lanes, planes, window); the first is the row's own, the rest go under
    at_shapes), timed by CUDA events at the paths' shapes beside its
    operation bound and its chain floor.  One lane is a batch (), as the
    bucket h MSM folds.  The plain version runs once over all the lanes of
    one (planes, window), timed: it is a few hundred small torch ops a
    point op, so its time hardly depends on the lanes."""
    from zkp2p_tpu_torch.ops import cuda_msm_fold

    g = "g2" if g2 else "g1"
    name = f"{g}_horner_fold"
    fold, plain = getattr(cuda_msm_fold, name), getattr(cuda_msm_fold, name + "_plain")
    ks = "K11" if g2 else "K10"
    gen = torch.Generator(device=device).manual_seed(SEED + (21 if g2 else 20))
    cases = [(f"{lanes} x {planes} x {window}", (lanes, planes, window), False) for lanes, planes, window in FOLD_CASES]
    cases += [(label, shape, True) for label, shape in shapes.items()]
    inputs = {label: fold_case(torch, gen, g2, *shape, device) for label, shape, _ in cases}
    want, plain_of = {}, {}
    for key in dict.fromkeys(shape[1:] for _, shape, _ in cases):
        labels = [label for label, shape, _ in cases if shape[1:] == key]
        init = tuple(torch.cat([inputs[label][0][c] for label in labels]) for c in range(3))
        planes = tuple(torch.cat([inputs[label][1][c] for label in labels], dim=1) for c in range(3))
        ms, out = cuda_ms(torch, lambda: plain(init, planes, key[1]), 1, warmup=False)
        at = 0
        for label in labels:
            n = inputs[label][0][0].shape[0]
            want[label] = tuple(c[at:at + n] for c in out)
            plain_of[label] = dict(plain_ms=ms, plain_lanes=init[0].shape[0])
            at += n

    def call(init, planes, window):
        if init[0].shape[0] > 1:
            return fold(init, planes, window)
        got = fold(tuple(c[0] for c in init), tuple(c[:, 0] for c in planes), window)  # batch ()
        return tuple(c[None] for c in got)

    fq = 3 if g2 else 1
    elem_bytes = 64 * (2 if g2 else 1)
    row = {}
    for label, (lanes, n_planes, window), timed in cases:
        init, planes = inputs[label]
        if timed:
            ms, got = cuda_ms(torch, lambda: call(init, planes, window), 10)
        else:
            got = call(init, planes, window)
        if max_abs_err(torch, got, want[label]):
            raise AssertionError(f"{name} ({label}) differs from its plain version")
        if not timed:
            continue
        steps = n_planes * (window * MONTS["double"] + MONTS["add"])
        b = bound(lanes, steps * fq, (6 + 3 * n_planes) * elem_bytes, peak_muls_per_s)
        chain = n_planes * (window * CHAIN_MONTS["double"] + CHAIN_MONTS["add"])
        at = dict(shape=[lanes, n_planes, window], max_abs_err=0, ms=ms, **plain_of[label], **b,
                  chain_floor_ms=chain * CHAIN_MADS_PER_MONT * MAD_LATENCY_CLK / sm_clock_hz * 1e3)
        if row:
            row.setdefault("at_shapes", {})[label] = at
        else:
            row.update(at, fold=label)
        log(f"{ks} at the {label} fold ({lanes} lanes x {n_planes} planes x window {window}): bitwise equal to "
            f"plain; {ms:.4f} ms (plain {at['plain_ms']:.1f} over {at['plain_lanes']} lanes, bound "
            f"{at['bound_ms']:.4f}, chain floor {at['chain_floor_ms']:.4f})")
    row["check"] = (f"bitwise equal to plain at (lanes, planes, window) {list(FOLD_CASES)} and at the paths' "
                    f"fold shapes (shape, at_shapes), special lanes included; the plain version run once over "
                    f"all the lanes of a (planes, window)")
    log(f"{ks}: bitwise equal to plain at {FOLD_CASES} (lanes, planes, window), special lanes included")
    return {name: row}


def ntt_rows(torch, gen, rows, m, device):
    """(rows, m, 16) random canonical Fr limbs; each row's first entries
    0, 1, r - 1 and the Montgomery one."""
    from zkp2p_tpu_torch.field.bn254 import MONT_R, R
    from zkp2p_tpu_torch.ops.cuda_mont import limbs_of

    x = rand_canon(torch, gen, (rows, m), device)
    for i, v in enumerate((0, 1, R - 1, MONT_R % R)[:m]):
        x[:, i] = torch.tensor(limbs_of(v), dtype=torch.int32, device=device)
    return x


def check_ntt_kernel(torch, peak_muls_per_s, device):
    """K12 against its plain version (bitwise) at every pass of the plans
    of NTT_CHECK_LOGS, with each kind of factor and in place; ntt, intt
    and coset_ladder there against the _ntt_core compositions; each pass
    of the 2^23 plan at the H ladder's shape, timed beside its bound and
    its plain version (held bitwise); ntt and intt of one 2^23 row against
    _ntt_core."""
    from zkp2p_tpu_torch.field.tfield import FR
    from zkp2p_tpu_torch.ops import cuda_ntt, ntt
    from zkp2p_tpu_torch.snark.groth16 import coset_gen

    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    log_full = VENMO["log_m"]

    def steps_ntt(x, log_m):
        d = ntt.domain(log_m, device)
        return ntt._ntt_core(x, d["tw"], d["perm"])

    def steps_intt(x, log_m):
        d = ntt.domain(log_m, device)
        return FR.mul(ntt._ntt_core(x, d["tw_inv"], d["perm"]), d["m_inv_mont"])

    for log_m in NTT_CHECK_LOGS:
        d = ntt.domain(log_m, device)
        g = coset_gen(log_m)
        factors = (None, d["m_inv_mont"], ntt._coset_factor(g, log_m, device))
        x = ntt_rows(torch, gen, LADDER_ROWS, 1 << log_m, device)
        for i, (s0, k) in enumerate(ntt.pass_plan(log_m)):
            for tw in (d["tw"], d["tw_inv"]):
                for f in factors:
                    want = cuda_ntt.ntt_pass_plain(x, tw, s0, k, i == 0, f)
                    if max_abs_err(torch, cuda_ntt.ntt_pass(x, tw, s0, k, i == 0, f), want):
                        raise AssertionError(f"fr_ntt_pass (2^{log_m}, stages {s0}+{k}) differs from plain")
                    if i:
                        y = x.clone()
                        cuda_ntt.ntt_pass(y, tw, s0, k, factor=f, out=y)
                        if max_abs_err(torch, y, want):
                            raise AssertionError(f"fr_ntt_pass in place (2^{log_m}, stages {s0}+{k}) differs")
        if (max_abs_err(torch, ntt.ntt(x, log_m), steps_ntt(x, log_m))
                or max_abs_err(torch, ntt.intt(x, log_m), steps_intt(x, log_m))
                or max_abs_err(torch, ntt.coset_ladder(x, g, log_m), ntt._ladder_steps(x, g, log_m))):
            raise AssertionError(f"ntt / intt / coset_ladder at 2^{log_m} differ from _ntt_core")
    log(f"K12 fr_ntt_pass: bitwise equal to plain at every pass of 2^{list(NTT_CHECK_LOGS)} (no factor, 1/m, "
        f"g^i/m; in place); ntt, intt and coset_ladder equal to _ntt_core there")

    # the 2^23 plan at the ladder's shape: each pass timed, its plain
    # version timed once on the same inputs, the two held bitwise
    d = ntt.domain(log_full, device)
    m = 1 << log_full
    x = ntt_rows(torch, gen, LADDER_ROWS, m, device)
    plan = ntt.pass_plan(log_full)
    shapes = {"ntt pass 0 (bit-reversed, g^i/m)": (plan[0], d["tw"], ntt._coset_factor(coset_gen(log_full), log_full,
                                                                                        device)),
              "intt pass 0 (bit-reversed)": (plan[0], d["tw_inv"], None)}
    shapes.update({f"pass {i}": (p, d["tw"], None) for i, p in enumerate(plan) if i})
    row = {}
    for label, ((s0, k), tw, f) in shapes.items():
        bitrev = s0 == 0
        out = torch.empty_like(x)
        ms, got = cuda_ms(torch, lambda: cuda_ntt.ntt_pass(x, tw, s0, k, bitrev, f, out=out), 5)
        plain_ms, want = cuda_ms(torch, lambda: cuda_ntt.ntt_pass_plain(x, tw, s0, k, bitrev, f), 1, warmup=False)
        err = max_abs_err(torch, got, want)
        if not bitrev:
            y = x.clone()
            cuda_ntt.ntt_pass(y, tw, s0, k, out=y)
            err = max(err, max_abs_err(torch, y, want))
        if err:
            raise AssertionError(f"fr_ntt_pass at 2^{log_full} x {LADDER_ROWS} ({label}) differs from plain")
        products = LADDER_ROWS * (k * m // 2 + (m if f is not None else 0))
        nbytes = (2 * LADDER_ROWS * m + (m if f is not None else 0) + (1 << (s0 + k - 1))) * 64
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, products * MULS_PER_MONT / peak_muls_per_s
        at = dict(shape=[LADDER_ROWS, m], stages=[s0, k], max_abs_err=0, ms=ms, plain_ms=plain_ms,
                  bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes > t_ops else "operations",
                  products=products, shared_bytes_per_block=32 << k)
        if row:
            row.setdefault("at_shapes", {})[label] = at
        else:
            row.update(at, **{"pass": label})
        log(f"K12 at 2^{log_full} x {LADDER_ROWS}, {label}, stages {s0}..{s0 + k - 1}: bitwise equal to plain; "
            f"{ms:.4f} ms (plain {plain_ms:.1f}, bound {at['bound_ms']:.4f} by {at['bound_by']}; "
            f"{32 << k} B of shared memory a block)")
    # whole transforms of one 2^23 row against the stage-at-a-time ladder
    x = ntt_rows(torch, gen, 1, m, device)[0]
    if (max_abs_err(torch, ntt.ntt(x, log_full), steps_ntt(x, log_full))
            or max_abs_err(torch, ntt.intt(x, log_full), steps_intt(x, log_full))):
        raise AssertionError(f"ntt / intt at 2^{log_full} differ from _ntt_core")
    log(f"ntt and intt at 2^{log_full}: bitwise equal to _ntt_core (plan {plan})")
    row["check"] = (f"bitwise equal to plain at every pass of the plans of 2^{list(NTT_CHECK_LOGS)} (3 rows; no "
                    f"factor, 1/m, g^i/m; in place) and of 2^{log_full} at the ladder's 3 rows (shape, at_shapes); "
                    f"ntt, intt and coset_ladder equal to _ntt_core there, ntt and intt at 2^{log_full}")
    row["library_ms_reason"] = "no PyTorch call computes an NTT over Fr (torch.fft is complex floating point)"
    return {"fr_ntt_pass": row}


def recode_specials():
    """Scalars that exercise the recode's carries: 0, 1, r-1, 2^253; all
    0xF nibbles below r; chains through digits equal to half (0x88..89 at
    w = 4, 0x8000 limbs above 0x8001 at w = 16); digits 2^w - 1 that take
    a carry in (mag 0, neg)."""
    from zkp2p_tpu_torch.field.bn254 import R

    return [0, 1, R - 1, 1 << 253, (1 << 252) - 1, int("8" * 63, 16) + 1,
            sum(0x8000 << (16 * i) for i in range(15)) + 1, 0xF9, 0xFFF9, 0xFFFF_9000,
            0xFFFF_FFFF_8001_0000_0000_9000]


def serial_recode(k: int, window: int):
    """Signed digits of the Python int k, least significant first with the
    carry in hand (K14's recurrence), most significant first out."""
    half, full = 1 << (window - 1), 1 << window
    mags, negs, carry = [], [], 0
    for j in range(256 // window):
        e = ((k >> (window * j)) & (full - 1)) + carry
        carry = int(e > half)
        mags.append(full - e if carry else e)
        negs.append(bool(carry))
    return mags[::-1], negs[::-1]


def check_recode_kernel(torch, device):
    """K14 against its plain version (the Kogge-Stone recode, bitwise on
    mags and negs) at RECODE_BATCHES x RECODE_WINDOWS with the special
    scalars first, and a sample against the serial recode over Python
    ints; then at the path's shapes (the witness at w = 4, H's 2^23 at
    w = 4 and w = 16), timed beside its bound and its plain version."""
    from zkp2p_tpu_torch.field.tfield import limbs_to_int
    from zkp2p_tpu_torch.ops import cuda_recode, msm
    from zkp2p_tpu_torch.ops.cuda_mont import limbs_of

    gen = torch.Generator(device=device).manual_seed(SEED + 40)
    specials = recode_specials()

    def scalars(n):
        x = rand_canon(torch, gen, (n,), device)
        k = min(n, len(specials))
        x[:k] = torch.tensor([limbs_of(v) for v in specials[:k]], dtype=torch.int32, device=device)
        return x

    def check(x, window):
        got = cuda_recode.signed_recode(x, window)
        want = msm.signed_digit_planes_from_limbs(x, window)
        if max_abs_err(torch, got, want):
            raise AssertionError(f"signed_recode (n={x.shape[0]}, w={window}) differs from its plain version")
        return got

    for n in RECODE_BATCHES:
        x = scalars(n)
        for window in RECODE_WINDOWS:
            mags, negs = check(x, window)
            xs, ms, ns = x[:32].cpu().numpy(), mags[:, :32].cpu().numpy(), negs[:, :32].cpu().numpy()
            for i in range(xs.shape[0]):
                if serial_recode(limbs_to_int(xs[i]), window) != (ms[:, i].tolist(), ns[:, i].tolist()):
                    raise AssertionError(f"signed_recode (w={window}) scalar {i} differs from the serial recode")
    log(f"K14 signed_recode: bitwise equal to plain at {RECODE_BATCHES} scalars, w = {RECODE_WINDOWS}, special "
        f"scalars included; sample equal to the serial recode")

    shapes = {"witness, w=4": (VENMO["n_wires"], 4), "H, w=4": (1 << VENMO["log_m"], 4),
              "H, w=16 (bucket h MSM)": (1 << VENMO["log_m"], 16)}
    row = {}
    for label, (n, window) in shapes.items():
        x = scalars(n)
        ms, got = cuda_ms(torch, lambda: cuda_recode.signed_recode(x, window), 10)
        plain_ms, want = cuda_ms(torch, lambda: msm.signed_digit_planes_from_limbs(x, window), 1, warmup=False)
        if max_abs_err(torch, got, want):
            raise AssertionError(f"signed_recode ({label}, n={n}) differs from its plain version")
        del want
        nbytes = n * 64 + (256 // window) * n * 5  # limbs in; an int32 magnitude and a bool sign a digit out
        at = dict(shape=[n], window=window, max_abs_err=0, ms=ms, plain_ms=plain_ms,
                  bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
        if row:
            row.setdefault("at_shapes", {})[label] = at
        else:
            row.update(at, scalars=label)
        log(f"K14 at {label} ({n} scalars): bitwise equal to plain; {ms:.4f} ms (plain {plain_ms:.1f}, bound "
            f"{at['bound_ms']:.4f} by bytes)")
    row["check"] = (f"bitwise equal to plain (mags and negs) at {list(RECODE_BATCHES)} scalars x w = "
                    f"{list(RECODE_WINDOWS)} with special scalars, sample equal to a serial recode over Python "
                    f"ints, and at the path's shapes (shape, at_shapes)")
    row["library_ms_reason"] = "no PyTorch call computes a signed base-2^w recode"
    return {"signed_recode": row}


def matvec_case(torch, gen, rows, long_row, device):
    """A random CSR matrix of `rows` rows (three nonzeros a row on average,
    rows unsorted) over rows + 3 witness values; from 4 rows up, row 1
    empty, row 2 one wire four times, row 3 the coefficients 0, 1, r-1
    against the witness values 0, 1, r-1; with `long_row`, that many
    nonzeros more in the last row.  Returns (csr, w)."""
    from zkp2p_tpu_torch.field.bn254 import R
    from zkp2p_tpu_torch.ops.cuda_matvec import csr_from_rows
    from zkp2p_tpu_torch.ops.cuda_mont import limbs_of

    n_wires, nnz = rows + 3, 3 * rows + long_row
    row = torch.randint(0, rows, (nnz,), generator=gen, device=device)
    wire = torch.randint(0, n_wires, (nnz,), generator=gen, device=device)
    coeff = rand_canon(torch, gen, (nnz,), device)
    w = rand_canon(torch, gen, (n_wires,), device)
    special = torch.tensor([limbs_of(v) for v in (0, 1, R - 1)], dtype=torch.int32, device=device)
    w[:3] = special
    if rows >= 4:
        row[row == 1] = 0
        row[:4], wire[:4] = 2, 7
        row[4:13] = 3
        wire[4:13] = torch.arange(3, device=device).repeat_interleave(3)
        coeff[4:13] = special.repeat(3, 1)
    if long_row:
        row[-long_row:] = rows - 1
    return csr_from_rows(coeff, wire, row, rows), w


def check_matvec_kernel(torch, device):
    """K13 against its plain version (bitwise) on random CSR matrices of
    MATVEC_BATCHES rows with the special rows and one row of
    MATVEC_LONG_ROW nonzeros, and sample rows against Python ints."""
    from zkp2p_tpu_torch.field.bn254 import MONT_R, R
    from zkp2p_tpu_torch.field.tfield import limbs_to_int
    from zkp2p_tpu_torch.ops import cuda_matvec

    gen = torch.Generator(device=device).manual_seed(SEED + 41)
    rinv = pow(MONT_R, -1, R)
    for rows in MATVEC_BATCHES:
        long_row = MATVEC_LONG_ROW if rows == 257 else 0
        csr, w = matvec_case(torch, gen, rows, long_row, device)
        got = cuda_matvec.fr_matvec(*csr, w)
        if max_abs_err(torch, got, cuda_matvec.fr_matvec_plain(*csr, w)):
            raise AssertionError(f"fr_matvec ({rows} rows) differs from its plain version")
        coeff, wire, offsets, wh, gh = (t.cpu().numpy() for t in (*csr, w, got))
        for i in sorted({*range(min(rows, 8)), rows - 1}):
            js = range(offsets[i], offsets[i + 1])
            want = sum(limbs_to_int(coeff[j]) * limbs_to_int(wh[wire[j]]) for j in js) * rinv % R
            if limbs_to_int(gh[i]) != want:
                raise AssertionError(f"fr_matvec ({rows} rows) row {i} ({len(js)} nonzeros) differs from Python ints")
    log(f"K13 fr_matvec: bitwise equal to plain at {MATVEC_BATCHES} rows (special rows; a row of "
        f"{MATVEC_LONG_ROW} nonzeros); sample rows equal to Python ints")
    for rows in MATVEC_BATCHES[1:]:
        long_row = MATVEC_LONG_ROW if rows == 257 else 0
        csr, w = matvec_case(torch, gen, rows, long_row, device)
        for batch in BATCH_SIZES:
            wb = torch.stack([w] + [rand_canon(torch, gen, tuple(w.shape[:1]), device) for _ in range(batch - 1)])
            got = cuda_matvec.fr_matvec(*csr, wb)
            each = torch.stack([cuda_matvec.fr_matvec(*csr, x) for x in wb])
            if max_abs_err(torch, got, cuda_matvec.fr_matvec_plain(*csr, wb)) or max_abs_err(torch, got, each):
                raise AssertionError(f"fr_matvec at batch {batch} ({rows} rows) differs from its plain version or "
                                     f"from the unbatched kernel")
    log(f"K13 batched: bitwise equal to plain and to the unbatched kernel at B {BATCH_SIZES} x "
        f"{MATVEC_BATCHES[1:]} rows")
    return {"fr_matvec": {"check": (
        f"bitwise equal to plain at {list(MATVEC_BATCHES)} rows with an empty row, a repeated wire, coefficients "
        f"and witness values 0, 1, r-1 and a row of {MATVEC_LONG_ROW} nonzeros, sample rows equal to Python ints, "
        f"and on the synthetic key's A and B over 2^{VENMO['log_m']} rows (shape, at_shapes); batched at B "
        f"{list(BATCH_SIZES)} on {list(MATVEC_BATCHES[1:])} rows and at B {BATCH_CHUNK} on the key's A (batch), "
        f"bitwise equal to plain and to the unbatched kernel"),
        "library_ms_reason": "no PyTorch call computes a sparse product over Fr (torch.sparse adds floats or "
                             "integers that wrap)"}}


def time_matvec_path(torch, key, witness, peak_muls_per_s, device):
    """K13 on the synthetic key's A and B (their CSR forms, as the prover
    builds them) against the real-size witness: timed beside its bound
    and its plain version, held bitwise.  Logs the CSR's extra bytes on
    the card and its longest row."""
    from zkp2p_tpu_torch.ops import cuda_matvec
    from zkp2p_tpu_torch.prover import groth16_gpu as gp

    w = gp.witness_to_device(witness, device)
    m = 1 << key.log_m
    row = {}
    for name in ("a", "b"):
        csr = gp.key_csr(key, name)
        nnz = csr.wire.numel()
        copied = csr.coeff.data_ptr() != getattr(key, f"{name}_coeff").data_ptr()
        extra = csr.wire.nbytes + csr.offsets.nbytes + (csr.coeff.nbytes if copied else 0)
        fan_in = int(csr.offsets.diff().max())
        out = torch.empty(m, 16, dtype=torch.int32, device=device)
        ms, got = cuda_ms(torch, lambda: cuda_matvec.fr_matvec(*csr, w, out=out), 10)
        plain_ms, want = cuda_ms(torch, lambda: cuda_matvec.fr_matvec_plain(*csr, w), 1, warmup=False)
        if max_abs_err(torch, got, want):
            raise AssertionError(f"fr_matvec on the key's {name.upper()} differs from its plain version")
        del want
        # coefficients and wire ids once a nonzero, offsets, the witness
        # read once, the rows written once; one product a nonzero
        nbytes = nnz * (64 + 4) + csr.offsets.nbytes + w.numel() * 4 + m * 64
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nnz * MULS_PER_MONT / peak_muls_per_s
        at = dict(shape=[m, nnz], max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
                  bound_by="bytes" if t_bytes > t_ops else "operations", max_fan_in=fan_in,
                  csr_extra_bytes=extra, coeff_copied=copied)
        if row:
            row.setdefault("at_shapes", {})[name.upper()] = at
        else:
            row.update(at, matrix=name.upper())
        log(f"K13 on the key's {name.upper()} ({nnz} nonzeros over {m} rows; longest row {fan_in}; CSR adds "
            f"{extra} bytes on the card{', coefficients sorted into a copy' if copied else ''}): bitwise equal "
            f"to plain; {ms:.4f} ms (plain {plain_ms:.1f}, bound {at['bound_ms']:.4f} by {at['bound_by']})")
    # the batch prover's chunk: BATCH_CHUNK witnesses against the key's A in one launch
    from zkp2p_tpu_torch.field.tfield import FR

    gen = torch.Generator(device=device).manual_seed(SEED + 42)
    csr = gp.key_csr(key, "a")
    nnz = csr.wire.numel()
    wb = torch.stack([w] + [FR.to_mont(rand_canon(torch, gen, tuple(w.shape[:1]), device))
                            for _ in range(BATCH_CHUNK - 1)])
    out = torch.empty(BATCH_CHUNK, m, 16, dtype=torch.int32, device=device)
    ms, got = cuda_ms(torch, lambda: cuda_matvec.fr_matvec(*csr, wb, out=out), 10)
    each_ms, each = cuda_ms(torch, lambda: torch.stack([cuda_matvec.fr_matvec(*csr, x) for x in wb]), 3)
    if max_abs_err(torch, got, each):
        raise AssertionError("fr_matvec at batch on the key's A differs from the unbatched kernel")
    del each
    plain_ms, want = cuda_ms(torch, lambda: cuda_matvec.fr_matvec_plain(*csr, wb), 1, warmup=False)
    if max_abs_err(torch, got, want):
        raise AssertionError("fr_matvec at batch on the key's A differs from its plain version")
    del want
    nbytes = nnz * (64 + 4) + csr.offsets.nbytes + BATCH_CHUNK * (w.numel() * 4 + m * 64)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, BATCH_CHUNK * nnz * MULS_PER_MONT / peak_muls_per_s
    row["batch"] = dict(batch=BATCH_CHUNK, shape=[BATCH_CHUNK, m, nnz], matrix="A", max_abs_err=0, ms=ms,
                        unbatched_ms=each_ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
                        bound_by="bytes" if t_bytes > t_ops else "operations")
    log(f"K13 at {BATCH_CHUNK} witnesses on the key's A: bitwise equal to plain and to the unbatched kernel; "
        f"{ms:.4f} ms (unbatched, one launch a witness: {each_ms:.4f}; plain {plain_ms:.1f}; bound "
        f"{row['batch']['bound_ms']:.4f} by {row['batch']['bound_by']})")
    return row


def old_witness_side(stack, gp):
    """Patch the prover's witness side back to the routes K13, K14 and the
    u64 upload replaced (for the duration of `stack`): the host-widened
    upload, the gathered K1 products with segment sums, the Kogge-Stone
    recode."""
    from unittest import mock

    from zkp2p_tpu_torch.ops import msm

    stack.enter_context(mock.patch.object(gp, "witness_to_device", gp._witness_to_device_widened))
    stack.enter_context(mock.patch.object(gp, "abc_evals", gp._abc_evals_gathered))
    stack.enter_context(mock.patch.object(gp, "signed_digit_planes", msm.signed_digit_planes_from_limbs))


def compare_witness_side(torch, key, witness, device):
    """The proof's witness side at real size (witness -> device, the
    matvec, the H ladder and the digit planes, as prove_gpu runs them) in
    turns: new (u64 upload, K13, K14), old (host widen, gathered K1
    products and segment sums, Kogge-Stone), new; the abc buffer, the
    witness's and H's planes held bitwise equal.  Stage seconds of each."""
    import contextlib
    from unittest import mock

    from zkp2p_tpu_torch.prover import groth16_gpu as gp

    order = ["new", "old", "new"]
    out = {"order": order, "stage_s": []}
    first = None
    for way in order:
        stages, kept = {}, {}
        with contextlib.ExitStack() as stack:
            if way == "old":
                old_witness_side(stack, gp)
            abc_of = gp.abc_evals
            stack.enter_context(mock.patch.object(gp, "abc_evals", lambda d, w: kept.setdefault("abc", abc_of(d, w))))

            def side():
                w_mont = gp._timed(stages, "witness", lambda: gp.witness_to_device(witness, device))
                return gp._h_and_planes(key, w_mont, gp.WINDOW, stages)

            stages["s_total"], ((w_planes, _), h_planes) = wall_s(torch, side)
        got = (kept["abc"], *w_planes, *h_planes)
        out["stage_s"].append({k[2:]: v for k, v in stages.items() if k.startswith("s_")})
        if first is None:
            first = got
        elif any(max_abs_err(torch, g, f) for g, f in zip(got, first)):
            raise AssertionError(f"the witness side ({way}) differs from the first run")
        log(f"witness side ({way}): {json.dumps(out['stage_s'][-1])}")
    out.update(bitwise_equal=True, compared="abc (3, m, 16), witness planes (mags, negs), H planes (mags, negs)")
    return out


def compare_ladder(torch, key, witness, device):
    """h_evals at real size through K12 (coset_ladder) and through the
    stage-at-a-time ladder (ntt._ladder_steps: _ntt_core with K1 products
    and plain add/sub) in turns: K12, ladder steps, K12; the three results
    held bitwise equal.  The ladder's and h_evals' seconds of each (host
    clock around work that ends in a synchronise)."""
    import contextlib
    from unittest import mock

    from zkp2p_tpu_torch.ops import ntt
    from zkp2p_tpu_torch.prover import groth16_gpu as gp

    w_mont = gp.witness_to_device(witness, device)
    order = ["kernel", "steps", "kernel"]
    out = {"order": order, "ladder_s": [], "h_evals_s": []}
    results = []
    for way in order:
        stages = {}
        steps = mock.patch.object(gp, "coset_ladder", ntt._ladder_steps) if way == "steps" else contextlib.nullcontext()
        with steps:
            sec, h = wall_s(torch, lambda: gp.h_evals(key, w_mont, stages))
        out["ladder_s"].append(stages["s_ntt"])
        out["h_evals_s"].append(sec)
        results.append(h)
    if any(max_abs_err(torch, r, results[0]) for r in results[1:]):
        raise AssertionError("h_evals through K12 differs from the stage-at-a-time ladder at real size")
    log(f"H ladder at 2^{key.log_m}: K12 {out['ladder_s'][0]:.4f}, {out['ladder_s'][2]:.4f} s, ladder steps "
        f"{out['ladder_s'][1]:.3f} s; h_evals bitwise equal")
    out.update(log_m=key.log_m, rows=LADDER_ROWS, bitwise_equal=True)
    return out


def fold_turns(torch, curve, acc, window):
    """The Horner fold of the (planes, lanes) partials `acc` both ways in
    turns: _fold_steps (K4 and K2 a step), the kernel (K10, K11), the
    kernel, _fold_steps.  Host seconds of each; the four results held
    bitwise equal.  Returns (seconds, the kernel's result)."""
    from zkp2p_tpu_torch.ops import msm

    init = curve.infinity((acc[0].shape[1],), acc[0].device)
    ways = {"steps": lambda: msm._fold_steps(curve, init, acc, window),
            "kernel": lambda: msm.horner_fold_planes(curve, init, acc, window)}
    secs = {"order": ["steps", "kernel", "kernel", "steps"], "steps_s": [], "kernel_s": []}
    outs = []
    for way in secs["order"]:
        sec, out = wall_s(torch, ways[way])
        secs[f"{way}_s"].append(sec)
        outs.append(out)
    if any(max_abs_err(torch, o, outs[0]) for o in outs[1:]):
        raise AssertionError(f"the {'K11' if curve.g2 else 'K10'} fold differs from _fold_steps")
    return secs, outs[1]


def compare_msm_h(torch, key, device):
    """The real-size h MSM (the key's 2^23 h bases, random scalars) once
    each way in turns: the step loops (the accumulate over K2/K3, the fold
    over K4/K2), the kernels (K6/K7, K10), the kernels, the step loops;
    all four held bitwise equal.  Then one more through the kernels a part
    at a time, the fold both ways in turns on the same partials (K10 and
    _fold_steps).  Seconds of each, host clock around work that ends in a
    synchronise."""
    from unittest import mock

    from zkp2p_tpu_torch.curve.tcurve import G1C
    from zkp2p_tpu_torch.ops import msm

    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    n = key.h_bases[0].shape[0]
    mags, negs = msm.signed_digit_planes_from_limbs(rand_canon(torch, gen, (n,), device), 4)
    lanes = msm.default_lanes(n)

    def loop():
        with mock.patch.object(msm, "horner_fold_planes", msm._fold_steps):
            return msm._windowed(G1C, key.h_bases, mags, negs, lanes, 4, msm._accumulate_steps)

    ways = {
        "loop": loop,
        "fused": lambda: msm.msm_windowed_signed(G1C, key.h_bases, mags, negs, lanes=lanes, window=4),
    }
    secs = {"loop": [], "fused": []}
    outs = []
    for way in ("loop", "fused", "fused", "loop"):
        sec, out = wall_s(torch, ways[way])
        secs[way].append(sec)
        outs.append(out)
    # one more through the kernels, a part at a time
    split = {}
    split["accumulate"], acc = wall_s(torch, lambda: msm._lane_partials(
        G1C, key.h_bases, mags, negs, lanes, 4, msm._accumulate_chunked))
    fold_s, per_lane = fold_turns(torch, G1C, acc, 4)
    split["horner_fold"] = fold_s["kernel_s"][0]
    split["lane_tree"], out = wall_s(torch, lambda: msm.tree_reduce(G1C, per_lane, lanes))
    if any(max_abs_err(torch, o, outs[0]) for o in outs[1:] + [out]):
        raise AssertionError("the real-size h MSM through K6/K7 and K10 differs from the step loops")
    log(f"msm_h at {n} bases: step loops {secs['loop']} s, K6/K7 + K10 {secs['fused']} s; bitwise equal; "
        f"split {split}; fold {fold_s}")
    return {"n": n, "lanes": lanes, "planes": int(mags.shape[0]), "order": ["loop", "fused", "fused", "loop"],
            "loop_s": secs["loop"], "fused_s": secs["fused"], "fused_split_s": split, "fold_s": fold_s,
            "bitwise_equal": True}


def compare_msm_b2(torch, key, device):
    """The real-size b2 MSM (the key's G2 bases over the b query's narrow
    and wide classes, random scalars of each class's width) as the prover
    runs it: the narrow MSM (3 planes), the wide MSM (64) and their join,
    once each way in turns: the step loops (the accumulate over K2/K3, the
    fold over K4/K2), the kernels (K8/K9, K11), the kernels, the step
    loops; all four held bitwise equal.  Then the wide MSM's fold both ways
    in turns on the same partials (K11 and _fold_steps).  Seconds of each,
    host clock around work that ends in a synchronise."""
    import contextlib
    from unittest import mock

    from zkp2p_tpu_torch.curve.tcurve import G2C
    from zkp2p_tpu_torch.ops import msm
    from zkp2p_tpu_torch.prover import groth16_gpu as gp

    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    parts = []
    for sel, planes, fn in ((key.b_nsel, 3, gp._msm_g2_narrow), (key.b_wsel, 64, gp._msm_g2)):
        scalars = rand_canon(torch, gen, (sel.numel(),), device)
        if planes < 64:  # the narrow class: below 2^11
            scalars = torch.zeros_like(scalars)
            scalars[:, 0] = torch.randint(0, 1 << 11, (sel.numel(),), generator=gen, device=device,
                                          dtype=torch.int32)
        mags, negs = msm.signed_digit_planes_from_limbs(scalars, 4)
        parts.append((fn, tuple(c.index_select(0, sel) for c in key.b2_bases), (mags[-planes:], negs[-planes:])))

    def b2():
        (fn_n, b_n, p_n), (fn_w, b_w, p_w) = parts
        return G2C.add(fn_n(b_n, p_n, False), fn_w(b_w, p_w, False))

    secs = {"loop": [], "fused": []}
    outs = []
    for way in ("loop", "fused", "fused", "loop"):
        with contextlib.ExitStack() as stack:
            if way == "loop":
                stack.enter_context(mock.patch.object(msm, "_accumulate_chunked", msm._accumulate_steps))
                stack.enter_context(mock.patch.object(msm, "horner_fold_planes", msm._fold_steps))
            sec, out = wall_s(torch, b2)
        secs[way].append(sec)
        outs.append(out)
    if any(max_abs_err(torch, o, outs[0]) for o in outs[1:]):
        raise AssertionError("the real-size b2 MSM through K8/K9 and K11 differs from the step loops")
    # the wide MSM's partials, as gp._msm_g2 lays them out, folded both ways
    _, b_w, (mags_w, negs_w) = parts[1]
    lanes_w = msm.default_lanes(b_w[0].shape[0], cap=2048)
    acc_w = msm._lane_partials(G2C, b_w, mags_w, negs_w, lanes_w, 4, msm._accumulate_chunked)
    fold_s, _ = fold_turns(torch, G2C, acc_w, 4)
    log(f"msm_b2 at {key.b_nsel.numel()} narrow + {key.b_wsel.numel()} wide bases: step loops {secs['loop']} s, "
        f"K8/K9 + K11 {secs['fused']} s; bitwise equal; wide fold ({lanes_w} lanes) {fold_s}")
    return {"narrow": key.b_nsel.numel(), "wide": key.b_wsel.numel(), "order": ["loop", "fused", "fused", "loop"],
            "loop_s": secs["loop"], "fused_s": secs["fused"], "wide_lanes": lanes_w, "wide_fold_s": fold_s,
            "bitwise_equal": True}


def compare_proofs(torch, key, witness, rs, device):
    """Four real-size Jacobian proofs with the same r and s: the G1 and G2
    MSMs through the step loops (the accumulate over K2/K3 before K6-K9,
    the fold over K4/K2 before K10/K11), with only the fold through
    _fold_steps, through the kernels, and through the kernels with the old
    witness side (host widen, gathered K1 products and segment sums,
    Kogge-Stone recode; old_witness_side).  The stage seconds of each; the
    four proofs held byte for byte equal."""
    import contextlib
    from unittest import mock

    from zkp2p_tpu_torch.ops import msm
    from zkp2p_tpu_torch.prover import groth16_gpu as gp
    from zkp2p_tpu_torch.snark.groth16 import proof_bytes

    r, s = rs.randrange(1, 1 << 250), rs.randrange(1, 1 << 250)
    patches = {
        "loop": (("_accumulate_chunked", msm._accumulate_steps), ("horner_fold_planes", msm._fold_steps)),
        "fold_steps": (("horner_fold_planes", msm._fold_steps),),
        "fused": (),
        "old_witness_side": (),
    }
    out, proofs = {}, []
    for way, patched in patches.items():
        stages = {}
        with contextlib.ExitStack() as stack:
            for attr, fn in patched:
                stack.enter_context(mock.patch.object(msm, attr, fn))
            if way == "old_witness_side":
                old_witness_side(stack, gp)
            stages["s_total"], proof = wall_s(
                torch, lambda: gp.prove_gpu(key, witness, r=r, s=s, device=device, stages=stages))
        proofs.append(proof_bytes(proof))
        out[way] = {k[2:]: v for k, v in stages.items() if k.startswith("s_")}
        log(f"real-size proof ({way}): {json.dumps(out[way])}")
    if any(p != proofs[-1] for p in proofs):
        raise AssertionError("the real-size proofs through the kernels and through the step loops differ")
    log(f"real-size proof, same r and s: step loops {out['loop']['total']:.2f} s, fold by _fold_steps "
        f"{out['fold_steps']['total']:.2f} s, kernels {out['fused']['total']:.2f} s, kernels with the old witness "
        f"side {out['old_witness_side']['total']:.2f} s; equal bytes")
    return {"order": list(patches), "stage_s": out, "proof_bytes_equal": True}


def compare_affine_routes(torch, key, witness, rs, device):
    """Real-size proofs with the same r and s: the affine path through the
    kernels (K6/K8 tables, K15, K16, the bucket's planes in groups of
    PLANE_GROUP), through the kernels with the bucket's planes in each
    group size of PLANE_GROUPS, and the Jacobian path.  The stage seconds,
    launches and peak device memory of each; the proofs held byte for
    byte equal.  (The old routes, _affine_steps and the bucket a plane at
    a time, 56-72 s a proof, no longer run here; PERF.md keeps their
    findings.)"""
    import contextlib
    from unittest import mock

    from zkp2p_tpu_torch.ops import cuda_build, msm_bucket
    from zkp2p_tpu_torch.prover import groth16_gpu as gp
    from zkp2p_tpu_torch.snark.groth16 import proof_bytes

    r, s = rs.randrange(1, 1 << 250), rs.randrange(1, 1 << 250)
    ways = (("kernels", AFFINE_ARMS, ()),
            *((f"kernels_plane_group_{g}", AFFINE_ARMS, ((msm_bucket, "PLANE_GROUP", g),)) for g in PLANE_GROUPS),
            ("jacobian", {}, ()))
    out, proofs = {}, []
    for way, arms, patched in ways:
        stages = {}
        with contextlib.ExitStack() as stack:
            for module, attr, fn in patched:
                stack.enter_context(mock.patch.object(module, attr, fn))
            cuda_build.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            stages["s_total"], proof = wall_s(
                torch, lambda: gp.prove_gpu(key, witness, r=r, s=s, device=device, stages=stages, **arms))
            launches = {k[len("zk_"):]: v for k, v in cuda_build.LAUNCHES.items() if v}
        proofs.append(proof_bytes(proof))
        out[way] = {"stage_s": {k[2:]: v for k, v in stages.items() if k.startswith("s_")}, "launches": launches,
                    "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"real-size proof ({way}): {json.dumps(out[way])}")
    if any(p != proofs[0] for p in proofs):
        raise AssertionError("the real-size affine proofs through the kernels at each plane group, and the "
                             "Jacobian proof, differ")
    log(f"affine path, same r and s: kernels {out['kernels']['stage_s']['total']:.3f} s, "
        f"Jacobian {out['jacobian']['stage_s']['total']:.3f} s; equal bytes")
    log("bucket plane groups, msm_h s (peak GiB): " + ", ".join(
        f"{g} {out[f'kernels_plane_group_{g}']['stage_s']['msm_h']:.4f} "
        f"({out[f'kernels_plane_group_{g}']['peak_device_gib']:.2f})" for g in PLANE_GROUPS))
    return {"order": [w for w, _, _ in ways], "plane_group": msm_bucket.PLANE_GROUP, **out, "proof_bytes_equal": True}


def bound(n, monts_per_elem, bytes_per_elem, peak_muls_per_s):
    t_bytes = n * bytes_per_elem / HBM_BYTES_PER_S
    t_ops = n * monts_per_elem * MULS_PER_MONT / peak_muls_per_s
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes > t_ops else "operations")


# --------------------------------------------------------------- profile


def profile_proof(torch, prove, top: int = 15):
    """One more proof under torch.profiler: the device's busy share (the
    device activities' time over the wall clock) and where the device
    time goes, by kernel and by torch op."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prove()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_ms(e):
        return (getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)) / 1e3

    # device activities (kernels, copies); "Command Buffer Full" marks the
    # host waiting on a full launch queue, not device work
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.key != "Command Buffer Full"]
    ops = [e for e in events if e.device_type == DeviceType.CPU and dev_ms(e) > 0]
    busy = sum(dev_ms(e) for e in kernels) / 1e3

    def rank(evs):
        return [[e.key[:70], dev_ms(e), e.count] for e in sorted(evs, key=dev_ms, reverse=True)[:top]]

    return {"wall_s": wall, "device_busy_s": busy, "busy_share": busy / wall,
            "top_kernels_ms": rank(kernels), "top_ops_ms": rank(ops)}


# --------------------------------------------------------------- phase 4


def synthetic_key(torch, device):
    """A key and witness of the flagship shape: random QAP rows, bases
    t_j*G from small host tables, width classes with the measured counts.
    Returns (key, witness u64 rows, base-index map, host tables)."""
    import numpy as np

    from zkp2p_tpu_torch.curve import host
    from zkp2p_tpu_torch.curve.tcurve import g1_to_affine_arrays, g2_to_affine_arrays
    from zkp2p_tpu_torch.field.bn254 import R
    from zkp2p_tpu_torch.prover.groth16_gpu import DeviceProvingKey
    from zkp2p_tpu_torch.snark.groth16 import domain_size_for

    V = VENMO
    n, n_pub, m = V["n_wires"], V["n_public"], 1 << V["log_m"]
    if domain_size_for(V["rows"]) != m:
        raise AssertionError("VENMO rows and log_m disagree")
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    rng = np.random.default_rng(SEED + 2)
    pyr = random.Random(SEED + 3)

    def randint(hi, size):
        return torch.randint(0, hi, (size,), generator=gen, device=device)

    # width classes: wire 0 (the constant one) narrow, the public wires
    # wide, the rest split with the measured counts
    perm = torch.randperm(n - n_pub - 1, generator=gen, device=device) + n_pub + 1
    wide_ids, narrow_ids = perm[: V["c_wide"]], perm[V["c_wide"]:]
    is_narrow = torch.zeros(n, dtype=torch.bool, device=device)
    is_narrow[0] = True
    is_narrow[narrow_ids] = True
    c_sel = torch.arange(n_pub + 1, n, device=device)
    b_sel = torch.cat([
        narrow_ids[torch.randperm(len(narrow_ids), generator=gen, device=device)[: V["b_narrow"]]],
        wide_ids[torch.randperm(len(wide_ids), generator=gen, device=device)[: V["b_wide"]]],
    ]).sort().values

    def classes(sel):
        nar = is_narrow[sel]
        return torch.nonzero(nar).flatten(), torch.nonzero(~nar).flatten()

    a_nsel, a_wsel = classes(torch.arange(n, device=device))
    b_nsel, b_wsel = classes(b_sel)
    c_nsel, c_wsel = classes(c_sel)

    # host tables of t_j * G (row G1_TABLE / G2_TABLE is the (0, 0) hole)
    t1 = [pyr.randrange(1, R) for _ in range(G1_TABLE)]
    t2 = [pyr.randrange(1, R) for _ in range(G2_TABLE)]
    T1 = g1_to_affine_arrays([host.g1_mul(host.G1_GENERATOR, t) for t in t1] + [None], device)
    T2 = g2_to_affine_arrays([host.g2_mul(host.G2_GENERATOR, t) for t in t2] + [None], device)

    def idx(count, table, holes):
        i = randint(table, count)
        if holes:
            i[randint(count, holes)] = table
        return i

    ix = dict(a=idx(n, G1_TABLE, HOLES), b1=idx(len(b_sel), G1_TABLE, 0), b2=idx(len(b_sel), G2_TABLE, 0),
              c=idx(len(c_sel), G1_TABLE, 0), h=idx(m, G1_TABLE, HOLES))

    def rows(nnz):
        from zkp2p_tpu_torch.field.tfield import FR

        return FR.to_mont(rand_canon(torch, gen, (nnz,), device)), randint(n, nnz), randint(V["rows"], nnz)

    a_coeff, a_wire, a_row = rows(V["nnz_a"])
    b_coeff, b_wire, b_row = rows(V["nnz_b"])
    blind = [host.g1_mul(host.G1_GENERATOR, pyr.randrange(1, R)) for _ in range(3)]
    blind2 = [host.g2_mul(host.G2_GENERATOR, pyr.randrange(1, R)) for _ in range(2)]
    key = DeviceProvingKey(
        n_public=n_pub, n_wires=n, log_m=V["log_m"],
        a_coeff=a_coeff, a_wire=a_wire, a_row=a_row, b_coeff=b_coeff, b_wire=b_wire, b_row=b_row,
        a_bases=tuple(c[ix["a"]] for c in T1), b1_bases=tuple(c[ix["b1"]] for c in T1),
        b2_bases=tuple(c[ix["b2"]] for c in T2), c_bases=tuple(c[ix["c"]] for c in T1),
        h_bases=tuple(c[ix["h"]] for c in T1),
        b_sel=b_sel, c_sel=c_sel, a_nsel=a_nsel, a_wsel=a_wsel, b_nsel=b_nsel, b_wsel=b_wsel,
        c_nsel=c_nsel, c_wsel=c_wsel,
        alpha_1=blind[0], beta_1=blind[1], delta_1=blind[2], beta_2=blind2[0], delta_2=blind2[1],
    )
    assert len(a_nsel) == V["c_narrow"] + 1 and len(a_wsel) == V["c_wide"] + n_pub
    assert (len(b_nsel), len(b_wsel)) == (V["b_narrow"], V["b_wide"])
    assert (len(c_nsel), len(c_wsel)) == (V["c_narrow"], V["c_wide"])

    # witness: narrow wires below 2^11 (the width guard), wide below R
    limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint16)
    limbs[:, 15] = rng.integers(0, 0x3064, size=n, dtype=np.uint16)
    nar = is_narrow.cpu().numpy()
    limbs[nar, 1:] = 0
    limbs[nar, 0] &= (1 << 11) - 1
    limbs[0] = 0
    limbs[0, 0] = 1
    witness = np.ascontiguousarray(limbs).view("<u8").reshape(n, 4).copy()
    return key, witness, ix, (t1, t2)


def expected_msm(torch, scalars_std, idx, table, rows):
    """(sum_i s_i * t_idx(i) mod r): per-table-row sums of the scalars'
    limbs on the device (exact in int64), combined on the host."""
    from zkp2p_tpu_torch.field.bn254 import R
    from zkp2p_tpu_torch.field.tfield import limbs_to_int

    acc = torch.zeros(rows + 1, 16, dtype=torch.int64, device=scalars_std.device)
    acc.index_add_(0, idx, scalars_std.long())
    sums = acc[:rows].cpu().numpy()
    return sum(limbs_to_int(sums[j]) % R * table[j] for j in range(rows)) % R


def check_msms(torch, key, witness, ix, tables, stages):
    from zkp2p_tpu_torch.curve import host
    from zkp2p_tpu_torch.field.tfield import FR

    t1, t2 = tables
    w = torch.from_numpy(witness.view("<u2").astype("int32").reshape(-1, 16)).to(key.device)
    h_std = FR.from_mont(stages["h"])
    a_acc, b1_acc, b2_acc, c_acc, h_acc = stages["acc"]
    wb, wc = w[key.b_sel], w[key.c_sel]
    want = (
        ("a", a_acc, host.g1_mul(host.G1_GENERATOR, expected_msm(torch, w, ix["a"], t1, G1_TABLE))),
        ("b1", b1_acc, host.g1_mul(host.G1_GENERATOR, expected_msm(torch, wb, ix["b1"], t1, G1_TABLE))),
        ("b2", b2_acc, host.g2_mul(host.G2_GENERATOR, expected_msm(torch, wb, ix["b2"], t2, G2_TABLE))),
        ("c", c_acc, host.g1_mul(host.G1_GENERATOR, expected_msm(torch, wc, ix["c"], t1, G1_TABLE))),
        ("h", h_acc, host.g1_mul(host.G1_GENERATOR, expected_msm(torch, h_std, ix["h"], t1, G1_TABLE))),
    )
    for name, got, exp in want:
        if got != exp:
            raise AssertionError(f"msm {name} at real size differs from the host discrete-log value")


def check_h_evals(torch, device):
    """h_evals on the card against the plain path (the CPU) at 2^16."""
    from zkp2p_tpu_torch.field.tfield import FR
    from zkp2p_tpu_torch.prover.groth16_gpu import h_evals

    log_m = H_CHECK_LOG_M
    m = 1 << log_m
    n_wires, rows = m, m - 200
    nnz_a, nnz_b = (rows * VENMO[k] // VENMO["rows"] for k in ("nnz_a", "nnz_b"))
    gen = torch.Generator(device="cpu").manual_seed(SEED + 4)
    w = FR.to_mont(rand_canon(torch, gen, (n_wires,), "cpu"))

    def mat(nnz):
        return (FR.to_mont(rand_canon(torch, gen, (nnz,), "cpu")),
                torch.randint(0, n_wires, (nnz,), generator=gen), torch.randint(0, rows, (nnz,), generator=gen))

    (ac, aw, ar), (bc, bw, br) = mat(nnz_a), mat(nnz_b)
    cpu = SimpleNamespace(log_m=log_m, a_coeff=ac, a_wire=aw, a_row=ar, b_coeff=bc, b_wire=bw, b_row=br, _split={})
    gpu = SimpleNamespace(**{k: (v.to(device) if hasattr(v, "to") else v) for k, v in vars(cpu).items()})
    gpu._split = {}
    got = h_evals(gpu, w.to(device)).cpu()
    want = h_evals(cpu, w)
    if not torch.equal(got, want):
        raise AssertionError("h_evals on the card differs from the plain path at 2^16")


# --------------------------------------------------------------- phase 3


def check_setup_vector(torch, device):
    """setup_from_rows on the committed setup vector's rows gives
    port_vector.npz's key arrays, blinding points and VK byte for byte;
    the key proves the committed proof; verify accepts it and rejects a
    tampered one and a wrong public input."""
    import numpy as np

    from zkp2p_tpu_torch.curve import host
    from zkp2p_tpu_torch.prover.groth16_gpu import DPK_ARRAY_FIELDS, prove_gpu
    from zkp2p_tpu_torch.prover.setup_device import setup_from_rows
    from zkp2p_tpu_torch.prover.vector import load_setup_vector, load_vector
    from zkp2p_tpu_torch.snark.groth16 import Proof, proof_bytes, verify

    arrays, meta, witness, r, s, proof = load_vector()
    sv = load_setup_vector()
    t0 = time.perf_counter()
    key, vk = setup_from_rows(*((arrays[f"{q}_coeff"], arrays[f"{q}_wire"], arrays[f"{q}_row"]) for q in "ab"),
                              sv["c"], meta["n_wires"], meta["n_public"], sv["widths"], seed=sv["seed"],
                              device=device)
    setup_s = time.perf_counter() - t0
    for name in DPK_ARRAY_FIELDS:
        got, want = getattr(key, name), arrays[name]
        for g, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
            if not np.array_equal(g.cpu().numpy().astype(np.int64), np.asarray(w).astype(np.int64)):
                raise AssertionError(f"the setup of the test vector's rows differs from its key at {name}")
    g2 = [tuple((c.c0, c.c1) for c in p) for p in (key.beta_2, key.delta_2, vk.gamma_2, meta["beta_2"],
                                                     meta["delta_2"], sv["gamma_2"])]
    if ((key.alpha_1, key.beta_1, key.delta_1) != (meta["alpha_1"], meta["beta_1"], meta["delta_1"])
            or g2[:3] != g2[3:] or vk.ic != sv["ic"]):
        raise AssertionError("the setup of the test vector's rows gives other blinding points or another VK")
    got = prove_gpu(key, witness, r=r, s=s, device=device)
    if proof_bytes(got) != proof_bytes(proof):
        raise AssertionError("the test vector's proof under the key set up on the card differs")
    pub = sv["public"]
    tampered = Proof(a=host.g1_add(proof.a, host.G1_GENERATOR), b=proof.b, c=proof.c)
    t0 = time.perf_counter()
    if not verify(vk, proof, pub):
        raise AssertionError("verify rejects the test vector's proof")
    verify_s = time.perf_counter() - t0
    if verify(vk, tampered, pub) or verify(vk, proof, [pub[0] + 1] + pub[1:]):
        raise AssertionError("verify accepts a tampered proof or a wrong public input")
    log(f"test vector: the setup of its rows on the card gives its key and VK byte for byte ({setup_s:.2f} s); "
        f"its proof verifies ({verify_s:.2f} s), a tampered one and a wrong input do not")
    return {"setup_s": setup_s, "verify_s": verify_s, "key_equal": True, "verify": True, "tampered_rejected": True}


# --------------------------------------------------------------- phase 6


def synthetic_r1cs(torch, device):
    """A satisfying R1CS with the flagship's counts, on the card: the QAP
    rows as COO (Montgomery coefficients, wire ids, row ids) sorted by
    row, the width array, the witness (u64 rows) and its public inputs.
    A covers every wire above the publics (so c_sel holds them all) and
    holds the binding rows; B's wires are the synthetic key's b_sel
    classes (so |b_sel| is the measured count); C_j = {0: (Aw)_j (Bw)_j}
    with w_0 = 1, so every constraint holds."""
    import numpy as np

    from zkp2p_tpu_torch.field.tfield import FR
    from zkp2p_tpu_torch.ops.cuda_matvec import csr_from_rows, fr_matvec
    from zkp2p_tpu_torch.ops.cuda_mont import limbs_of

    V = VENMO
    n, n_pub, n_cons, rows = V["n_wires"], V["n_public"], V["constraints"], V["rows"]
    if rows != n_cons + n_pub + 1:
        raise AssertionError("VENMO rows are not the constraints plus the binding rows")
    gen = torch.Generator(device=device).manual_seed(SEED + 70)
    rng = np.random.default_rng(SEED + 71)

    def randint(hi, size):
        return torch.randint(0, hi, (size,), generator=gen, device=device)

    perm = torch.randperm(n - n_pub - 1, generator=gen, device=device) + n_pub + 1
    wide_ids, narrow_ids = perm[: V["c_wide"]], perm[V["c_wide"]:]
    widths = torch.full((n,), 254, dtype=torch.int32, device=device)
    widths[0] = 1
    widths[narrow_ids] = 11
    b_wires = torch.cat([
        narrow_ids[torch.randperm(len(narrow_ids), generator=gen, device=device)[: V["b_narrow"]]],
        wide_ids[torch.randperm(len(wide_ids), generator=gen, device=device)[: V["b_wide"]]],
    ])
    bind = torch.arange(n_pub + 1, device=device)
    extra_a = V["nnz_a"] - (n_pub + 1) - (n - n_pub - 1)
    a_wire = torch.cat([bind, torch.arange(n_pub + 1, n, device=device), randint(n, extra_a)])
    a_row = torch.cat([n_cons + bind, randint(n_cons, V["nnz_a"] - n_pub - 1)])
    b_wire = torch.cat([b_wires, b_wires[randint(len(b_wires), V["nnz_b"] - len(b_wires))]])
    b_row = randint(n_cons, V["nnz_b"])

    def coo(wire, row, nnz):
        coeff = FR.to_mont(rand_canon(torch, gen, (nnz,), device))
        order = torch.sort(row, stable=True).indices
        return coeff[order], wire[order], row[order]

    a = coo(a_wire, a_row, V["nnz_a"])
    a[0][-(n_pub + 1):] = torch.tensor(limbs_of(FR.mont_r), dtype=torch.int32, device=device)  # binding rows: 1
    b = coo(b_wire, b_row, V["nnz_b"])

    limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint16)
    limbs[:, 15] = rng.integers(0, 0x3064, size=n, dtype=np.uint16)
    nar = (widths <= 11).cpu().numpy()
    limbs[nar, 1:] = 0
    limbs[nar, 0] &= (1 << 11) - 1
    limbs[0] = 0
    limbs[0, 0] = 1
    witness = np.ascontiguousarray(limbs).view("<u8").reshape(n, 4).copy()
    w = FR.to_mont(torch.from_numpy(limbs.astype(np.int32)).to(device))
    az = fr_matvec(*csr_from_rows(*a, rows), w)
    bz = fr_matvec(*csr_from_rows(*b, rows), w)
    c = (FR.mul(az[:n_cons], bz[:n_cons]), torch.zeros(n_cons, dtype=torch.int64, device=device),
         torch.arange(n_cons, device=device))
    pub = [int.from_bytes(witness[i].tobytes(), "little") for i in range(1, n_pub + 1)]
    return a, b, c, widths.cpu().numpy(), witness, pub


def _host_tau(entries, lag):
    """sum coeff * lag[row] over (Montgomery coefficient limbs, row) pairs, in ints."""
    from zkp2p_tpu_torch.field.bn254 import MONT_R, R
    from zkp2p_tpu_torch.field.tfield import limbs_to_int

    rinv = pow(MONT_R, -1, R)
    return sum(limbs_to_int(co) * rinv % R * lag(int(j)) for co, j in entries) % R


def check_setup_samples(torch, key, a, b, c, seed):
    """Sampled bases of the key against the host curve at the scalars of
    the setup's definition, computed in Python ints from the COO rows:
    a_i = sum A_ji L_j(tau), b1 and b2 at b_tau, c at the scaled values
    of the private wires, h_j = scale w^j / (tau' - w^j)."""
    from zkp2p_tpu_torch.curve import host
    from zkp2p_tpu_torch.field.bn254 import R, fr_domain_root, fr_inv
    from zkp2p_tpu_torch.field.tfield import FQ
    from zkp2p_tpu_torch.snark.groth16 import _seeded_scalars, coset_gen

    tau, alpha, beta, gamma, delta = _seeded_scalars(seed, 5)
    m = 1 << key.log_m
    w = fr_domain_root(key.log_m)
    z_tau = (pow(tau, m, R) - 1) % R
    minv = fr_inv(m)
    g = coset_gen(key.log_m)
    tau_p = tau * fr_inv(g) % R
    scale = (pow(tau_p, m, R) - 1) * minv % R * z_tau % R * fr_inv(delta * ((pow(g, m, R) - 1) % R) % R) % R

    def lag(j):
        wj = pow(w, j, R)
        return z_tau * wj % R * minv % R * fr_inv((tau - wj) % R) % R

    def tau_of(rows, i):
        sel = torch.nonzero(rows[1] == i).flatten()
        return _host_tau(zip(rows[0][sel].cpu().numpy(), rows[2][sel].cpu().numpy()), lag)

    def g1_at(bases, p):
        x, y = (FQ.from_mont_host(c[p].cpu().numpy()) for c in bases)
        return None if (x, y) == (0, 0) else (x, y)

    def g2_at(bases, p):
        x, y = (tuple(FQ.from_mont_host(v) for v in c[p].cpu().numpy()) for c in bases)
        return None if x == (0, 0) and y == (0, 0) else (x, y)

    pyr = random.Random(SEED + 72)
    G1, G2 = host.G1_GENERATOR, host.G2_GENERATOR
    n_pub = key.n_public
    checked = 0
    for i in [0, n_pub, n_pub + 1] + [pyr.randrange(key.n_wires) for _ in range(SETUP_SAMPLES)]:
        if g1_at(key.a_bases, i) != host.g1_mul(G1, tau_of(a, i)):
            raise AssertionError(f"the key's A base of wire {i} differs from the host")
        checked += 1
    for p in [0] + [pyr.randrange(key.b_sel.numel()) for _ in range(SETUP_SAMPLES)]:
        bt = tau_of(b, int(key.b_sel[p]))
        want2 = host.g2_mul(G2, bt)
        if g1_at(key.b1_bases, p) != host.g1_mul(G1, bt) or g2_at(key.b2_bases, p) != (
                None if want2 is None else tuple((v.c0, v.c1) for v in want2)):
            raise AssertionError(f"the key's B bases at position {p} differ from the host")
        checked += 1
    for p in [0] + [pyr.randrange(key.c_sel.numel()) for _ in range(SETUP_SAMPLES)]:
        i = int(key.c_sel[p])
        val = (beta * tau_of(a, i) + alpha * tau_of(b, i) + tau_of(c, i)) * fr_inv(delta) % R
        if g1_at(key.c_bases, p) != host.g1_mul(G1, val):
            raise AssertionError(f"the key's C base of wire {i} differs from the host")
        checked += 1
    for j in [0, m - 1] + [pyr.randrange(m) for _ in range(SETUP_SAMPLES)]:
        wj = pow(w, j, R)
        if g1_at(key.h_bases, j) != host.g1_mul(G1, scale * wj % R * fr_inv((tau_p - wj) % R) % R):
            raise AssertionError(f"the key's h base {j} differs from the host")
        checked += 1
    return checked


def real_size_setup(torch, rows, peak_muls_per_s, device):
    """Phase 6: the setup of a satisfying synthetic R1CS of the
    flagship's counts on the card (every stage timed, the launches
    counted), its sampled bases against the host, one proof under the
    key that the port's verify accepts, and a full-size key cache round
    trip (save_dpk, load_dpk) that proves the same bytes.  Adds K13's and
    K15's setup shapes to their rows."""
    import os

    from zkp2p_tpu_torch.field.tfield import FR
    from zkp2p_tpu_torch.ops import cuda_build, cuda_matvec
    from zkp2p_tpu_torch.ops import msm_affine as MA
    from zkp2p_tpu_torch.prover import keycache
    from zkp2p_tpu_torch.prover.groth16_gpu import prove_gpu
    from zkp2p_tpu_torch.prover.setup_device import setup_from_rows
    from zkp2p_tpu_torch.snark.groth16 import proof_bytes, verify

    V = VENMO
    t0 = time.perf_counter()
    a, b, c, widths, witness, pub = synthetic_r1cs(torch, device)
    torch.cuda.synchronize()
    r1cs_s = time.perf_counter() - t0
    log(f"real-size R1CS made on the card: {r1cs_s:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    stages = {}
    cuda_build.reset_launches()
    setup_s, (key, vk) = wall_s(torch, lambda: setup_from_rows(
        a, b, c, V["n_wires"], V["n_public"], widths, seed=SETUP_SEED, device=device, n_rows=V["rows"],
        stages=stages))
    launches = dict(cuda_build.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() - resident) / 2**30  # above what was resident before
    want = {"b_sel": V["b_narrow"] + V["b_wide"], "c_sel": V["n_wires"] - V["n_public"] - 1,
            "a_nsel": V["c_narrow"] + 1, "b_nsel": V["b_narrow"], "c_nsel": V["c_narrow"]}
    got = {k: getattr(key, k).numel() for k in want}
    if got != want:
        raise AssertionError(f"the real-size key's selections {got} differ from the flagship's {want}")
    missing = [k for k in SETUP_KERNELS if not launches["zk_" + k]]
    if missing or launches["zk_fr_matvec"] < 3:
        raise AssertionError(f"the setup launched {launches}; missing {missing}, K13 three times or more expected")
    log(f"real-size setup: {setup_s:.3f} s (" + ", ".join(f"{k[2:]} {v:.3f}" for k, v in stages.items())
        + f"), peak {peak:.2f} GiB; launches " + json.dumps({k: v for k, v in launches.items() if v}))
    t0 = time.perf_counter()
    checked = check_setup_samples(torch, key, a, b, c, SETUP_SEED)
    log(f"real-size key: {checked} sampled bases equal to the host curve ({time.perf_counter() - t0:.1f} s)")

    # K13 over the transposed A and K15 over the setup's (2, m) Fr denominators
    m = 1 << V["log_m"]
    gen = torch.Generator(device=device).manual_seed(SEED + 73)
    lag = FR.to_mont(rand_canon(torch, gen, (m,), device))
    csr = cuda_matvec.csr_from_rows(a[0], a[2], a[1], V["n_wires"])
    nnz = csr.wire.numel()
    ms, got_t = cuda_ms(torch, lambda: cuda_matvec.fr_matvec(*csr, lag), 5)
    plain_ms, want_t = cuda_ms(torch, lambda: cuda_matvec.fr_matvec_plain(*csr, lag), 1, warmup=False)
    if max_abs_err(torch, got_t, want_t):
        raise AssertionError("fr_matvec over the transposed A differs from its plain version")
    del got_t, want_t, csr
    nbytes = nnz * (64 + 4) + (V["n_wires"] + 1) * 8 + m * 64 + V["n_wires"] * 64
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nnz * MULS_PER_MONT / peak_muls_per_s
    rows["fr_matvec"].setdefault("at_shapes", {})["setup A^T"] = dict(
        shape=[V["n_wires"], nnz], ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes > t_ops else "operations", launches_a_setup=launches["zk_fr_matvec"])
    den = FR.to_mont(rand_canon(torch, gen, (2, m), device))
    inv_ms, got_i = cuda_ms(torch, lambda: MA.batch_inverse(FR, den), 3)
    k = min(m, PLAIN_SLICE)
    inv_plain_ms, want_i = cuda_ms(torch, lambda: MA.batch_inverse_blocked(FR, den[:, :k], INV_BLOCK), 1,
                                   warmup=False)
    if max_abs_err(torch, got_i[:, :k], want_i):
        raise AssertionError("batch_inverse at the setup's shape differs from its plain version")
    inv_bound = bound(2 * m, 3, 128, peak_muls_per_s)  # a product each way and one to apply, in and out
    rows["batch_inverse"].setdefault("at_shapes", {})["setup 2 x 2^23 Fr"] = dict(
        shape=[2, m], ms=inv_ms, plain_ms=inv_plain_ms, plain_over=2 * k, **inv_bound,
        launches_a_setup=launches["zk_batch_inverse"])
    del got_i, want_i, den, lag
    log(f"setup shapes: K13 over A^T {ms:.3f} ms (plain {plain_ms:.1f}, bound {t_bytes * 1e3:.3f} bytes / "
        f"{t_ops * 1e3:.3f} ops); K15 batch_inverse 2 x 2^23 Fr {inv_ms:.3f} ms (plain {inv_plain_ms:.1f} over "
        f"{2 * k}, bound {inv_bound['bound_ms']:.3f})")

    rng = random.Random(SEED + 74)
    r, s = rng.randrange(1, 1 << 250), rng.randrange(1, 1 << 250)
    prove_s, proof = wall_s(torch, lambda: prove_gpu(key, witness, r=r, s=s, device=device))
    t0 = time.perf_counter()
    ok = verify(vk, proof, pub)
    verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("the real-size proof under the key set up on the card does not verify")
    if verify(vk, proof, [pub[0] + 1] + pub[1:]):
        raise AssertionError("the real-size proof verifies against a wrong public input")
    log(f"real-size proof under the card's key: {prove_s:.3f} s (first, the key's CSR built), verify "
        f"{verify_s:.2f} s: accepted; a wrong public input rejected")

    os.makedirs(".chip_scratch", exist_ok=True)
    path = os.path.join(".chip_scratch", "real_size_key.npz")
    try:
        save_s, _ = wall_s(torch, lambda: keycache.save_dpk(path, key, vk, digest="real-size"))
        size = os.path.getsize(path)
        del key
        torch.cuda.empty_cache()
        load_s, (key2, vk2) = wall_s(torch, lambda: keycache.load_dpk(path, digest="real-size", device=device))
    finally:
        if os.path.exists(path):
            os.remove(path)
    again = prove_gpu(key2, witness, r=r, s=s, device=device)
    if proof_bytes(again) != proof_bytes(proof) or vk2.ic != vk.ic:
        raise AssertionError("the key loaded from the cache proves other bytes or has another VK")
    log(f"key cache at full size: save {save_s:.1f} s, {size / 2**30:.2f} GiB, load {load_s:.1f} s; "
        f"the loaded key proves the same bytes")
    return {"shape": "venmo 1024/6400 counts, satisfying synthetic R1CS", "log_m": V["log_m"],
            "n_wires": V["n_wires"], "seed": SETUP_SEED, "r1cs_s": r1cs_s, "setup_s": setup_s,
            "stage_s": {k[2:]: v for k, v in stages.items()}, "peak_device_gib": peak,
            "launches": {k[len("zk_"):]: v for k, v in launches.items() if v}, "selections": got,
            "sampled_bases_checked": checked, "prove_s": prove_s, "verify_s": verify_s, "verify": True,
            "cache": {"save_s": save_s, "load_s": load_s, "file_gib": size / 2**30, "proof_bytes_equal": True}}, \
        launches


# -------------------------------------------------------------------- main


def real_size_proofs(torch, key, witness, ix, tables, rs, device, timed, warmup=True, **arms):
    """One warm-up (if `warmup`) and `timed` proofs of the real-size key
    under `arms`.
    The launch counts are reset just before the first timed proof and
    read just after it, whose five MSMs are checked against their
    discrete-log values.  Returns (stage seconds of each timed proof,
    launches, peak device GiB of the timed proofs)."""
    from zkp2p_tpu_torch.ops import cuda_build
    from zkp2p_tpu_torch.prover.groth16_gpu import prove_gpu

    def prove(stages=None):
        return prove_gpu(key, witness, r=rs.randrange(1, 1 << 250), s=rs.randrange(1, 1 << 250), device=device,
                         stages=stages, **arms)

    if warmup:
        t0 = time.perf_counter()
        prove()
        torch.cuda.synchronize()
        log(f"warm-up proof {arms}: {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for i in range(timed):
        stages = {}
        if i == 0:
            cuda_build.reset_launches()
        t0 = time.perf_counter()
        prove(stages)
        torch.cuda.synchronize()
        stages["s_total"] = time.perf_counter() - t0
        if i == 0:
            launches = dict(cuda_build.LAUNCHES)
            check_msms(torch, key, witness, ix, tables, stages)
            log(f"real size {arms}: all five MSMs equal their host discrete-log values")
        runs.append({k: v for k, v in stages.items() if k.startswith("s_")})
        log(f"proof {i} {arms}: {stages['s_total']:.2f} s")
    return runs, launches, torch.cuda.max_memory_allocated() / 2**30


def batch_witness(key, seed):
    """A real-size witness for the synthetic key, as synthetic_key makes
    its own: narrow wires below 2^11 (the width guard), wide below R,
    wire 0 the constant one."""
    import numpy as np

    n = key.n_wires
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint16)
    limbs[:, 15] = rng.integers(0, 0x3064, size=n, dtype=np.uint16)
    nar = np.zeros(n, dtype=bool)
    nar[key.a_nsel.cpu().numpy()] = True
    limbs[nar, 1:] = 0
    limbs[nar, 0] &= (1 << 11) - 1
    limbs[0] = 0
    limbs[0, 0] = 1
    return np.ascontiguousarray(limbs).view("<u8").reshape(n, 4).copy()


def key_resident_bytes(torch, key) -> int:
    """Device bytes the key holds: its tensors and the splits and CSR forms
    built once per key (each storage counted once)."""
    seen, total = set(), 0

    def walk(v):
        nonlocal total
        if isinstance(v, torch.Tensor):
            st = v.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
        elif isinstance(v, (tuple, list)):
            for x in v:
                walk(x)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)

    walk(list(vars(key).values()))
    return total


def batch_phase(torch, key, witness, ix, tables, jac_launches, device):
    """The batch prover at real size: BATCH_WITNESSES distinct seeded
    witnesses (the first the phase-4 witness), one warm-up chunk, then in
    turns with the same (r, s): prove_gpu_batch at chunk BATCH_CHUNK
    (launches counted), prove_gpu on each witness, prove_gpu_batch again;
    all proof bytes equal.  Each batch proof's five MSMs against their
    discrete-log values (H's scalars from the looped proof of the same
    witness) and its accumulators equal to the looped proof's.  Launches
    a chunk: the tables, accumulates, folds and lane trees as one proof's;
    K13 and K14 2, K12 2 x the passes.  Then the peak device memory of one
    chunk at each of PEAK_CHUNKS, and the key's resident bytes.  Returns
    the real_size_batch and batch_same_run lines and the counted run's
    launches."""
    from zkp2p_tpu_torch.field.bn254 import R
    from zkp2p_tpu_torch.ops import cuda_build
    from zkp2p_tpu_torch.ops.ntt import pass_plan
    from zkp2p_tpu_torch.prover.groth16_gpu import batch_spans, prove_gpu, prove_gpu_batch
    from zkp2p_tpu_torch.snark.groth16 import proof_bytes

    t0 = time.perf_counter()
    ws = [witness] + [batch_witness(key, SEED + 100 + i) for i in range(1, BATCH_WITNESSES)]
    pyr = random.Random(SEED + 6)
    rs = [(pyr.randrange(1, R), pyr.randrange(1, R)) for _ in ws]
    log(f"batch phase: {len(ws)} witnesses made ({time.perf_counter() - t0:.1f} s)")
    n_chunks = len(batch_spans(len(ws), BATCH_CHUNK))

    def batch(stages):
        return prove_gpu_batch(key, ws, rs=rs, chunk=BATCH_CHUNK, device=device, stages=stages)

    warm_s, _ = wall_s(torch, lambda: prove_gpu_batch(key, ws[:BATCH_CHUNK], rs=rs[:BATCH_CHUNK], chunk=BATCH_CHUNK,
                                                      device=device))
    log(f"batch warm-up ({BATCH_CHUNK} witnesses): {warm_s:.2f} s")
    cuda_build.reset_launches()
    st_a = {}
    batch_a_s, proofs_a = wall_s(torch, lambda: batch(st_a))
    launches = dict(cuda_build.LAUNCHES)
    log(f"prove_gpu_batch ({len(ws)} witnesses, chunk {BATCH_CHUNK}): {batch_a_s:.3f} s")
    loop_s, loop_stage_s = [], []
    for i, w in enumerate(ws):
        st = {}
        t, proof = wall_s(torch, lambda: prove_gpu(key, w, r=rs[i][0], s=rs[i][1], device=device, stages=st))
        loop_s.append(t)
        loop_stage_s.append({k[2:]: v for k, v in st.items() if k.startswith("s_")})
        if proof_bytes(proof) != proof_bytes(proofs_a[i]):
            raise AssertionError(f"batch proof {i} differs from prove_gpu's on the same witness, r and s")
        if st["acc"] != st_a["acc"][i]:
            raise AssertionError(f"batch accumulators of witness {i} differ from prove_gpu's")
        check_msms(torch, key, w, ix, tables, {"h": st["h"], "acc": st_a["acc"][i]})
        del st
    log(f"prove_gpu on each witness: {sum(loop_s):.3f} s ({', '.join(f'{t:.3f}' for t in loop_s)}); proofs and "
        f"accumulators equal to the batch's; all {len(ws)} x 5 MSMs equal their host discrete-log values")
    st_b = {}
    batch_b_s, proofs_b = wall_s(torch, lambda: batch(st_b))
    if [proof_bytes(p) for p in proofs_b] != [proof_bytes(p) for p in proofs_a]:
        raise AssertionError("the second prove_gpu_batch run differs from the first")
    log(f"prove_gpu_batch again: {batch_b_s:.3f} s; equal bytes")

    per_chunk = {k: launches["zk_" + k] / n_chunks for k in (*PER_CHUNK_AS_ONE_PROOF, "fr_matvec", "signed_recode",
                                                             "fr_ntt_pass", "mont_mul")}
    want = {k: jac_launches["zk_" + k] for k in PER_CHUNK_AS_ONE_PROOF}
    want.update(fr_matvec=2, signed_recode=2, fr_ntt_pass=2 * len(pass_plan(key.log_m)))
    bad = {k: (per_chunk[k], v) for k, v in want.items() if per_chunk[k] != v}
    if bad:
        raise AssertionError(f"launches a batch chunk (got, expected): {bad}")
    stray = [k for k in NOT_ON_JACOBIAN if launches["zk_" + k]]
    if stray:
        raise AssertionError(f"launchers launched on the batch path, which does not run them: {stray}")
    log(f"launches a batch chunk of {BATCH_CHUNK}: {json.dumps(per_chunk)} (a proof: "
        f"{json.dumps({k: jac_launches['zk_' + k] for k in per_chunk})})")

    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    resident = key_resident_bytes(torch, key)
    peaks = {}
    for c in PEAK_CHUNKS:
        torch.cuda.reset_peak_memory_stats()
        prove_gpu_batch(key, ws[:c], rs=rs[:c], chunk=c, device=device)
        torch.cuda.synchronize()
        peaks[c] = torch.cuda.max_memory_allocated() / 2**30
        log(f"peak device memory of one chunk of {c}: {peaks[c]:.2f} GiB")
    log(f"key resident: {resident / 2**30:.2f} GiB; allocated before the peak runs: {allocated / 2**30:.2f} GiB; "
        f"batch phase {time.perf_counter() - t0:.1f} s")

    n = len(ws)
    real = dict(shape="venmo 1024/6400", log_m=key.log_m, n_wires=key.n_wires, witnesses=n, chunk=BATCH_CHUNK,
                proofs_per_s=[n / batch_a_s, n / batch_b_s], batch_s=[batch_a_s, batch_b_s],
                chunk_stage_s=[{k[2:]: v for k, v in c.items() if k.startswith("s_")} for c in st_a["chunks"]],
                peak_device_gib_by_chunk=peaks, key_resident_bytes=resident, allocated_before_peak_runs=allocated,
                launches_per_chunk=per_chunk)
    same = dict(order=["batch", "loop", "batch"], s=[batch_a_s, sum(loop_s), batch_b_s],
                proofs_per_s=[n / batch_a_s, n / sum(loop_s), n / batch_b_s], loop_proof_s=loop_s,
                loop_stage_s_median={k: statistics.median(r[k] for r in loop_stage_s) for k in loop_stage_s[0]},
                proof_bytes_equal=True)
    return real, same, launches


def run(torch, device, peak_muls, sm_clock_hz):
    """Phases 1-6 on `device`; returns what main prints."""
    from zkp2p_tpu_torch.ops import cuda_build
    from zkp2p_tpu_torch.ops.cuda_msm_window import chunk_steps
    from zkp2p_tpu_torch.ops.msm import default_lanes
    from zkp2p_tpu_torch.ops.ntt import pass_plan
    from zkp2p_tpu_torch.prover.groth16_gpu import key_from_numpy, prove_gpu
    from zkp2p_tpu_torch.prover.vector import load_vector
    from zkp2p_tpu_torch.snark.groth16 import proof_bytes

    # phase 1
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    build_s = time.perf_counter() - t0
    for stem, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"ptxas {stem}: {line.strip()}")
    log(f"build: {build_s:.1f} s")

    # the main path's shapes: K1 at the domain (a*b; the NTT's products
    # run in K12); G1's K2 and K4 at the h
    # MSM's lanes (K2 in its lane tree; K4 did its Horner fold before
    # K10); G1's K3 in the affine arm's narrow tables (lanes capped at
    # 16,384, as the prover sets them; K6 builds the windowed path's);
    # G2's K2 and K4 at the b2 narrow MSM's lanes (K4 did its fold before
    # K11), G2's K3 in the affine arm's b2 narrow tables
    V = VENMO
    h_lanes = default_lanes(1 << V["log_m"])
    narrow_lanes = default_lanes(V["c_narrow"] + 1, cap=16384)
    b2_lanes = default_lanes(V["b_narrow"], cap=4096)
    geometry = {
        "mont_mul": 1 << V["log_m"],
        "g1_add": h_lanes, "g1_add_mixed": narrow_lanes, "g1_double": h_lanes,
        "g2_add": b2_lanes, "g2_add_mixed": b2_lanes, "g2_double": b2_lanes,
    }
    # K6/K7's chunks (digit planes, steps, lanes): the h MSM's; the narrow
    # classes'; the wide classes' (a's, the widest: one chunk of all its
    # steps).  K8/K9's: the b2 narrow MSM's, and its wide MSM's (one chunk)
    wide_n = V["c_wide"] + V["n_public"]
    wide_lanes = default_lanes(wide_n)
    b2w_lanes = default_lanes(V["b_wide"], cap=2048)
    window_shapes = {
        False: {
            "h": (64, chunk_steps(h_lanes, N_TABLE, 16), h_lanes),
            "narrow": (3, chunk_steps(narrow_lanes, N_TABLE, 16), narrow_lanes),
            "wide": (64, min(chunk_steps(wide_lanes, N_TABLE, 16), -(-wide_n // wide_lanes)), wide_lanes),
        },
        True: {
            "b2 narrow": (3, chunk_steps(b2_lanes, N_TABLE, 32), b2_lanes),
            "b2 wide": (64, min(chunk_steps(b2w_lanes, N_TABLE, 32), -(-V["b_wide"] // b2w_lanes)), b2w_lanes),
        },
    }
    # K15/K16's chunks (digit planes, steps, lanes, G2): the affine arm's
    # narrow, a wide and b1 wide classes (lanes rounded down to a power of
    # 2, as msm_windowed_affine does), and b2's narrow and wide; K15's
    # jac_to_affine normalises each chunk's (steps, 8, lanes) table
    def pow2(n):
        return 1 << (n.bit_length() - 1)

    affine_shapes = {}
    for name, n, cap, g2 in (("narrow", V["c_narrow"] + 1, 16384, False), ("a wide", wide_n, 4096, False),
                             ("b1 wide", V["b_wide"], 4096, False), ("b2 narrow", V["b_narrow"], 4096, True),
                             ("b2 wide", V["b_wide"], 2048, True)):
        lanes = pow2(default_lanes(n, cap=cap))
        steps = min(chunk_steps(lanes, N_TABLE, 32 if g2 else 16), -(-n // lanes))
        affine_shapes[name] = (3 if "narrow" in name else 64, steps, lanes, g2)
    # K10/K11's folds (lanes, planes, window): the h MSM's, the wide
    # classes' (a's lanes and b1's), the narrow classes', the bucket h
    # MSM's (one lane, w = 16); b2's wide and narrow MSMs'
    fold_shapes = {
        False: {"h": (h_lanes, 64, 4), "a wide": (wide_lanes, 64, 4),
                "b1 wide": (default_lanes(V["b_wide"]), 64, 4), "narrow": (narrow_lanes, 3, 4),
                "bucket h": (1, 16, 16)},
        True: {"b2 wide": (b2w_lanes, 64, 4), "b2 narrow": (b2_lanes, 3, 4)},
    }

    # phase 2
    t0 = time.perf_counter()
    rows = check_kernels(torch, geometry, peak_muls, device)
    rows["mont_pow"] = check_mont_pow(torch, peak_muls, sm_clock_hz, device)
    for g2 in (False, True):
        rows.update(check_window_kernels(torch, g2, window_shapes[g2], peak_muls, device))
        first = next(iter(window_shapes[g2].values()))
        rows[f"{'g2' if g2 else 'g1'}_window_accumulate"]["batch"] = check_window_batch(
            torch, g2, first, peak_muls, device)
        check_window_msm(torch, g2, device)
    for g2 in (False, True):
        rows.update(check_fold_kernels(torch, g2, fold_shapes[g2], peak_muls, sm_clock_hz, device))
    rows.update(check_affine_kernels(torch, affine_shapes, peak_muls, sm_clock_hz, device))
    affine_msm_same_run = check_affine_msm(torch, device)
    rows.update(check_ntt_kernel(torch, peak_muls, device))
    rows.update(check_matvec_kernel(torch, device))
    rows.update(check_recode_kernel(torch, device))
    # K17 at the setup's launches (the four G1 queries in one, b2 in G2)
    # and at each query's size
    g1_queries = {"a": V["n_wires"], "b1": V["b_narrow"] + V["b_wide"],
                  "c": V["n_wires"] - V["n_public"] - 1, "h": 1 << V["log_m"]}
    fb_sizes = {"setup G1 launch (a, b1, c, h)": (False, sum(g1_queries.values())),
                **{q: (False, n) for q, n in g1_queries.items()}, "setup G2 launch (b2)": (True, g1_queries["b1"])}
    rows.update(check_fixed_base_kernels(torch, fb_sizes, peak_muls, device))
    log(f"kernels against plain: {time.perf_counter() - t0:.1f} s")

    # phase 3
    t0 = time.perf_counter()
    arrays, meta, witness, r, s, expected = load_vector()
    vkey = key_from_numpy(arrays, meta, device=device)
    for arms in ({}, AFFINE_ARMS):
        got = prove_gpu(vkey, witness, r=r, s=s, device=device, **arms)
        if proof_bytes(got) != proof_bytes(expected):
            raise AssertionError(f"the test vector's proof {arms} differs from the committed one")
        log(f"test vector {arms}: proof equal to the committed one ({time.perf_counter() - t0:.1f} s)")
    setup_vector = check_setup_vector(torch, device)

    # phase 4
    t0 = time.perf_counter()
    check_h_evals(torch, device)
    log(f"h_evals at 2^{H_CHECK_LOG_M}: equal to the plain path ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    key, witness, ix, tables = synthetic_key(torch, device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"real-size synthetic key: {setup_s:.1f} s")
    rows["fr_matvec"].update(time_matvec_path(torch, key, witness, peak_muls, device))
    rs = random.Random(SEED + 5)
    runs, jac_launches, peak_gib = real_size_proofs(torch, key, witness, ix, tables, rs, device, JACOBIAN_TIMED)
    witness_same_run = compare_witness_side(torch, key, witness, device)
    ntt_same_run = compare_ladder(torch, key, witness, device)
    msm_h_same_run = compare_msm_h(torch, key, device)
    msm_b2_same_run = compare_msm_b2(torch, key, device)
    proof_same_run = compare_proofs(torch, key, witness, rs, device)

    # the batch phase
    real_batch, batch_same_run, batch_launches = batch_phase(torch, key, witness, ix, tables, jac_launches, device)

    # phase 5
    aff_runs, aff_launches, aff_peak_gib = real_size_proofs(torch, key, witness, ix, tables, rs, device,
                                                            AFFINE_TIMED, **AFFINE_ARMS)
    affine_same_run = compare_affine_routes(torch, key, witness, rs, device)

    # phase 6 (the phase-4 key stays resident for the profiles)
    real_setup, setup_launches = real_size_setup(torch, rows, peak_muls, device)
    torch.cuda.empty_cache()
    # last, so that no timed proof runs after the profiler
    profile = profile_proof(torch, lambda: prove_gpu(
        key, witness, r=rs.randrange(1, 1 << 250), s=rs.randrange(1, 1 << 250), device=device))
    profile_affine = profile_proof(torch, lambda: prove_gpu(
        key, witness, r=rs.randrange(1, 1 << 250), s=rs.randrange(1, 1 << 250), device=device, **AFFINE_ARMS))
    by_path = {"jacobian": jac_launches, "affine": aff_launches, "batch": batch_launches, "setup": setup_launches}
    for path, names in PATH_KERNELS.items():
        missing = [k for k in names if by_path[path]["zk_" + k] == 0]
        if missing:
            raise AssertionError(f"launchers never launched on the {path} path: {missing}")
    for path, names in (("jacobian", NOT_ON_JACOBIAN), ("affine", NOT_ON_AFFINE), ("batch", NOT_ON_JACOBIAN),
                        ("setup", OFF_PATH)):
        stray = [k for k in names if by_path[path]["zk_" + k]]
        if stray:
            raise AssertionError(f"launchers launched on the {path} path, which no longer runs them: {stray}")
    # OFF_PATH is asserted above to launch on no path
    unused = [k for k in cuda_build.LAUNCHERS if not any(v[k] for v in by_path.values())
              and k[len("zk_"):] not in OFF_PATH]
    if unused:
        raise AssertionError(f"launchers launched on no path: {unused}")
    passes = 2 * len(pass_plan(V["log_m"]))  # the iNTT's and the NTT's, all three rows in each
    for launcher, want in (("zk_fr_ntt_pass", passes), ("zk_fr_matvec", 2), ("zk_signed_recode", 2)):
        if any(v[launcher] != want for v in (jac_launches, aff_launches)):
            raise AssertionError(f"{launcher} launched {[v[launcher] for v in (jac_launches, aff_launches)]} times "
                                 f"a proof, expected {want}")
    k1_jac, k1_aff = jac_launches["zk_mont_mul"], aff_launches["zk_mont_mul"]
    log(f"K1 mont_mul launches a proof: {k1_jac} on the Jacobian path, {k1_aff} on the affine path")
    if max(k1_jac, k1_aff) > K1_JACOBIAN_MAX:
        raise AssertionError(f"K1 launched {k1_jac} / {k1_aff} times on the Jacobian / affine path, at most "
                             f"{K1_JACOBIAN_MAX} expected")
    log("launches of the affine proof: " + json.dumps({k: v for k, v in aff_launches.items() if v}))

    kernels = []
    for launcher in cuda_build.LAUNCHERS:
        name = launcher[len("zk_"):]
        row = rows[name]
        extra = {k: v for k, v in row.items()
                 if k not in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "check")}
        big = {"mont_mul": "2^20", "mont_pow": "2^16"}.get(name, "2^18")
        check = row.get("check", f"bitwise equal to plain at batches 1, 257, {big} and at shape; sample equal to host")
        kernels.append(dict(
            name=name, route="cuda", source="zkp2p_tpu_torch/csrc/" + SOURCE.get(name, "point_ops.cu"),
            replaces=REPLACES[name], launches=sum(v[launcher] for v in by_path.values()),
            launches_by_path={p: v[launcher] for p, v in by_path.items()}, max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=None, check=check, **extra,
        ))

    def summary(runs, peak):
        return {"stage_s_median": {k[2:]: statistics.median(r[k] for r in runs) for k in runs[0]},
                "prove_s": [r["s_total"] for r in runs], "peak_device_gib": peak}

    shape = {"shape": "venmo 1024/6400", "log_m": V["log_m"], "n_wires": V["n_wires"]}
    real = dict(shape, path="jacobian", build_s=build_s, key_setup_s=setup_s, k1_launches=k1_jac,
                **summary(runs, peak_gib))
    real_affine = dict(shape, path="affine", arms=AFFINE_ARMS, k1_launches=k1_aff,
                       launches={k[len("zk_"):]: v for k, v in aff_launches.items() if v},
                       **summary(aff_runs, aff_peak_gib))
    lines = {"profile": profile, "profile_affine": profile_affine, "kernels": kernels, "real_size": real, "real_size_affine": real_affine,
             "witness_same_run": witness_same_run, "ntt_same_run": ntt_same_run, "msm_h_same_run": msm_h_same_run,
             "msm_b2_same_run": msm_b2_same_run, "proof_same_run": proof_same_run,
             "affine_msm_same_run": affine_msm_same_run, "affine_same_run": affine_same_run,
             "real_size_batch": real_batch, "batch_same_run": batch_same_run, "setup_vector": setup_vector,
             "real_size_setup": real_setup}
    return lines


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    import zkp2p_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = smi("name,power.limit")
    props = torch.cuda.get_device_properties(0)
    sm_clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    peak_muls = props.multi_processor_count * INT_MULS_PER_SM_CLK * sm_clock_hz
    log(f"{card}; {props.multi_processor_count} SMs, max SM clock {sm_clock_hz / 1e6:.0f} MHz")
    t0 = time.perf_counter()
    lines = run(torch, torch.device("cuda", 0), peak_muls, sm_clock_hz)
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s")
    print(card)
    for name, value in lines.items():
        print(json.dumps({name: value}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
