#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zkp2p_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each of which raises on failure (the script then exits nonzero
and prints no result line).  They run in the order 1 (phase 12, chaos,
and phase 13 (b), the scheduler's fleet, and the `flame` command, starting
once its kernels are built, beside the rest of phase 1 and phase 8, and
ending before phase 9), 8 (its CLI
subprocesses beside it and phase 9), 9, 13 (a), 2 (no other process's kernels on
the card: phase 11's workers build their circuits and import their keys
beside it), 11 (phase 2's K15/K16 bitwise checks and phase 3 beside its
proofs), 6, 7 (phase 4's h_evals check
and synthetic key beside its `prove` and `batch` subprocesses), 10 (its
counted run; its command line runs in a thread from the end of phase 6,
beside 7 and the counted run, and ends before phase 4), 4, 5, the
profiles:

1. Build: every kernel source under zkp2p_tpu_torch/csrc/ with nvcc for
   sm_90a, one process per source, all started together, timed as
   set-up; beside it, in a thread, phase 8's circuit (VenmoParams(),
   1024/6400) by the port's builder, timed, with this process's RSS
   before and after.
2. Kernels against plain: each of the twenty-eight launchers (K1
   mont_mul; K2 add, K3 add_mixed, K4 double for G1 and G2; K5 mont_pow;
   K6/K8 the G1 and G2 window tables, K7/K9 the G1 and G2 window
   accumulates; K10/K11 the G1 and G2 Horner folds; K12 the NTT pass;
   K13 the CSR sparse matvec over Fr; K14 the signed digit recode; K15
   batch_inverse and jac_to_affine; K16 the G1 and G2 affine add and
   affine accumulate; K17 the G1 and G2 fixed-base batch; K18 the G1
   and G2 lane tree; K19 the G1 batch scaled by one scalar) on
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
   bitwise (K6-K9 over the chunk's first 8 steps, the whole chunk timed;
   K7/K9's whole chunk also equal under both digit layouts).  The whole
   G1 MSM through K6/K7, at 2^16 points with 64 digit
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
   against one plain run over all the lanes of the same (planes, window),
   over the first 8 planes (all of them timed).
   K12 on three random canonical rows with 0, 1, r-1 and the Montgomery
   one at log m 1, 2, 11, 12 and 16, at every pass of each size's plan
   (the first pass bit-reversed, with no factor, the 1/m constant and the
   g^i / m table; the later ones also in place), held bitwise against
   ntt_pass_plain, and ntt, intt and coset_ladder there against the
   stage-at-a-time _ntt_core compositions; then each pass of the 2^23
   plan at the H ladder's shape (3 rows): timed with its bound, its plain
   version timed on the first row, held bitwise there, the in-place pass
   equal to the out-of-place one on all three; and ntt and intt
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
   broadcast operands, held bitwise against their plain versions (these
   checks run beside phase 11's proofs, where no kernel is timed).  Then
   K15 at batch 1 against K5 in turns (K5, K15, K15, K5), timed with its
   chain floor; batch_inverse and jac_to_affine at each table chunk of
   the affine path (narrow 42 x 8 x 16,384, a wide 17 x 8 x 2,048, b1
   wide 18 x 8 x 512, b2 narrow 85 x 8 x 4,096 and b2 wide 18 x 8 x 512
   in Fq2) and batch_inverse at a bucket level (2^22 x 16); the K16
   accumulate at each chunk (3 x 16,384 x 42, 64 x 2,048 x 17, 64 x 512
   x 18, 3 x 4,096 x 85 and 64 x 512 x 18 in Fq2), its plain version
   over the first 2 steps; the G1 add at a bucket level (2^22 x 16
   planes, the strided halves of 2^23 x 16) and the G2 add at 2^16:
   each timed with its bound and its plain version (over the first 2^16
   elements above that), held bitwise.  The whole affine MSMs through
   K6/K8 + K15 + K16 at 2^16 (G1 and G2, 64 planes and the narrow 3) and
   the bucket MSM at w = 16 through the grouped planes, held bitwise
   against the old routes (_affine_steps; the bucket a plane at a time)
   and against host discrete logs.
   K17 (the G1 and G2 fixed-base batch of the setup, a signed 8-bit
   comb) at 1, 257 and 2^20 scalars with 0, 1, 2, r-1, r-2, 2^8k,
   scalars with runs of zero windows and the signed digits' boundaries
   (windows 0x7F, 0x80, 0x81, 0xFF alone and in runs, a run of 0xFF
   carrying into the top window), held bitwise against fixed_base_plain
   (over the first 2^16) and a sample against the host curve; then at
   the setup's two launches (the a, b1, c and h queries together in G1:
   19,825,624 scalars; b2 in G2: 1,603,487) and at each G1 query's size,
   timed with its bound (one mixed add a nonzero signed digit) and its
   plain version, held bitwise.
   K18 (the G1 and G2 lane tree) at (batch, lanes) (1, 1), (1, 2), (1,
   3), (1, 17), (4, 17), (3, 257), (2, 600) and at each tree the paths
   give it (G1: the h MSM's 4,096 lanes, the narrow classes' 16,384, a's
   wide 2,088, b1's wide 572; G2: b2's narrow 4,096 and wide 572), each
   at a batch of 1 and of 4, with a lane at infinity, P + P and P + (-P),
   held bitwise against the K2 loop it replaced (msm.tree_reduce_steps)
   and its plain version; at the paths' trees K18 and the K2 loop timed
   in turns, beside K18's operation bound and chain floor.
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
   path (CPU) at 2^14,
   and at real size through K12 against the stage-at-a-time ladder
   (ntt._ladder_steps) in turns (K12, ladder steps, K12; bitwise equal).
   Then the h MSM at real size (2^23 bases, 64 planes) once each way in
   turns (step loops, kernels, kernels, step loops: the accumulate by
   _accumulate_steps and the fold by _fold_steps, or by K6/K7 and K10),
   the four results held bitwise equal, and one more through the kernels
   split into its accumulate, Horner fold and lane tree (K18, then the
   K2 loop it replaced), the fold timed both ways in turns on the same
   partials (_fold_steps, K10, K10, _fold_steps; bitwise equal); the b2 MSM at real size (its narrow and
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
   tables, accumulates, folds, lane trees and joins (K2, K6-K11, K18) as
   many as one
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
   loaded key proving the same bytes (the real_size_setup line).  The key,
   its VK and the witness are then written as the drop-in path's files
   under .chip_scratch/cli/: a real-size .zkey (write_zkey_data; b1, b2
   and c scattered back over every wire, the pruned wires at infinity;
   the coefficient records from the key's A and B rows with the binding
   rows), verification_key.json and witness.wtns, and 4 .wtns for a batch
   (the witness and 7 made as batch_witness makes them).
7. Real size, the command line (the cli_real_size line):
   `python -m zkp2p_tpu_torch prove` on those files and then `verify`
   (exit 0, OK) as subprocesses, timed on the wall clock (what a user of
   the drop-in path waits for, files to proof.json; the prove's gpu/prove
   span read from its --trace file), and beside them `batch` at chunk 4
   over the 4 .wtns (the package's __main__ run as -m runs it, with the
   draws pinned; its gpu/prove_batch span from its --trace file); then in
   this process main(["prove", ...]) with r and s pinned (secrets.randbelow
   patched), its launches counted, each step of its path timed with a
   synchronise at each boundary (read_zkey, read_wtns, reduce_rows,
   device_pk_from_zkey with infer_zkey_widths inside it, prove_gpu,
   dump), its gpu/prove span, the width classes of the key it imported
   (the synthetic R1CS has no bit-constraint rows, so inference leaves
   every wire but wire 0 wide: the imported key's MSMs run wide), its
   proof.json byte-equal to prove_gpu's on that key; then
   main(["batch", ...]) in this process with the same
   draws, handed the zkey and the key that the in-process prove read and
   imported (no third 3 GB import), its launches counted: every file
   equal to the subprocess's and to the proofs its prove_gpu_batch
   returned, w0's to prove_gpu's with its (r, s); the witness's batch
   proof verifies, a seeded one's does not.  The CLI's prove must launch
   the Jacobian path's kernels and no other, its batch the batch path's,
   K12 6, K13 and K14 2 times a proof (a chunk), checked once phase 4
   has counted those paths.  .chip_scratch/cli/ is deleted at the end.
8. The flagship circuit (the flagship line).  Its start, just after
   phase 1: phase 1's VenmoParams() is set up on the card by
   setup_device (its stages, qap_coo and widths_array timed inside it,
   its launches counted), its counts (constraints, publics, wires, QAP
   rows, domain, nonzeros of A and B, the b and c query classes) held
   equal to VENMO, which was read from the reference's builder, and the
   key's a classes to the circuit's tagged widths; the files the CLI's
   setup writes (zkey_from_key, write_zkey_data, vkey_to_json,
   export_verifier) go under .chip_scratch/flagship/ in one rename (in
   a thread, as what follows until the inference);
   then `python -m zkp2p_tpu_torch --circuit venmo --max-header 1024
   --max-body 6400 prove --demo` (r and s pinned to the first proof's;
   it builds its circuit on the host for 80-110 s before it reads the
   zkey) and the 256/192 `setup` (the audit on) start as subprocesses,
   which run beside the rest of this phase and phase 9, and the zkey's
   classes are inferred (infer_zkey_widths).  Then in this process:
   four synthetic signed Venmo emails (FLAGSHIP_EMAILS) go through
   generate_inputs, the first through cs.witness and all four through
   cs.witness_batch (the first equal both ways), each timed; the 256/192
   circuit is set up here; the first witness is checked against the R1CS
   (cs.check_witness, which builds the check's matrices once for the
   circuit: phase 9's service checks every witness); prove_gpu on the
   first witness (launches counted, the Jacobian path's kernels; verify
   accepts it and rejects a changed public signal; the same (r, s)
   proves the same bytes again, timed warm), prove_gpu_batch of the four
   at chunk 4 (every proof verifies, the first equals prove_gpu's), the
   first again on the key with the zkey's inferred classes (the same
   bytes; first and warm timed; its launches counted, which phase 11's
   workers make a chunk).  Then the CLI setup's three files byte-equal to
   this process's (its wall clock, logged steps and sampled peak RSS
   recorded).  After phase 9: the CLI prove's proof.json and public.json equal to
   prove_gpu's and its key's classes to the inferred ones; `verify` (OK)
   as a subprocess beside phase 2.  The flame sampler (the flame line):
   (a) after this phase's timed work, one warm prove_gpu on its key and
   first witness outside the sampler (its launches held to the Jacobian
   rule), FLAME_PLAIN_PROOFS timed without it, then FLAME_S seconds of
   warm proofs under it through flameprof.profile_proves: the capture's
   gpu_launches equal, launcher by launcher, the proofs times the warm
   proof's, a `gpu:` frame sits under prove_gpu, and the top stacks,
   samples, the sampler's self_ms and the proofs' p50 with and without
   it are printed; (c) `python -m zkp2p_tpu_torch --circuit toy flame
   --duration 3` (the dev setup on the card) from the end of phase 1's
   build must exit 0, print collapsed stacks and write a capture of the
   card's launches; `perf --json` on (b)'s ledger, beside phase 2, must
   print its trendlines.
9. The proving service (the service line), on phase 8's resident key:
   ProvingService.for_venmo at batch 4 sweeps
   FLAGSHIP_EMAILS as demo payloads beside a payload with no raw_id, a
   torn request and one past its deadline, proving with prove_gpu_batch
   at phase 8's (r, s): 4 done, 2 error-bad-input, 1
   error-deadline-exceeded, each .proof.json and .public.json equal to
   phase 8's batch proof's, the done records carrying batch_index,
   batch_n and hbm_peak_bytes.  Then the default prover (random r,
   s) over eight new demo emails at batch 4 and prefetch 1 (phase 8's
   `prove --circuit venmo` may still run beside it): its launches counted over the sweep (two chunks, each K12 6,
   K13 and K14 2, K18 7 + 2, K2 3 + 1; nothing of NOT_ON_JACOBIAN),
   every proof verified; requests/s, the witness_batch, check_witness
   and prove seconds of each batch, the card's busy share (prove seconds
   over the sweep's wall clock), peak device memory and host RSS.  The
   perf sentry (b): this sweep runs with the ledger on in
   .chip_scratch/perf/cache (the pinned sweep with none); its exit stamp
   must be one valid entry under the card's fingerprint key; `perf
   --rebaseline` then `perf --gate` on that ledger must exit 0; then
   PERF_SEEDED entries whose prove p50 is a tenth of the sweep's are
   appended and a second band frozen from them, for phase 13 (a).
10. The key's life cycle, the phase-2 ceremony (the ceremony line).  In
   phase 2, K19 at the ceremony's shape (the
   flagship's C and H queries together, 13,305,359 points made on the
   card by K17 and K15, 16 (0, 0) holes, G, -G and 2 points off the
   curve among them) with a seeded full-width scalar: timed with its
   bound and the former NAF-only design's (scale.cu's second entry,
   which no path launches) on the same points in the same call, then
   K15's jac_to_affine once on its output; held bitwise against plain
   over the first 65,536 points, 10 sampled points (K19's, the
   comparator's, K15's) against the host g1_mul, and its first 257
   points with k = 0, 1, 2, 2^127, r-1, r and 2^256-1 against the host
   g1_mul; both kernels' registers, spills and static SASS mix.  The
   counted run, in this process on phase 6's key as
   its parsed zkey (no file): contribute_zkey twice (the first binds the
   circuit hash), beacon_zkey at iter_exp 10, verify_zkeys of the chain
   against the initial key (it must accept with the reference's lines),
   each with the launch counts reset just before and read just after,
   each launching exactly its CEREMONY_KERNELS (K19 and K15 once a
   contribution).  The command line, from phase 6's files hard-linked
   under .chip_scratch/ceremony/: `python -m zkp2p_tpu_torch ceremony
   contribute` and `beacon --iter-exp 10` in turn, then
   together `ceremony verify` of the final key (ZKEY OK, exit 0), of a
   copy with one H point moved to G (ZKEY INVALID, exit 1, the H
   scaling check failing) and `prove --zkey final --wtns`; then `verify`
   of that proof against the final key's VK (read_zkey_vk; OK, exit 0)
   and the initial one's (INVALID, exit 1), and `doctor --json --strict`
   (exit 0: the card, every kernel built, its K1 workload equal to
   plain): each subprocess's wall clock, peak RSS and its logged stage
   seconds and launches.
11. The fleet (the fleet line; its `service` workers are the command
   phase 9's `service` subprocess ran before, at full width):
   `python -m zkp2p_tpu_torch --build-dir <phase 8's files> --circuit
   venmo --max-header 1024 --max-body 6400 fleet --workers 2 --batch 2
   --fleet-metrics-port auto` starts just before phase 2, in a session of
   its own, with the fleet plane on a port the OS chooses; each worker
   builds the circuit, reads the zkey and imports the key (beside phase
   2), then serves its endpoint on a port the OS chooses.  Once both
   heartbeats say `up` with their ports (status.json listing both), the
   eight SERVICE_EMAILS are spooled and phase 2's K15/K16 bitwise checks
   and phase 3 run here while the workers prove them.  Every request ends `done` exactly once, both
   workers among the done records, every record and time-series line
   naming its worker and the fleet, every proof verifying under phase
   8's vkey; with the fleet still running each worker's /healthz (200),
   /metrics (200, its zkp2p_service_requests_total), /status (200, its
   worker, the fleet and the execution digest it logged) and /snapshot
   (armed, metrics the port's Registry.merge takes) answer.  The plane
   (polled every 0.5 s from the spawn) answered /status 503 with its
   reason until both workers were armed, then 200; FLEET_QUIET_CYCLES
   scrape cycles after the last request, its /metrics holds every counter
   of the workers' /snapshot summed label for label (the request counters
   among them), every histogram's count summed, every gauge labelled by
   worker, no merge refused, and its /status the merged window's n (the
   workers' sum), no alert and status.json its port; `python -m
   zkp2p_tpu_torch top --fleet-dir <state> --once` exits 0 with both
   workers up in its frame.  Then SIGTERM
   to the supervisor: exit 0 within 60 s plus the drain timeout, no
   escalation, no claim left, each worker drained with its logged
   launches exactly its chunks' (phase 8's proof under the zkey's classes
   a chunk, K1 4 + B) and its domain tables' (K1 68 at 2^23, once).  Recorded: requests/s, each worker's ready seconds
   from the spawn, done count, chunks, witness_batch, prove and sample
   verify seconds, busy share, idle and peak device memory, the card's
   peak memory.used (sampled each second), the drain's seconds; the
   plane's 503 reasons, the seconds from the second worker ready to its
   first 200, its scrape cycles (and those that failed, and the workers'
   scrapes that failed) and a cycle's median and maximum ms (its /status's
   last_ms at each cycle), its counters' parity, `top`'s seconds and frame.
12. Chaos (the chaos line): `python -m zkp2p_tpu_torch.tools.chaos
   --fleet 2 --requests 12 --batch 2 --prove-s 0.6 --stale-claim-s 3
   --device cuda` on the toy circuit set up on the card, with the
   reference's default fault plan (witness hang, prove raise, emit
   ENOSPC, claim raise) and its plane checks, in a session of its own
   from the end of phase 1's kernel build, beside phase 8's circuit
   build and phase 8 (memory room on the card, no kernel timed); it must
   exit 0 within CHAOS_TIMEOUT_S with no violation: every request
   terminal exactly once and each proof verifying, a SIGKILL landed on a
   worker holding a claim, a claim holder drained with its claims done,
   the supervisor SIGKILLed and its replacement clean, the plane's
   request counters equal to the live workers' sum under the faults, and
   a crash-looping worker parked (exit 4) with restart_storm fired.
   Recorded: requests, states, the workers' restarts under each
   supervisor, the parity, seconds, the card's peak memory.used, each
   worker's logged launches.
13. The adaptive scheduler (the sched line).  (a) Right after phase 9, on
   phase 8's resident key: ProvingService(sched="adaptive", batch 4)
   replays phase 8's four witnesses, its cost curve seeded with this
   run's measurements (amort_points {1: phase 8's warm prove_gpu
   seconds, 4: phase 9's median prove seconds a chunk}), over six
   requests: one interactive, three bulk, one whose deadline has passed
   and one bulk whose deadline is half the seeded model's prediction for
   its place.  The interactive request is proved alone in the first
   batch, the bulk three in one batch after it, the other two end
   error-shed with `sched` in their error before any witness work; the
   done records carry batch_size_target, one sched line says backlog 6,
   shed 2, lanes {interactive 1, bulk 3}, zkp2p_sched_decisions_total
   counts them, every proof verifies under phase 8's vkey, the sweep
   launches exactly two chunks' worth (the batch rule a chunk).
   Recorded: the controller's model_scale after the first observed batch
   (and that batch's seconds over the seed), the wall clock, each
   batch's check_witness and prove seconds.  It runs with flame=True on
   phase 9's seeded ledger: every done request's prove span must overrun
   the seeded budget and count in zkp2p_stage_budget_overruns_total, the
   counters' moves must equal the heartbeat's perf block, one capture
   must land linked to the seeded head with `gpu:` frames, and after the
   run's stamp `perf --gate` against the seeded band must exit 1 naming
   that capture.  (b) `python -m
   zkp2p_tpu_torch.tools.loadgen` with SCHED_FLEET_ARGS: one toy chaos
   worker on the card under `fleet --workers-min 1 --workers-max 2
   --sched adaptive`, a spike trace, in a session of its own from the
   end of phase 1's kernel build beside chaos and phase 8, followed in
   that session by the chaos invariant over its spool; it must exit 0
   within SCHED_FLEET_TIMEOUT_S with every request done exactly once and
   each proof verifying, the fleet grown to 2 on the spike and the same
   worker retired back to 1 after it (the capacity JSON's and
   status.json's scale events), no restart, park or escalation.
   Recorded: served-under-SLO a segment, the scale events' seconds from
   the ramp's start, each worker's logged launches.

The launch counts are reset just before the first timed proof of each
path and read just after it (phase 8: just before and after its setup,
its first proof and its batch, checked as the setup, Jacobian and batch
paths); every kernel of a path must have launched in
its run (on the Jacobian path K1, K2, K6-K14 and K18; on the affine path
K1, K2, K6, K8, K10-K14, K18, K15's jac_to_affine, K16's G1 add and both
accumulates; in the setup of phase 6, counted from just before it to just
after it, K1, K13 (once a matrix, twice for one with a long row), K15's
batch_inverse and jac_to_affine and K17), the launchers of OFF_PATH (K3, K4, K5, K16's G2 add) on no path and
K15's batch_inverse and K17 on no proof's path; K12 launches once a pass of the
iNTT and of the NTT on each path, K13 and K14 twice a proof on each path,
and K1 at most 5 times a proof on each path (printed); a Jacobian proof
(phase 4's and the flagship's) launches K18 once a tree, 7 G1 and 2 G2,
and K2 only for its 3 G1 and 1 G2 joins of the classes; on the batch path,
besides the per-chunk counts above, nothing of OFF_PATH or the affine
path; in phase 7 the CLI's in-process prove as the Jacobian path and
prove_gpu_batch on the key it imported as the batch path; in phase 10
each ceremony op (contribute, contribute_2, beacon, verify) as a path.

Before the last line it prints the card's name and power limit, a
profile each of one more Jacobian and one more affine proof, run after
every timed proof (the device's busy share and the ops with the most
device time, from torch.profiler), one JSON line with the
twenty-eight kernels (checks, launches on each path, times and bounds),
one each with the two paths' per-stage times, launches and peak device
memory, and one each with the same-run comparisons of the witness side
(witness_same_run), the H ladder (ntt_same_run), the h MSM, the b2 MSM,
the proof, the affine MSMs at 2^16 (affine_msm_same_run) and the affine
proof at each plane group beside the Jacobian one (affine_same_run), and the batch phase's lines: real_size_batch (proofs/s,
per-chunk stage seconds, peak memory a chunk size) and batch_same_run
(the batch against prove_gpu in a loop), the test vector's setup
(setup_vector) and the real-size key (real_size_setup: stage seconds,
launches, selections, the proof's and the verifier's seconds, the
cache's), and the command line at full size (cli_real_size: the card's
free memory before the subprocesses, the files' sizes and write seconds,
the prove and verify subprocesses' wall-clock seconds, each step's
seconds, the gpu/prove span, the classes, the launches of the CLI's
prove and batch, the batch's seconds and proofs/s beside
prove_gpu_batch's), and the flagship circuit's (phase 8: counts, build,
witness, qap_coo, setup, proof and batch seconds, the CLI's wall clock,
steps, classes and peak RSS, the 256/192 setup), the service's
(phase 9), the fleet's (phase 11), chaos (phase 12), the scheduler's (phase 13), the flame sampler's and the
perf sentry's commands (the flame line) and the ceremony's (phase 10: the
counted run's stage
seconds, wall clock and launches an op; each command's).  The last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import gc
import json
import random
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
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
H_CHECK_LOG_M = 14
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
INT_MULS_PER_SM_CLK = 64  # 32-bit integer multiply-adds per SM per clock (Hopper: 64 INT32 lanes per SM)
# 32-bit multiplies of one 8x32-bit CIOS Montgomery product: 64 + 64
# wide products (lo and hi halves) and 8 low products
MULS_PER_MONT = 2 * 64 + 2 * 64 + 8
# of a Montgomery square (mont_cc.cuh's fe_sqr_cc): 28 cross products and
# 8 squares (lo and hi halves each), then the same reduction
MULS_PER_SQR = 2 * 36 + 2 * 64 + 8
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
    "g1_lane_tree": "zkp2p_tpu/ops/pallas_curve.py:351 (g1_add, a launch a level of zkp2p_tpu/ops/msm.py:56 "
                    "tree_reduce)",
    "g2_lane_tree": "zkp2p_tpu/ops/pallas_curve.py:369 (g2_add, a launch a level of zkp2p_tpu/ops/msm.py:56 "
                    "tree_reduce)",
    "g1_scale": "csrc/zkp2p_native.cpp:6448 (native C++ g1_scale_batch, no Pallas row)",
}
WINDOW_KERNELS = ("g1_window_table", "g1_window_accumulate", "g2_window_table", "g2_window_accumulate")
FOLD_KERNELS = ("g1_horner_fold", "g2_horner_fold")
LANE_TREE_KERNELS = ("g1_lane_tree", "g2_lane_tree")
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
          "g1_fixed_base": "fixed_base.cu", "g2_fixed_base": "fixed_base.cu",
          **dict.fromkeys(LANE_TREE_KERNELS, "lane_tree.cu"), "g1_scale": "scale.cu"}  # the rest: point_ops.cu
# the launchers each real-size path must have launched, and must not have
_POINT_KERNELS = ("g1_add", "g2_add") + FOLD_KERNELS + LANE_TREE_KERNELS
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
# phase 7: the CLI's prove runs the Jacobian path's kernels, its batch the
# batch path's, but for K2's G2 launch: b has no narrow class on the CLI's
# imported key, so b2 has no join
PATH_KERNELS["cli_prove"] = tuple(k for k in PATH_KERNELS["jacobian"] if k != "g2_add")
PATH_KERNELS["cli_batch"] = tuple(k for k in PATH_KERNELS["batch"] if k != "g2_add")
# phase 8: the flagship circuit's setup, proof and batch
PATH_KERNELS["flagship_setup"] = SETUP_KERNELS
PATH_KERNELS["flagship_prove"] = PATH_KERNELS["jacobian"]
PATH_KERNELS["flagship_batch"] = PATH_KERNELS["batch"]
# phase 9: the service's sweep on the default prover, two batch chunks
PATH_KERNELS["service"] = PATH_KERNELS["batch"]
# phase 10, the ceremony: each op's launchers, exactly (the first
# contribution's K1 is its circuit hash; the verify's K1 its two circuit
# hashes and the on-curve tests, K14/K6/K7/K10/K18 its four combinations)
CEREMONY_KERNELS = {
    "ceremony_contribute": ("mont_mul", "g1_scale", "jac_to_affine"),
    "ceremony_contribute_2": ("g1_scale", "jac_to_affine"),
    "ceremony_beacon": ("g1_scale", "jac_to_affine"),
    "ceremony_verify": ("mont_mul", "signed_recode", "g1_window_table", "g1_window_accumulate", "g1_horner_fold",
                        "g1_lane_tree"),
}
PATH_KERNELS.update(CEREMONY_KERNELS)
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
# at the path's chunk shapes the plain table and accumulate run over the
# chunk's first WINDOW_PLAIN_STEPS steps (a step's table depends on that
# step's bases alone; the kernel runs the same prefix for the comparison,
# and the whole chunk timed)
WINDOW_PLAIN_STEPS = 8
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
AFFINE_PLAIN_STEPS = 2
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
# the plain fold (and the kernel for the comparison) runs over the first
# FOLD_PLAIN_PLANES planes of a case with more: Horner's rule over a
# prefix of the planes is the same fold of fewer planes
FOLD_PLAIN_PLANES = 8
# K18: (batch, lanes) held bitwise against the K2 loop and the plain
# version before the paths' trees: one lane, two, odd counts, one stage
# and two (above lane_tree.CAP lanes)
LANE_TREE_CASES = ((1, 1), (1, 2), (1, 3), (1, 17), (4, 17), (3, 257), (2, 600))
# K12: log2 of the domains held bitwise against plain at every pass of
# their plans (11: one pass of 64 KB of shared memory a block), before the
# 2^23 plan's passes at the H ladder's shape (three rows)
NTT_CHECK_LOGS = (1, 2, 11, 12, 16)
LADDER_ROWS = 3
# at 2^23 the plain pass runs over the first NTT_PLAIN_ROWS of the
# ladder's rows (a pass transforms each row alone)
NTT_PLAIN_ROWS = 1
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
# phase 7: the CLI's files, and the seeded witnesses beside the satisfying
# one in its batch
CLI_DIR = ".chip_scratch/cli"
CLI_SEEDED = 3
PEAK_CHUNKS = (1, 2, 4)
# phase 8: the synthetic signed emails (raw_id, amount, order_id) of the
# flagship's witnesses, the first the CLI's --demo email; the setup's seed;
# the small shape whose CLI setup (audit on) is held against this process's
FLAGSHIP_EMAILS = (("1234567891234567891", "30", 1), ("2345678912345678912", "45", 2),
                   ("3456789123456789123", "7", 3), ("4567891234567891234", "1250", 4))
FLAGSHIP_SEED = "chip-smoke-flagship"
FLAGSHIP_DIR = ".chip_scratch/flagship"
SMALL_VENMO = (256, 192)
SETUP_FILES = ("circuit_final.zkey", "verification_key.json", "verifier.sol")
# phase 9: the service's scratch, its batch and prefetch on the default
# path, that path's eight new demo emails (two batches; phase 11's too),
# and how long a service may take to drain after SIGTERM
SERVICE_DIR = ".chip_scratch/service"
SERVICE_BATCH = 4
SERVICE_PREFETCH = 1
SERVICE_EMAILS = (("5678912345678912345", "12", 11), ("6789123456789123456", "99", 12),
                  ("7891234567891234567", "250", 13), ("8912345678912345678", "3", 14),
                  ("9123456789123456789", "40", 15), ("1357913579135791357", "75", 16),
                  ("2468024680246802468", "1000", 17), ("9876543219876543210", "60", 18))
SERVICE_DRAIN_S = 60
# phase 11, the fleet: its scratch, FLEET_WORKERS flagship workers at batch
# FLEET_BATCH, how long they may take to be ready (each builds the circuit,
# reads the zkey and imports the key) and to prove SERVICE_EMAILS, and the
# supervisor's drain timeout (its default)
FLEET_DIR = ".chip_scratch/fleet"
FLEET_WORKERS = 2
FLEET_BATCH = 2
FLEET_READY_S = 600
FLEET_PROVE_S = 600
FLEET_DRAIN_TIMEOUT_S = 30
# the fleet plane: how many of its scrape cycles phase 11 waits for once the
# requests have ended, before it holds the plane's counters to the workers'
FLEET_QUIET_CYCLES = 2
# phase 12, chaos: the harness's run on the toy world (the reference's
# fleet acceptance shape with two workers: a kill window of 0.6 s a
# request), its scratch and its time limit
CHAOS_DIR = ".chip_scratch/chaos"
CHAOS_ARGS = ("--fleet", "2", "--requests", "12", "--batch", "2", "--prove-s", "0.6", "--stale-claim-s", "3",
              "--device", "cuda")
CHAOS_TIMEOUT_S = 420
# phase 13, the scheduler: (a) in this process on phase 8's key, its batch
# cap; (b) the load generator's toy fleet autoscaling 1 -> 2 -> 1 on a spike
# (one chaos worker on the card at the start, 0.3 s a request and 0.6 s a
# batch of service time, an 8 s objective), then the chaos invariant over
# its spool in the same session; its scratch and time limit.  The windows
# and the trace go together: a request alone holds the backlog above zero
# (and so "growing", against the plane's 5 s trend window) for ~2.3 s, two
# of the first segment's together for ~5 s, the spike for ~10 s: a 6 s
# scale-up window grows the fleet on the spike alone (with 1 s windows it
# grew on the first pair and flapped on a 0.3 QPS tail, on one H100).
# The 0.1 QPS tail leaves idle gaps of 3 s and more once the spike's
# backlog is gone, in which the 3 s scale-down window retires the worker
# before the ramp ends.
SCHED_DIR = ".chip_scratch/sched"
SCHED_BATCH = 4
SCHED_FLEET_ARGS = ("--circuit", "toy", "--device", "cuda", "--fleet", "1", "--fleet-min", "1", "--fleet-max", "2",
                    "--sched", "adaptive", "--trace", "0.3x10,4x6,0.1x40", "--prove-s", "0.3", "--batch-overhead-s",
                    "0.6", "--objective-s", "8", "--seed", "7", "--scale-up-s", "6", "--scale-down-s", "3",
                    "--fleet-scrape-s", "0.5")
SCHED_FLEET_CHECK = (
    "import json, subprocess, sys\n"
    "from zkp2p_tpu_torch.tools.chaos import check_invariants\n"
    "rc = subprocess.call([sys.executable, '-m', 'zkp2p_tpu_torch.tools.loadgen', *sys.argv[3:]])\n"
    "rep = check_invariants(sys.argv[1], device='cuda') if rc == 0 else {}\n"
    "with open(sys.argv[2], 'w') as f:\n"
    "    json.dump({'rc': rc, **rep}, f)\n"
    "sys.exit(rc)\n")
SCHED_FLEET_TIMEOUT_S = 300
# the perf sentry and the flame sampler (phases 8, 9 and 13 (a)): their
# scratch (the ledger's cache dir, the baselines, the flame command's build
# dir), the flame loop's seconds at full width after FLAME_PLAIN_PROOFS
# proofs without the sampler, the top stacks printed, the history seeded
# before phase 13 (a) (PERF_SEEDED entries at a tenth of phase 9's prove
# p50), the flame command's duration on the toy circuit and time limit
PERF_DIR = ".chip_scratch/perf"
FLAME_S = 5.0
FLAME_PLAIN_PROOFS = 3
FLAME_TOP = 8
PERF_SEEDED = 3
FLAME_CLI_S = 3.0
FLAME_CLI_TIMEOUT_S = 300
# phase 10, the ceremony: K19 at the ceremony's shape, where SCALE_HOLES
# (0, 0) holes and SCALE_OFF_CURVE points off the curve sit among the
# points and SCALE_SAMPLES are checked against the host, as are the first
# SCALE_SPECIAL_POINTS with k = 0, 1, 2, 2^127, r - 1, r, 2^256 - 1; the
# scratch of its command line, the beacon's value and
# iteration exponent
SCALE_SPECIAL_POINTS = 257
SCALE_HOLES = 16
SCALE_SAMPLES = 10
SCALE_OFF_CURVE = 2  # points off the curve: one among the special points, one in the big launch alone
CEREMONY_DIR = ".chip_scratch/ceremony"
CEREMONY_BEACON = bytes.fromhex("5f1e2a6c" * 8)
CEREMONY_ITER_EXP = 10
# the launchers whose launches a batch chunk makes as often as one proof:
# the tables once a chunk of steps, the accumulates once for the chunk's
# witnesses, the folds and the lane trees once over the chunk's lanes
PER_CHUNK_AS_ONE_PROOF = WINDOW_KERNELS + FOLD_KERNELS + LANE_TREE_KERNELS + ("g1_add", "g2_add")
# a proof's K2 and K18 launches on a key with narrow and wide classes in
# every query (the synthetic key's and the flagship's): K18 once a tree,
# K2 for the joins of the classes (tree_and_join_launches)
CLASSED_PROOF_LAUNCHES = {"g1_lane_tree": 7, "g2_lane_tree": 2, "g1_add": 3, "g2_add": 1}


def tree_and_join_launches(key) -> dict:
    """K18's and K2's launches in one proof on `key` with the default arms
    (prover/groth16_gpu.py: the queries): a lane tree a windowed MSM (h's,
    and each class of a, b1, c and b2 that holds a lane; one MSM a query
    on an unclassed key) and a K2 join for each query with both classes."""
    if not key.a_nsel.numel():
        return {"g1_lane_tree": 4, "g2_lane_tree": 1, "g1_add": 0, "g2_add": 0}
    held = {q: (getattr(key, f"{q}_nsel").numel() > 0, getattr(key, f"{q}_wsel").numel() > 0) for q in "abc"}
    # b's classes serve b1 (G1) and b2 (G2)
    return {"g1_lane_tree": 1 + sum(sum(held[q]) for q in "abc"), "g2_lane_tree": sum(held["b"]),
            "g1_add": sum(all(held[q]) for q in "abc"), "g2_add": int(all(held["b"]))}


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
    with runs of zero windows, and the signed digits' boundaries (windows
    0x7F, 0x80, 0x81, 0xFF alone and in runs, a run of 0xFF carrying into
    the top window)."""
    from zkp2p_tpu_torch.field.bn254 import R
    from zkp2p_tpu_torch.ops import cuda_mont

    k = rand_canon(torch, gen, (n,), device)
    rng = random.Random(SEED + 60)
    zero_runs = [int.from_bytes(bytes(b if (j // 4) % 2 else 0 for j, b in enumerate(rng.randbytes(32))), "little")
                 % R for _ in range(3)]
    run_ff = (1 << 248) - 1  # its carry runs into the top window
    signed = ([v << (8 * j) for v in (0x7F, 0x80, 0x81, 0xFF) for j in (0, 9)]
              + [int.from_bytes(bytes([v]) * 31, "little") for v in (0x7F, 0x80, 0x81)]
              + [int.from_bytes(bytes([0x7F, 0x80, 0x81, 0xFF] * 7 + [0x7F, 0x80, 0x81]), "little"),
                 run_ff, (0x2F << 248) | run_ff])
    specials = [0, 1, 2, R - 1, R - 2, 1 << 8, 1 << 128, 1 << 248, 0x30 << 248, 0xFF << 240] + zero_runs + signed
    if n >= len(specials):
        for i, v in enumerate(specials):
            k[i] = torch.tensor(cuda_mont.limbs_of(v), device=device)
    return k


def fixed_base_bound(torch, g2, k, peak_muls_per_s):
    """K17's bound on these scalars: one mixed add (11 products, 3x in
    Fq2) for each nonzero signed 8-bit digit, against the scalars read
    once, the Jacobian points written once and the 32 x 128-row table read
    once."""
    from zkp2p_tpu_torch.ops.cuda_fixed_base import ROWS, WINDOWS, signed_windows

    n = k.shape[0]
    adds = sum(int((signed_windows(k[i:i + (1 << 22)])[0] != 0).sum()) for i in range(0, n, 1 << 22))
    muls = adds * MONTS["add_mixed"] * (3 if g2 else 1) * MULS_PER_MONT
    coord = 128 if g2 else 64
    nbytes = n * (64 + 3 * coord) + WINDOWS * ROWS * 2 * coord
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
            f"bitwise equal to plain at {list(FIXED_BASE_BATCHES)} scalars (0, 1, 2, r-1, r-2, 2^8k, zero windows, "
            f"windows 0x7F/0x80/0x81/0xFF alone and in runs, a run of 0xFF carrying into the top window; plain "
            f"over the first {PLAIN_SLICE}) and at every query size of the setup; sample equal to the host "
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


def check_affine_bitwise(torch, device):
    """K15 (batch inversion, Jacobian -> affine) and K16 (the affine add
    and accumulate, G1 and G2) against their plain versions, bitwise:
    K15 against the grid-wide plain route (nonzero lanes; zero gives 0)
    and the kernels' grouping (every lane), at AFFINE_BATCHES over Fq, Fr
    and Fq2 with the special values, its nonzero lanes against K5 and a
    sample against Python pow; K16 at AFFINE_BATCHES with the special
    lanes, also on strided and broadcast operands.  Nothing is timed: the
    script runs these beside phase 11's proofs."""
    from zkp2p_tpu_torch.curve.tcurve import G1C, G2C
    from zkp2p_tpu_torch.field.bn254 import MONT_R, P, R
    from zkp2p_tpu_torch.field.tfield import FQ, FQ2, FR, limbs_to_int
    from zkp2p_tpu_torch.ops import cuda_mont
    from zkp2p_tpu_torch.ops import msm_affine as MA

    gen = torch.Generator(device=device).manual_seed(SEED + 30)
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


def check_affine_kernels(torch, shapes, peak_muls_per_s, sm_clock_hz, device):
    """K15 (batch inversion, Jacobian -> affine) and K16 (the affine add
    and accumulate, G1 and G2) at the shapes the path gives them
    (`shapes`), timed with their bounds and plain versions (on the first
    PLAIN_SLICE elements, or the accumulate's first AFFINE_PLAIN_STEPS
    steps, above them) and held bitwise against them there, and K15 at
    batch 1 against K5 in turns (check_affine_bitwise holds them at
    AFFINE_BATCHES)."""
    from zkp2p_tpu_torch.curve.tcurve import G1C, G2C
    from zkp2p_tpu_torch.field.bn254 import P
    from zkp2p_tpu_torch.field.tfield import FQ, FQ2, limbs_to_int
    from zkp2p_tpu_torch.ops import cuda_affine, cuda_mont
    from zkp2p_tpu_torch.ops import msm_affine as MA

    gen = torch.Generator(device=device).manual_seed(SEED + 33)
    pyr = random.Random(SEED + 31)
    curves = {False: G1C, True: G2C}

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
        # timed: the plain versions over the first WINDOW_PLAIN_STEPS steps
        S = min(steps, WINDOW_PLAIN_STEPS) if timed else steps
        if timed:
            times["table"], table = cuda_ms(torch, lambda: table_of(bases, N_TABLE), 5)
            times["table_plain"], want = cuda_ms(torch, lambda: table_plain(tuple(b[:S] for b in bases)), 1,
                                                 warmup=False)
        else:
            table, want = table_of(bases, N_TABLE), table_plain(bases)
        err_t = max_abs_err(torch, tuple(c[:S] for c in table), want)
        if err_t:
            raise AssertionError(f"{name_t} ({steps} x {lanes}) differs from its plain version")
        cut = tuple(c[:S] for c in table)
        if timed:
            times["acc"], whole = cuda_ms(torch, lambda: accumulate(acc, table, mags, negs, s0), 3)
            # the whole chunk over the same digits laid out contiguously
            if max_abs_err(torch, whole, accumulate(acc, table, mags.contiguous(), negs.contiguous(), s0)):
                raise AssertionError(f"{name_a} ({n_digits} x {lanes}, {steps} steps) differs between the digits' "
                                     "layouts")
            del whole
            times["acc_plain"], want = cuda_ms(
                torch, lambda: accumulate_plain(acc, cut, mags, negs, s0), 1, warmup=False)
        else:
            want = accumulate_plain(acc, cut, mags, negs, s0)
        got = accumulate(acc, cut, mags, negs, s0)
        # the same digits laid out contiguously
        got_c = accumulate(acc, cut, mags.contiguous(), negs.contiguous(), s0)
        err_a = max(max_abs_err(torch, got, want), max_abs_err(torch, got_c, want))
        if err_a:
            raise AssertionError(f"{name_a} ({n_digits} x {lanes}, {S} steps) differs from its plain version")
        times["plain_steps"] = S
        return times, (err_t, err_a), mags[:, s0:s0 + steps]

    for lanes, n_digits, steps in WINDOW_BATCHES:
        check(steps, lanes, n_digits)
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
        S = times["plain_steps"]
        at = {
            name_t: dict(shape=[steps, N_TABLE, lanes], max_abs_err=err_t, ms=times["table"],
                         plain_ms=times["table_plain"], plain_steps=S, **b_t),
            name_a: dict(shape=[n_digits, steps, N_TABLE, lanes], max_abs_err=err_a, ms=times["acc"],
                         plain_ms=times["acc_plain"], plain_steps=S, adds=adds,
                         ns_per_add=times["acc"] * 1e6 / max(adds, 1), **b_a),
        }
        for kernel, row in at.items():
            if k == 0:
                rows[kernel].update(row, chunk=name)
            else:
                rows[kernel].setdefault("at_shapes", {})[name] = row
        log(f"{ks} at the {name} chunk ({n_digits} planes x {lanes} lanes x {steps} steps): bitwise equal to plain "
            f"over its first {S} steps; table {times['table']:.4f} ms (plain {times['table_plain']:.1f} over {S} "
            f"steps, bound {b_t['bound_ms']:.4f}), accumulate {times['acc']:.4f} ms (plain "
            f"{times['acc_plain']:.1f} over {S} steps, bound {b_a['bound_ms']:.4f}, "
            f"{at[name_a]['ns_per_add']:.3f} ns an add)")
    for row in rows.values():
        row["check"] = (f"bitwise equal to plain at (lanes, planes, steps) {list(WINDOW_BATCHES)} and at the "
                        f"path's chunk shapes (shape, at_shapes) over their first {WINDOW_PLAIN_STEPS} steps "
                        f"(plain_steps; the whole chunk timed, the accumulate's equal under both digit layouts), "
                        f"special lanes included; the {g.upper()} MSM through it equal to the step loop")
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

    def cut(shape):  # the (planes, window) the plain version runs
        return min(shape[1], FOLD_PLAIN_PLANES), shape[2]

    want, plain_of = {}, {}
    for key in dict.fromkeys(cut(shape) for _, shape, _ in cases):
        labels = [label for label, shape, _ in cases if cut(shape) == key]
        init = tuple(torch.cat([inputs[label][0][c] for label in labels]) for c in range(3))
        planes = tuple(torch.cat([inputs[label][1][c][:key[0]] for label in labels], dim=1) for c in range(3))
        ms, out = cuda_ms(torch, lambda: plain(init, planes, key[1]), 1, warmup=False)
        at = 0
        for label in labels:
            n = inputs[label][0][0].shape[0]
            want[label] = tuple(c[at:at + n] for c in out)
            plain_of[label] = dict(plain_ms=ms, plain_lanes=init[0].shape[0], plain_planes=key[0])
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
            ms, _ = cuda_ms(torch, lambda: call(init, planes, window), 10)
        got = call(init, tuple(c[:FOLD_PLAIN_PLANES] for c in planes), window)
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
            f"plain over its first {at['plain_planes']} planes; {ms:.4f} ms (plain {at['plain_ms']:.1f} over "
            f"{at['plain_lanes']} lanes x {at['plain_planes']} planes, bound {at['bound_ms']:.4f}, chain floor "
            f"{at['chain_floor_ms']:.4f})")
    row["check"] = (f"bitwise equal to plain at (lanes, planes, window) {list(FOLD_CASES)} and at the paths' "
                    f"fold shapes (shape, at_shapes), special lanes included, over the first {FOLD_PLAIN_PLANES} "
                    f"planes (plain_planes; all of them timed); the plain version run once over all the lanes of "
                    f"a (planes, window)")
    log(f"{ks}: bitwise equal to plain at {FOLD_CASES} (lanes, planes, window) over the first {FOLD_PLAIN_PLANES} "
        "planes, special lanes included")
    return {name: row}


def lane_tree_case(torch, gen, g2, batch, lanes, device):
    """Random Jacobian coordinates (batch, lanes, *elem): a lane at
    infinity, and on the first level (pairs i, i + ceil(lanes/2)) a pair
    P, P (the add's doubling) and a pair P, -P (infinity)."""
    from zkp2p_tpu_torch.field.tfield import FQ

    pts = [rand_canon(torch, gen, (batch, lanes, 2) if g2 else (batch, lanes), device) for _ in range(3)]
    h = (lanes + 1) // 2
    if lanes >= 2:
        pts[2][:, 0] = 0
    if lanes >= 4:
        for c in pts:
            c[:, 1 + h] = c[:, 1]
    if lanes >= 6:
        pts[0][:, 2 + h], pts[2][:, 2 + h] = pts[0][:, 2], pts[2][:, 2]
        pts[1][:, 2 + h] = FQ.neg(pts[1][:, 2])
    return tuple(pts)


def check_lane_tree_kernels(torch, shapes, peak_muls_per_s, sm_clock_hz, device):
    """K18 (G1 and G2) at LANE_TREE_CASES and at each tree the paths give
    it (`shapes`: (G2?) -> name -> lanes; each at a batch of 1, a proof's,
    and of BATCH_CHUNK, a batch chunk's; the first name's batch of 1 is the
    row's own), held bitwise against the K2 loop (msm.tree_reduce_steps,
    the route K18 replaced) and the plain version.  At the paths' trees
    K18 and the K2 loop are timed in turns (K2 loop, K18, K18, K2 loop),
    beside K18's operation bound ((lanes - 1) adds a witness, 16 products,
    3x in Fq2) and its chain floor (5 dependent products a level)."""
    from zkp2p_tpu_torch.curve.tcurve import G1C, G2C
    from zkp2p_tpu_torch.ops import cuda_lane_tree, msm

    rows = {}
    for g2, C in ((False, G1C), (True, G2C)):
        name = f"{'g2' if g2 else 'g1'}_lane_tree"
        gen = torch.Generator(device=device).manual_seed(SEED + (71 if g2 else 70))
        cases = [(f"{b} x {n}", b, n, False) for b, n in LANE_TREE_CASES]
        cases += [(f"{label} x {b}", b, n, True) for label, n in shapes[g2].items() for b in (1, BATCH_CHUNK)]
        fq = 3 if g2 else 1
        elem_bytes = 64 * (2 if g2 else 1)
        row = {}
        for label, b, n, timed in cases:
            pts = lane_tree_case(torch, gen, g2, b, n, device)
            got = cuda_lane_tree.lane_tree(g2, pts)
            loop = msm.tree_reduce_steps(C, pts, n)
            plain_ms, plain = cuda_ms(torch, lambda: cuda_lane_tree.lane_tree_plain(g2, pts), 1, warmup=False)
            if max_abs_err(torch, got, loop) or max_abs_err(torch, got, plain):
                raise AssertionError(f"{name} ({b} x {n} lanes) differs from the K2 loop or its plain version")
            if not timed:
                continue
            turns = []
            for way in ("loop", "kernel", "kernel", "loop"):
                fn = ((lambda: cuda_lane_tree.lane_tree(g2, pts)) if way == "kernel"
                      else (lambda: msm.tree_reduce_steps(C, pts, n)))
                turns.append(cuda_ms(torch, fn, 10)[0])
            adds = b * (n - 1)
            t_ops = adds * MONTS["add"] * fq * MULS_PER_MONT / peak_muls_per_s
            t_bytes = b * (n + 1) * 3 * elem_bytes / HBM_BYTES_PER_S
            levels = cuda_lane_tree.levels_of(n)
            at = dict(shape=[b, n], max_abs_err=0, ms=min(turns[1:3]), ms_turns=turns,
                      k2_loop_ms=min(turns[0], turns[3]), k2_launches=levels, plain_ms=plain_ms,
                      bound_ms=max(t_ops, t_bytes) * 1e3, bound_by="bytes" if t_bytes > t_ops else "operations",
                      chain_floor_ms=levels * CHAIN_MONTS["add"] * CHAIN_MADS_PER_MONT * MAD_LATENCY_CLK
                      / sm_clock_hz * 1e3, plan=list(cuda_lane_tree.tree_plan(n)))
            if row:
                row.setdefault("at_shapes", {})[label] = at
            else:
                row.update(at, tree=label)
            log(f"K18 {name} at the {label} tree ({b} x {n} lanes, {levels} levels): bitwise equal to the K2 loop "
                f"and plain; turns (K2 loop, K18, K18, K2 loop) {[round(t, 4) for t in turns]} ms; bound "
                f"{at['bound_ms']:.5f}, chain floor {at['chain_floor_ms']:.4f}, plain {plain_ms:.1f} ms")
        row["check"] = (f"bitwise equal to the K2 loop (msm.tree_reduce_steps) and to plain at (batch, lanes) "
                        f"{list(LANE_TREE_CASES)} and at the paths' trees (shape, at_shapes) at batches 1 and "
                        f"{BATCH_CHUNK}; a lane at infinity, P + P and P + (-P) on the first level")
        row["library_ms_reason"] = "no PyTorch call adds curve points"
        rows[name] = row
        log(f"K18 {name}: bitwise equal to the K2 loop and plain at {LANE_TREE_CASES} (batch, lanes) and at the "
            f"paths' trees")
    return rows


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
        plain_ms, want = cuda_ms(torch, lambda: cuda_ntt.ntt_pass_plain(x[:NTT_PLAIN_ROWS], tw, s0, k, bitrev, f),
                                 1, warmup=False)
        err = max_abs_err(torch, got[:NTT_PLAIN_ROWS], want)
        if not bitrev:
            y = x.clone()
            cuda_ntt.ntt_pass(y, tw, s0, k, out=y)
            err = max(err, max_abs_err(torch, y, got))
        if err:
            raise AssertionError(f"fr_ntt_pass at 2^{log_full} x {LADDER_ROWS} ({label}) differs from plain")
        products = LADDER_ROWS * (k * m // 2 + (m if f is not None else 0))
        nbytes = (2 * LADDER_ROWS * m + (m if f is not None else 0) + (1 << (s0 + k - 1))) * 64
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, products * MULS_PER_MONT / peak_muls_per_s
        at = dict(shape=[LADDER_ROWS, m], stages=[s0, k], max_abs_err=0, ms=ms, plain_ms=plain_ms,
                  plain_rows=NTT_PLAIN_ROWS, bound_ms=max(t_bytes, t_ops) * 1e3,
                  bound_by="bytes" if t_bytes > t_ops else "operations",
                  products=products, shared_bytes_per_block=32 << k)
        if row:
            row.setdefault("at_shapes", {})[label] = at
        else:
            row.update(at, **{"pass": label})
        log(f"K12 at 2^{log_full} x {LADDER_ROWS}, {label}, stages {s0}..{s0 + k - 1}: bitwise equal to plain on "
            f"its first {NTT_PLAIN_ROWS} row(s), in place equal to out of place; {ms:.4f} ms (plain {plain_ms:.1f} "
            f"over {NTT_PLAIN_ROWS} row(s), bound {at['bound_ms']:.4f} by {at['bound_by']}; "
            f"{32 << k} B of shared memory a block)")
    # whole transforms of one 2^23 row against the stage-at-a-time ladder
    x = ntt_rows(torch, gen, 1, m, device)[0]
    if (max_abs_err(torch, ntt.ntt(x, log_full), steps_ntt(x, log_full))
            or max_abs_err(torch, ntt.intt(x, log_full), steps_intt(x, log_full))):
        raise AssertionError(f"ntt / intt at 2^{log_full} differ from _ntt_core")
    log(f"ntt and intt at 2^{log_full}: bitwise equal to _ntt_core (plan {plan})")
    row["check"] = (f"bitwise equal to plain at every pass of the plans of 2^{list(NTT_CHECK_LOGS)} (3 rows; no "
                    f"factor, 1/m, g^i/m; in place) and of 2^{log_full} at the ladder's 3 rows (shape, at_shapes; "
                    f"the plain version over the first {NTT_PLAIN_ROWS}, plain_rows); ntt, intt and coset_ladder "
                    f"equal to _ntt_core there, ntt and intt at 2^{log_full}")
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
    _fold_steps), the lane tree by K18 and then by the K2 loop it
    replaced.  Seconds of each, host clock around work that ends in a
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
    # the tree as it ran before K18, one K2 launch a level
    split["lane_tree_k2_loop"], out_loop = wall_s(torch, lambda: msm.tree_reduce_steps(G1C, per_lane, lanes))
    if any(max_abs_err(torch, o, outs[0]) for o in outs[1:] + [out, out_loop]):
        raise AssertionError("the real-size h MSM through K6/K7, K10 and K18 differs from the step loops")
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


def profile_proof(torch, prove, name, top: int = 15):
    """One more proof under the port's torch.profiler capture
    (trace.profile, its Chrome trace written under .chip_scratch/ and
    deleted): the device's busy share (the device activities' time over
    the wall clock) and where the device time goes, by kernel and by
    torch op."""
    import os
    import shutil

    from torch.autograd import DeviceType

    from zkp2p_tpu_torch.utils import trace

    trace_dir = os.path.join(".chip_scratch", "profiles")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with trace.profile(name, trace_dir) as prof:
        prove()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    shutil.rmtree(trace_dir, ignore_errors=True)
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
    """h_evals on the card against the plain path (the CPU) at
    2^H_CHECK_LOG_M."""
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
        raise AssertionError(f"h_evals on the card differs from the plain path at 2^{log_m}")


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
    K15's setup shapes to their rows.  Writes phase 7's files from the
    loaded key (write_cli_files); returns them, the real_size_setup line
    and the setup's launches."""
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
    files = write_cli_files(torch, key2, vk, witness, pub)
    return files, {"shape": "venmo 1024/6400 counts, satisfying synthetic R1CS", "log_m": V["log_m"],
            "n_wires": V["n_wires"], "seed": SETUP_SEED, "r1cs_s": r1cs_s, "setup_s": setup_s,
            "stage_s": {k[2:]: v for k, v in stages.items()}, "peak_device_gib": peak,
            "launches": {k[len("zk_"):]: v for k, v in launches.items() if v}, "selections": got,
            "sampled_bases_checked": checked, "prove_s": prove_s, "verify_s": verify_s, "verify": True,
            "cache": {"save_s": save_s, "load_s": load_s, "file_gib": size / 2**30, "proof_bytes_equal": True}}, \
        launches


# --------------------------------------------------------------- phase 7


def write_cli_files(torch, key, vk, witness, pub):
    """Phase 6's key, VK and satisfying witness as the files a user of the
    drop-in path hands the CLI, under CLI_DIR: circuit_final.zkey (the
    port's write_zkey_data), verification_key.json (vkey_to_json), the
    witness as witness.wtns, and in wtns/ the witness and CLI_SEEDED more
    made as batch_witness makes them (which do not satisfy the R1CS); the
    zkey's parsed form is kept for phase 10."""
    import os

    from zkp2p_tpu_torch.formats.circom_bin import write_wtns
    from zkp2p_tpu_torch.formats.proof_json import dump, vkey_to_json
    from zkp2p_tpu_torch.formats.zkey import write_zkey_data, zkey_from_key

    d = os.path.abspath(CLI_DIR)
    os.makedirs(os.path.join(d, "wtns"), exist_ok=True)
    paths = {"zkey": os.path.join(d, "circuit_final.zkey"), "wtns": os.path.join(d, "witness.wtns"),
             "indir": os.path.join(d, "wtns")}
    zk = zkey_from_key(key, vk)
    t0 = time.perf_counter()
    write_zkey_data(paths["zkey"], zk)
    zkey_s = time.perf_counter() - t0
    dump(vkey_to_json(vk), os.path.join(d, "verification_key.json"))
    t0 = time.perf_counter()
    write_wtns(witness, paths["wtns"])
    wtns_s = time.perf_counter() - t0
    batch = [witness] + [batch_witness(key, SEED + 200 + i) for i in range(CLI_SEEDED)]
    for i, w in enumerate(batch):
        write_wtns(w, os.path.join(paths["indir"], f"w{i}.wtns"))
    sizes = {k: os.path.getsize(paths[k]) for k in ("zkey", "wtns")}
    log(f"CLI files: zkey {sizes['zkey'] / 2**30:.3f} GiB written in {zkey_s:.1f} s, wtns "
        f"{sizes['wtns'] / 2**20:.1f} MiB in {wtns_s:.2f} s, {len(batch)} batch wtns")
    return dict(paths=paths, witness=witness, batch=batch, pub=pub, vk=vk, zk=zk,
                files={"zkey_bytes": sizes["zkey"], "wtns_bytes": sizes["wtns"], "zkey_write_s": zkey_s,
                       "wtns_write_s": wtns_s})


# the package's __main__ run as -m runs it, secrets.randbelow returning
# the draws of its first argument in turn
PINNED_MAIN = ("import json, runpy, secrets, sys\n"
               "draws = iter(json.loads(sys.argv.pop(1)))\n"
               "secrets.randbelow = lambda n: next(draws)\n"
               "runpy.run_module('zkp2p_tpu_torch', run_name='__main__', alter_sys=True)\n")


def cli_start(args, log_path, draws=None):
    """python -m zkp2p_tpu_torch <args> from the root of the checkout,
    started in the background; with `draws`, the package's __main__ runs
    as -m runs it, with secrets.randbelow returning `draws` in turn (the
    provers draw r then s a proof).  Its standard errors and output go to
    `log_path` and `log_path`.out, its resident memory is sampled every
    0.1 s from /proc/<pid>/statm by a thread; cli_finish waits for it."""
    import os
    import threading

    cmd = [sys.executable, "-m", "zkp2p_tpu_torch", *args]
    if draws is not None:
        cmd = [sys.executable, "-c", PINNED_MAIN, json.dumps(draws), *args]
    err, out = open(log_path, "w"), open(log_path + ".out", "w")
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), stdout=out, stderr=err, text=True)
    rss = {"peak": None, "end": None}

    def sample():
        page = os.sysconf("SC_PAGE_SIZE")
        while proc.poll() is None:
            try:
                with open(f"/proc/{proc.pid}/statm") as f:
                    gib = int(f.read().split()[1]) * page / 2**30
                rss["peak"] = gib if rss["peak"] is None else max(rss["peak"], gib)
            except (OSError, ValueError, IndexError):
                pass
            time.sleep(0.1)
        rss["end"] = time.perf_counter()  # within 0.1 s of its exit

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    return proc, time.perf_counter(), log_path, (err, out), sampler, rss


def cli_finish(handle, timeout=900):
    """(wall-clock seconds from cli_start to its exit, the finished
    process with its stdout and stderr read back, its peak resident memory
    in GiB as sampled, None where /proc/<pid>/statm cannot be read); its
    log goes to ours."""
    proc, t0, log_path, files, sampler, rss = handle
    try:
        proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        sampler.join()
        for f in files:
            f.close()
    wall = rss["end"] - t0
    with open(log_path) as f:
        stderr = f.read()
    with open(log_path + ".out") as f:
        stdout = f.read()
    for line in stderr.splitlines():
        log(f"  | {line}")
    return wall, subprocess.CompletedProcess(proc.args, proc.returncode, stdout, stderr), rss["peak"]


# the functions of the CLI's path that phase 7 times in its in-process run
CLI_STEPS = ("read_zkey", "read_wtns", "reduce_rows", "device_pk_from_zkey", "prove_gpu", "dump")


@contextlib.contextmanager
def patched(settings):
    """Set each (module, name, value) for the block, then restore."""
    old = [(m, n, getattr(m, n)) for m, n, _ in settings]
    for m, n, v in settings:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in reversed(old):
            setattr(m, n, v)


def timed_calls(torch, seconds, results, module, names):
    """(module, name, wrapper) settings for `patched`: each wrapper adds
    its call's seconds, between two synchronises, to seconds[name] and
    keeps its result in results[name]."""
    def wrap(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
            results[name] = out
            return out
        return run
    return [(module, n, wrap(n, getattr(module, n))) for n in names]


def cli_log_seconds(stderr: str) -> dict:
    """The seconds (and proofs/s) the CLI logs for its steps."""
    import re

    out = {}
    for name, pattern in (("read", r"read the zkey and the witness in ([0-9.]+)s"),
                          ("key", r"key on \S+ in ([0-9.]+)s"), ("prove", r"\] proved in ([0-9.]+)s"),
                          ("batch", r"batch of \d+ proved in ([0-9.]+)s"), ("proofs_per_s", r"-> ([0-9.]+) proofs/s")):
        m = re.search(pattern, stderr)
        if m:
            out[name] = float(m.group(1))
    return out


def trace_file_span(path, stage):
    """The milliseconds of the one `stage` span that a --trace file
    holds after its manifest line."""
    with open(path) as f:
        lines = [json.loads(ln) for ln in f]
    spans = [rec["ms"] for rec in lines[1:] if rec["stage"] == stage]
    if lines[0].get("type") != "manifest" or len(spans) != 1:
        raise AssertionError(f"{path}: a manifest line and one {stage} span expected")
    return spans[0]


def pinned_draws(rs):
    """secrets.randbelow's returns that make the provers draw `rs`."""
    return [v - 1 for pair in rs for v in pair]


def same_file(a, b) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def cli_phase(torch, inp, device, beside):
    """Phase 7: the command line at full size, from the files phase 6
    wrote, before phase 4.
    `python -m zkp2p_tpu_torch prove`, then `verify` (exit 0), as
    subprocesses, timed on the wall clock, and beside them `batch` at
    chunk BATCH_CHUNK over the CLI_SEEDED + 1 witnesses as a subprocess
    with the draws pinned; then main(["prove", ...]) in this process with
    r and s pinned, its launches counted, each step of its path timed
    with a synchronise at each boundary (CLI_STEPS and
    infer_zkey_widths), its gpu/prove span, the classes of the key it
    imported, its proof.json byte-equal to prove_gpu's on that key; and
    main(["batch", ...]) here on the zkey and key the in-process prove
    read and imported, its launches counted, the same draws: every file
    equal to the subprocess's and to the proofs its prove_gpu_batch
    returned, w0's to prove_gpu's; the satisfying witness's batch proof
    verifies, a seeded one's does not; both subprocesses' spans read from
    their --trace files.  `beside()` runs in this process while `prove`
    and `batch` run (phase 4's set-up, phase 10's counted run).  Deletes CLI_DIR.  Returns the
    cli_real_size line, the launches of the CLI's prove and batch run
    here, what check_cli_launches holds them to once phase 4 has run, and
    what beside() returned."""
    import os
    import secrets
    import shutil

    from zkp2p_tpu_torch.field.bn254 import R
    from zkp2p_tpu_torch.formats.circom_bin import read_wtns, reduce_rows
    from zkp2p_tpu_torch.formats.proof_json import dump, load, proof_from_json, proof_to_json, public_to_json
    from zkp2p_tpu_torch.ops import cuda_build
    from zkp2p_tpu_torch.ops.ntt import pass_plan
    from zkp2p_tpu_torch.pipeline import cli
    from zkp2p_tpu_torch.prover import groth16_gpu
    from zkp2p_tpu_torch.prover.groth16_gpu import batch_spans, prove_gpu
    from zkp2p_tpu_torch.snark.groth16 import verify
    from zkp2p_tpu_torch.utils import trace

    paths, vk, pub = inp["paths"], inp["vk"], inp["pub"]
    d = os.path.abspath(CLI_DIR)
    started = []

    def out_path(name):
        return os.path.join(d, name)

    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        held = torch.cuda.memory_allocated()
        log(f"before the CLI subprocesses: {free / 2**30:.2f} of {total / 2**30:.2f} GiB free on the card, "
            f"{held / 2**30:.2f} GiB allocated here")
        rng = random.Random(SEED + 210)
        r, s = rng.randrange(1, R), rng.randrange(1, R)
        ws = [reduce_rows(read_wtns(os.path.join(paths["indir"], f"w{i}.wtns"))) for i in range(len(inp["batch"]))]
        if any((a != b).any() for a, b in zip(ws, inp["batch"])):
            raise AssertionError("a batch witness read back differs from the one written")
        rs = [(rng.randrange(1, R), rng.randrange(1, R)) for _ in ws]

        # the drop-in path as a user runs it: `prove` and `batch` (the
        # draws pinned) together, then `verify` once the proof exists
        files = ["--zkey", paths["zkey"], "--wtns", paths["wtns"]]
        prove_sub = cli_start(["--build-dir", d, "prove", *files, "--proof", out_path("proof.json"),
                               "--public", out_path("public.json"), "--trace", out_path("prove.trace")],
                              out_path("prove.log"))
        started.append(prove_sub[0])
        batch_args = ["--build-dir", d, "batch", "--zkey", paths["zkey"], "--indir", paths["indir"],
                      "--chunk", str(BATCH_CHUNK)]
        batch_sub = cli_start(batch_args + ["--outdir", out_path("sub"), "--trace", out_path("batch.trace")],
                              out_path("batch.log"), draws=pinned_draws(rs))
        started.append(batch_sub[0])
        beside_out = beside()
        prove_s, run, _ = cli_finish(prove_sub)
        if run.returncode:
            raise AssertionError(f"python -m zkp2p_tpu_torch prove exited {run.returncode}")
        if load(out_path("public.json")) != [str(v) for v in pub]:
            raise AssertionError("public.json differs from the witness's public inputs")
        prove_log = dict(cli_log_seconds(run.stderr), span_ms=trace_file_span(out_path("prove.trace"), "gpu/prove"))
        verify_sub = cli_start(["--build-dir", d, "verify", "--proof", out_path("proof.json"),
                                "--public", out_path("public.json")], out_path("verify.log"))
        started.append(verify_sub[0])
        sub_s, run, _ = cli_finish(batch_sub)
        if run.returncode:
            raise AssertionError(f"python -m zkp2p_tpu_torch batch exited {run.returncode}")
        sub_log = dict(cli_log_seconds(run.stderr),
                       span_ms=trace_file_span(out_path("batch.trace"), "gpu/prove_batch"))
        verify_s, run, _ = cli_finish(verify_sub)
        if run.returncode or run.stdout.strip() != "OK":
            raise AssertionError(f"python -m zkp2p_tpu_torch verify exited {run.returncode}: {run.stdout!r}")
        log(f"CLI subprocesses: prove {prove_s:.1f} s (files to proof.json, beside the batch subprocess; its log: "
            f"{prove_log}), verify {verify_s:.1f} s (beside the batch subprocess): OK")

        # main(["prove", ...]) in this process: r and s pinned, its launches
        # counted, each step of its path timed to a synchronise, its key kept
        steps, kept = {}, {}
        draws = iter(pinned_draws([(r, s)]))
        trace.reset()
        with patched(timed_calls(torch, steps, kept, cli, CLI_STEPS) + timed_calls(
                torch, steps, kept, groth16_gpu, ("infer_zkey_widths",)) + [(secrets, "randbelow",
                                                                            lambda n: next(draws))]):
            cuda_build.reset_launches()
            main_s, _ = wall_s(torch, lambda: cli.main(["--build-dir", d, "prove", *files, "--device", str(device),
                                                        "--proof", out_path("pinned.proof.json"),
                                                        "--public", out_path("pinned.public.json")]))
            prove_launches = dict(cuda_build.LAUNCHES)
        key, widths, zk = kept["device_pk_from_zkey"], kept["infer_zkey_widths"], kept["read_zkey"]
        span = [rec["ms"] for rec in trace.records() if rec["stage"] == "gpu/prove"]
        if len(span) != 1:
            raise AssertionError(f"the CLI's prove left {len(span)} gpu/prove spans, one expected")
        rows = reduce_rows(read_wtns(paths["wtns"]))
        warm = {}
        warm_s, proof = wall_s(torch, lambda: prove_gpu(key, rows, r=r, s=s, device=device, stages=warm))
        dump(proof_to_json(proof), out_path("direct.proof.json"))
        if not same_file(out_path("pinned.proof.json"), out_path("direct.proof.json")):
            raise AssertionError("the CLI's proof.json with r, s pinned differs from prove_gpu's on the imported key")
        if not verify(vk, proof, pub):
            raise AssertionError("the proof under the imported key does not verify")
        trees = tree_and_join_launches(key)
        classes = {k: getattr(key, k).numel() for k in ("a_nsel", "a_wsel", "b_nsel", "b_wsel", "c_nsel", "c_wsel")}
        del kept
        log(f"CLI prove in process, r and s pinned: {main_s:.1f} s (" + ", ".join(
            f"{k} {v:.3f}" for k, v in steps.items()) + f" s; gpu/prove span {span[0]:.1f} ms); proof.json equal "
            f"to prove_gpu's on its key, which proves again in {warm_s:.3f} s; inferred narrow wires "
            f"{int((widths <= 11).sum())}; classes {json.dumps(classes)}; launches "
            + json.dumps({k[3:]: v for k, v in prove_launches.items() if v}))

        # main(["batch", ...]) here on the zkey and key the CLI's prove read
        # and imported above (its launches counted), the draws pinned as the
        # subprocess's; the files of the two and the proofs its
        # prove_gpu_batch returned all equal
        batch_steps, batch_kept = {}, {}
        draws = iter(pinned_draws(rs))
        with patched(timed_calls(torch, batch_steps, batch_kept, cli, ("prove_gpu_batch",)) + [
                (cli, "_load_zkey", lambda args: zk), (cli, "_key", lambda args, z, dev: key),
                (secrets, "randbelow", lambda n: next(draws))]):
            cuda_build.reset_launches()
            main_batch_s, _ = wall_s(torch, lambda: cli.main(batch_args + ["--outdir", out_path("main"),
                                                                           "--device", str(device)]))
            cli_batch_launches = dict(cuda_build.LAUNCHES)
        proofs, batch_s = batch_kept["prove_gpu_batch"], batch_steps["prove_gpu_batch"]
        n_public = key.n_public
        del zk
        for i, p in enumerate(proofs):
            dump(proof_to_json(p), out_path(f"direct.w{i}.proof.json"))
            for kind in ("proof", "public"):
                name = f"w{i}.{kind}.json"
                if not same_file(os.path.join(d, "sub", name), os.path.join(d, "main", name)):
                    raise AssertionError(f"the CLI batch's {name} differs between the subprocess and main() here")
            if not same_file(os.path.join(d, "main", f"w{i}.proof.json"), out_path(f"direct.w{i}.proof.json")):
                raise AssertionError(f"the CLI batch's w{i}.proof.json differs from its prove_gpu_batch's proof")
            if load(os.path.join(d, "main", f"w{i}.public.json")) != public_to_json(
                    int.from_bytes(ws[i][j].tobytes(), "little") for j in range(1, n_public + 1)):
                raise AssertionError(f"the CLI batch's w{i}.public.json differs from the witness's")
        dump(proof_to_json(prove_gpu(key, ws[0], r=rs[0][0], s=rs[0][1], device=device)), out_path("w0.single.json"))
        limits = dict(trees=trees, passes=2 * len(pass_plan(key.log_m)),
                      n_chunks=len(batch_spans(len(ws), BATCH_CHUNK)))
        del key
        if not same_file(out_path("w0.single.json"), os.path.join(d, "main", "w0.proof.json")):
            raise AssertionError("the CLI batch's w0.proof.json differs from prove_gpu's with its r, s")
        sub_proof = proof_from_json(load(os.path.join(d, "sub", "w0.proof.json")))
        seeded_pub = load(os.path.join(d, "sub", "w1.public.json"))
        if not verify(vk, sub_proof, pub) or verify(vk, proofs[1], [int(v) for v in seeded_pub]):
            raise AssertionError("the satisfying witness's batch proof must verify and a seeded one's must not")
        n = len(ws)
        log(f"CLI batch ({n} wtns, chunk {BATCH_CHUNK}): subprocess {sub_s:.1f} s (its log: {sub_log}); main() "
            f"here on the imported key {main_batch_s:.2f} s, its prove_gpu_batch {batch_s:.2f} s ({n / batch_s:.3f} "
            f"proofs/s); every file equal between the two and to the proofs prove_gpu_batch returned, w0's to "
            f"prove_gpu's; w0 verifies, w1 does not; launches of main() "
            + json.dumps({k[3:]: v for k, v in cli_batch_launches.items() if v}))
        return {
            "shape": "venmo 1024/6400 counts, phase 6's key and satisfying witness as files",
            "mem_get_info_before_subprocesses": {"free": free, "total": total, "allocated_here": held},
            **inp["files"],
            "prove_subprocess_s": prove_s, "prove_subprocess_log_s": prove_log, "verify_subprocess_s": verify_s,
            "verify_exit": 0, "step_s": steps, "gpu_prove_span_ms": span[0],
            "warm_proof_s": warm_s, "warm_proof_stage_s": {k[2:]: v for k, v in warm.items() if k.startswith("s_")},
            "inferred_narrow_wires": int((widths <= 11).sum()), "classes": classes,
            "pinned_main_prove_s": main_s, "pinned_proof_bytes_equal": True,
            "prove_launches": {k[3:]: v for k, v in prove_launches.items() if v},
            "batch": {"witnesses": n, "chunk": BATCH_CHUNK, "subprocess_s": sub_s, "subprocess_log": sub_log,
                      "main_in_process_s": main_batch_s, "prove_gpu_batch_s": batch_s,
                      "prove_gpu_batch_proofs_per_s": n / batch_s, "files_equal": True,
                      "launches": {k[3:]: v for k, v in cli_batch_launches.items() if v}},
            "concurrency": "the prove and batch subprocesses together, beside phase 4's set-up here (h_evals "
                           "check, synthetic key), then verify beside the batch; the in-process prove and batch "
                           "after them, alone",
        }, prove_launches, cli_batch_launches, limits, beside_out
    finally:
        stop(started)
        shutil.rmtree(d, ignore_errors=True)


def check_cli_launches(prove_launches, batch_launches_cli, limits, jac_launches, batch_launches):
    """Phase 7's launches, once phase 4 has counted the paths: the CLI's
    prove launches the Jacobian path's kernels, its batch the batch path's
    (a chunk), K18 once a tree and K2 once a join of the imported key's
    classes (limits["trees"]), K12 once a pass, K13 and K14 twice."""
    trees, passes, n_chunks = limits["trees"], limits["passes"], limits["n_chunks"]
    skip = {"zk_" + k for k, v in trees.items() if not v}
    for what, launches, path, per in (("prove", prove_launches, jac_launches, 1),
                                      ("batch", batch_launches_cli, batch_launches, n_chunks)):
        want = {k for k, v in path.items() if v} - skip
        got = {k for k, v in launches.items() if v}
        fixed = {k: launches[k] / per for k in ("zk_fr_ntt_pass", "zk_fr_matvec", "zk_signed_recode")}
        fixed.update({"zk_" + k: launches["zk_" + k] / per for k in trees})
        if got != want or fixed != {"zk_fr_ntt_pass": passes, "zk_fr_matvec": 2, "zk_signed_recode": 2,
                                    **{"zk_" + k: v for k, v in trees.items()}}:
            raise AssertionError(f"the CLI's {what} launched {sorted(got)} ({fixed} a chunk), its path "
                                 f"{sorted(want)}, K18 / K2 {trees} a chunk")


# --------------------------------------------------------------- phase 8


def rss_gib() -> float:
    """This process's resident memory now (from /proc/self/statm)."""
    import os

    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**30


def setup_files(zk, vk, d):
    """The files the CLI's setup writes of a key's ZkeyData `zk`
    (zkey_from_key) and its VK, through the functions it writes them
    with; returns their paths."""
    import os

    from zkp2p_tpu_torch.formats.proof_json import dump, vkey_to_json
    from zkp2p_tpu_torch.formats.solidity import export_verifier
    from zkp2p_tpu_torch.formats.zkey import write_zkey_data

    os.makedirs(d, exist_ok=True)
    paths = [os.path.join(d, n) for n in SETUP_FILES]
    write_zkey_data(paths[0], zk)
    dump(vkey_to_json(vk), paths[1])
    with open(paths[2], "w") as f:
        f.write(export_verifier(vk))
    return paths


def cli_log_steps(stderr: str) -> dict:
    """The steps the CLI's circuit route logs: seconds, the imported
    key's narrow/wide lanes, the peak host RSS."""
    import re

    out = {}
    for name, pattern in (("build", r"constraints=\d+ wires=\d+ \(([0-9.]+)s\)"),
                          ("read_zkey", r"read the zkey in ([0-9.]+)s"), ("key", r"key on \S+ in ([0-9.]+)s"),
                          ("witness", r"witness in ([0-9.]+)s"), ("prove", r"\] proved in ([0-9.]+)s"),
                          ("setup", r"setup on \S+ in ([0-9.]+)s"), ("audit", r"findings in ([0-9.]+)s"),
                          ("peak_rss_gib", r"peak host RSS ([0-9.]+) GiB")):
        m = re.search(pattern, stderr)
        if m:
            out[name] = float(m.group(1))
    m = re.search(r"narrow/wide lanes: a (\d+)/(\d+) b (\d+)/(\d+) c (\d+)/(\d+)", stderr)
    if m:
        v = [int(x) for x in m.groups()]
        out["classes"] = {"a": v[0:2], "b": v[2:4], "c": v[4:6]}
    m = re.search(r"soundness audit clean: 0 unwaived / (\d+) waived findings in [0-9.]+s \((\w+)", stderr)
    if m:
        out["audit_waived"], out["audit_source"] = int(m.group(1)), m.group(2)
    return out


def build_flagship():
    """VenmoParams() built by the port's builder (phase 8's circuit), run
    in a thread beside the kernel build of phase 1, which mostly waits on
    nvcc: the circuit, its layout and params, the build's seconds and
    this process's RSS before and after it."""
    from zkp2p_tpu_torch.models.venmo import VenmoParams, build_venmo_circuit

    rss0 = rss_gib()
    t0 = time.perf_counter()
    params = VenmoParams()
    cs, lay = build_venmo_circuit(params)
    return dict(cs=cs, lay=lay, params=params, build_s=time.perf_counter() - t0,
                rss_gib={"before": rss0, "after": rss_gib()})


def stop(procs):
    """Kill each of `procs` still running (a failed check leaves no
    subprocess behind)."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def flagship_start(torch, built, device):
    """Phase 8's start, run just after phase 1 so that its two subprocesses
    run beside the rest of phase 8 and phase 9: the flagship circuit
    `built` by the port's builder
    is set up on the card (setup_device; its counts held to VENMO, its a
    classes to the circuit's tagged widths, its launches counted); then
    the files the CLI's setup writes go under FLAGSHIP_DIR/full in one
    rename, `prove --circuit venmo` (1024/6400, r and s pinned to the
    first proof's) and the 256/192 `setup` (audit on) start as
    subprocesses and the zkey's classes are inferred (infer_zkey_widths).
    The files, the subprocesses and the inference run in a thread, which
    flagship_join waits for.  Returns phase 8's state for flagship_phase;
    on a failure here the directory is removed, after it the caller joins
    the thread, then stops st["procs"]."""
    import os
    import shutil

    from zkp2p_tpu_torch.formats.zkey import zkey_from_key
    from zkp2p_tpu_torch.ops import cuda_build
    from zkp2p_tpu_torch.prover import setup_device as sd
    from zkp2p_tpu_torch.prover.groth16_gpu import NARROW_WIDTH, infer_zkey_widths

    V = VENMO
    cs = built["cs"]
    d = os.path.abspath(FLAGSHIP_DIR)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    procs = []
    try:
        full = os.path.join(d, "full")
        rng = random.Random(SEED + 80)
        rs = [(rng.randrange(1, 1 << 250), rng.randrange(1, 1 << 250)) for _ in FLAGSHIP_EMAILS]
        flags = ["--build-dir", full, "--circuit", "venmo", "--max-header", "1024", "--max-body", "6400"]

        secs, res, stages = {}, {}, {}
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        cuda_build.reset_launches()
        with patched(timed_calls(torch, secs, res, sd, ("qap_coo", "widths_array"))):
            setup_s, (key, vk) = wall_s(torch, lambda: sd.setup_device(cs, seed=FLAGSHIP_SEED, device=device,
                                                                       stages=stages))
        setup_launches = dict(cuda_build.LAUNCHES)
        setup_peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
        a, b, _, n_rows = res.pop("qap_coo")
        tagged_narrow = int((res.pop("widths_array") <= NARROW_WIDTH).sum())
        counts = dict(constraints=cs.num_constraints, n_public=cs.num_public, n_wires=cs.num_wires, rows=n_rows,
                      log_m=key.log_m, nnz_a=int(a[1].size), nnz_b=int(b[1].size), b_narrow=key.b_nsel.numel(),
                      b_wide=key.b_wsel.numel(), c_narrow=key.c_nsel.numel(), c_wide=key.c_wsel.numel())
        del a, b
        if counts != V:
            raise AssertionError(f"the port's flagship circuit has {counts}, the reference's builder {V}")
        tagged = {q: [getattr(key, q + "_nsel").numel(), getattr(key, q + "_wsel").numel()] for q in "abc"}
        if tagged["a"] != [tagged_narrow, V["n_wires"] - tagged_narrow]:
            raise AssertionError(f"the key's a classes {tagged['a']} are not the circuit's tagged widths")
        missing = [k for k in SETUP_KERNELS if not setup_launches["zk_" + k]]
        if missing or setup_launches["zk_fr_matvec"] < 3:
            raise AssertionError(f"the flagship setup launched {setup_launches}; missing {missing}")
        log(f"flagship setup_device: {setup_s:.3f} s (qap_coo {secs['qap_coo']:.2f} s, widths_array "
            f"{secs['widths_array']:.2f} s; " + ", ".join(f"{k[2:]} {v:.3f}" for k, v in stages.items())
            + f"), peak {setup_peak:.2f} GiB; counts equal to VENMO; classes {tagged}")

        zk = zkey_from_key(key, vk)

        def files_then_subprocesses():
            # host work (numpy, file writes, a Python scan of the zkey's
            # rows), off the card, in a thread beside phase 8
            t0 = time.perf_counter()
            setup_files(zk, vk, full + ".part")
            os.replace(full + ".part", full)
            out = dict(files_s=time.perf_counter() - t0,
                       zkey_bytes=os.path.getsize(os.path.join(full, SETUP_FILES[0])))
            out["cli_prove"] = cli_start(flags + ["prove", "--demo", "--proof", os.path.join(d, "proof.json"),
                                                  "--public", os.path.join(d, "public.json")],
                                         os.path.join(d, "prove.log"), draws=pinned_draws(rs[:1]))
            procs.append(out["cli_prove"][0])
            out["cli_setup"] = cli_start(["--build-dir", os.path.join(d, "small_cli"), "--circuit", "venmo",
                                          "setup", "--seed", FLAGSHIP_SEED], os.path.join(d, "setup.log"))
            procs.append(out["cli_setup"][0])
            t0 = time.perf_counter()
            out["inferred"] = infer_zkey_widths(zk)
            out["infer_s"] = time.perf_counter() - t0
            return out

        pool = ThreadPoolExecutor(1)
        pending = pool.submit(files_then_subprocesses)
        pool.shutdown(wait=False)
        return dict(dir=d, rs=rs, flags=flags, key=key, vk=vk, counts=counts, tagged=tagged, setup_s=setup_s,
                    secs=secs, stages=stages, setup_peak=setup_peak, setup_launches=setup_launches,
                    pending=pending, procs=procs)
    except BaseException:
        stop(procs)
        shutil.rmtree(d, ignore_errors=True)
        raise


def flagship_join(st):
    """Wait for flagship_start's thread; its results go into `st` (its
    error raises).  The subprocesses it started are in st["procs"]."""
    if "pending" in st:
        pending = st.pop("pending")
        st.update(pending.result())


def flagship_phase(torch, built, st, device):
    """Phase 8 in this process, on flagship_start's state `st` (its key on
    the card; its subprocesses run beside this and phase 9): four
    synthetic signed Venmo emails witnessed (generate_inputs; the first
    through cs.witness, all four through cs.witness_batch, the first equal
    both ways), the 256/192 circuit set up here, the first witness checked
    against the R1CS (cs.check_witness, which builds the check's matrices
    once: phase 9's service checks every witness); prove_gpu under the
    tagged classes and, once flagship_start's thread has inferred them,
    under the zkey's (its launches, which phase 11's workers make a batch
    chunk, in st["inferred_launches"]), and prove_gpu_batch, each
    verified; then, the 256/192 `setup` having ended, its files held
    against this process's.  Returns (the flagship line, the launches of
    the setup, of the proof and of the batch, and phase 9's context: the
    key, the circuit, the batch's proofs); flagship_finish and
    flagship_verified complete the line with the CLI's prove and
    verify."""
    import dataclasses
    import os
    import shutil

    import numpy as np

    from zkp2p_tpu_torch.formats.proof_json import dump, proof_to_json, public_to_json
    from zkp2p_tpu_torch.formats.zkey import zkey_from_key
    from zkp2p_tpu_torch.inputs.email import generate_inputs, make_test_key, make_venmo_email
    from zkp2p_tpu_torch.models.venmo import VenmoParams, build_venmo_circuit
    from zkp2p_tpu_torch.ops import cuda_build
    from zkp2p_tpu_torch.prover import setup_device as sd
    from zkp2p_tpu_torch.prover.groth16_gpu import NARROW_WIDTH, _selections, prove_gpu, prove_gpu_batch
    from zkp2p_tpu_torch.snark.groth16 import proof_bytes, verify

    cs, lay, params = built["cs"], built["lay"], built["params"]
    d, rs, key, vk = st["dir"], st["rs"], st["key"], st["vk"]
    try:
        rsa = make_test_key(1)
        pubs, seeds, inputs_s = [], [], []
        for raw_id, amount, order_id in FLAGSHIP_EMAILS:
            t0 = time.perf_counter()
            inputs = generate_inputs(make_venmo_email(rsa, raw_id=raw_id, amount=amount), rsa.n, order_id, 0,
                                     params, lay)
            inputs_s.append(time.perf_counter() - t0)
            pubs.append(inputs.public_signals)
            seeds.append(inputs.seed)
        t0 = time.perf_counter()
        first = cs.witness(pubs[0], seeds[0])
        witness_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        wits = cs.witness_batch(list(zip(pubs, seeds)))
        witness_batch_s = time.perf_counter() - t0
        if list(wits[0]) != list(first):
            raise AssertionError("the first email's witness differs between cs.witness and cs.witness_batch")
        del first
        log(f"flagship witnesses of {len(wits)} emails: inputs {[round(x, 2) for x in inputs_s]} s, cs.witness of "
            f"the first {witness_s:.2f} s, cs.witness_batch of all {witness_batch_s:.2f} s (the first equal)")

        small_s, (cs_small, _) = wall_s(torch, lambda: build_venmo_circuit(VenmoParams(*SMALL_VENMO)))
        small_setup_s, (key_s, vk_s) = wall_s(torch, lambda: sd.setup_device(cs_small, seed=FLAGSHIP_SEED,
                                                                             device=device))
        mine = setup_files(zkey_from_key(key_s, vk_s), vk_s, os.path.join(d, "small_here"))
        del key_s, cs_small
        t0 = time.perf_counter()
        cs.check_witness(wits[0])
        check_s = time.perf_counter() - t0

        pst, warm = {}, {}
        cuda_build.reset_launches()
        prove_s, proof = wall_s(torch, lambda: prove_gpu(key, wits[0], r=rs[0][0], s=rs[0][1], device=device,
                                                        stages=pst))
        prove_launches = dict(cuda_build.LAUNCHES)
        warm_s, again = wall_s(torch, lambda: prove_gpu(key, wits[0], r=rs[0][0], s=rs[0][1], device=device,
                                                       stages=warm))
        t0 = time.perf_counter()
        ok = verify(vk, proof, pubs[0])
        verify_s = time.perf_counter() - t0
        if not ok or proof_bytes(again) != proof_bytes(proof):
            raise AssertionError("the flagship proof does not verify, or the same (r, s) proved other bytes")
        if verify(vk, proof, [pubs[0][0] + 1] + pubs[0][1:]):
            raise AssertionError("the flagship proof verifies against a changed public signal")
        missing = [k for k in PATH_KERNELS["jacobian"] if not prove_launches["zk_" + k]]
        stray = [k for k in NOT_ON_JACOBIAN if prove_launches["zk_" + k]]
        if missing or stray:
            raise AssertionError(f"the flagship proof launched {prove_launches}: missing {missing}, stray {stray}")
        log(f"flagship prove_gpu: first {prove_s:.3f} s (its CSR built), warm {warm_s:.3f} s ("
            + ", ".join(f"{k[2:]} {v:.4f}" for k, v in warm.items() if k.startswith("s_"))
            + f"); verify {verify_s:.2f} s: accepted, a changed public signal rejected, the same bytes again")

        bst = {}
        cuda_build.reset_launches()
        batch_s, proofs = wall_s(torch, lambda: prove_gpu_batch(key, wits, rs=rs, chunk=BATCH_CHUNK, device=device,
                                                               stages=bst))
        batch_launches = dict(cuda_build.LAUNCHES)
        if proof_bytes(proofs[0]) != proof_bytes(proof) or not all(verify(vk, p, q) for p, q in zip(proofs, pubs)):
            raise AssertionError("a flagship batch proof does not verify, or differs from prove_gpu's")
        n_wits = len(wits)
        log(f"flagship prove_gpu_batch of {n_wits} (chunk {BATCH_CHUNK}): {batch_s:.3f} s "
            f"({n_wits / batch_s:.3f} proofs/s); every proof verifies")

        # the 256/192 `setup` has ended by now: its files
        flagship_join(st)
        small_wall, sout, small_rss = cli_finish(st["cli_setup"])
        if sout.returncode:
            raise AssertionError(f"`setup --circuit venmo` at {SMALL_VENMO} exited {sout.returncode}")
        for path in mine:
            if not same_file(path, os.path.join(d, "small_cli", os.path.basename(path))):
                raise AssertionError(f"the CLI setup's {os.path.basename(path)} differs from the in-process setup's")
        small_steps = cli_log_steps(sout.stderr)
        log(f"flagship at {SMALL_VENMO}: built {small_s:.1f} s, set up here {small_setup_s:.2f} s; `setup` "
            f"(audit on, beside this phase) {small_wall:.1f} s wall, peak RSS {small_rss} GiB ({small_steps}), its "
            "three files equal to this process's")

        # the classes the CLI's prove infers from the zkey, on this key:
        # the same proof bytes under them, its stages timed
        inferred = st["inferred"]
        sels = _selections(inferred, key.n_wires, key.b_sel.cpu().numpy(), key.c_sel.cpu().numpy())
        ikey = dataclasses.replace(
            key, _split={}, inferred_narrow_wires=np.flatnonzero(inferred <= NARROW_WIDTH).astype(np.int64).tobytes(),
            **{k: torch.from_numpy(v.astype(np.int64)).to(device) for k, v in sels.items()
               if k not in ("b_sel", "c_sel")})
        inferred_classes = {q: [getattr(ikey, q + "_nsel").numel(), getattr(ikey, q + "_wsel").numel()]
                            for q in "abc"}
        ist, iwarm = {}, {}
        cuda_build.reset_launches()
        ifirst_s, iproof = wall_s(torch, lambda: prove_gpu(ikey, wits[0], r=rs[0][0], s=rs[0][1], device=device,
                                                          stages=ist))
        # a proof's launches under the classes the CLI's key has: phase 11's
        # workers launch these a batch chunk (K1 4 + B)
        st["inferred_launches"] = dict(cuda_build.LAUNCHES)
        iwarm_s, _ = wall_s(torch, lambda: prove_gpu(ikey, wits[0], r=rs[0][0], s=rs[0][1], device=device,
                                                    stages=iwarm))
        if proof_bytes(iproof) != proof_bytes(proof):
            raise AssertionError("the proof under the zkey's inferred classes differs from the tagged key's")
        log(f"flagship under the zkey's inferred classes {inferred_classes} (inferred in {st['infer_s']:.2f} s): "
            f"first {ifirst_s:.3f} s, warm {iwarm_s:.3f} s ("
            + ", ".join(f"{k[2:]} {v:.4f}" for k, v in iwarm.items() if k.startswith("s_"))
            + "); the same bytes as under the tagged classes")
        del ikey, again
        torch.cuda.empty_cache()
        dump(proof_to_json(proof), os.path.join(d, "want.proof.json"))
        dump(public_to_json(pubs[0]), os.path.join(d, "want.public.json"))

        line = {
            "shape": "venmo 1024/6400: VenmoParams() built by zkp2p_tpu_torch.models.venmo, synthetic signed "
                     "emails (make_venmo_email(make_test_key(1)))",
            "counts": st["counts"], "counts_equal_venmo": True, "build_s_beside_kernel_build": built["build_s"],
            "build_rss_gib": built["rss_gib"],
            "emails": [list(e) for e in FLAGSHIP_EMAILS], "inputs_s": inputs_s, "witness_first_s": witness_s,
            "witness_batch_s": witness_batch_s, "check_witness_first_s": check_s,
            "setup_s": st["setup_s"], "qap_coo_s": st["secs"]["qap_coo"], "widths_array_s": st["secs"]["widths_array"],
            "setup_stage_s": {k[2:]: v for k, v in st["stages"].items()}, "setup_peak_device_gib": st["setup_peak"],
            "tagged_classes": st["tagged"], "inferred_classes": inferred_classes, "infer_zkey_widths_s": st["infer_s"],
            "inferred_prove_s": ifirst_s, "inferred_warm_prove_s": iwarm_s,
            "inferred_warm_stage_s": {k[2:]: v for k, v in iwarm.items() if k.startswith("s_")},
            "inferred_same_bytes": True, "prove_s": prove_s,
            "prove_stage_s": {k[2:]: v for k, v in pst.items() if k.startswith("s_")},
            "warm_prove_s": warm_s, "warm_stage_s": {k[2:]: v for k, v in warm.items() if k.startswith("s_")},
            "verify_s": verify_s, "verify": True, "changed_public_rejected": True, "same_bytes_again": True,
            "batch": {"witnesses": n_wits, "chunk": BATCH_CHUNK, "s": batch_s,
                      "proofs_per_s": n_wits / batch_s, "all_verify": True},
            "cli": {"setup_files_s": st["files_s"], "zkey_bytes": st["zkey_bytes"],
                    "beside": "phase 8 in process and phase 9"},
            "small": {"shape": list(SMALL_VENMO), "build_s": small_s, "setup_here_s": small_setup_s,
                      "cli_setup_wall_s": small_wall, "cli_setup_peak_rss_gib_sampled": small_rss,
                      "cli_setup_steps": small_steps, "files_equal": True},
            "launches": {"setup": {k[3:]: v for k, v in st["setup_launches"].items() if v},
                         "prove": {k[3:]: v for k, v in prove_launches.items() if v},
                         "batch": {k[3:]: v for k, v in batch_launches.items() if v}},
        }
        # phase 9's: the resident key, the circuit, the batch's proofs
        # with their (r, s) and public signals
        # and phase 13's: the four witnesses, the warm proof's seconds
        ctx = dict(key=key, vk=vk, cs=cs, lay=lay, params=params, rs=rs, pubs=pubs, proofs=proofs,
                   flagship_cli=st["cli_prove"][0], wits=wits, warm_prove_s=warm_s)
        return line, st["setup_launches"], prove_launches, batch_launches, ctx
    except BaseException:
        stop(st["procs"])
        raise


def flagship_finish(st, line):
    """Phase 8's CLI, after phase 9: `prove --circuit venmo` (started by
    flagship_start) must have exited 0 with proof.json and public.json
    equal to prove_gpu's on the demo email and its key's classes equal to
    the inferred ones; then `verify` of its proof starts as a subprocess,
    beside phase 2 (flagship_verified waits for it)."""
    import os

    d = st["dir"]
    prove_wall, out, prove_rss = cli_finish(st["cli_prove"])
    if out.returncode:
        raise AssertionError(f"`prove --circuit venmo` exited {out.returncode}")
    steps = cli_log_steps(out.stderr)
    for name in ("proof", "public"):
        if not same_file(os.path.join(d, f"{name}.json"), os.path.join(d, f"want.{name}.json")):
            raise AssertionError(f"the CLI's {name}.json differs from prove_gpu's on the demo email")
    if steps.get("classes") != line["inferred_classes"]:
        raise AssertionError(f"the CLI's key has the classes {steps.get('classes')}, {line['inferred_classes']} "
                             "expected")
    st["cli_verify"] = cli_start(st["flags"] + ["verify", "--proof", os.path.join(d, "proof.json"),
                                                "--public", os.path.join(d, "public.json")],
                                 os.path.join(d, "verify.log"))
    st["procs"].append(st["cli_verify"][0])
    line["cli"].update(prove_wall_s=prove_wall, prove_steps=steps, prove_peak_rss_gib_sampled=prove_rss,
                       files_equal_prove_gpu=True, classes_equal_inferred=True)
    log(f"flagship CLI: the setup's files written in {st['files_s']:.1f} s (in a thread; zkey "
        f"{st['zkey_bytes'] / 2**30:.3f} GiB); `prove --circuit venmo --demo` (beside phases 8 and 9) "
        f"{prove_wall:.1f} s wall, peak RSS {prove_rss} GiB ({steps}), its files equal to prove_gpu's")


def flagship_verified(st, line):
    """flagship_finish's `verify` must have printed OK and exited 0."""
    verify_wall, vout, _ = cli_finish(st["cli_verify"])
    if vout.returncode or vout.stdout.strip() != "OK":
        raise AssertionError(f"`verify` exited {vout.returncode}: {vout.stdout!r}")
    line["cli"].update(verify_wall_s=verify_wall, verify="OK")
    log(f"flagship CLI `verify` (beside phase 2): {verify_wall:.1f} s: OK")


# --------------------------------------------------------------- phase 9


def write_requests(spool, payloads):
    """One <name>.req.json a payload ({name: payload})."""
    import os

    os.makedirs(spool, exist_ok=True)
    for name, payload in payloads.items():
        with open(os.path.join(spool, name + ".req.json"), "w") as f:
            json.dump(payload, f)


def demo_payload(raw_id, amount, order_id, **extra):
    return {"raw_id": raw_id, "amount": amount, "order_id": order_id, "claim_id": 0, **extra}


def sink_records(spool, kind):
    with open(spool.rstrip("/") + ".metrics.jsonl") as f:
        return [rec for rec in map(json.loads, f) if rec.get("type") == kind]


def verify_spool(vk, spool, names):
    """Every <name>.proof.json of `names` verifies under `vk` against its
    .public.json; returns the host seconds."""
    import os

    from zkp2p_tpu_torch.formats.proof_json import load, proof_from_json
    from zkp2p_tpu_torch.snark.groth16 import verify

    t0 = time.perf_counter()
    for name in names:
        base = os.path.join(spool, name)
        if not verify(vk, proof_from_json(load(base + ".proof.json")), [int(v) for v in load(base + ".public.json")]):
            raise AssertionError(f"{base}.proof.json does not verify")
    return time.perf_counter() - t0


def service_phase(torch, fl, device):
    """Phase 9: the proving service on the card, on phase 8's resident
    flagship key (`fl`).  ProvingService.for_venmo at batch SERVICE_BATCH
    sweeps (1) FLAGSHIP_EMAILS as demo payloads, a payload with no raw_id,
    a torn request past the grace and one past its deadline, proving with
    prove_gpu_batch at phase 8's pinned (r, s): 4 done, 2 error-bad-input,
    1 error-deadline-exceeded, the files equal to phase 8's batch proofs
    byte for byte; then (2) the default prover (random r, s) over SERVICE_EMAILS at prefetch
    SERVICE_PREFETCH (phase 8's `prove --circuit venmo` may run beside
    it; the line says whether it did): two batches, the second's witnesses
    made while the first proves; launches counted over the sweep (the batch
    rule a chunk), every proof verified.  Returns (the service line, the
    sweep's launches)."""
    import os
    import shutil
    import threading

    from zkp2p_tpu_torch.formats.proof_json import dump, proof_to_json, public_to_json
    from zkp2p_tpu_torch.ops import cuda_build
    from zkp2p_tpu_torch.pipeline.service import ProvingService
    from zkp2p_tpu_torch.prover.groth16_gpu import prove_gpu_batch
    from zkp2p_tpu_torch.utils import trace as tr

    d = os.path.abspath(SERVICE_DIR)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    cs, n_pub = fl["cs"], fl["cs"].num_public
    try:
        # (1) the bytes: phase 8's emails at its pinned (r, s)
        spool = os.path.join(d, "pinned")
        names = [f"a{i}" for i in range(len(FLAGSHIP_EMAILS))]
        write_requests(spool, {**{n: demo_payload(*e) for n, e in zip(names, FLAGSHIP_EMAILS)},
                               "b_bad": {"amount": "30", "order_id": 9, "claim_id": 0},
                               "c_late": demo_payload("6789123456789123456", "5", 10, deadline_s=1)})
        with open(os.path.join(spool, "d_torn.req.json"), "w") as f:
            f.write('{"raw_id": "1"')
        past = time.time() - 60
        for n in ("c_late", "d_torn"):
            os.utime(os.path.join(spool, n + ".req.json"), (past, past))
        rs_of = {tuple(p): rs for p, rs in zip(fl["pubs"], fl["rs"])}

        def pinned(dpk, wits):
            return prove_gpu_batch(dpk, wits, rs=[rs_of[tuple(int(v) for v in w[1:n_pub + 1])] for w in wits],
                                   device=device)

        svc = ProvingService.for_venmo(cs, fl["lay"], fl["params"], fl["key"], fl["vk"], batch_size=SERVICE_BATCH,
                                       prover_fn=pinned, device=device, cache_dir=None)
        pinned_s, pinned_stats = wall_s(torch, lambda: svc.process_dir(spool))
        want = {"done": 4, "error-bad-input": 2, "error-failed-to-prove": 0, "error-deadline-exceeded": 1,
                "error-shed": 0}
        if pinned_stats != want:
            raise AssertionError(f"the pinned sweep ended {pinned_stats}, {want} expected")
        for name, proof, pub in zip(names, fl["proofs"], fl["pubs"]):
            dump(proof_to_json(proof), os.path.join(d, "want.proof.json"))
            dump(public_to_json(pub), os.path.join(d, "want.public.json"))
            for ext in ("proof", "public"):
                if not same_file(os.path.join(spool, f"{name}.{ext}.json"), os.path.join(d, f"want.{ext}.json")):
                    raise AssertionError(f"the service's {name}.{ext}.json differs from phase 8's prove_gpu_batch")
        recs = {r["request_id"]: r for r in sink_records(spool, "request")}
        states = {k: v["state"] for k, v in sorted(recs.items())}
        if states != {**dict.fromkeys(names, "done"), "b_bad": "error-bad-input",
                      "c_late": "error-deadline-exceeded", "d_torn": "error-bad-input"}:
            raise AssertionError(f"the pinned sweep's records: {states}")
        bad = [n for n in names if (recs[n].get("batch_n"), recs[n].get("batch_index")) != (4, names.index(n))
               or not recs[n].get("hbm_peak_bytes")]
        if bad:
            raise AssertionError(f"done records without their batch slot or device memory: {bad}")
        log(f"service, pinned sweep: {pinned_stats} in {pinned_s:.2f} s; the four proofs and publics equal phase 8's "
            "prove_gpu_batch files; records carry batch_index, batch_n, hbm_peak_bytes")

        # (2) the default prover (phase 8's CLI prove may still run)
        spool = os.path.join(d, "default")
        names = [f"r{i}" for i in range(len(SERVICE_EMAILS))]
        write_requests(spool, {n: demo_payload(*e) for n, e in zip(names, SERVICE_EMAILS)})
        # the perf sentry on (its default), its ledger in PERF_DIR/cache
        cache = os.path.abspath(os.path.join(PERF_DIR, "cache"))
        svc = ProvingService.for_venmo(cs, fl["lay"], fl["params"], fl["key"], fl["vk"], batch_size=SERVICE_BATCH,
                                       prefetch=SERVICE_PREFETCH, device=device, circuit="venmo", cache_dir=cache)
        check_s = []
        real_check = cs.check_witness

        def timed_check(w):
            t0 = time.perf_counter()
            real_check(w)
            check_s.append(time.perf_counter() - t0)

        rss = {"peak": rss_gib(), "stop": threading.Event()}

        def sample_rss():
            while not rss["stop"].wait(0.1):
                rss["peak"] = max(rss["peak"], rss_gib())

        sampler = threading.Thread(target=sample_rss, daemon=True)
        sampler.start()
        tr.reset()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        beside = [fl["flagship_cli"].poll() is None]
        cuda_build.reset_launches()
        try:
            with patched([(cs, "check_witness", timed_check)]):
                wall, stats = wall_s(torch, lambda: svc.process_dir(spool))
        finally:
            rss["stop"].set()
            sampler.join()
        launches = dict(cuda_build.LAUNCHES)
        beside.append(fl["flagship_cli"].poll() is None)
        peak = torch.cuda.max_memory_allocated() / 2**30
        spans = tr.records()
        if stats["done"] != len(names) or sum(stats.values()) != len(names):
            raise AssertionError(f"the default sweep ended {stats}")
        chunks = -(-len(names) // SERVICE_BATCH)
        want = {"fr_ntt_pass": 6, "fr_matvec": 2, "signed_recode": 2, **CLASSED_PROOF_LAUNCHES}
        got = {k: launches["zk_" + k] for k in want}
        if got != {k: v * chunks for k, v in want.items()}:
            raise AssertionError(f"the sweep's launches {got}, {chunks} chunks of {want} expected")
        missing = [k for k in PATH_KERNELS["batch"] if not launches["zk_" + k]]
        stray = [k for k in NOT_ON_JACOBIAN if launches["zk_" + k]]
        if missing or stray:
            raise AssertionError(f"the sweep launched {launches}: missing {missing}, stray {stray}")
        verify_s = verify_spool(fl["vk"], spool, names)
        witness_s = [r["ms"] / 1e3 for r in spans if r["stage"] == "service/witness_batch"]
        prove_s = [r["ms"] / 1e3 for r in spans if r["stage"] == "service/prove"]
        inputs_s = [r["ms"] / 1e3 for r in spans if r["stage"] == "service/inputs"]
        sample_verify_s = [r["ms"] / 1e3 for r in spans if r["stage"] == "service/verify"]
        if len(witness_s) != chunks or len(prove_s) != chunks:
            raise AssertionError(f"spans: witness_batch {witness_s}, prove {prove_s}")
        recs = sink_records(spool, "request")
        stamp = perf_stamp_check(svc, cache, len(names), device)
        line = {
            "shape": "venmo 1024/6400, phase 8's key; synthetic signed emails as demo payloads",
            "perf_stamp": stamp,
            "pinned": {"requests": 7, "stats": pinned_stats, "s": pinned_s, "files_equal_prove_gpu_batch": True},
            "default": {"requests": len(names), "batch": SERVICE_BATCH, "prefetch": SERVICE_PREFETCH,
                        "wall_s": wall, "requests_per_s": len(names) / wall, "witness_batch_s": witness_s,
                        "check_witness_s": check_s, "inputs_s": inputs_s, "prove_s": prove_s,
                        "sample_verify_s": sample_verify_s, "busy_share": sum(prove_s) / wall,
                        "peak_device_gib": peak, "resident_device_gib": resident / 2**30,
                        "host_rss_gib_peak_sampled": rss["peak"], "all_verify": True, "verify_s": verify_s,
                        "queue_wait_s": [r.get("queue_wait_s") for r in recs],
                        "flagship_cli_running_at_start_end": beside,
                        "launches": {k[3:]: v for k, v in launches.items() if v}},
        }
        log(f"service, default prover: {len(names)} requests in {wall:.2f} s ({len(names) / wall:.3f} requests/s); "
            f"witness_batch {[round(x, 2) for x in witness_s]} s, check_witness {[round(x, 2) for x in check_s]} s, "
            f"prove {[round(x, 3) for x in prove_s]} s, busy share {sum(prove_s) / wall:.3f}, peak device "
            f"{peak:.2f} GiB, host RSS peak {rss['peak']:.2f} GiB; every proof verifies ({verify_s:.2f} s); phase 8's "
            f"`prove --circuit venmo` running at the sweep's start and end: {beside}")
        return line, launches
    finally:
        shutil.rmtree(d, ignore_errors=True)


def perf_stamp_check(svc, cache, n_requests, device):
    """Phase 9's exit stamp (the sweep's ledger entry): exactly one valid
    entry under the card's fingerprint key in `cache`'s ledger, source
    service, circuit venmo, its prove stage over every request."""
    from zkp2p_tpu_torch.utils import hostprof
    from zkp2p_tpu_torch.utils import perfledger as pl

    path = svc._perf_stamp()
    entries, refused = pl.load_entries(path, device=device)
    key = hostprof.fingerprint_key(device=device)
    if path != pl.ledger_path(cache, device) or len(entries) != 1 or any(refused.values()):
        raise AssertionError(f"phase 9's stamp: {path}, {len(entries)} valid entries, refused {refused}")
    e = entries[0]
    if (e["source"], e["circuit"], e["fingerprint_key"], e["stages"]["prove"]["n"]) != (
            "service", "venmo", key, n_requests):
        raise AssertionError(f"phase 9's stamp: {e}")
    fp = hostprof.host_fingerprint(device)
    log(f"sentry (b): phase 9's exit stamp, one valid entry under key {key} ({fp.get('device_name')}, "
        f"{fp.get('sm_count')} SMs): prove p50 {e['stages']['prove']['p50_ms']:.1f} ms over {n_requests} requests")
    return {"ledger": path, "key": key, "fingerprint": fp, "stages": e["stages"], "device": str(device)}


# -------------------------------------------------------------- phase 11


def read_json(path):
    """The JSON object in `path`, or None while it is missing or torn."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def fleet_start(build_dir):
    """Phase 11's start: `python -m zkp2p_tpu_torch --build-dir <build_dir>
    --circuit venmo --max-header 1024 --max-body 6400 fleet` of
    FLEET_WORKERS workers at batch FLEET_BATCH on an empty spool under
    FLEET_DIR, in a session of its own (so that a failure kills its
    workers with it), its output in FLEET_DIR/fleet.log and fleet.out.
    A thread notes when each worker's heartbeat first says `up` with a
    bound port, and samples the card's memory.used every second, until
    fleet_stop."""
    import os
    import shutil
    import threading

    d = os.path.abspath(FLEET_DIR)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    spool, state = os.path.join(d, "spool"), os.path.join(d, "state")
    from zkp2p_tpu_torch.pipeline.fleet_obs import discover_fleet_port, http_status_json

    cmd = [sys.executable, "-m", "zkp2p_tpu_torch", "--build-dir", build_dir, "--circuit", "venmo", "--max-header",
           "1024", "--max-body", "6400", "fleet", "--spool", spool, "--workers", str(FLEET_WORKERS), "--batch",
           str(FLEET_BATCH), "--fleet-dir", state, "--drain-timeout-s", str(FLEET_DRAIN_TIMEOUT_S),
           "--fleet-metrics-port", "auto", "--cache-dir", os.path.join(d, "cache")]
    files = (open(os.path.join(d, "fleet.log"), "w"), open(os.path.join(d, "fleet.out"), "w"))
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), stdout=files[1], stderr=files[0],
                            text=True, start_new_session=True)
    fh = dict(dir=d, spool=spool, state=state, cache=os.path.join(d, "cache"), proc=proc, files=files,
              t0=time.time(), ready={}, smi=[],
              stop=threading.Event(), plane=dict(port=None, polls=0, reasons={}, first_200=None, cycle_ms={},
                                                 unreachable=0))

    def watch():
        plane = fh["plane"]
        while not fh["stop"].wait(0.5):
            now = time.time()
            for i in range(FLEET_WORKERS):
                wid = f"w{i}"
                hb = read_json(os.path.join(state, wid + ".hb"))
                if wid not in fh["ready"] and hb and hb.get("state") == "up" and hb.get("port"):
                    fh["ready"][wid] = now
            # the plane's /status: each 503's reason, its first 200, each
            # cycle's milliseconds
            plane["port"] = plane["port"] or discover_fleet_port(state)
            body = http_status_json(f"http://127.0.0.1:{plane['port']}/status", timeout=2) if plane["port"] else None
            if plane["port"]:
                plane["polls"] += 1
            if body is None:
                plane["unreachable"] += bool(plane["port"])
            elif not body.get("ok"):
                reason = body.get("reason", "?")
                plane["reasons"][reason] = plane["reasons"].get(reason, 0) + 1
            elif plane["first_200"] is None:
                plane["first_200"] = now
            if body and body.get("scrape", {}).get("last_ms") is not None:
                plane["cycle_ms"][body["scrape"]["cycles"]] = body["scrape"]["last_ms"]
            if not fh["smi"] or now - fh["smi"][-1][0] >= 1.0:
                with contextlib.suppress(subprocess.SubprocessError, OSError, ValueError, IndexError):
                    fh["smi"].append((now, int(smi("memory.used").split()[0])))

    fh["watch"] = threading.Thread(target=watch, daemon=True)
    fh["watch"].start()
    log(f"phase 11: the fleet started ({' '.join(cmd[3:])})")
    return fh


def fleet_stop(fh):
    """Kill what is left of the fleet (its whole session) and end the
    watch thread."""
    import os
    import signal

    if fh["proc"].poll() is None:
        with contextlib.suppress(OSError):
            os.killpg(fh["proc"].pid, signal.SIGKILL)
        fh["proc"].wait()
    fh["stop"].set()
    fh["watch"].join()
    for f in fh["files"]:
        f.close()


def scrape(port, route):
    """(status, body) of GET 127.0.0.1:<port><route>."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def fleet_phase(torch, fh, vk, proof_launches, beside):
    """Phase 11 (the fleet line), on fleet_start's fleet `fh`: once both
    heartbeats say `up` with a bound port (status.json listing both up
    with their ports), each worker's device memory in use (its /snapshot)
    is read and SERVICE_EMAILS are spooled as demo requests; `beside()`
    (phase 2's untimed checks, phase 3) runs here while the workers prove
    them, and each proof is verified under phase 8's `vk` as it lands.
    Every request must end `done`; with the fleet still running, each
    worker's /healthz answers 200, /metrics 200 with its
    zkp2p_service_requests_total, /status 200 with its worker, fleet and
    the execution digest it logged, /snapshot armed with metrics the
    port's Registry.merge takes.  Then SIGTERM to the supervisor and
    fleet_drained's checks (`proof_launches`: phase 8's proof under the
    zkey's classes).  Returns (the fleet line, what `beside` returned)."""
    import os

    wids = [f"w{i}" for i in range(FLEET_WORKERS)]
    proc = fh["proc"]
    t0 = time.time()
    while len(fh["ready"]) < FLEET_WORKERS:
        if proc.poll() is not None:
            raise AssertionError(f"the fleet exited {proc.returncode} before its workers were ready")
        if time.time() - fh["t0"] > FLEET_READY_S:
            raise AssertionError(f"the fleet's workers were not ready {FLEET_READY_S} s after the spawn: {fh['ready']}")
        time.sleep(0.5)
    waited_s = time.time() - t0
    status = read_json(os.path.join(fh["state"], "status.json"))
    ports = {w: status["workers"][w]["port"] for w in wids}
    if any(status["workers"][w]["state"] != "up" or not ports[w] for w in wids):
        raise AssertionError(f"status.json before the requests: {status['workers']}")
    fleet_id = status["fleet_id"]

    # `top --once` once the plane answers 200, beside the requests
    t_top = time.time()
    while fh["plane"]["first_200"] is None and time.time() - t_top < 30:
        time.sleep(0.2)
    t_top = time.time()
    top = subprocess.Popen([sys.executable, "-m", "zkp2p_tpu_torch", "top", "--fleet-dir", fh["state"], "--once"],
                           cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    top_end = []  # its frame is a few hundred bytes: waiting does not block on the pipe
    threading.Thread(target=lambda: (top.wait(), top_end.append(time.time())), daemon=True).start()
    try:
        return fleet_serve(torch, fh, vk, proof_launches, beside, ports, fleet_id, waited_s, top, t_top, top_end)
    finally:
        stop([top])


def fleet_serve(torch, fh, vk, proof_launches, beside, ports, fleet_id, waited_s, top, t_top, top_end):
    """fleet_phase once both workers are ready and `top` has started: the
    requests, the endpoints, the plane, `top`'s frame, the drain."""
    import os
    import re
    import signal

    from zkp2p_tpu_torch.formats.proof_json import load, proof_from_json
    from zkp2p_tpu_torch.snark.groth16 import verify
    from zkp2p_tpu_torch.utils.metrics import Registry

    wids = [f"w{i}" for i in range(FLEET_WORKERS)]
    proc, spool = fh["proc"], fh["spool"]
    idle = {}
    for w in wids:
        snap = json.loads(scrape(ports[w], "/snapshot")[1])
        idle[w] = max(m["value"] for m in snap["metrics"] if m["name"] == "zkp2p_hbm_bytes_in_use")
    torch.cuda.empty_cache()
    names = [f"f{i}" for i in range(len(SERVICE_EMAILS))]
    t_req = time.time()
    write_requests(spool, {n: demo_payload(*e) for n, e in zip(names, SERVICE_EMAILS)})
    beside_s, beside_out = wall_s(torch, beside)
    verify_s, verified = 0.0, set()
    while len(verified) < len(names):
        for n in names:
            base = os.path.join(spool, n)
            if os.path.exists(base + ".error.json"):
                raise AssertionError(f"the fleet ended {n} in an error")
            if n not in verified and os.path.exists(base + ".proof.json"):
                t1 = time.perf_counter()
                if not verify(vk, proof_from_json(load(base + ".proof.json")),
                              [int(v) for v in load(base + ".public.json")]):
                    raise AssertionError(f"{base}.proof.json does not verify")
                verify_s += time.perf_counter() - t1
                verified.add(n)
        if proc.poll() is not None:
            raise AssertionError(f"the fleet exited {proc.returncode} with requests open")
        if time.time() - t_req > FLEET_PROVE_S:
            raise AssertionError(f"the fleet did not end {len(names)} requests in {FLEET_PROVE_S} s")
        time.sleep(0.2)

    # the plane: FLEET_QUIET_CYCLES more scrape cycles once every request
    # has ended
    plane = fh["plane"]
    cycles0, t_quiet = max(plane["cycle_ms"], default=0), time.time()
    while max(plane["cycle_ms"], default=0) < cycles0 + FLEET_QUIET_CYCLES:
        if time.time() - t_quiet > 30:
            raise AssertionError(f"the fleet plane's scrape cycles stopped at {max(plane['cycle_ms'], default=0)}")
        time.sleep(0.2)

    # the four endpoints of each worker, the fleet still running
    with open(os.path.join(fh["dir"], "fleet.out")) as f:
        digests = dict(re.findall(r"\[service (w\d+)\] preflight: backend=cuda execution_digest=(\w+)", f.read()))
    snaps = {}
    for w in wids:
        code, body = scrape(ports[w], "/healthz")
        if code != 200 or json.loads(body) != {"ok": True}:
            raise AssertionError(f"{w} /healthz: {code} {body}")
        code, body = scrape(ports[w], "/metrics")
        if code != 200 or 'zkp2p_service_requests_total{state="done"}' not in body:
            raise AssertionError(f"{w} /metrics: {code}, no done requests in {len(body)} bytes")
        code, body = scrape(ports[w], "/status")
        st = json.loads(body)
        if code != 200 or not st["ok"] or (st.get("worker"), st.get("fleet")) != (w, fleet_id) \
                or st["execution_digest"] != digests.get(w):
            raise AssertionError(f"{w} /status: {code} {body[:300]} (logged digest {digests.get(w)})")
        code, body = scrape(ports[w], "/snapshot")
        snap = snaps[w] = json.loads(body)
        if code != 200 or not snap["armed"] or snap.get("worker") != w:
            raise AssertionError(f"{w} /snapshot: {code} {body[:300]}")
        Registry().merge(snap["metrics"])
    status = read_json(os.path.join(fh["state"], "status.json"))
    if any(status["workers"][w]["state"] != "up" or status["workers"][w]["port"] != ports[w] for w in wids):
        raise AssertionError(f"status.json with the fleet running: {status['workers']}")
    plane_line = plane_checks(fh, snaps, status)
    out, err = top.communicate(timeout=60)
    top_s = top_end[0] - t_top if top_end else None
    up = {w for w in wids if re.search(rf"^{w} +up ", out, re.M)}
    if top.returncode != 0 or f"fleet {fleet_id}  READY" not in out or up != set(wids):
        raise AssertionError(f"top --once: exit {top.returncode}, workers up {sorted(up)}:\n{out}\n{err[-2000:]}")
    plane_line.update(top_s=top_s, top_frame=out.splitlines())

    fh["t_term"] = time.time()
    os.kill(proc.pid, signal.SIGTERM)
    with contextlib.suppress(subprocess.TimeoutExpired):
        proc.wait(timeout=SERVICE_DRAIN_S + FLEET_DRAIN_TIMEOUT_S)
    fh["t_exit"] = time.time()
    line = {
        "shape": "venmo 1024/6400, phase 8's zkey and vkey; synthetic signed emails as demo payloads",
        "command": " ".join(proc.args[3:]), "workers": FLEET_WORKERS, "batch": FLEET_BATCH,
        "requests": len(names), "names": names, "fleet_id": fleet_id, "t_req": t_req, "all_verify": True,
        "verify_s": verify_s, "waited_for_ready_after_phase_2_s": waited_s,
        "beside": "phase 2's K15/K16 bitwise checks, phase 3",
        "beside_s": beside_s, "ports": ports, "idle": idle, "digests": digests, "plane": plane_line,
    }
    return fleet_drained(fh, line, proof_launches), beside_out


def prom_samples(text):
    """({family: kind}, {(sample name, label string): value}) of
    Prometheus text."""
    import re

    kinds, samples = {}, {}
    for ln in text.splitlines():
        m = re.match(r"# TYPE (\S+) (\S+)$", ln)
        if m:
            kinds[m.group(1)] = m.group(2)
            continue
        m = re.match(r"([a-zA-Z_:][\w:]*)(?:\{(.*)\})? (\S+)$", ln)
        if m:
            samples[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return kinds, samples


def label_string(labels: dict) -> str:
    """A label set as the exposition writes it (keys sorted)."""
    return ",".join('%s="%s"' % (k, str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n"))
                    for k, v in sorted(labels.items()))


def plane_checks(fh, snaps, status):
    """Phase 11's fleet plane, the requests ended and FLEET_QUIET_CYCLES
    cycles since: its /metrics holds every counter of the workers'
    /snapshot (`snaps`) summed, label for label (the request counters
    among them), every histogram's count summed, every gauge labelled by
    worker, no merge refused; its /status answers 200 with the merged
    window's n the workers' sum and no alert; status.json names its port.
    Returns the plane's figures: its /status before the workers were armed
    (503s and their reasons), the seconds from the second worker ready to
    its first 200, its scrape cycles (ok, and the workers' scrapes that
    failed) and a cycle's median and maximum ms."""
    from zkp2p_tpu_torch.pipeline.fleet_obs import http_status_json

    plane = fh["plane"]
    port = plane["port"]
    code, text = scrape(port, "/metrics")
    body = http_status_json(f"http://127.0.0.1:{port}/status")
    if code != 200 or not body or not body.get("ok"):
        raise AssertionError(f"the fleet plane: /metrics {code}, /status {body}")
    kinds, samples = prom_samples(text)
    want_counters, want_counts = {}, {}
    for snap in snaps.values():
        for m in snap["metrics"]:
            key = (m["name"], label_string(m["labels"]))
            if m["kind"] == "counter":
                want_counters[key] = want_counters.get(key, 0.0) + m["value"]
            elif m["kind"] == "histogram":
                key = (m["name"] + "_count", key[1])
                want_counts[key] = want_counts.get(key, 0) + m["count"]
    fleet_fam = [f for f in kinds if f.startswith("zkp2p_fleet_")]
    counters = {k: v for k, v in samples.items() if kinds.get(k[0]) == "counter" and k[0] not in fleet_fam}
    counts = {k: v for k, v in samples.items() if k[0].endswith("_count") and kinds.get(k[0][:-6]) == "histogram"
              and k[0][:-6] not in fleet_fam}
    requests = {k[1]: v for k, v in counters.items() if k[0] == "zkp2p_service_requests_total"}
    if counters != want_counters or counts != want_counts or not requests:
        raise AssertionError(f"the plane's counters {counters} / histogram counts {counts} against the workers' sums "
                             f"{want_counters} / {want_counts}")
    gauges = [k for k in samples if kinds.get(k[0]) == "gauge" and k[0] not in fleet_fam]
    labelled = {w for w in snaps if any(f'worker="{w}"' in k[1] for k in gauges)}
    if labelled != set(snaps) or any("worker=" not in k[1] for k in gauges):
        raise AssertionError(f"the plane's gauges: {gauges}")
    refusals = sum(v for k, v in samples.items() if k[0] == "zkp2p_fleet_merge_refusals_total")
    slo_n = sum(snap["slo_window"]["n"] for snap in snaps.values())
    if refusals or body["slo"]["n"] != slo_n or body["alerts"] or status.get("metrics_port") != port:
        raise AssertionError(f"the plane: {refusals} refusals, merged n {body['slo']['n']} against {slo_n}, alerts "
                             f"{body['alerts']}, status.json port {status.get('metrics_port')} against {port}")
    second_ready = max(fh["ready"].values())
    if not plane["reasons"] or plane["first_200"] is None or plane["first_200"] < second_ready - 1.0:
        raise AssertionError(f"the plane's /status: 503 reasons {plane['reasons']}, first 200 at "
                             f"{plane['first_200']}, the second worker ready at {second_ready}")
    ms = list(plane["cycle_ms"].values())
    return {"port": port, "scrape_s": body["scrape"]["interval_s"], "cycles": body["scrape"]["cycles"],
            "worker_scrape_failures": sum(v for k, v in samples.items()
                                          if k[0] == "zkp2p_fleet_scrape_failures_total"),
            "cycle_ms_median": statistics.median(ms), "cycle_ms_max": max(ms), "cycles_timed": len(ms),
            "status_503_reasons": plane["reasons"], "status_unreachable_polls": plane["unreachable"],
            "first_200_after_second_ready_s": plane["first_200"] - second_ready,
            "counters_match": True, "requests_total": requests, "merged_slo_n": slo_n, "merge_refusals": 0,
            "alerts": body["alerts"], "histograms": len(counts), "counters": len(counters)}


def domain_table_launches(log_m: int) -> int:
    """K1's launches for the tables a process builds at its first proof on
    a 2^log_m domain, once (ops/ntt.py: `domain`'s twiddles and inverse
    twiddles, 2^(log_m - 1) powers each by log_m - 1 doublings, and
    `_coset_factor`'s 2^log_m powers by log_m doublings and a product by
    1/m)."""
    return 2 * (log_m - 1) + log_m + 1


def fleet_drained(fh, line, proof_launches):
    """Phase 11's drain, checked once the supervisor has exited or the
    wait for it has timed out: exit 0 within SERVICE_DRAIN_S plus the drain
    timeout of the SIGTERM, no escalation, no claim left, both workers
    done; every request `done` exactly once in the records, both workers
    among them, each record and time-series line naming its worker and
    the fleet; each worker drained with its logged launches exactly its
    chunks' (`proof_launches`, phase 8's proof under the zkey's classes,
    a chunk: K1 4 + B) and its domain tables' (domain_table_launches);
    one perf-ledger stamp a worker in the fleet's own cache.  Completes and returns the fleet line: requests/s, each worker's ready
    seconds, done count, chunks, witness_batch, prove and sample verify
    seconds, busy share, idle and peak device memory, the card's peak
    memory.used."""
    import os
    import re

    wids = [f"w{i}" for i in range(FLEET_WORKERS)]
    proc, spool, names, fleet_id = fh["proc"], fh["spool"], line.pop("names"), line.pop("fleet_id")
    rc = proc.poll()
    if rc is None:
        raise AssertionError(f"the fleet did not exit within {SERVICE_DRAIN_S + FLEET_DRAIN_TIMEOUT_S} s of SIGTERM")
    drain_s = fh["t_exit"] - fh["t_term"]
    fh["stop"].set()
    fh["watch"].join()
    with open(os.path.join(fh["dir"], "fleet.log")) as f:
        stderr = f.read()
    for text in stderr.splitlines():
        if "fleet:" in text or "exiting" in text or "key on" in text or "constraints=" in text:
            log(f"  | {text}")
    status = read_json(os.path.join(fh["state"], "status.json"))
    left = [f for f in os.listdir(spool) if f.endswith(".claim")]
    if rc != 0 or status["escalations"] or left or any(status["workers"][w]["state"] != "done" for w in wids):
        raise AssertionError(f"the fleet's drain: exit {rc}, escalations {status['escalations']}, claims left {left}, "
                             f"workers {status['workers']}")
    # the plane's last view in status.json: its port, no alert ever fired
    fired = {k: v["fired_count"] for k, v in status.get("alerts_state", {}).items() if v["fired_count"]}
    if status.get("metrics_port") != line["plane"]["port"] or "alerts_state" not in status or fired:
        raise AssertionError(f"the plane's last status.json: port {status.get('metrics_port')}, alerts fired {fired}")
    line["plane"].update(cycles_final=status["scrape"]["cycles"],
                         cycles_failed=stderr.count("fleet scrape cycle failed"))

    recs = sink_records(spool, "request")
    done = sorted(r["request_id"] for r in recs if r["state"] == "done")
    if done != names or any(r.get("fleet") != fleet_id or r.get("worker") not in wids for r in recs):
        raise AssertionError(f"the fleet's records: done {done}")
    by = {w: [r for r in recs if r["worker"] == w] for w in wids}
    if not all(by.values()):
        raise AssertionError(f"a worker ended no request: {({w: len(v) for w, v in by.items()})}")
    ts = sink_records(spool, "timeseries")
    if {r.get("worker") for r in ts} != set(wids) or any(r.get("fleet") != fleet_id for r in ts):
        raise AssertionError(f"time-series lines of {sorted({str(r.get('worker')) for r in ts})}")
    logged = {w: (why, json.loads(launches)) for w, why, launches in
              re.findall(r"service (w\d+) exiting \((\w+)\): launches (\{[^{}]*\})", stderr)}
    chunks = {w: sum(r.get("batch_index") == 0 for r in by[w]) for w in wids}
    for w in wids:
        want = {k[3:]: v * chunks[w] for k, v in proof_launches.items() if v}
        want["mont_mul"] = 4 * chunks[w] + len(by[w]) + domain_table_launches(VENMO["log_m"])
        if logged.get(w) != ("drained", want):
            raise AssertionError(f"{w} logged {logged.get(w)}; drained with {chunks[w]} chunks' {want} expected")
    # the perf sentry in each worker: its ledger in this run's fresh cache
    # (no budgets, so no overrun), one exit stamp a worker under the card's key
    from zkp2p_tpu_torch.utils import perfledger

    stamps, refused = perfledger.load_entries(perfledger.ledger_path(fh["cache"], "cuda"), device="cuda")
    if len(stamps) != FLEET_WORKERS or any(refused.values()) or any(
            (e["source"], e["circuit"]) != ("service", "venmo") for e in stamps):
        raise AssertionError(f"the fleet's ledger: {len(stamps)} valid stamps, refused {refused}")
    stages = sink_records(spool, "stage")
    pid_of = {r["pid"]: r["worker"] for r in recs}
    t_req = line.pop("t_req")
    wall = max(r["ts"] for r in recs) - t_req

    def spans(w, stage):
        return [r["ms"] / 1e3 for r in stages if r["stage"] == stage and pid_of.get(r["pid"]) == w]

    workers = {}
    for w in wids:
        peaks = [r["hbm_peak_bytes"] for r in by[w] + [r for r in ts if r["worker"] == w] if r.get("hbm_peak_bytes")]
        workers[w] = {"ready_s": fh["ready"][w] - fh["t0"], "port": line["ports"][w], "done": len(by[w]),
                      "chunks": chunks[w], "witness_batch_s": spans(w, "service/witness_batch"),
                      "prove_s": spans(w, "service/prove"), "sample_verify_s": spans(w, "service/verify"),
                      "busy_share": sum(spans(w, "service/prove")) / wall,
                      "idle_device_gib": line["idle"][w] / 2**30, "peak_device_gib": max(peaks) / 2**30,
                      "execution_digest": line["digests"][w], "launches": logged[w][1]}
    for k in ("ports", "idle", "digests"):
        line.pop(k)
    smi_all = [m for _, m in fh["smi"]]
    smi_run = [m for t, m in fh["smi"] if t_req <= t <= fh["t_exit"]]
    line.update({"wall_s": wall, "requests_per_s": len(names) / wall, "drain_s": drain_s, "exit": rc,
                 "escalations": status["escalations"], "claims_left": 0, "timeseries_lines": len(ts),
                 "ledger_stamps": len(stamps),
                 "card_memory_used_mib_peak": {"proving": max(smi_run, default=None),
                                               "from_spawn": max(smi_all, default=None)},
                 "per_worker": workers})
    log(f"fleet: {len(names)} requests in {wall:.2f} s ({len(names) / wall:.3f} requests/s) by "
        + ", ".join(f"{w} {v['done']} ({v['chunks']} chunks, busy {v['busy_share']:.3f}, peak "
                    f"{v['peak_device_gib']:.2f} GiB, idle {v['idle_device_gib']:.2f}, ready {v['ready_s']:.1f} s)"
                    for w, v in workers.items())
        + f"; card memory.used peak {line['card_memory_used_mib_peak']} MiB; drained {drain_s:.2f} s after SIGTERM, "
        f"exit 0, no escalation; endpoints answered; every proof verifies ({line['verify_s']:.2f} s)")
    pl = line["plane"]
    log(f"fleet plane on :{pl['port']}: 503 {sum(pl['status_503_reasons'].values())} polls "
        f"({', '.join(pl['status_503_reasons'])}), 200 {pl['first_200_after_second_ready_s']:.2f} s after the second "
        f"worker was ready; {pl['cycles_final']} cycles, {pl['cycles_failed']} failed, "
        f"{pl['worker_scrape_failures']:g} worker scrapes failed; a cycle {pl['cycle_ms_median']:.2f} ms median, "
        f"{pl['cycle_ms_max']:.2f} max; {pl['counters']} counters and {pl['histograms']} histogram counts equal to "
        f"the workers' sums, requests {pl['requests_total']}; merged SLO n {pl['merged_slo_n']}; no alert; "
        f"top --once {pl['top_s']:.2f} s")
    return line


# -------------------------------------------------------------- phase 12


def chaos_start():
    """Phase 12's start: `python -m zkp2p_tpu_torch.tools.chaos` with
    CHAOS_ARGS (the toy world on the card, the reference's default fault
    plan, two fleet workers) in a session of its own, its output in
    CHAOS_DIR/chaos.log and its report in CHAOS_DIR/report.json; a thread
    samples the card's memory.used every second."""
    import os
    import shutil

    d = os.path.abspath(CHAOS_DIR)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    cmd = [sys.executable, "-m", "zkp2p_tpu_torch.tools.chaos", *CHAOS_ARGS, "--spool", os.path.join(d, "spool"),
           "--report", os.path.join(d, "report.json")]
    out = open(os.path.join(d, "chaos.log"), "w")
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), stdout=out,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    ch = dict(dir=d, proc=proc, out=out, t0=time.time(), smi=[], stop=threading.Event())

    def sample():
        while not ch["stop"].wait(1.0):
            with contextlib.suppress(subprocess.SubprocessError, OSError, ValueError, IndexError):
                ch["smi"].append(int(smi("memory.used").split()[0]))

    ch["sampler"] = threading.Thread(target=sample, daemon=True)
    ch["sampler"].start()
    log(f"phase 12: chaos started ({' '.join(cmd[3:])})")
    return ch


def chaos_stop(ch):
    """Kill what is left of the chaos run (its whole session) and end the
    sampler; idempotent."""
    import os
    import signal

    if ch["proc"].poll() is None:
        with contextlib.suppress(OSError):
            os.killpg(ch["proc"].pid, signal.SIGKILL)
        ch["proc"].wait()
    ch["stop"].set()
    ch["sampler"].join()
    ch["out"].close()


def chaos_finish(ch, beside):
    """Phase 12 (the chaos line), once the harness has exited (within
    CHAOS_TIMEOUT_S of its start): exit 0 and no violation; every request
    terminal, each proof verified; a SIGKILL landed on a worker holding a
    claim, a claim holder drained with its claims done, the supervisor
    SIGKILLed (rc -9) and its replacement clean (rc 0); the plane's request
    counters equal to the live workers' sum under the faults, and the
    restart storm parked its worker (rc 4) and fired.  Recorded: requests,
    states, the restarts of both supervisors' workers, the plane's parity,
    seconds, the card's peak memory.used, each worker's logged launches."""
    import os
    import re

    try:
        ch["proc"].wait(timeout=max(1.0, CHAOS_TIMEOUT_S - (time.time() - ch["t0"])))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the chaos run did not end within {CHAOS_TIMEOUT_S} s") from None
    seconds = time.time() - ch["t0"]
    rc = ch["proc"].returncode
    chaos_stop(ch)
    with open(os.path.join(ch["dir"], "chaos.log")) as f:
        text = f.read()
    for ln in text.splitlines():
        if ln.startswith("[chaos]") or "exiting" in ln or "ALERT" in ln or "PARKED" in ln:
            log(f"  | {ln}")
    report = read_json(os.path.join(ch["dir"], "report.json"))
    if rc != 0 or not report or report["violations"]:
        raise AssertionError(f"chaos: exit {rc}, violations {report and report['violations']}:\n{text[-4000:]}")
    plane, storm = report["plane"], report["plane"]["restart_storm"]
    fired = storm["alerts_state"]["restart_storm"]["fired_count"]
    if not report["killed_worker"] or not report["drained_worker"] or report["supervisor_rcs"][0] != -9 \
            or report["supervisor_rcs"][-1] != 0 or plane["parity"]["fleet"] != plane["parity"]["worker_sum"] \
            or plane["parity"]["workers_scraped"] != 2 or storm["supervisor_rc"] != 4 or not fired \
            or report["states"].get("open", 0) or report["proofs_verified"] != report["states"].get("done"):
        raise AssertionError(f"chaos report: {json.dumps(report)[:3000]}")
    restarts = {}
    for sub in (".fleet1", ".fleet2"):
        st = read_json(os.path.join(ch["dir"], "spool", sub, "status.json")) or {}
        restarts[sub[1:]] = sum(w.get("restarts", 0) for w in st.get("workers", {}).values())
    launches = [{"worker": wid, "why": why, "launches": json.loads(js)} for wid, why, js in
                re.findall(r"\[chaos-worker \d+\] (\S+) exiting \((\w+)\): launches (\{[^{}]*\})", text)]
    if not launches or not all(v["launches"] for v in launches):
        raise AssertionError(f"chaos workers' launches: {launches}")
    line = {"shape": "the toy circuit out = (x*y)^2 set up on the card, seed 'chaos'", "command": " ".join(
                ch["proc"].args[3:]), "requests": report["requests"], "states": report["states"],
            "proofs_verified": report["proofs_verified"], "killed_worker_held_claim": report["killed_worker"],
            "drained_claims": report["drained_claims"], "restarts": restarts,
            "supervisor_rcs": report["supervisor_rcs"], "faults": report["faults"],
            "plane_parity": plane["parity"], "restart_storm": {"rc": storm["supervisor_rc"], "fired": fired},
            "violations": report["violations"], "seconds": seconds, "beside": beside,
            "card_memory_used_mib_peak": max(ch["smi"], default=None), "worker_launches": launches}
    log(f"chaos: {report['requests']} requests {report['states']}, {report['proofs_verified']} verified; SIGKILL "
        f"{report['killed_worker']} (held a claim), drained {report['drained_worker']} "
        f"({len(report['drained_claims'])} claims done), supervisor {report['supervisor_rcs']}, restarts {restarts}; "
        f"plane parity {plane['parity']['fleet']}; restart_storm fired {fired} (rc {storm['supervisor_rc']}); "
        f"{seconds:.1f} s beside {beside}; memory.used peak {line['card_memory_used_mib_peak']} MiB; "
        f"{len(launches)} workers logged launches")
    return line


# -------------------------------------------------------------- phase 13


def sched_fleet_start():
    """Phase 13 (b)'s start: the load generator's toy fleet
    (SCHED_FLEET_ARGS: one chaos worker on the card under `fleet
    --workers-min 1 --workers-max 2 --sched adaptive`, a spike trace) in a
    session of its own, from the end of phase 1's kernel build beside
    chaos and phase 8, then, in the same session, the chaos harness's
    invariant over its spool (SCHED_FLEET_CHECK: every proof verified on
    the host, off this process's thread); the output in
    SCHED_DIR/fleet/loadgen.log, the capacity JSON in capacity.json, the
    invariant's report in report.json."""
    import os
    import shutil

    d = os.path.abspath(os.path.join(SCHED_DIR, "fleet"))
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    cmd = [sys.executable, "-c", SCHED_FLEET_CHECK, os.path.join(d, "spool"), os.path.join(d, "report.json"),
           *SCHED_FLEET_ARGS, "--spool", os.path.join(d, "spool"), "--out", os.path.join(d, "capacity.json")]
    out = open(os.path.join(d, "loadgen.log"), "w")
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), stdout=out,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    log(f"phase 13 (b): the load generator's fleet started (python -m zkp2p_tpu_torch.tools.loadgen "
        f"{' '.join(cmd[5:])})")
    return dict(dir=d, proc=proc, out=out, t0=time.time())


def sched_fleet_stop(lg):
    """Kill what is left of the load generator's run (its whole session);
    idempotent."""
    import os
    import signal

    if lg["proc"].poll() is None:
        with contextlib.suppress(OSError):
            os.killpg(lg["proc"].pid, signal.SIGKILL)
        lg["proc"].wait()
    lg["out"].close()


def sched_fleet_finish(lg, beside):
    """Phase 13 (b), once the load generator has exited (within
    SCHED_FLEET_TIMEOUT_S of its start): exit 0; every request terminal
    exactly once, each proof verifying under the toy key's VK (the
    session's ``chaos.check_invariants``), all of them done; the fleet grown to 2
    on the spike and retired back to 1 after it (the capacity JSON's
    fleet_sched events and status.json's sched block: up to 2, then down
    to 1 of the same worker), no worker restarted or parked, no drain
    escalated.  Recorded: served-under-SLO a segment, the scale events'
    seconds from the ramp's start, each worker's logged launches."""
    import glob
    import os
    import re

    try:
        lg["proc"].wait(timeout=max(1.0, SCHED_FLEET_TIMEOUT_S - (time.time() - lg["t0"])))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the load generator's fleet did not end within {SCHED_FLEET_TIMEOUT_S} s") from None
    seconds = time.time() - lg["t0"]
    rc = lg["proc"].returncode
    sched_fleet_stop(lg)
    with open(os.path.join(lg["dir"], "loadgen.log")) as f:
        text = f.read()
    for ln in text.splitlines():
        if "autoscale" in ln or "scaled down" in ln or "exiting" in ln or "[loadgen]" in ln:
            log(f"  | {ln}")
    cap = read_json(os.path.join(lg["dir"], "capacity.json"))
    report = read_json(os.path.join(lg["dir"], "report.json"))
    if rc != 0 or not cap or not report:
        raise AssertionError(f"the load generator's fleet exited {rc}:\n{text[-4000:]}")
    spool = os.path.join(lg["dir"], "spool")
    offered = sum(s["offered"] for s in cap["steps"])
    if report["violations"] or report["states"] != {"done": offered} or report["proofs_verified"] != offered:
        raise AssertionError(f"phase 13 (b)'s spool: {report} ({offered} offered)")
    status = [read_json(p) for p in glob.glob(os.path.join(spool, ".fleet-*", "status.json"))]
    if len(status) != 1 or not status[0]:
        raise AssertionError(f"phase 13 (b)'s status.json: {status}")
    status = status[0]
    # grown on the spike (after the trace's first segment), retired after
    # it: up to 2, then down to 1 (alternating, should it grow again)
    spike_at = float(SCHED_FLEET_ARGS[SCHED_FLEET_ARGS.index("--trace") + 1].split("x")[1].split(",")[0])
    for name, block in (("capacity JSON", cap.get("fleet_sched") or {}), ("status.json", status.get("sched") or {})):
        events = block.get("events") or []
        steps = [(e["direction"], e["workers"]) for e in events]
        if not steps or steps != [("up", 2), ("down", 1)] * (len(steps) // 2) or len(steps) % 2 \
                or events[0]["ts"] < cap["ts"] + spike_at or events[0]["worker"] != events[1]["worker"]:
            raise AssertionError(f"the {name}'s scale events {events}: up to 2 on the spike (from {spike_at:g} s into "
                                 "the ramp) and down to 1 after it expected")
    workers = status["workers"]
    if any(w.get("restarts") or w["state"] == "parked" for w in workers.values()) or status["escalations"]:
        raise AssertionError(f"phase 13 (b)'s workers: {workers}, escalations {status['escalations']}")
    events = [{**e, "s_from_ramp": round(e["ts"] - cap["ts"], 3)} for e in cap["fleet_sched"]["events"]]
    launches = [{"worker": wid, "why": why, "launches": json.loads(js)} for wid, why, js in
                re.findall(r"\[chaos-worker \d+\] (\S+) exiting \((\w+)\): launches (\{[^{}]*\})", text)]
    line = {"shape": "the toy circuit out = (x*y)^2 set up on the card, seed 'chaos'; chaos workers under `fleet`",
            "command": "python -m zkp2p_tpu_torch.tools.loadgen " + " ".join(lg["proc"].args[5:]), "trace": cap["trace"], "objective_p95_s": cap["objective_p95_s"],
            "sched": cap["sched"], "requests": offered, "states": report["states"],
            "served_under_slo": [s["served_under_slo"] for s in cap["steps"]],
            "p95_s": [s["p95_s"] for s in cap["steps"]], "attainment": [s["attainment"] for s in cap["steps"]],
            "mean_batch_fill": cap.get("mean_batch_fill"), "scale_events": events,
            "fleet_slo": cap.get("fleet_slo"), "alerts_fired": (cap.get("fleet_alerts") or {}).get("fired"),
            "workers": {wid: {"state": w["state"], "last_rc": w["last_rc"], "restarts": w["restarts"]}
                        for wid, w in workers.items()},
            "worker_launches": launches, "seconds": seconds, "beside": beside}
    log(f"sched fleet: {offered} requests {report['states']}, {report['proofs_verified']} verified; served under "
        f"the {cap['objective_p95_s']:g} s objective {line['served_under_slo']} of "
        f"{[s['offered'] for s in cap['steps']]}; scale events "
        + ", ".join(f"{e['direction']} {e['worker']} -> {e['workers']} at {e['s_from_ramp']:.1f} s ({e['reason']})"
                    for e in events)
        + f"; {seconds:.1f} s beside {beside}; {len(launches)} workers logged launches")
    return line


def sched_phase(torch, fl, service_line, sentry, device):
    """Phase 13 (a): the adaptive scheduler at full width, on phase 8's
    resident key (`fl`).  A ProvingService with sched="adaptive",
    batch_size SCHED_BATCH, seeded with the card's cost measured earlier in
    this run (amort_points {1: phase 8's warm prove_gpu seconds, 4: phase
    9's median prove seconds a chunk}), replays phase 8's four witnesses
    over six requests: one interactive, three bulk, one whose deadline
    has passed, one bulk whose deadline (unexpired) is half of what the
    seeded model predicts for its place.  The interactive request must
    be proved alone in the first batch and the three bulk in one batch
    after it, the other two end error-shed with `sched` in their error
    before any witness work; every done record carries
    batch_size_target; one sched line reports backlog 6, shed 2, lanes
    {interactive 1, bulk 3}; zkp2p_sched_decisions_total counts 2 sheds,
    2 batches, 1 lane; every proof verifies under phase 8's vkey; the
    sweep launches exactly two chunks' worth.  Recorded: the controller's
    model_scale after the first observed batch (and the observed batch
    seconds over the seed), the wall clock, each batch's witness check
    and prove seconds.  The service runs with flame=True (a capture over
    one sweep) on the seeded ledger of `sentry` (sentry_seed), which
    sentry_check then holds.  Returns (the line, the sweep's launches)."""
    import os
    import shutil

    from zkp2p_tpu_torch.ops import cuda_build
    from zkp2p_tpu_torch.pipeline.sched import AmortModel
    from zkp2p_tpu_torch.pipeline.service import ProvingService
    from zkp2p_tpu_torch.utils import trace as tr
    from zkp2p_tpu_torch.utils.metrics import REGISTRY

    d = os.path.abspath(os.path.join(SCHED_DIR, "in_process"))
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    cs, wits, n_pub = fl["cs"], fl["wits"], fl["cs"].num_public
    points = {1: fl["warm_prove_s"], SCHED_BATCH: statistics.median(service_line["default"]["prove_s"])}
    try:
        spool = os.path.join(d, "spool")
        svc = ProvingService(cs, fl["key"], fl["vk"], lambda p: wits[int(p["w"])], lambda w: list(w[1 : n_pub + 1]),
                             batch_size=SCHED_BATCH, sched="adaptive", amort_points=points, device=device,
                             circuit="venmo", flame=True, flame_capture_n=1, cache_dir=sentry["cache_dir"])
        ctl = svc._sched_controller()
        observed = []
        observe = ctl.observe_batch

        def observe_batch(fill, seconds):
            scale = observe(fill, seconds)
            observed.append({"fill": fill, "s": seconds, "over_seed": seconds / ctl.amort.batch_s(fill),
                             "model_scale": scale})
            return scale

        ctl.observe_batch = observe_batch
        # the tight request sits at kept position 4 (after the interactive
        # and the three bulk): the seeded model's optimistic completion
        # there, of which its deadline is half
        predicted = min(-(-5 // s) * AmortModel(points).batch_s(s) for s in range(1, SCHED_BATCH + 1))
        write_requests(spool, {"a_inter": {"w": 0, "priority": "interactive"},
                               "b_late": {"w": 1, "deadline_s": 5}})
        past = time.time() - 60
        os.utime(os.path.join(spool, "b_late.req.json"), (past, past))
        write_requests(spool, {f"c_bulk{i}": {"w": i} for i in (1, 2, 3)})
        write_requests(spool, {"d_tight": {"w": 2, "priority": "bulk", "deadline_s": predicted / 2}})
        check_s = []
        real_check = cs.check_witness

        def timed_check(w):
            t0 = time.perf_counter()
            real_check(w)
            check_s.append(time.perf_counter() - t0)

        kinds = ("shed", "batch", "lane")
        before = {k: REGISTRY.counter("zkp2p_sched_decisions_total", {"kind": k}).value for k in kinds}
        overruns_before = overrun_counts()
        tr.reset()
        cuda_build.reset_launches()
        with patched([(cs, "check_witness", timed_check)]):
            wall, stats = wall_s(torch, lambda: svc.process_dir(spool))
        launches = dict(cuda_build.LAUNCHES)
        spans = tr.records()
        decisions = {k: REGISTRY.counter("zkp2p_sched_decisions_total", {"kind": k}).value - v
                     for k, v in before.items()}
        if stats != {"done": 4, "error-bad-input": 0, "error-failed-to-prove": 0, "error-deadline-exceeded": 0,
                     "error-shed": 2}:
            raise AssertionError(f"the adaptive sweep ended {stats}")
        recs = {r["request_id"]: r for r in sink_records(spool, "request")}
        done = ["a_inter", "c_bulk1", "c_bulk2", "c_bulk3"]
        slots = {n: (recs[n]["state"], recs[n].get("batch_n"), recs[n].get("batch_size_target")) for n in done}
        if slots != {"a_inter": ("done", 1, 1), **{n: ("done", 3, 3) for n in done[1:]}}:
            raise AssertionError(f"the adaptive sweep's batches: {slots}")
        if recs["a_inter"]["t_claim"] >= min(recs[n]["t_claim"] for n in done[1:]) or recs["a_inter"]["ts"] >= min(
                recs[n]["ts"] for n in done[1:]):
            raise AssertionError("the interactive request was not claimed and proved first")
        for n in ("b_late", "d_tight"):
            if recs[n]["state"] != "error-shed" or "sched:" not in recs[n]["error"] or recs[n].get("spans"):
                raise AssertionError(f"{n}: {recs[n]}")
        lines = sink_records(spool, "sched")
        if len(lines) != 1 or (lines[0]["backlog"], lines[0]["shed"], lines[0]["lanes"]) != (
                6, 2, {"interactive": 1, "bulk": 3}):
            raise AssertionError(f"the sched lines: {lines}")
        if decisions != {"shed": 2, "batch": 2, "lane": 1}:
            raise AssertionError(f"zkp2p_sched_decisions_total moved {decisions}")
        want = {"fr_ntt_pass": 6, "fr_matvec": 2, "signed_recode": 2, **CLASSED_PROOF_LAUNCHES}
        got = {k: launches["zk_" + k] for k in want}
        if got != {k: 2 * v for k, v in want.items()}:
            raise AssertionError(f"the adaptive sweep's launches {got}, two chunks of {want} expected")
        missing = [k for k in PATH_KERNELS["batch"] if not launches["zk_" + k]]
        stray = [k for k in NOT_ON_JACOBIAN if launches["zk_" + k]]
        if missing or stray:
            raise AssertionError(f"the adaptive sweep launched {launches}: missing {missing}, stray {stray}")
        verify_s = verify_spool(fl["vk"], spool, done)
        if len(observed) != 2 or [o["fill"] for o in observed] != [1, 3]:
            raise AssertionError(f"the controller observed {observed}")
        prove_s = [r["ms"] / 1e3 for r in spans if r["stage"] == "service/prove"]
        sample_verify_s = [r["ms"] / 1e3 for r in spans if r["stage"] == "service/verify"]
        line = {
            "shape": "venmo 1024/6400, phase 8's key and its four witnesses replayed",
            "sentry": sentry_check(svc, recs, done, overruns_before, sentry),
            "amort_points": points, "predicted_s_at_position_4": predicted, "tight_deadline_s": predicted / 2,
            "stats": stats, "batches": [1, 3], "sched_line": {k: v for k, v in lines[0].items()
                                                              if k not in ("ts", "pid", "run_id")},
            "decisions": decisions, "wall_s": wall, "check_witness_s": check_s, "prove_s": prove_s,
            "sample_verify_s": sample_verify_s, "observed": observed,
            "model_scale_after_first_batch": observed[0]["model_scale"], "model_scale": ctl.model_scale,
            "all_verify": True, "verify_s": verify_s, "launches": {k[3:]: v for k, v in launches.items() if v},
        }
        log(f"sched, adaptive at full width: {stats} in {wall:.2f} s; batches [1, 3] (the interactive first); "
            f"seed {{1: {points[1]:.3f}, {SCHED_BATCH}: {points[SCHED_BATCH]:.3f}}} s, the tight deadline "
            f"{predicted / 2:.2f} s of a predicted {predicted:.2f} s; observed "
            + ", ".join(f"{o['fill']}: {o['s']:.2f} s ({o['over_seed']:.2f}x the seed)" for o in observed)
            + f", model_scale {observed[0]['model_scale']:.3f} after the first batch, {ctl.model_scale:.3f} after "
            f"both; check_witness {[round(x, 2) for x in check_s]} s, prove {[round(x, 3) for x in prove_s]} s; "
            f"every proof verifies ({verify_s:.2f} s)")
        return line, launches
    finally:
        shutil.rmtree(d, ignore_errors=True)


# ------------------------------------- the perf sentry and the flame sampler


def perf_cmd(args):
    """`python -m zkp2p_tpu_torch perf ARGS` in this process: (its exit
    code, its standard output)."""
    import io

    from zkp2p_tpu_torch.pipeline import cli

    buf, rc = io.StringIO(), 0
    with contextlib.redirect_stdout(buf):
        try:
            cli.main(["perf", *args])
        except SystemExit as e:
            rc = e.code or 0
    return rc, buf.getvalue()


def flame_cli_start():
    """(c)'s first command, from the end of phase 1's kernel build beside
    phase 8: `python -m zkp2p_tpu_torch --circuit toy flame --duration
    FLAME_CLI_S` on the card, its build dir empty (so the dev setup runs on
    the card), its capture in PERF_DIR/flame_cli.  PERF_DIR is made anew
    here."""
    import os
    import shutil

    d = os.path.abspath(PERF_DIR)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return cli_start(["--circuit", "toy", "--build-dir", os.path.join(d, "toy_build"), "flame", "--duration",
                      str(FLAME_CLI_S), "--cache-dir", os.path.join(d, "flame_cli")], os.path.join(d, "flame.log"))


def flame_cli_finish(handle):
    """The flame command must exit 0 within FLAME_CLI_TIMEOUT_S, print
    collapsed stacks (`frames count` lines) and write a loadable manual
    capture whose launches are the card's; the capture is removed.
    Returns what the line records."""
    import os
    import re

    from zkp2p_tpu_torch.utils import flameprof

    wall, out, _rss = cli_finish(handle, timeout=FLAME_CLI_TIMEOUT_S)
    if out.returncode:
        raise AssertionError(f"`flame --circuit toy` exited {out.returncode}")
    rows = [ln.rsplit(" ", 1) for ln in out.stdout.splitlines() if ln.strip()]
    if not rows or not all(len(r) == 2 and r[1].isdigit() for r in rows):
        raise AssertionError(f"`flame` printed no collapsed stacks: {out.stdout[:2000]!r}")
    m = re.search(r"flame: capture -> (\S+)", out.stderr)
    doc = flameprof.load_capture(m.group(1)) if m else None
    if doc is None or doc["trigger"] != "manual" or not sum(doc["gpu_launches"].values()):
        raise AssertionError(f"`flame` wrote no capture of the card's launches: {m and m.group(1)}, {doc}")
    os.remove(m.group(1))
    return {"command": "--circuit toy flame --duration " + str(FLAME_CLI_S), "wall_s": wall, "rc": 0,
            "stack_lines": len(rows), "samples": doc["samples"], "self_ms": doc["sampler"]["self_ms"],
            "gpu_launches": doc["gpu_launches"], "gpu_frames": sum(v for k, v in doc["stacks"].items() if ";gpu:" in k)}


def flame_phase(torch, fl, device):
    """(a), after phase 8's timed work, on its key and first witness: one
    warm prove_gpu outside the sampler (its launches held to the Jacobian
    launch rule), FLAME_PLAIN_PROOFS more timed, then
    flameprof.profile_proves for FLAME_S seconds.  The capture's launches
    must equal, launcher by launcher, the proofs times the warm proof's,
    and its stacks must hold a `gpu:` frame under prove_gpu, some of them
    beside the waits in tcurve.py's copies to the host.  Returns the
    flame line's in-process part."""
    from zkp2p_tpu_torch.ops import cuda_build
    from zkp2p_tpu_torch.ops.ntt import pass_plan
    from zkp2p_tpu_torch.prover.groth16_gpu import prove_gpu
    from zkp2p_tpu_torch.utils import flameprof

    key, w = fl["key"], fl["wits"][0]

    def prove():
        return prove_gpu(key, w, device=device)

    cuda_build.reset_launches()
    prove()
    per_proof = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    rule = {"fr_ntt_pass": 2 * len(pass_plan(VENMO["log_m"])), "fr_matvec": 2, "signed_recode": 2,
            **CLASSED_PROOF_LAUNCHES}
    missing = [k for k in PATH_KERNELS["jacobian"] if "zk_" + k not in per_proof]
    stray = [k for k in NOT_ON_JACOBIAN if "zk_" + k in per_proof]
    if missing or stray or any(per_proof.get("zk_" + k) != v for k, v in rule.items()) \
            or per_proof["zk_mont_mul"] > K1_JACOBIAN_MAX:
        raise AssertionError(f"the warm flagship proof launched {per_proof}: missing {missing}, stray {stray}")
    plain = [wall_s(torch, prove)[0] for _ in range(FLAME_PLAIN_PROOFS)]
    sampler, seconds = flameprof.profile_proves(prove, FLAME_S, hz=flameprof.DEFAULT_HZ)
    sampler.stop()
    body = sampler.result()
    want = {k: len(seconds) * v for k, v in per_proof.items()}
    if body["gpu_launches"] != want:
        raise AssertionError(f"the sampler counted {body['gpu_launches']}, {len(seconds)} proofs of {per_proof} "
                             "expected")
    under = {k: v for k, v in body["stacks"].items() if "groth16_gpu.py:prove_gpu" in k and ";gpu:" in k}
    if not under:
        raise AssertionError("no gpu: frame under prove_gpu in the flame stacks")
    # the prover's waits for the MSMs (the copies to the host in
    # tcurve.py): the card is busy there, so they carry the last launcher
    waits = {k: v for k, v in body["stacks"].items() if "groth16_gpu.py:prove_gpu" in k
             and [f for f in k.split(";") if not f.startswith("gpu:")][-1].startswith("tcurve.py:")}
    waits_gpu = sum(v for k, v in waits.items() if ";gpu:" in k)
    if not waits_gpu:
        raise AssertionError(f"no gpu: frame beside the prover's waits on the card: {waits}")
    top = flameprof.collapsed_text(body["stacks"]).splitlines()[:FLAME_TOP]
    line = {"shape": "venmo 1024/6400, phase 8's key and first witness, prove_gpu warm",
            "hz": body["hz"], "proofs": len(seconds), "samples": body["samples"], "windows": body["windows"],
            "duration_s": body["duration_s"], "self_ms": body["sampler"]["self_ms"],
            "cpu_ms": body["sampler"]["cpu_ms"],
            "p50_s_sampled": statistics.median(seconds), "p50_s_plain": statistics.median(plain),
            "prove_s_sampled": seconds, "prove_s_plain": plain, "launches_a_proof": per_proof,
            "launches_equal_proofs_times_a_proof": True, "gpu_launches": body["gpu_launches"],
            "gpu_unattributed_launches": body["gpu_unattributed_launches"],
            "samples_gpu_under_prove_gpu": sum(under.values()), "samples_waiting_in_tcurve": sum(waits.values()),
            "samples_waiting_in_tcurve_with_gpu": waits_gpu,
            "top": [";".join(k.rsplit(" ", 1)[0].split(";")[-6:]) + " " + k.rsplit(" ", 1)[1] for k in top]}
    log(f"flame (a): {len(seconds)} warm proofs in {body['duration_s']:.2f} s under the sampler at {body['hz']:g} Hz, "
        f"p50 {line['p50_s_sampled']:.3f} s against {line['p50_s_plain']:.3f} s without it; {body['samples']} samples, "
        f"self {body['sampler']['self_ms']:.1f} ms ({body['sampler']['cpu_ms']:.1f} ms of CPU); launches {sum(want.values())} = {len(seconds)} x "
        f"{sum(per_proof.values())}; {line['samples_gpu_under_prove_gpu']} samples with a gpu: frame under prove_gpu, "
        f"{waits_gpu} of the {line['samples_waiting_in_tcurve']} waiting in tcurve.py's copies to the host")
    for row in line["top"]:
        log(f"  flame | ...{row}")
    return line


def sentry_seed(stamp):
    """(b) between phases 9 and 13 (a), on phase 9's ledger (`stamp`: its
    exit stamp's path and stages): `perf --rebaseline` then `perf --gate`
    must exit 0; then PERF_SEEDED entries whose prove p50 is a tenth of
    phase 9's are appended (the seeded history) and a second band is
    frozen from them.  Returns the state phase 13 (a) and the gate after
    it read."""
    import os

    from zkp2p_tpu_torch.utils import perfledger as pl

    ledger, d = stamp["ledger"], os.path.dirname(stamp["ledger"])
    clean, seeded = os.path.join(d, "baseline_clean.json"), os.path.join(d, "baseline_seeded.json")
    rc1, _ = perf_cmd(["--rebaseline", "--baseline", clean, "--ledger", ledger])
    rc2, out2 = perf_cmd(["--gate", "--baseline", clean, "--ledger", ledger])
    if rc1 or rc2 or "perf-gate: ok" not in out2:
        raise AssertionError(f"perf --rebaseline / --gate on phase 9's ledger exited {rc1} / {rc2}:\n{out2}")
    p50 = stamp["stages"]["prove"]["p50_ms"] / 10
    for _ in range(PERF_SEEDED):
        pl.append_entry(pl.make_entry("bench", "venmo", {"prove": {"p50_ms": p50, "p95_ms": p50, "n": 4}},
                                      device=stamp["device"]), ledger)
    entries, _ = pl.load_entries(ledger, device=stamp["device"])
    rc3, _ = perf_cmd(["--rebaseline", "--baseline", seeded, "--ledger", ledger])
    if rc3 or len(entries) != 1 + PERF_SEEDED:
        raise AssertionError(f"the seeded ledger holds {len(entries)} entries; its rebaseline exited {rc3}")
    log(f"sentry (b): phase 9's stamp rebaselined and gated ok; {PERF_SEEDED} entries seeded at prove p50 "
        f"{p50:.1f} ms (a tenth of phase 9's), a band frozen from them")
    return {"ledger": ledger, "cache_dir": d, "baseline_seeded": seeded, "seeded_p50_ms": p50,
            "seeded_head": entries[-1]["entry_digest"], "gate_clean": out2.strip().splitlines()}


def sentry_check(svc, recs, done, before, sentry):
    """(b) after phase 13 (a)'s sweep (`svc`, its records `recs`, the done
    ones `done`, the overrun counters `before` it): every done request's
    prove span over the seeded budget and counted; the counters' moves
    equal to the heartbeat's perf block (a heartbeat file written here);
    one capture, linked to the seeded head, with `gpu:` frames and in the
    heartbeat; then the run's stamp, and `perf --gate` against the seeded
    band exits 1 naming that capture."""
    import os
    import tempfile

    from zkp2p_tpu_torch.pipeline.fleet import _write_heartbeat
    from zkp2p_tpu_torch.utils import flameprof

    moved = {k: v - before.get(k, 0) for k, v in overrun_counts().items() if v - before.get(k, 0)}
    budget = svc._perf_book.budget_ms("prove")
    spans = [sp["ms"] for n in done for sp in recs[n]["spans"] if sp["name"] == "prove"]
    if len(spans) != len(done) or not all(ms > budget for ms in spans) or moved.get("prove") != len(done):
        raise AssertionError(f"prove spans {spans} against the seeded budget {budget} ms; overruns moved {moved}")
    with tempfile.TemporaryDirectory(dir=sentry["cache_dir"]) as hb_dir:
        _write_heartbeat(svc, hb_dir)
        (hb_file,) = os.listdir(hb_dir)
        hb = read_json(os.path.join(hb_dir, hb_file))["perf"]
    if hb["overruns"] != sum(moved.values()) or hb["budgets"] != len(svc._perf_book) or hb["checked"] < len(done):
        raise AssertionError(f"the heartbeat's perf block {hb} against the counters' moves {moved}")
    caps = flameprof.captures_for("venmo", sentry["cache_dir"], "prove")
    if len(caps) != 1:
        raise AssertionError(f"captures: {[c[0] for c in caps]}")
    path, doc = caps[0]
    gpu = sum(v for k, v in doc["stacks"].items() if ";gpu:" in k)
    if doc["entry_digest"] != sentry["seeded_head"] or doc["trigger"] != "overrun" or not gpu \
            or (hb.get("capture") or {}).get("file") != os.path.basename(path):
        raise AssertionError(f"the capture {path}: entry {doc['entry_digest']} (seeded head "
                             f"{sentry['seeded_head']}), gpu frames {gpu}, heartbeat {hb.get('capture')}")
    if not svc._perf_stamp():
        raise AssertionError("phase 13 (a)'s exit stamp was not written")
    rc, out = perf_cmd(["--gate", "--baseline", sentry["baseline_seeded"], "--ledger", sentry["ledger"]])
    if rc != 1 or "DRIFT" not in out or f"capture: {path}" not in out:
        raise AssertionError(f"perf --gate against the seeded band exited {rc}:\n{out}")
    line = {"budget_ms": budget, "prove_span_ms": spans, "overruns_moved": moved, "heartbeat_perf": hb,
            "capture": {"file": os.path.basename(path), "samples": doc["samples"], "gpu_frames": gpu,
                        "self_ms": doc["sampler"]["self_ms"], "gpu_launches": doc["gpu_launches"],
                        "entry_digest_is_seeded_head": True},
            "gate_seeded": {"rc": rc, "out": out.strip().splitlines()}}
    log(f"sentry (b): phase 13 (a) overran the seeded prove budget {budget:.1f} ms on every done request "
        f"({[round(x) for x in spans]} ms); counters {moved} equal the heartbeat's {hb['overruns']}; capture "
        f"{os.path.basename(path)} ({doc['samples']} samples, {gpu} with gpu: frames) linked to the seeded head; "
        f"perf --gate against the seeded band: rc 1, naming it")
    return line


def overrun_counts():
    """zkp2p_stage_budget_overruns_total by stage, in this process."""
    from zkp2p_tpu_torch.utils.metrics import REGISTRY

    return {m["labels"]["stage"]: m["value"] for m in REGISTRY.snapshot()
            if m["name"] == "zkp2p_stage_budget_overruns_total"}


def perf_json_start(sentry):
    """(c)'s second command: `perf --json` on (b)'s ledger as a process,
    beside phase 2 (it launches nothing)."""
    import os

    return cli_start(["perf", "--json", "--ledger", sentry["ledger"]], os.path.join(sentry["cache_dir"], "perf.log"))


def perf_json_finish(handle, sentry):
    """`perf --json` must exit 0 and print the trendlines: venmo/prove's
    series ending in phase 9's, the seeded and phase 13 (a)'s p50s."""
    wall, out, _rss = cli_finish(handle, timeout=300)
    doc = json.loads(out.stdout) if out.returncode == 0 else {}
    series = (doc.get("series") or {}).get("venmo/prove") or []
    if len(series) != PERF_SEEDED + 2 or series[1:1 + PERF_SEEDED] != [round(sentry["seeded_p50_ms"], 3)] * PERF_SEEDED:
        raise AssertionError(f"`perf --json` exited {out.returncode}: {out.stdout[:2000]}")
    log(f"sentry (c): `perf --json` in {wall:.1f} s: venmo/prove {series}")
    return {"wall_s": wall, "series_prove": series, "budgets_prove": doc["budgets"]["venmo"]["prove"]}


# -------------------------------------------------------------- phase 10


def sass_profile(lib_path):
    """Each kernel's static SASS of a built library (`cuobjdump -sass`; no
    ncu on the machine), as parse_sass gives it, or {"error": ...} where
    the toolkit has no cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True, check=True,
                              timeout=120).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return {"error": f"cuobjdump: {e}"}
    return parse_sass(text)


def parse_sass(text: str):
    """{kernel: {"instructions", "imad" (the IMAD family), "muls" (of them
    the multiplies: IMAD, IMAD.HI, IMAD.WIDE, not the moves and adds),
    "per_mul", "top" (the ten commonest opcodes with their modifiers),
    "calls": {address: the same for the called function there, from its
    address to its RET}}}; the kernel's own figures leave its callees out."""
    import collections
    import re

    def summary(rows):
        ops = collections.Counter(op for _, op, _ in rows)
        imad = sum(v for k, v in ops.items() if k.startswith("IMAD"))
        muls = sum(v for k, v in ops.items() if k in ("IMAD", "IMAD.U32") or k.startswith(("IMAD.HI", "IMAD.WIDE")))
        return {"instructions": len(rows), "imad": imad, "muls": muls, "per_mul": len(rows) / max(muls, 1),
                "top": dict(ops.most_common(10))}

    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*)", line)
        if m and name is not None:
            funcs[name].append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = {}
    for name, rows in funcs.items():
        calls, inside = {}, set()
        for target in sorted({int(t, 16) for _, op, rest in rows if op.startswith("CALL")
                              for t in re.findall(r"0x([0-9a-f]+)", rest)}):
            start = next((i for i, r in enumerate(rows) if r[0] == target), None)
            if start is None:
                continue
            end = next((i for i in range(start, len(rows)) if rows[i][1].startswith("RET")), len(rows) - 1)
            calls[f"0x{target:x}"] = summary(rows[start:end + 1])
            inside.update(range(start, end + 1))
        out[name] = dict(summary([r for i, r in enumerate(rows) if i not in inside]), calls=calls)
    return out


def scale_bound(n_on: int, n_off: int, n: int, k: int, peak_muls_per_s):
    """K19's bounds on these points against the points read once and the
    Jacobian points written once: the work the kernel does (the curve
    test, 2 squares and a product a live point; beta * x a point on the
    curve; each op of its stream after the first, which starts from the
    point at infinity and costs nothing: a doubling 5 squares and 2
    products, a mixed add 3 squares and 8 products; the GLV stream for
    points on the curve, the NAF stream for the rest; a square
    MULS_PER_SQR multiplies, a product MULS_PER_MONT) and, as bound_ms_naf,
    the former NAF-only design's work for the same function (every live
    point a doubling of 7 products a NAF digit below the top and a mixed
    add of 11 at a nonzero one, at MULS_PER_MONT)."""
    from zkp2p_tpu_torch.ops.cuda_scale import glv_ops, naf_digits, naf_ops

    def work(ops):
        d = sum(1 for o in ops if o == 0)
        a = max(sum(1 for o in ops if o) - 1, 0)
        return d, a, d * (5 * MULS_PER_SQR + 2 * MULS_PER_MONT) + a * (3 * MULS_PER_SQR + 8 * MULS_PER_MONT)

    test = 2 * MULS_PER_SQR + MULS_PER_MONT
    g_d, g_a, g_muls = work(glv_ops(k))
    n_d, n_a, n_muls = work(naf_ops(k))
    muls = n_on * (test + MULS_PER_MONT + g_muls) + n_off * (test + n_muls)
    digits = naf_digits(k)
    d_old, a_old = max(len(digits) - 1, 0), max(sum(1 for d in digits if d) - 1, 0)
    muls_naf = (n_on + n_off) * (d_old * MONTS["double"] + a_old * MONTS["add_mixed"]) * MULS_PER_MONT
    t_bytes = n * (2 + 3) * 64 / HBM_BYTES_PER_S
    t_ops, t_naf = muls / peak_muls_per_s, muls_naf / peak_muls_per_s
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes > t_ops else "operations",
                bound_ms_naf=max(t_bytes, t_naf) * 1e3, glv_doubles=g_d, glv_adds=g_a, naf_doubles=n_d,
                naf_adds=n_a, multiplies_a_point_on_curve=test + MULS_PER_MONT + g_muls,
                multiplies_a_point_naf_design=(d_old * MONTS["double"] + a_old * MONTS["add_mixed"]) * MULS_PER_MONT)


def scale_naf_launch(torch, x, y, out, k: int) -> None:
    """One launch of the NAF-only comparator entry that csrc/scale.cu keeps
    beside K19 (no path of the program launches it; counted nowhere)."""
    import ctypes

    from zkp2p_tpu_torch.field.tfield import FQ
    from zkp2p_tpu_torch.ops import cuda_build
    from zkp2p_tpu_torch.ops.cuda_mont import field_consts
    from zkp2p_tpu_torch.ops.cuda_scale import digit_block

    fn = cuda_build.library("scale").zk_g1_scale_naf
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), y.data_ptr(), *(c.data_ptr() for c in out), x.shape[0], digit_block(k).ctypes.data,
             field_consts(FQ).ctypes.data, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"zk_g1_scale_naf: CUDA launch failed with cudaError {err}")


def check_scale_kernel(torch, peak_muls_per_s, sm_clock_hz, device):
    """K19 (phase 2): at the ceremony's shape, the
    flagship's C and H queries together (13,305,359 points made on the
    card as K17 multiples of the generator, SCALE_HOLES (0, 0) holes, the
    generator and its negation and SCALE_OFF_CURVE points off the curve
    among them) scaled by a seeded full-width scalar: timed with its
    bounds (the card otherwise quiet), then the former NAF-only kernel
    on the same points in the same call, then K15's jac_to_affine once on
    K19's output; K19 held bitwise against its plain version over the
    first PLAIN_SLICE points, and SCALE_SAMPLES sampled points (the
    holes', G's, -G's and the off-curve ones among them), K19's, the
    comparator's and K15's, against the host g1_mul; the first
    SCALE_SPECIAL_POINTS (a hole, G, -G, a point off the curve) with
    k = 0, 1, 2, 2^127, r - 1, r, 2^256 - 1 against the host g1_mul.  Also the static SASS mix of
    both kernels (sass_profile) and what it gives with the times: SASS
    instructions a multiply and the issue slots used.  Returns K19's row
    and K15's line at this shape."""
    from zkp2p_tpu_torch.curve import host
    from zkp2p_tpu_torch.curve.tcurve import g1_jac_to_host, g1_limbs
    from zkp2p_tpu_torch.field.bn254 import R
    from zkp2p_tpu_torch.field.tfield import FQ
    from zkp2p_tpu_torch.ops import cuda_build
    from zkp2p_tpu_torch.ops.cuda_fixed_base import fixed_base, fixed_base_table
    from zkp2p_tpu_torch.ops.cuda_scale import g1_scale, g1_scale_plain
    from zkp2p_tpu_torch.ops.msm_affine import jac_to_affine_batch

    V = VENMO
    n_c, n_h = V["n_wires"] - V["n_public"] - 1, 1 << V["log_m"]
    n = n_c + n_h
    gen = torch.Generator(device=device).manual_seed(SEED + 190)
    table = fixed_base_table(False, host.G1_GENERATOR, device)
    k_pts = rand_canon(torch, gen, (n,), device)
    x, y = jac_to_affine_batch(FQ, fixed_base(False, table, k_pts))
    del k_pts
    holes = torch.linspace(0, n - 1, SCALE_HOLES, device=device).long()
    x[holes] = 0
    y[holes] = 0
    (gx,), (gy,) = (torch.from_numpy(c).to(device) for c in g1_limbs([host.G1_GENERATOR]))
    x[1], y[1], x[2], y[2] = gx, gy, gx, FQ.neg(gy)
    rng = random.Random(SEED + 191)
    off = [3, n // 3][:SCALE_OFF_CURVE]
    for i in off:  # y + 1: off the curve, and not on y^2 = x^3
        y[i] = FQ.add(y[i], FQ.const("one", device).int())

    def host_points(idx):
        return [None if not (x[i].any() or y[i].any()) else (FQ.from_mont_host(x[i].cpu().numpy()),
                                                             FQ.from_mont_host(y[i].cpu().numpy())) for i in idx]

    for (px, py) in host_points(off):
        if (py * py - px ** 3) % FQ.modulus in (0, host.CURVE_B):
            raise AssertionError("an off-curve test point lies on y^2 = x^3 or on the curve")
    first = host_points(range(SCALE_SPECIAL_POINTS))
    for k in (0, 1, 2, 1 << 127, R - 1, R, (1 << 256) - 1):
        got = g1_scale((x[:SCALE_SPECIAL_POINTS], y[:SCALE_SPECIAL_POINTS]), k)
        if g1_jac_to_host(got) != [None if p is None else host.g1_mul(p, k) for p in first]:
            raise AssertionError(f"g1_scale (k={k}) differs from the host g1_mul")
    k = rng.randrange(1, R)
    ms, got = cuda_ms(torch, lambda: g1_scale((x, y), k), 3)
    naf_out = tuple(torch.empty_like(x) for _ in range(3))
    ms_naf, _ = cuda_ms(torch, lambda: scale_naf_launch(torch, x, y, naf_out, k), 1)
    ms_k15, (ax, ay) = cuda_ms(torch, lambda: jac_to_affine_batch(FQ, got), 1)
    m = min(n, PLAIN_SLICE)
    plain_ms, want = cuda_ms(torch, lambda: g1_scale_plain((x[:m], y[:m]), k), 1, warmup=False)
    if max_abs_err(torch, tuple(c[:m] for c in got), want):
        raise AssertionError(f"g1_scale at {n} points differs from its plain version over the first {m}")
    idx = sorted({0, 1, 2, *off, int(holes[SCALE_HOLES // 2]), n - 1,
                  *(rng.randrange(n) for _ in range(SCALE_SAMPLES - 4 - len(off)))})
    pts = host_points(idx)
    want_host = [None if p is None else host.g1_mul(p, k) for p in pts]
    if g1_jac_to_host(tuple(c[idx] for c in got)) != want_host:
        raise AssertionError("g1_scale differs from the host g1_mul at the sampled points")
    if g1_jac_to_host(tuple(c[idx] for c in naf_out)) != want_host:
        raise AssertionError("the NAF-only comparator differs from the host g1_mul at the sampled points")
    if [None if not (ax[i].any() or ay[i].any()) else (FQ.from_mont_host(ax[i].cpu().numpy()),
                                                        FQ.from_mont_host(ay[i].cpu().numpy())) for i in idx] \
            != want_host:
        raise AssertionError("K15's jac_to_affine of K19's output differs from the host g1_mul at the samples")
    n_off = len(off)
    n_live = n - int(((x == 0).all(-1) & (y == 0).all(-1)).sum())
    ptxas = [line.strip() for line in cuda_build._lib_path("scale").with_suffix(".log").read_text().splitlines()
             if "registers" in line or "spill" in line or "Compiling entry" in line or "properties" in line]
    b = scale_bound(n_live - n_off, n_off, n, k, peak_muls_per_s)
    # the static SASS of K19, of its two called products and of the
    # comparator; SASS instructions a multiply in the products (the
    # comparator inlines its own), and from them and the times the issue
    # slots that the products take (4 a clock an SM) and the share of the
    # multiply pipe (the bound over the time)
    found = sass_profile(cuda_build._lib_path("scale"))
    sass = {name: next((v for key, v in found.items() if tag in key), None) for name, tag in (
        ("k_g1_scale", "k_g1_scaleP"), ("k_g1_scale_naf", "k_g1_scale_nafP"))}
    shares = {}
    if all(sass.values()) and len(sass["k_g1_scale"]["calls"]) == 2:
        prods = sass["k_g1_scale"]["calls"].values()  # the called product and square
        per_mul = sum(v["instructions"] for v in prods) / sum(v["muls"] for v in prods)
        slots = 4 * torch.cuda.get_device_properties(0).multi_processor_count * sm_clock_hz
        for name, t, bms, pm in (("k_g1_scale", ms, b["bound_ms"], per_mul),
                                 ("k_g1_scale_naf", ms_naf, b["bound_ms_naf"], sass["k_g1_scale_naf"]["per_mul"])):
            warp_instructions = bms * 1e-3 * peak_muls_per_s * pm / 32
            shares[name] = dict(sass_per_multiply=pm, issue_slot_share=warp_instructions / (t * 1e-3 * slots),
                                multiply_pipe_share=bms / t)
    else:
        sass["found"] = found
    row = dict(max_abs_err=0, shape=[n], shape_of="the flagship's C and H queries together (c 4,916,751 + h "
                                                   "8,388,608 points)",
               ms=ms, ms_naf_design_same_call=ms_naf, plain_ms=plain_ms, plain_over=m, holes=SCALE_HOLES,
               off_curve=n_off, host_samples=len(idx), ptxas=ptxas, sass=sass, shares=shares, **b,
               check=(f"bitwise equal to plain at {n} points (holes, G, -G, off the curve; plain over the first "
                      f"{m}); {len(idx)} sampled points of it, of the NAF-only comparator and of K15's "
                      f"normalisation equal to the host g1_mul; at the first {SCALE_SPECIAL_POINTS} points with k "
                      f"in {{0, 1, 2, 2^127, r-1, r, 2^256-1}} equal to the host g1_mul"),
               library_ms_reason="no PyTorch call multiplies a curve point")
    k15 = dict(shape=[n], ms=ms_k15, **bound(n, 7, 5 * 64, peak_muls_per_s),
               check=f"{len(idx)} sampled points of K19's output equal to the host g1_mul's affine")
    log(f"K19 g1_scale at {n} points: {ms:.1f} ms against the NAF-only design's {ms_naf:.1f} ms in the same call; "
        f"bound {b['bound_ms']:.1f} ms ({b['bound_by']}; GLV {b['glv_doubles']} doublings, {b['glv_adds']} adds), "
        f"the NAF-only work's {b['bound_ms_naf']:.1f} ms (NAF {b['naf_doubles']} doublings, {b['naf_adds']} adds); "
        f"plain {plain_ms:.1f} ms over {m}; bitwise equal; {len(idx)} samples equal to the host; ptxas {ptxas}; "
        f"SASS {json.dumps(sass)}; {json.dumps(shares)}; K15 jac_to_affine on its output {ms_k15:.1f} ms "
        f"(bound {k15['bound_ms']:.1f})")
    del x, y, got, want, naf_out, ax, ay
    torch.cuda.empty_cache()
    return {"g1_scale": row}, k15


def ceremony_in_process(torch, zk, device):
    """Phase 10's counted run, on phase 6's key as its parsed zkey (no
    file): two contributions (the first binds the circuit hash), the
    beacon at CEREMONY_ITER_EXP, and the verify of the chain against the
    initial key, each with the launch counts set to 0 just before it and
    read just after, its stage seconds and wall clock.  The verify must
    accept with the reference's lines; each op must launch exactly its
    CEREMONY_KERNELS.  Returns (its part of the ceremony line, launches
    by op)."""
    from zkp2p_tpu_torch.ops import cuda_build
    from zkp2p_tpu_torch.snark import ceremony

    ops = (("contribute", lambda z, st: ceremony.contribute_zkey(z, b"chip smoke, first", name="alice",
                                                                  device=device, stages=st)),
           ("contribute_2", lambda z, st: ceremony.contribute_zkey(z, b"chip smoke, second", name="bob",
                                                                    device=device, stages=st)),
           ("beacon", lambda z, st: ceremony.beacon_zkey(z, CEREMONY_BEACON, iter_exp=CEREMONY_ITER_EXP,
                                                          device=device, stages=st)),
           ("verify", lambda z, st: ceremony.verify_zkeys(zk, z, device=device, stages=st)))
    line, launches = {}, {}
    z = zk
    for name, fn in ops:
        st = {}
        cuda_build.reset_launches()
        wall, out = wall_s(torch, lambda: fn(z, st))
        launches["ceremony_" + name] = dict(cuda_build.LAUNCHES)
        line[name] = {"wall_s": wall, "stage_s": {k[2:]: v for k, v in st.items()},
                      "launches": {k[3:]: v for k, v in cuda_build.LAUNCHES.items() if v}}
        if name != "verify":
            z = out
    ok, lines = out
    if not ok or sum("PoK + delta link verified" in s for s in lines) != 2 or lines[-1] != (
            "H query scaling verified (randomized)") or not any(
            f"beacon re-derived (iter_exp={CEREMONY_ITER_EXP})" in s for s in lines):
        raise AssertionError(f"the in-process verify of the chain: {ok} {lines}")
    check_ceremony_launches(launches)
    log("ceremony in process: " + "; ".join(f"{k} {v['wall_s']:.2f} s (" + ", ".join(
        f"{s} {t:.2f}" for s, t in v["stage_s"].items()) + ") " + json.dumps(v["launches"]) for k, v in line.items()))
    return line, launches


def check_ceremony_launches(launches) -> None:
    """Each ceremony op launched exactly its CEREMONY_KERNELS, and each
    contribution K19 and K15 once."""
    for name, want in CEREMONY_KERNELS.items():
        got = {k[3:] for k, v in launches[name].items() if v}
        if got != set(want):
            raise AssertionError(f"{name} launched {sorted(got)}, expected {sorted(want)}")
    for name in ("contribute", "contribute_2", "beacon"):
        if [launches["ceremony_" + name][k] for k in ("zk_g1_scale", "zk_jac_to_affine")] != [1, 1]:
            raise AssertionError(f"the {name} launched K19 / K15 other than once each")


def ceremony_files(inp):
    """Phase 6's zkey, witness and VK hard-linked under CEREMONY_DIR (phase
    7 deletes CLI_DIR while the ceremony still reads them)."""
    import os
    import shutil

    d = os.path.abspath(CEREMONY_DIR)
    shutil.rmtree(d, ignore_errors=True)
    for sub in ("initial", "final"):
        os.makedirs(os.path.join(d, sub))
    paths = {"initial": os.path.join(d, "initial.zkey"), "wtns": os.path.join(d, "witness.wtns"),
             "initial_dir": os.path.join(d, "initial"), "final_dir": os.path.join(d, "final"), "dir": d}
    os.link(inp["paths"]["zkey"], paths["initial"])
    os.link(inp["paths"]["wtns"], paths["wtns"])
    os.link(os.path.join(os.path.dirname(inp["paths"]["zkey"]), "verification_key.json"),
            os.path.join(paths["initial_dir"], "verification_key.json"))
    return paths


def ceremony_log(stderr: str, op: str) -> dict:
    """The stage seconds and launches a ceremony command logs."""
    import re

    m = re.search(rf"\] {op}: (.*) s; launches (\{{.*\}})", stderr)
    if not m:
        raise AssertionError(f"the ceremony {op} logged no stage line")
    stages = {k: float(v) for k, v in (part.rsplit(" ", 1) for part in m.group(1).split(", "))}
    return {"stage_s": stages, "launches": json.loads(m.group(2))}


def edit_h_point(path: str, index: int) -> None:
    """Overwrite H query point `index` of a zkey file in place with the
    generator (a point on the curve, so only the scaling check catches
    it)."""
    import struct

    from zkp2p_tpu_torch.curve.host import G1_GENERATOR
    from zkp2p_tpu_torch.field.bn254 import MONT_R, P

    with open(path, "r+b") as f:
        (n,) = struct.unpack_from("<I", f.read(12), 8)
        for _ in range(n):
            stype, size = struct.unpack("<IQ", f.read(12))
            if stype == 9:
                f.seek(64 * index, 1)
                f.write(b"".join((c * MONT_R % P).to_bytes(32, "little") for c in G1_GENERATOR))
                return
            f.seek(size, 1)
    raise AssertionError(f"{path} has no H section")


def ceremony_chain(paths, started, abort):
    """Phase 10's command line, run in a thread beside phase 7 and phase
    10's counted run from phase 6's files: `ceremony contribute` and
    `beacon` (iter_exp CEREMONY_ITER_EXP) in turn (one contribution: the
    counted run makes two, and a second here would outlast it); then
    `ceremony verify` of the final key (ZKEY OK, exit 0), of a copy with
    one H point moved (ZKEY INVALID, exit 1) and `prove --zkey final
    --wtns` together; then
    `verify` of that proof against the final key's VK (OK, exit 0) and the
    initial one's (INVALID, exit 1); beside them `doctor --json --strict`
    (exit 0: the card, every kernel library built, the K1 workload equal
    to plain, no warning).  Each subprocess's wall clock, peak RSS and
    logged stages and launches.  Deletes CEREMONY_DIR."""
    import os
    import shutil

    from zkp2p_tpu_torch.formats.proof_json import dump, vkey_to_json
    from zkp2p_tpu_torch.formats.zkey import read_zkey_vk

    d = paths["dir"]
    z = {name: os.path.join(d, f"{name}.zkey") for name in ("c1", "final", "tampered")}
    out = {}

    def start(label, args):
        if abort.is_set():
            raise RuntimeError("phase 10's command line stopped: an earlier phase failed")
        handle = cli_start(args, os.path.join(d, label + ".log"))
        started.append(handle[0])
        return handle

    def finish(label, handle, code, last, op=None):
        wall, run, peak = cli_finish(handle)
        lines = run.stdout.strip().splitlines()
        if run.returncode != code or (last is not None and (not lines or lines[-1] != last)):
            raise AssertionError(f"phase 10's {label} exited {run.returncode} printing {lines[-3:]}, expected "
                                 f"{code} and {last!r}")
        out[label] = {"wall_s": wall, "peak_rss_gib": peak, "exit": code, "last_line": last,
                      **(ceremony_log(run.stderr, op) if op else {})}
        return lines

    try:
        t0 = time.perf_counter()
        for label, op, args, last in (
                ("contribute_1", "contribute", ["contribute", paths["initial"], z["c1"], "--entropy",
                                                "chip smoke CLI, first", "--name", "alice"],
                 f"contributed -> {z['c1']}"),
                ("beacon", "beacon", ["beacon", z["c1"], z["final"], "--beacon-hash", CEREMONY_BEACON.hex(),
                                      "--iter-exp", str(CEREMONY_ITER_EXP)], f"beacon applied -> {z['final']}")):
            finish(label, start(label, ["ceremony", *args]), 0, last, op)
        shutil.copyfile(z["final"], z["tampered"])
        edit_h_point(z["tampered"], 1)
        dump(vkey_to_json(read_zkey_vk(z["final"])), os.path.join(paths["final_dir"], "verification_key.json"))
        proof = [os.path.join(paths["final_dir"], f) for f in ("proof.json", "public.json")]
        verify = start("verify", ["ceremony", "verify", paths["initial"], z["final"]])
        tampered = start("verify_tampered", ["ceremony", "verify", paths["initial"], z["tampered"]])
        prove = start("prove_final", ["--build-dir", paths["final_dir"], "prove", "--zkey", z["final"], "--wtns",
                                      paths["wtns"], "--proof", proof[0], "--public", proof[1]])
        doctor = start("doctor", ["doctor", "--json", "--strict"])
        rep = json.loads(finish("doctor", doctor, 0, None)[-1])
        if (rep["backend"] != "cuda" or not all(k["built"] for k in rep["kernels"].values())
                or rep["workload_s"] is None or rep["warnings"]):
            raise AssertionError(f"phase 10's doctor reported {rep}")
        out["doctor"].update(device=rep["device"], workload_s=rep["workload_s"], gates=rep["gates"],
                             execution_digest=rep["execution_digest"])
        finish("prove_final", prove, 0, None)
        checks = {name: start(name, ["--build-dir", paths[f"{which}_dir"], "verify", "--proof", proof[0],
                                     "--public", proof[1]])
                  for name, which in (("final_vk_accepts", "final"), ("initial_vk_rejects", "initial"))}
        finish("final_vk_accepts", checks["final_vk_accepts"], 0, "OK")
        finish("initial_vk_rejects", checks["initial_vk_rejects"], 1, "INVALID")
        lines = finish("verify", verify, 0, "ZKEY OK", "verify")
        if sum("PoK + delta link verified" in s for s in lines) != 1 or not any("beacon re-derived" in s
                                                                                 for s in lines):
            raise AssertionError(f"phase 10's verify printed {lines}")
        lines = finish("verify_tampered", tampered, 1, "ZKEY INVALID", "verify")
        if lines[-2] != "FAIL: H query not a consistent delta-scaling of the initial key":
            raise AssertionError(f"phase 10's verify of the edited key printed {lines}")
        out["chain_s"] = time.perf_counter() - t0
        out["zkey_bytes"] = os.path.getsize(z["final"])
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


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


def kernels_phase(torch, peak_muls, sm_clock_hz, device):
    """Phase 2: every launcher against its plain version at the main
    path's shapes.  Returns (the kernels' rows, the affine MSMs' same-run
    line)."""
    from zkp2p_tpu_torch.ops.cuda_msm_window import chunk_steps
    from zkp2p_tpu_torch.ops.msm import default_lanes

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

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
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
    # K18's trees: the lanes of the h MSM, the narrow classes, a's and
    # b1's wide classes (G1); b2's narrow and wide classes (G2)
    tree_shapes = {False: {"h": h_lanes, "narrow": narrow_lanes, "a wide": wide_lanes,
                           "b1 wide": default_lanes(V["b_wide"])},
                   True: {"b2 narrow": b2_lanes, "b2 wide": b2w_lanes}}
    rows.update(check_lane_tree_kernels(torch, tree_shapes, peak_muls, sm_clock_hz, device))
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
    scale_rows, k15 = check_scale_kernel(torch, peak_muls, sm_clock_hz, device)
    rows.update(scale_rows)
    rows["jac_to_affine"].setdefault("at_shapes", {})["ceremony C + H (K19's output)"] = k15
    free, total = torch.cuda.mem_get_info()
    log(f"kernels against plain: {time.perf_counter() - t0:.1f} s; peak device memory allocated here "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, {free / 2**30:.2f} of "
        f"{total / 2**30:.2f} GiB free on the card at the end")
    return rows, affine_msm_same_run


def vector_phase(torch, device):
    """Phase 3: the test vector's proof under both arms, then its setup
    (check_setup_vector, whose line it returns)."""
    from zkp2p_tpu_torch.prover.groth16_gpu import key_from_numpy, prove_gpu
    from zkp2p_tpu_torch.prover.vector import load_vector
    from zkp2p_tpu_torch.snark.groth16 import proof_bytes

    t0 = time.perf_counter()
    arrays, meta, witness, r, s, expected = load_vector()
    vkey = key_from_numpy(arrays, meta, device=device)
    for arms in ({}, AFFINE_ARMS):
        got = prove_gpu(vkey, witness, r=r, s=s, device=device, **arms)
        if proof_bytes(got) != proof_bytes(expected):
            raise AssertionError(f"the test vector's proof {arms} differs from the committed one")
        log(f"test vector {arms}: proof equal to the committed one ({time.perf_counter() - t0:.1f} s)")
    return check_setup_vector(torch, device)


def run(torch, device, peak_muls, sm_clock_hz):
    """Phases 1-13 on `device`, in the order 1 (12 and 13 (b) from the end
    of its kernel build, beside the rest of 1 and 8), 8 (its subprocesses
    beside it and 9), 9, 13 (a), 2 (phase 11's workers building their circuits and
    importing their keys beside it), 11 (2's K15/K16 bitwise checks and 3
    beside its proofs), 6, 7
    (phase 4's set-up beside its subprocesses), 10 (its command line in a
    thread from the end of 6, beside 7 and its counted run), 4, 5; returns
    what main prints."""
    import os
    import shutil

    from zkp2p_tpu_torch.ops import cuda_build
    from zkp2p_tpu_torch.ops.ntt import pass_plan
    from zkp2p_tpu_torch.prover.groth16_gpu import prove_gpu

    # phase 1, and phase 8's circuit built beside it; phase 12 (chaos)
    # starts once the kernels are built, beside the rest of the circuit's
    # build and phase 8
    t0 = time.perf_counter()
    chaos = sched_fleet = flame_cli = perf_json = None
    try:
        with ThreadPoolExecutor(1) as pool:
            flagship_build = pool.submit(build_flagship)
            libs = cuda_build.build_all()
            build_s = time.perf_counter() - t0
            chaos = chaos_start()
            sched_fleet = sched_fleet_start()
            flame_cli = flame_cli_start()
            built = flagship_build.result()
    except BaseException:
        if chaos is not None:
            chaos_stop(chaos)
        if sched_fleet is not None:
            sched_fleet_stop(sched_fleet)
        if flame_cli is not None:
            stop([flame_cli[0]])
        raise
    # its tens of millions of objects live to the end: no collection scans them
    gc.freeze()
    log(f"flagship: VenmoParams() built by the port in {built['build_s']:.1f} s beside the kernel build: "
        f"{built['cs'].num_constraints} constraints, {built['cs'].num_wires} wires; RSS "
        f"{built['rss_gib']['before']:.2f} -> {built['rss_gib']['after']:.2f} GiB")
    for stem, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"ptxas {stem}: {line.strip()}")
    log(f"build: {build_s:.1f} s")

    # phase 8's start: the flagship set up on the card; its files written
    # and its two CLI subprocesses started in a thread, which run beside
    # phase 8 in this process and phase 9 (phase 2's kernel times run with
    # no other process's kernels on the card)
    t0 = time.perf_counter()
    try:
        fl_start = flagship_start(torch, built, device)
    except BaseException:
        chaos_stop(chaos)
        sched_fleet_stop(sched_fleet)
        stop([flame_cli[0]])
        raise
    fleet = None
    log(f"phase 8's start (setup_device, the zkey's data; its files, subprocesses and inference follow in a "
        f"thread): {time.perf_counter() - t0:.1f} s")
    try:
        t0 = time.perf_counter()
        flagship, fl_setup, fl_prove, fl_batch, fl = flagship_phase(torch, built, fl_start, device)
        log(f"phase 8 (the flagship circuit) in this process: {time.perf_counter() - t0:.1f} s")
        del built
        # (a): the flame loop on phase 8's key, after its timed work
        t0 = time.perf_counter()
        flame_line = flame_phase(torch, fl, device)
        log(f"flame (a) at full width: {time.perf_counter() - t0:.1f} s")
        flame_line = {"in_process": flame_line, "cli": flame_cli_finish(flame_cli)}
        # phase 12 ends before phase 9
        t0 = time.perf_counter()
        chaos_line = chaos_finish(chaos, "phase 1's circuit build, phase 8")
        log(f"phase 12 (chaos): waited {time.perf_counter() - t0:.1f} s for it after phase 8")
        # phase 13 (b) ends before phase 9 too
        t0 = time.perf_counter()
        sched_fleet_line = sched_fleet_finish(sched_fleet, "phase 1's circuit build, chaos, phase 8")
        log(f"phase 13 (b) (the scheduler's fleet): waited {time.perf_counter() - t0:.1f} s for it after phase 12")
        # phase 9, on phase 8's key
        t0 = time.perf_counter()
        service, service_launches = service_phase(torch, fl, device)
        log(f"phase 9 (the proving service): {time.perf_counter() - t0:.1f} s")
        # (b): phase 9's ledger gated, then seeded for phase 13 (a)
        sentry = sentry_seed(service["perf_stamp"])
        # phase 13 (a), on phase 8's key and witnesses, seeded by phases 8-9
        t0 = time.perf_counter()
        sched_line, sched_launches = sched_phase(torch, fl, service, sentry, device)
        log(f"phase 13 (a) (the adaptive scheduler at full width): {time.perf_counter() - t0:.1f} s")
        # (c)'s `perf --json` on that ledger, beside phase 2
        perf_json = perf_json_start(sentry)
        del fl
        fl_start.pop("key")  # the flagship key leaves the card before phase 2
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        flagship_finish(fl_start, flagship)
        log(f"phase 8's CLI after phase 9: {time.perf_counter() - t0:.1f} s")
        # phase 11's fleet on phase 8's files: its workers build their
        # circuits on the host and import their keys beside phase 2
        fleet = fleet_start(os.path.join(fl_start["dir"], "full"))
        # phase 2
        rows, affine_msm_same_run = kernels_phase(torch, peak_muls, sm_clock_hz, device)
        flagship_verified(fl_start, flagship)
        flame_line["perf_json"] = perf_json_finish(perf_json, sentry)
        # phase 11's requests; phase 2's untimed K15/K16 checks and phase 3
        # beside their proofs
        t0 = time.perf_counter()

        def beside_fleet():
            check_affine_bitwise(torch, device)
            return vector_phase(torch, device)

        fleet_line, setup_vector = fleet_phase(torch, fleet, fl_start["vk"], fl_start["inferred_launches"],
                                               beside_fleet)
        log(f"phase 11 (the fleet) after phase 2, K15/K16's bitwise checks and phase 3 beside it: "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        chaos_stop(chaos)
        shutil.rmtree(chaos["dir"], ignore_errors=True)
        stop([h[0] for h in (flame_cli, perf_json) if h is not None])
        shutil.rmtree(os.path.abspath(PERF_DIR), ignore_errors=True)
        sched_fleet_stop(sched_fleet)
        shutil.rmtree(os.path.abspath(SCHED_DIR), ignore_errors=True)
        if fleet is not None:
            fleet_stop(fleet)
            shutil.rmtree(fleet["dir"], ignore_errors=True)
        with contextlib.suppress(BaseException):
            flagship_join(fl_start)  # its thread may still start the subprocesses
        stop(fl_start["procs"])
        shutil.rmtree(fl_start["dir"], ignore_errors=True)
    del fl_start
    torch.cuda.empty_cache()

    # phase 6, then phase 7 on its files, phase 4's set-up beside its
    # subprocesses; phase 10's command line in a thread from phase 6's files,
    # beside phase 7 and phase 10's counted run
    cli_files, real_setup, setup_launches = real_size_setup(torch, rows, peak_muls, device)
    torch.cuda.empty_cache()
    cer_started, cer_abort = [], threading.Event()
    cer_pool = ThreadPoolExecutor(1)
    cer_chain = cer_pool.submit(ceremony_chain, ceremony_files(cli_files), cer_started, cer_abort)
    try:
        t0 = time.perf_counter()

        def phase4_setup():  # beside phase 7's `prove` and `batch` subprocesses
            t0 = time.perf_counter()
            check_h_evals(torch, device)
            log(f"h_evals at 2^{H_CHECK_LOG_M}: equal to the plain path ({time.perf_counter() - t0:.1f} s)")
            t0 = time.perf_counter()
            made = synthetic_key(torch, device)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            log(f"real-size synthetic key (beside phase 7's subprocesses): {setup_s:.1f} s")
            return made, setup_s

        cli_line, cli_launches, cli_batch_launches, cli_limits, ((key, witness, ix, tables), setup_s) = cli_phase(
            torch, cli_files, device, phase4_setup)
        torch.cuda.empty_cache()
        log(f"phase 7 (the CLI at full size): {time.perf_counter() - t0:.1f} s")

        # phase 10's counted run, beside its command line's last subprocesses;
        # then its command line ends before phase 4 (no ceremony process
        # beside a timed proof or a peak-memory run)
        t0 = time.perf_counter()
        cer_line, cer_launches = ceremony_in_process(torch, cli_files.pop("zk"), device)
        del cli_files
        torch.cuda.empty_cache()
        log(f"phase 10's counted run: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cer_cli = cer_chain.result()
        log(f"phase 10's command line: {cer_cli['chain_s']:.1f} s from phase 6's files, waited "
            f"{time.perf_counter() - t0:.1f} s for after its counted run: "
            + json.dumps({k: v["wall_s"] for k, v in cer_cli.items() if isinstance(v, dict)}))

        # phase 4, on the key made beside phase 7
        # phase 6's setup shape of K13 stays beside the key's
        setup_shapes = rows["fr_matvec"].get("at_shapes", {})
        rows["fr_matvec"].update(time_matvec_path(torch, key, witness, peak_muls, device))
        rows["fr_matvec"]["at_shapes"] = {**setup_shapes, **rows["fr_matvec"].get("at_shapes", {})}
        rs = random.Random(SEED + 5)
        runs, jac_launches, peak_gib = real_size_proofs(torch, key, witness, ix, tables, rs, device, JACOBIAN_TIMED)
        witness_same_run = compare_witness_side(torch, key, witness, device)
        ntt_same_run = compare_ladder(torch, key, witness, device)
        msm_h_same_run = compare_msm_h(torch, key, device)
        msm_b2_same_run = compare_msm_b2(torch, key, device)
        proof_same_run = compare_proofs(torch, key, witness, rs, device)

        # the batch phase
        real_batch, batch_same_run, batch_launches = batch_phase(torch, key, witness, ix, tables, jac_launches,
                                                                 device)
        check_cli_launches(cli_launches, cli_batch_launches, cli_limits, jac_launches, batch_launches)

        # phase 5 (the phase-4 key stays resident for the profiles)
        aff_runs, aff_launches, aff_peak_gib = real_size_proofs(torch, key, witness, ix, tables, rs, device,
                                                                AFFINE_TIMED, **AFFINE_ARMS)
        affine_same_run = compare_affine_routes(torch, key, witness, rs, device)
    finally:
        cer_abort.set()
        stop(list(cer_started))
        cer_pool.shutdown(wait=True)
    # last, so that no timed proof runs after the profiler
    profile = profile_proof(torch, lambda: prove_gpu(
        key, witness, r=rs.randrange(1, 1 << 250), s=rs.randrange(1, 1 << 250), device=device), "jacobian")
    profile_affine = profile_proof(torch, lambda: prove_gpu(
        key, witness, r=rs.randrange(1, 1 << 250), s=rs.randrange(1, 1 << 250), device=device, **AFFINE_ARMS),
        "affine")
    by_path = {"jacobian": jac_launches, "affine": aff_launches, "batch": batch_launches, "setup": setup_launches,
               "cli_prove": cli_launches, "cli_batch": cli_batch_launches, "flagship_setup": fl_setup,
               "flagship_prove": fl_prove, "flagship_batch": fl_batch, "service": service_launches,
               "sched": sched_launches, **cer_launches}
    for path, names in PATH_KERNELS.items():
        missing = [k for k in names if by_path[path]["zk_" + k] == 0]
        if missing:
            raise AssertionError(f"launchers never launched on the {path} path: {missing}")
    for path, names in (("jacobian", NOT_ON_JACOBIAN), ("affine", NOT_ON_AFFINE), ("batch", NOT_ON_JACOBIAN),
                        ("setup", OFF_PATH), ("cli_prove", NOT_ON_JACOBIAN), ("cli_batch", NOT_ON_JACOBIAN),
                        ("flagship_setup", OFF_PATH), ("flagship_prove", NOT_ON_JACOBIAN),
                        ("flagship_batch", NOT_ON_JACOBIAN), ("service", NOT_ON_JACOBIAN),
                        ("sched", NOT_ON_JACOBIAN)):
        stray = [k for k in names if by_path[path]["zk_" + k]]
        if stray:
            raise AssertionError(f"launchers launched on the {path} path, which no longer runs them: {stray}")
    # OFF_PATH is asserted above to launch on no path
    unused = [k for k in cuda_build.LAUNCHERS if not any(v[k] for v in by_path.values())
              and k[len("zk_"):] not in OFF_PATH]
    if unused:
        raise AssertionError(f"launchers launched on no path: {unused}")
    V = VENMO
    passes = 2 * len(pass_plan(V["log_m"]))  # the iNTT's and the NTT's, all three rows in each
    for launcher, want in (("zk_fr_ntt_pass", passes), ("zk_fr_matvec", 2), ("zk_signed_recode", 2)):
        if any(v[launcher] != want for v in (jac_launches, aff_launches)):
            raise AssertionError(f"{launcher} launched {[v[launcher] for v in (jac_launches, aff_launches)]} times "
                                 f"a proof, expected {want}")
    # K18 once a tree, K2 only for the joins of the classes
    if tree_and_join_launches(key) != CLASSED_PROOF_LAUNCHES:
        raise AssertionError(f"the synthetic key's classes give {tree_and_join_launches(key)}")
    for path in ("jacobian", "flagship_prove"):
        got = {k: by_path[path]["zk_" + k] for k in CLASSED_PROOF_LAUNCHES}
        if got != CLASSED_PROOF_LAUNCHES:
            raise AssertionError(f"K2 / K18 launches of a {path} proof {got}, expected {CLASSED_PROOF_LAUNCHES}")
    log("K2 / K18 launches: " + json.dumps({p: {k: v["zk_" + k] for k in CLASSED_PROOF_LAUNCHES}
                                           for p, v in by_path.items()}))
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
             "real_size_setup": real_setup, "cli_real_size": cli_line, "flagship": flagship, "service": service,
             "fleet": fleet_line, "chaos": chaos_line, "flame": flame_line,
             "sched": {"in_process": sched_line, "fleet": sched_fleet_line},
             "ceremony": {"shape": f"phase 6's key (venmo 1024/6400 counts): c {V['n_wires'] - V['n_public'] - 1} + "
                                   f"h {1 << V['log_m']} points, zkey {cer_cli['zkey_bytes']} bytes",
                          "in_process": cer_line, "cli": cer_cli,
                          "concurrency": "the command line's subprocesses in turn from phase 6's files, beside "
                                         "phase 7 and then the counted run in this process (the verify, the "
                                         "edited key's verify and the final key's prove together); the command "
                                         "line ends before phase 4"}}
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
