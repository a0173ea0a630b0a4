"""The development trusted setup on the card: a constraint system (or
its QAP rows as arrays) straight to a ``DeviceProvingKey`` and its
``VerifyingKey`` (port of the reference's ``prover/setup_device.py``).

The key is the one the reference's ``setup_device(cs, seed)`` and
``device_pk(setup(cs, seed), cs)`` give for the same seed, bit for bit:
tau, alpha, beta, gamma, delta from ``_seeded_scalars(seed, 5)``, the
snarkjs coset-Lagrange h basis, the b and c queries pruned to their
non-infinity wires and the width classes of the circuit's wire widths.

Where the reference runs Python ints over the domain and the nonzeros
and a native C++ fixed-base comb, everything here with more than a few
hundred elements runs on the device, in this order (``stages`` names):

  powers   w^j for j < m: log2(m) K1 products, each doubling the run
  inverse  (tau - w^j)^-1 and (tau' - w^j)^-1, tau' = tau / g: one K15
           ``batch_inverse`` over Fr of the (2, m) denominators
  lagrange L_j(tau) = Z(tau) w^j / (m (tau - w^j)) and the h scalars
           scale * w^j / (tau' - w^j): K1
  qap      a_tau, b_tau, c_tau = A^T L, B^T L, C^T L: one K13 launch each
           over the transposed CSR (``csr_from_rows`` with the row and
           wire ids swapped), two for a matrix with a row of M^T longer
           than LONG_ROW
  scaled   (beta a + alpha b + c) / gamma for wires 0..n_public, / delta
           after: K1
  prune    b_sel (b_tau != 0), c_sel (private wires with a nonzero
           scaled value): ``torch.nonzero``
  points   ``from_mont`` (K1), then one K17 launch for the a, b1, c and
           h queries together in G1 and one for the b2 query in G2, and
           K15 ``jac_to_affine`` for each: the key's affine Montgomery limbs

The IC points (n_public + 1) and the five blinding points are host
multiplications.  Without CUDA and without ``device="cpu"`` the entry
points raise; on the CPU every kernel runs its plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..curve.host import G1_GENERATOR, G2_GENERATOR, g1_mul, g2_mul
from ..curve.tcurve import G1C, G2C
from ..field.bn254 import R, fr_domain_root, fr_inv
from ..field.tfield import FR, NUM_LIMBS, mont_limbs
from ..ops.cuda_fixed_base import fixed_base, fixed_base_table
from ..ops.cuda_matvec import csr_from_rows, fr_matvec
from ..ops.msm_affine import batch_inverse, jac_to_affine_batch
from ..snark.groth16 import VerifyingKey, _seeded_scalars, coset_gen, domain_size_for, qap_rows
from ..utils.device import resolve_device
from .groth16_gpu import DeviceProvingKey, _rows_to_arrays, _selections, _timed, widths_array

Rows = Tuple[object, object, object]  # (coeff (nnz, 16) Montgomery limbs, wire ids, row ids)


def _const(x: int, device) -> torch.Tensor:
    """A host Fr value as a (16,) Montgomery limb tensor."""
    return torch.from_numpy(mont_limbs([x % R], R)[0]).to(device)


def _tensor(x, dtype, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype).contiguous()


def domain_powers(log_m: int, device) -> torch.Tensor:
    """w^j for j < 2^log_m (w the domain's root), Montgomery limbs: each
    of the log_m K1 launches doubles the run (w^(j + 2^k) = w^j w^(2^k))."""
    m = 1 << log_m
    out = torch.empty(m, NUM_LIMBS, dtype=torch.int32, device=device)
    out[0] = _const(1, device)
    step = fr_domain_root(log_m)
    for k in range(log_m):
        half = 1 << k
        out[half:2 * half] = FR.mul(out[:half], _const(step, device))
        step = step * step % R
    return out


# K13 gives a row to one thread, so a row of k nonzeros is a chain of k
# dependent products.  A wire in many rows (the constant wire 0 in C) makes
# a long row of M^T: rows longer than this run as chunks of it, then a
# second K13 pass adds each row's chunk sums.
LONG_ROW = 2048


def _transposed_matvec(rows: Rows, vec: torch.Tensor, n_wires: int) -> torch.Tensor:
    """sum_j M[j][i] vec[j] for each wire i: K13 over the CSR of M^T, in
    two passes when a row of M^T is longer than LONG_ROW (the first over
    the rows cut into chunks of at most LONG_ROW nonzeros, the second
    over each row's chunk sums with coefficient one)."""
    coeff, wire, row = rows
    csr = csr_from_rows(coeff, row, wire, n_wires)
    lengths = csr.offsets.diff()
    if not lengths.numel() or int(lengths.max()) <= LONG_ROW:
        return fr_matvec(*csr, vec)
    dev = vec.device
    chunks = torch.clamp((lengths + LONG_ROW - 1) // LONG_ROW, min=1)
    first = torch.repeat_interleave(torch.arange(n_wires, device=dev), chunks)
    ends = torch.cumsum(chunks, 0)
    within = torch.arange(first.numel(), device=dev) - (ends - chunks)[first]
    starts = csr.offsets[:-1][first] + within * LONG_ROW
    offsets = torch.cat([starts, csr.offsets[-1:]])
    partial = fr_matvec(csr.coeff, csr.wire, offsets, vec)
    ones = _const(1, dev).expand(first.numel(), NUM_LIMBS).contiguous()
    join = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), ends])
    return fr_matvec(ones, torch.arange(first.numel(), dtype=torch.int32, device=dev), join, partial)


def _fixed_base_affine(g2: bool, scalars_mont: torch.Tensor):
    """k_i * G for Montgomery scalars: from_mont (K1), K17, then K15's
    jac_to_affine -> (x, y) Montgomery limbs, (0, 0) for k = 0."""
    curve = G2C if g2 else G1C
    table = fixed_base_table(g2, G2_GENERATOR if g2 else G1_GENERATOR, scalars_mont.device)
    jac = fixed_base(g2, table, FR.from_mont(scalars_mont))
    return jac_to_affine_batch(curve.F, jac)


def _host_ints(limbs_mont: torch.Tensor):
    std = FR.from_mont(limbs_mont).cpu().numpy().astype("<u2")
    return [int.from_bytes(r.tobytes(), "little") for r in std]


def setup_from_rows(a: Rows, b: Rows, c: Rows, n_wires: int, n_public: int,
                    widths: Optional[np.ndarray] = None, seed: str = "zkp2p-tpu-dev", device=None,
                    n_rows: Optional[int] = None, stages: Optional[dict] = None
                    ) -> Tuple[DeviceProvingKey, VerifyingKey]:
    """The seeded setup of the QAP given as COO rows: a, b, c are
    (coefficients (nnz, 16) int32 Montgomery limbs, wire ids, row ids),
    tensors or numpy arrays, with the public binding rows included (the
    reference's ``qap_rows``).  The key's A and B rows are a and b as
    given.  `n_rows` (the QAP's rows) sets the domain; by default the
    largest row id + 1.  `widths` (per-wire bit bounds; None: unclassed)
    sets the width classes.  Runs on CUDA unless device="cpu"; when
    `stages` is a dict it receives each stage's seconds ("s_<stage>",
    synchronised)."""
    dev = resolve_device(device)
    a, b, c = ((_tensor(co, torch.int32, dev), _tensor(w, torch.int64, dev), _tensor(r, torch.int64, dev))
               for co, w, r in (a, b, c))
    if n_rows is None:
        n_rows = 1 + max(int(r.max()) if r.numel() else -1 for _, _, r in (a, b, c))
    m = domain_size_for(n_rows)
    log_m = m.bit_length() - 1
    tau, alpha, beta, gamma, delta = _seeded_scalars(seed, 5)

    pw = _timed(stages, "powers", lambda: domain_powers(log_m, dev))
    z_tau = (pow(tau, m, R) - 1) % R
    minv = fr_inv(m)
    g = coset_gen(log_m)
    tau_p = tau * fr_inv(g) % R
    z_tau_p = (pow(tau_p, m, R) - 1) % R
    z_coset = (pow(g, m, R) - 1) % R
    scale = z_tau_p * minv % R * z_tau % R * fr_inv(delta * z_coset % R) % R

    def inverses():
        den = torch.stack([FR.sub(_const(t, dev).expand_as(pw), pw) for t in (tau, tau_p)])
        return batch_inverse(FR, den)

    dinv = _timed(stages, "inverse", inverses)

    def lagrange():
        lag = FR.mul(FR.mul(pw, _const(z_tau * minv, dev)), dinv[0])
        h = FR.mul(FR.mul(pw, _const(scale, dev)), dinv[1])
        return lag, h

    lag, h_scalars = _timed(stages, "lagrange", lagrange)
    del pw, dinv
    a_tau, b_tau, c_tau = _timed(stages, "qap", lambda: [_transposed_matvec(x, lag, n_wires) for x in (a, b, c)])
    del lag

    def scaled_vals():
        vals = FR.add(FR.add(FR.mul(a_tau, _const(beta, dev)), FR.mul(b_tau, _const(alpha, dev))), c_tau)
        out = FR.mul(vals, _const(fr_inv(delta), dev))
        out[:n_public + 1] = FR.mul(vals[:n_public + 1], _const(fr_inv(gamma), dev))
        return out

    scaled = _timed(stages, "scaled", scaled_vals)
    del c_tau

    def prune():
        ids = torch.arange(n_wires, device=dev)
        b_flags = ~FR.is_zero(b_tau)
        c_flags = ~FR.is_zero(scaled) & (ids > n_public)
        sels = []
        for flags, vals in ((b_flags, b_tau), (c_flags, scaled)):
            sel = torch.nonzero(flags).flatten()
            if not sel.numel():  # one infinity lane: scalar 0
                sel = torch.zeros(1, dtype=torch.int64, device=dev)
            sels.append((sel, torch.where(flags[sel, None], vals[sel], torch.zeros_like(vals[sel]))))
        return sels

    (b_sel, b_scalars), (c_sel, c_scalars) = _timed(stages, "prune", prune)
    del b_tau

    def points():
        g1 = (("a_bases", a_tau), ("b1_bases", b_scalars), ("c_bases", c_scalars), ("h_bases", h_scalars))
        x, y = _fixed_base_affine(False, torch.cat([k for _, k in g1]))
        out, at = {}, 0
        for name, k in g1:
            out[name] = (x[at:at + k.shape[0]], y[at:at + k.shape[0]])
            at += k.shape[0]
        out["b2_bases"] = _fixed_base_affine(True, b_scalars)
        return out

    bases = _timed(stages, "points", points)
    ic = [g1_mul(G1_GENERATOR, s) for s in _host_ints(scaled[:n_public + 1])]

    sels = {k: torch.from_numpy(v.astype(np.int64)).to(dev)
            for k, v in _selections(widths, n_wires, b_sel.cpu().numpy(), c_sel.cpu().numpy()).items()}
    dpk = DeviceProvingKey(
        n_public=n_public, n_wires=n_wires, log_m=log_m,
        a_coeff=a[0], a_wire=a[1], a_row=a[2], b_coeff=b[0], b_wire=b[1], b_row=b[2],
        alpha_1=g1_mul(G1_GENERATOR, alpha), beta_1=g1_mul(G1_GENERATOR, beta),
        beta_2=g2_mul(G2_GENERATOR, beta), delta_1=g1_mul(G1_GENERATOR, delta),
        delta_2=g2_mul(G2_GENERATOR, delta),
        **bases, **sels,
    )
    vk = VerifyingKey(n_public=n_public, alpha_1=dpk.alpha_1, beta_2=dpk.beta_2,
                      gamma_2=g2_mul(G2_GENERATOR, gamma), delta_2=dpk.delta_2, ic=ic)
    return dpk, vk


def qap_coo(cs) -> Tuple[Rows, Rows, Rows, int]:
    """The QAP rows of a constraint system (``qap_rows``: the binding
    rows included) as three COO triples of numpy arrays in the
    reference's order (row by row, each row's dict order), and the
    number of rows."""
    rows = qap_rows(cs)
    m = domain_size_for(len(rows))
    return tuple(_rows_to_arrays([t[k] for t in rows], m) for k in range(3)) + (len(rows),)


def setup_device(cs, seed: str = "zkp2p-tpu-dev", device=None,
                 stages: Optional[dict] = None) -> Tuple[DeviceProvingKey, VerifyingKey]:
    """The development setup of a constraint system on `device` (CUDA
    unless "cpu"): the reference's ``setup_device(cs, seed)``, bit for
    bit.  Duck-typed over the ConstraintSystem: reads constraints (their
    a/b/c dicts), num_public, num_wires and wire_width."""
    resolve_device(device)
    a, b, c, n_rows = qap_coo(cs)
    return setup_from_rows(a, b, c, cs.num_wires, cs.num_public, widths_array(cs), seed=seed, device=device,
                           n_rows=n_rows, stages=stages)
