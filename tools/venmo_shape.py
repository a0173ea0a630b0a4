"""Print the flagship circuit's prover shape as one JSON line.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/venmo_shape.py

Builds P2POnrampVerify(1024, 6400) with the reference package
(build_venmo_circuit(VenmoParams())) and counts what sizes the prover:
constraints, public inputs, wires, QAP rows and domain, nonzeros of A
and B, the pruned b/c query lanes (wires in any B row; non-public wires
in any row) and how many of each query's wires are narrow (width bound
<= NARROW_WIDTH bits).  The PyTorch port's chip_smoke.py carries these
counts as its VENMO constants.  Takes about a minute and ~4 GB of host
memory.
"""

import json
import time

import numpy as np

from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.models.venmo import VenmoParams, build_venmo_circuit
from zkp2p_tpu.prover.groth16_tpu import NARROW_WIDTH, widths_array
from zkp2p_tpu.snark.groth16 import domain_size_for, qap_rows


def main() -> None:
    t0 = time.perf_counter()
    cs, _ = build_venmo_circuit(VenmoParams())
    build_s = time.perf_counter() - t0
    rows = qap_rows(cs)
    n = cs.num_wires
    used = {k: np.zeros(n, dtype=bool) for k in "abc"}
    nnz = {"a": 0, "b": 0}
    for row in rows:
        for k, terms in zip("abc", row):
            if k in nnz:
                nnz[k] += len(terms)
            for wire, coeff in terms.items():
                if coeff % R:
                    used[k][wire] = True
    narrow = widths_array(cs) <= NARROW_WIDTH
    b_sel = np.flatnonzero(used["b"])
    c_mask = used["a"] | used["b"] | used["c"]
    c_mask[: cs.num_public + 1] = False
    c_sel = np.flatnonzero(c_mask)
    print(json.dumps(dict(
        constraints=cs.num_constraints, n_public=cs.num_public, n_wires=n, rows=len(rows),
        log_m=domain_size_for(cs).bit_length() - 1, nnz_a=nnz["a"], nnz_b=nnz["b"],
        a_narrow=int(narrow.sum()), a_wide=int((~narrow).sum()),
        b_narrow=int(narrow[b_sel].sum()), b_wide=int((~narrow[b_sel]).sum()),
        c_narrow=int(narrow[c_sel].sum()), c_wide=int((~narrow[c_sel]).sum()),
        build_s=round(build_s, 1), total_s=round(time.perf_counter() - t0, 1),
    )))


if __name__ == "__main__":
    main()
