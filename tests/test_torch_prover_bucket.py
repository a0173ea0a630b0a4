"""The port's prover with the sorted-prefix bucket h MSM
(prove_gpu(..., msm_h="bucket"), the reference's ZKP2P_MSM_H=bucket),
alone and with the batch-affine accumulate, against prove_host on the
circuits of test_torch_prover_arms.py: equal bytes, and the proof
verifies.  Each proof takes some hundred plain batch inversions on the
CPU, minutes a proof: tier 1 runs both arms on the toy circuit, the slow
tier the rest."""

import pytest
import torch

from test_torch_prover_arms import BUILDS, check_arm

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)


def _cases():
    for circuit in BUILDS:
        for arm in ("bucket", "both"):
            tier1 = (circuit, arm) == ("toy", "both")
            yield pytest.param(circuit, arm, id=f"{circuit}-{arm}", marks=() if tier1 else pytest.mark.slow)


@pytest.mark.parametrize("circuit,arm", list(_cases()))
def test_prove_gpu_bucket_arm_matches_host(circuit, arm):
    check_arm(circuit, arm)
