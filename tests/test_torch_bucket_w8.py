"""The port's sorted-prefix bucket MSM (zkp2p_tpu_torch.ops.msm_bucket)
at w = 8 against the host curve: a point count that is not a power of 2
(the MSM pads it) with the scalars 1 and r - 1, and all-zero scalars.
Beside test_torch_bucket.py so that the two run in parallel: each bucket
MSM costs some hundred plain batch inversions on the CPU."""

import pytest
import torch

from test_torch_bucket import check_bucket_case

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)


@pytest.mark.parametrize("case", ["w8", "w8_all_zero"])
def test_msm_bucket_affine_w8_matches_host(case):
    check_bucket_case(case)
