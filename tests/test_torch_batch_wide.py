"""prove_gpu_batch on the wide circuit (two public inputs, no width classes): five witnesses
as ints and as (n, 4) u64 rows, at chunk=2 and chunk=0, each proof equal to
prove_gpu's and prove_host's byte for byte.  Beside test_torch_batch.py so
that the circuits' cases run in parallel."""

import pytest
import torch

from test_torch_batch import BATCH_CASES, BATCH_IDS, check_batch

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)


@pytest.mark.parametrize("form,chunk", BATCH_CASES, ids=BATCH_IDS)
def test_prove_gpu_batch_wide_matches_prove_gpu_and_host(form, chunk):
    check_batch("wide", form, chunk)
