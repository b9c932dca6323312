"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
root of the repository.  The harness's modules import as `harness.*` and
`reference.*` from the benchmark's folder."""
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def _one_thread():
    # small tensors: threads only contend (and batched LU of a few hundred
    # unknowns can hang in MKL with several threads)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
