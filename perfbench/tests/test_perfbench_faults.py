"""A whole run of each cell at its small size on the CPU (the harness's
look for a card skipped), once sound and once with each fault planted
underneath the timed path: ``correct`` must come out true, then false."""
import pytest

import small
from perfbench.tools import faults

CASES = [(w, f) for w, (_, mix) in small.CELLS.items()
         for f in faults.FAULTS[small.traffic(mix)["loop"]]]


@pytest.mark.parametrize("workload", sorted(small.CELLS))
def test_sound_run_is_correct(workload):
    r, out = small.run_small(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("workload,fault", CASES)
def test_planted_fault_is_caught(workload, fault):
    loop = small.traffic(small.CELLS[workload][1])["loop"]
    with faults.FAULTS[loop][fault]():
        _, out = small.run_small(workload)
    assert not out["correct"], out["checks"]
