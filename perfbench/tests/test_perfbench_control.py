"""The control at each cell's own size, on the card: the reference
computed in float8 in the program's place must fail a limit that the
program's own run meets on the same seed.  Each case runs a short window,
the comparison and the control (1-2 minutes a cell)."""
import contextlib
import json

import pytest

from perfbench.harness import cell, compare
from perfbench.reference import control, dense
from perfbench.tools.readings import control_patch

CELLS = sorted(w["name"] for w in cell.manifest()["workloads"])


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_program_passes(card, workload):
    record = {}
    with contextlib.ExitStack() as stack:
        stack.enter_context(control_patch(dense, compare, control, record))
        _, out = cell.run(workload, 2 ** 31 + 77, 2.0, False)
    limits = json.loads(cell.cell_files(cell.manifest(), workload)[
        "limits"].read_text())
    assert out["correct"], out["checks"]
    assert any(record[k] > limits[k]["limit"] for k in limits), record
