"""``readings.py`` for a cell whose plain reference is not ``dense.py``
(``qwen2-vl-2b.doc-sft-2k``): the float8 control patched into the cell's
own reference module, and the image faults of ``image_faults.py`` beside
``faults.py``'s (their ``half_batch`` takes each row's images with it).

    python3 perfbench/tools/image_readings.py --workload <cell> \
        --seeds 1,2,3 [--control 1,2,3] [--fault causal_tower=4,5 ...] \
        --out chiprun_out/readings/<cell>.json

Arguments and output as ``readings.py``'s.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def control_patch(ref, compare, control, record: dict):
    """Wrap ``ref.train`` so that each call also trains the control, the
    reference with float8 products, from the same start on the same
    batches, and records the control's numbers against the reference's."""
    from perfbench.tools.faults import patched
    train = ref.train

    def train_both(dm, params, batch_of, tc, steps, row_chunk, start_leaves,
                   mm=None):
        out = train(dm, params, batch_of, tc, steps, row_chunk, start_leaves)
        params.clear()
        ctl = train(dm, dict(start_leaves()), batch_of, tc, steps, row_chunk,
                    start_leaves, mm=control.fp8_matmul)
        record.update(compare.train_numbers(ctl, out))
        return out

    return patched(ref, "train", train_both)


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench.harness import cell
    from perfbench.tools import faults, image_faults, readings
    argv = sys.argv[1:] if argv is None else argv
    name = argv[argv.index("--workload") + 1]
    f = cell.cell_files(cell.manifest(), name)
    ref = cell.module("reference",
                      json.loads(f["config"].read_text())["reference"])
    readings.control_patch = (lambda dense, compare, control, record:
                              control_patch(ref, compare, control, record))
    faults.FAULTS["train"] = {**faults.FAULTS["train"], **image_faults.FAULTS}
    return readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())
