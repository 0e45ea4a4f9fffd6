"""The readings that a cell's limits are set from, at the cell's own size
on the card, many seeds in one process.

    python3 perfbench/tools/readings.py --workload <cell> --seeds 1,2,3 \
        [--control 1,2,3] [--fault <name>=4,5,6 ...] \
        [--seconds 2] --out chiprun_out/readings/<cell>.json

For each of ``--seeds`` a sound run of the program (a short window, the
comparison as a run makes it) gives its numbers, the lower readings.  On
the seeds of ``--control`` the reference is also computed in float8 beside
float32, on the same inputs, and the control's numbers read: in training
the float8 reference's losses, gradient and change norms against the
float32 one; in serving, at every position of the sampled requests, the
gap of the token the float8 reference puts first.  Each ``--fault``
plants one of ``faults.FAULTS`` in the program for the runs on its seeds.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def control_patch(dense, compare, control, record: dict):
    """Wrap the reference so that each call also computes the control on
    the same inputs and records the control's numbers."""
    train, serve = dense.train, dense.serve_logits

    def train_both(dm, params, batch_of, tc, steps, row_chunk, start_leaves,
                   mm=None):
        ref = train(dm, params, batch_of, tc, steps, row_chunk, start_leaves)
        params.clear()
        ctl = train(dm, dict(start_leaves()), batch_of, tc, steps, row_chunk,
                    start_leaves, mm=control.fp8_matmul)
        record.update(compare.train_numbers(ctl, ref))
        return ref

    def serve_both(dm, embed, layer_of, head, final_norm, requests, mm=None):
        ref = serve(dm, embed, layer_of, head, final_norm, requests)
        ctl = serve(dm, embed, layer_of, head, final_norm, requests,
                    mm=control.fp8_matmul)
        gap = max(compare.token_gap(x, y.argmax(dim=-1).tolist())
                  for x, y in zip(ref, ctl))
        record["token_gap"] = max(record.get("token_gap", 0.0), gap)
        return ref

    stack = contextlib.ExitStack()
    from perfbench.tools.faults import patched
    stack.enter_context(patched(dense, "train", train_both))
    stack.enter_context(patched(dense, "serve_logits", serve_both))
    return stack


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench.harness import cell, compare, program
    program.set_env(ROOT)
    import torch
    from perfbench.reference import control, dense
    from perfbench.tools import faults

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    loop = json.loads((cell.cell_files(cell.manifest(), a.workload)[
        "traffic"]).read_text())["loop"]
    plan = ([("sound", s) for s in ints(a.seeds)]
            + [("control", s) for s in ints(a.control)]
            + [(f"fault:{name}", s) for name, seeds in
               (f.split("=") for f in a.fault) for s in ints(seeds)])
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    for kind, seed in plan:
        t0 = time.perf_counter()
        record = {}
        with contextlib.ExitStack() as stack:
            if kind == "control":
                stack.enter_context(control_patch(dense, compare, control,
                                                  record))
            elif kind.startswith("fault:"):
                stack.enter_context(faults.FAULTS[loop][kind[6:]]())
            r, res = cell.run(a.workload, seed, a.seconds, False)
        row = {"kind": kind, "seed": seed,
               "correct": res["correct"], "attempted": res["attempted"],
               "seconds": time.perf_counter() - t0,
               "peak_bytes": res["device"]["memory_peak_bytes"]}
        if record:
            row["control"] = record
        for k in ("gaps", "worst"):
            if k in r.work:
                row[k] = r.work[k]
        row["program"] = dict(r.checks)
        row["phases"] = r.phases
        rows.append(row)
        print(json.dumps(row), flush=True)
        out.write_text(json.dumps({"workload": a.workload,
                                   "card": torch.cuda.get_device_name(),
                                   "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
