"""Run one cell of the benchmark once, on one H100, and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

The cell, its configuration, traffic mix, metric readers and limits are
found by name from ``BENCHMARK.json`` (``perfbench/harness/cell.py``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (end-to-end with ``--trace 0``,
per-layer with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number that decided ``correct``
beside its limit, which also close standard error.  Exits non-zero, and
prints no result, without CUDA or enough cards, or if the JAX side was
imported.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from perfbench.harness import program
    program.set_env(ROOT)
    import torch
    from perfbench.harness import cell

    bench = cell.manifest()
    spec = cell.cell_files(bench, args.workload)["cell"]
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec["chips"]:
        print(f"{args.workload} needs {spec['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    r, out = cell.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START)
    print(f"[perfbench] {args.workload} seed {args.seed}: "
          f"{_power_limit()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", file=sys.stderr)
    found = cell.forbidden_modules(sys.modules)
    if found:
        print(f"[perfbench] the JAX side was imported: {found}",
              file=sys.stderr)
        return 3
    print(f"[perfbench] the run's configuration set these fields of the "
          f"program's registered {r.config['arch']} (registered, run): "
          f"{r.work.get('moved')}", file=sys.stderr)
    print(f"[perfbench] launches {json.dumps(program.launch_counts())}; "
          f"window {r.host.get('window_s')} s; set-up phases (s since "
          f"start) {json.dumps(r.phases)}")
    for k in sorted(set(r.checks) - set(out["checks"])):
        print(f"reading {k} {r.checks[k]!r} (not compared)", file=sys.stderr)
    print(f"[perfbench] host {json.dumps(r.host)}", file=sys.stderr)
    if "worst" in r.work:
        print(f"[perfbench] worst leaves {r.work['worst']}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
