"""Small copies of the cells, for the CPU tests, each kept in files of its
own and found by the names that ``BENCHMARK.json`` gives:

- ``small_copies/configs/<config>.json`` and ``small_copies/traffic/
  <mix>.json``: ``replace``, the keys of the configuration's or the mix's
  file set to a CPU size (every width cut, the structure kept), and
  ``why``;
- ``small_copies/limits/<cell>.json``: the small copy's own limits, in
  the form of a cell's limits file.

A run of a small copy goes through the harness's one path: only the
contents of the cell's files are replaced (``cell.inputs``)."""
import contextlib
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
SMALL = Path(__file__).resolve().parent / "small_copies"
CELLS = {w["name"]: (w["config"], w["traffic"]) for w in json.loads(
    (BENCH.parent / "BENCHMARK.json").read_text())["workloads"]}


def paths(workload: str) -> dict:
    """The small copy's files of a cell of ``BENCHMARK.json``."""
    conf, mix = CELLS[workload]
    return {"config": SMALL / "configs" / f"{conf}.json",
            "traffic": SMALL / "traffic" / f"{mix}.json",
            "limits": SMALL / "limits" / f"{workload}.json"}


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


def config(name: str) -> dict:
    """The configuration at its small size."""
    c = _read(BENCH / "configs" / f"{name}.json")
    return {**c, **_read(SMALL / "configs" / f"{name}.json")["replace"]}


def traffic(name: str) -> dict:
    t = _read(BENCH / "traffic" / f"{name}.json")
    return {**t, **_read(SMALL / "traffic" / f"{name}.json")["replace"]}


@contextlib.contextmanager
def files(workload: str):
    """The cell's files read as their small copies."""
    from perfbench.harness import cell
    conf, mix = CELLS[workload]
    small = (config(conf), traffic(mix), _read(paths(workload)["limits"]))
    old = cell.inputs
    cell.inputs = lambda f: small
    try:
        yield
    finally:
        cell.inputs = old


def run_small(workload: str, seed: int = 7):
    """The cell at its small size on the CPU, through the harness's whole
    run but the look for a card.  Returns (Run, result)."""
    from perfbench.harness import cell
    with files(workload):
        return cell.run(workload, seed, 0.0, False, device="cpu")
