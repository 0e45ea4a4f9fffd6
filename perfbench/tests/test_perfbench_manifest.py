"""BENCHMARK.json keeps to its contract: names, units and lines of the
allowed characters, the keys each entry may have, and every file of every
cell found by the name the manifest gives."""
import json
import re

import pytest

import small
from perfbench.harness import cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = cell.manifest()
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = ("hidden_size", "intermediate", "latent", "state_size",
          "projection", "d_model",
          "head", "ffn", "expansion", "experts_per_tok")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entries(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["source"])
    assert _line(entry["why"]) and len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key)
        assert not key.endswith(("_dim", "_rank"))
        assert not any(w in key for w in WIDTHS), key
    c = json.loads((cell.ROOT / entry["file"]).read_text())
    assert c["name"] == entry["name"] and c["source"] == entry["source"]
    assert c["reduced"] == entry["reduced"]
    ref = cell.module("reference", c["reference"])
    for name in ("Dims", "program_fields", "highest_precision", "train",
                 "serve_logits"):
        assert hasattr(ref, name), (c["reference"], name)
    ref.Dims.from_file(c)


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload_entries_and_their_files(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert entry["chips"] == 1 and _line(entry["why"])
    f = cell.cell_files(BENCH, entry["name"])
    for key in ("config", "traffic", "limits"):
        assert f[key].is_file(), f[key]
    t = json.loads(f["traffic"].read_text())
    assert t["loop"] in cell.LOOPS
    assert hasattr(cell.module("generators", t["generator"]), "Feed")
    assert f["metrics"], "every cell reports a per-layer metric"
    for path in f["metrics"].values():
        assert callable(cell.reader(path))
    limits = json.loads(f["limits"].read_text())
    assert all(v["limit"] > 0 for v in limits.values())
    e2e = [m for m in BENCH["end_to_end"]
           if entry["name"] in m.get("workloads", [entry["name"]])]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", [])) <= cells
    if "bound" in m:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
        moved = {e["name"]: e for e in BENCH["end_to_end"]}[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_names_unique_and_every_config_used():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_small_copies_cover_every_cell():
    assert set(small.CELLS) == {w["name"] for w in BENCH["workloads"]}
