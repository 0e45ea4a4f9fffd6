"""A run imports nothing of the JAX side, compared by whole top-level
module names (``repro_torch`` passes, ``repro`` fails), refuses to run
without a card, and needs the program beside the benchmark."""
import json
import os
import shutil
import subprocess
import sys
import textwrap

from perfbench.harness import cell

ROOT = cell.ROOT


def _python(code, cwd=ROOT, env=None):
    env = dict(os.environ, **(env or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=env)


def test_forbidden_names_compare_whole():
    assert cell.forbidden_modules(["repro_torch", "repro_torch.models",
                                   "jaxtyping", "reprolib"]) == []
    assert cell.forbidden_modules(["repro.core", "jax.numpy", "flax",
                                   "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                  "repro"]


def test_a_cpu_run_of_each_cell_loads_no_jax_and_no_repro():
    out = _python(f"""
        import json, sys
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'perfbench' / 'tests')!r}]
        import small
        for w in sorted(small.CELLS):
            small.run_small(w)
        from perfbench.harness import cell
        loaded = sorted({{m.split(".")[0] for m in sys.modules}})
        print(json.dumps([cell.forbidden_modules(sys.modules), loaded]))
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    found, loaded = json.loads(out.stdout.splitlines()[-1])
    assert found == []
    assert "repro_torch" in loaded and "repro" not in loaded


def test_run_refuses_without_a_card_and_prints_no_result():
    out = _python("""
        import runpy, sys
        sys.argv = ["run.py", "--workload", "yi-34b.code-completion",
                    "--seed", "1", "--seconds", "1", "--trace", "0"]
        runpy.run_path("perfbench/run.py", run_name="__main__")
    """, env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_fails_in_a_tree_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "yi-34b.code-completion", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert "correct" not in out.stdout
