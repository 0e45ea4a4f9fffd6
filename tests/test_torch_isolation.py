"""The PyTorch port stands alone: no module of ``src/repro_torch`` (nor
``chip_smoke.py``) imports ``jax`` or ``repro``, every module imports with
both made unimportable, and an entry point left at its default device
raises where there is no GPU instead of running on the CPU."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, \
                f"{path.relative_to(ROOT)} imports {name}"


def test_every_module_imports_without_jax_or_repro():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        print(" ".join(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(out.stdout.split())
    assert len(names) >= 14
    assert {"repro_torch.core.policies.solver_backends.refine",
            "repro_torch.core.simulator", "repro_torch.core.online",
            "repro_torch.core.runtime", "repro_torch.core.tonks",
            "repro_torch.fault.injection", "repro_torch.launch.train",
            "repro_torch.checkpoint.manager", "repro_torch.optim.adamw",
            "repro_torch.data.pipeline", "repro_torch.models.moe",
            "repro_torch.analytics"} <= names


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    from repro_torch import configs, resolve_device
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import distributions as TD
    from repro_torch.data import SyntheticLM
    from repro_torch.core import (engine, fitting, market, online, runtime,
                                  scenarios, service, service_kernel,
                                  simulator, tonks)
    from repro_torch.core.policies import checkpointing
    from repro_torch.fault import PreemptionSource
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer, weights
    d = TD.constrained_for()
    cfg = configs.smoke("recurrentgemma-2b")
    mkt = market.MarketModel.for_scenarios(scenarios.default_grid()[:1])
    grid = mkt.grid()
    calls = [
        lambda: resolve_device(),
        lambda: checkpointing.solve_batch([d], 4, grid_dt=1.0),
        lambda: checkpointing.solve(d, 4, grid_dt=1.0),
        lambda: engine.draw_lifetime_pool_batch([d], 4),
        lambda: engine.simulate_makespan_batch(
            engine.no_checkpoint_policy_table(4), 4, first=[1.0],
            pool=[[1.0, 1.0]], max_restarts=0),
        lambda: scenarios.sweep_checkpointing(scenarios.default_grid()[:1],
                                              job_steps=4, n_trials=2),
        lambda: scenarios.sweep_checkpointing(scenarios.default_grid()[:1],
                                              job_steps=4, n_trials=2,
                                              mode="serial"),
        lambda: scenarios.sweep_checkpointing(scenarios.default_grid()[:1],
                                              job_steps=4, n_trials=2,
                                              mode="grouped"),
        lambda: checkpointing.model_lifetimes_fn(d),
        lambda: engine.capped_model_draw([d], torch.full((1, 2), 0.5,
                                                         dtype=torch.float64)),
        lambda: engine.simulate_makespan_engine(
            engine.no_checkpoint_policy_table(4),
            checkpointing.model_lifetimes_fn(d, device="cpu"), 4,
            n_trials=2),
        lambda: transformer.init(cfg, torch.Generator()),
        lambda: weights.from_jax_params(cfg, {}),
        lambda: serve.serve_batch(cfg, None, [[1, 2, 3]]),
        lambda: serve.main(["--arch", "recurrentgemma-2b", "--smoke"]),
        lambda: PreemptionSource(d),
        lambda: engine.ReuseTable(d, [1.0]),
        lambda: engine.ReuseTables([d], [1.0]),
        lambda: service.draw_service_pool(d, seed=0, size=4),
        lambda: service.BatchService(d),
        lambda: service.run_bag(d, n_jobs=2),
        lambda: service.run_bag_grid(n_jobs=2),
        lambda: service.run_bag_grid(n_jobs=2, mode="batched"),
        lambda: service_kernel.draw_service_pool_batch([d], [0], size=4),
        lambda: service_kernel.simulate_service_batch(
            lengths=[[1.0]], pools=[[2.0]], bag_index=0, pool_index=0,
            policy="memoryless", cluster_size=1),
        lambda: scenarios.sweep_service(scenarios.default_grid()[:1],
                                        n_jobs=2),
        lambda: scenarios.sweep_service(scenarios.default_grid()[:1],
                                        n_jobs=2, mode="batched"),
        lambda: engine.accumulate_price_cost(grid, [[1.0]]),
        lambda: checkpointing.evaluate_policy_dollars(
            np.ones((1, 5, 3), np.int32), [d], grid, grid_dt=12.0),
        lambda: scenarios.solve_market_tables(
            scenarios.default_grid()[:1], mkt, job_steps=4),
        lambda: scenarios.sweep_market(scenarios.default_grid()[:1],
                                       job_steps=4, n_trials=2),
        lambda: fitting.fit("exponential", [1.0, 2.0], [0.2, 0.4]),
        lambda: fitting.fit_samples("exponential", [1.0, 2.0]),
        lambda: fitting.fit_all([1.0, 2.0]),
        lambda: checkpointing.solve_batch([d], 4, grid_dt=1.0, refine=True),
        lambda: online.OnlineModelTracker(),
        lambda: runtime.FleetStream(),
        lambda: runtime.FleetRuntime(),
        lambda: tonks.partition_function(3, 24.0, 0.5),
        lambda: tonks.p_boundary(3, 24.0, 0.5),
        lambda: simulator.GroundTruth().hazard(1.0),
        lambda: simulator.GroundTruth().cdf(1.0),
        lambda: simulator.GroundTruth().from_uniforms(0.5),
        lambda: train.train(configs.smoke("smollm-135m"),
                            TrainConfig(ckpt_dir="unused"), total_steps=1),
        lambda: train.main(["--arch", "smollm-135m", "--smoke"]),
        lambda: transformer.init(configs.smoke("smollm-135m"),
                                 torch.Generator(), trainable=True),
        lambda: weights.from_jax_params(cfg, {}, trainable=True),
        lambda: weights.named(cfg, {}),
        lambda: weights.opt_state_from_jax(cfg, None),
        lambda: SyntheticLM(vocab_size=8, seq_len=4, global_batch=1).batch(0),
        lambda: CheckpointManager(directory="unused", dist=d),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
