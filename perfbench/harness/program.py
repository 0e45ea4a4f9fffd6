"""The program under test, ``repro_torch``, as the harness reaches it: its
configuration built from the benchmark's file; its model built on the
weights the harness drew; its train, prefill and decode steps; its
kernels' launch counters.  Nothing else of the harness imports the
program."""
from __future__ import annotations

import dataclasses
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _import():
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch.configs as configs
    import repro_torch.launch.steps as steps
    import repro_torch.models.transformer as transformer
    import repro_torch.optim as optim
    return configs, steps, transformer, optim


def model_config(c: dict, fields: dict):
    """The program's ``ModelConfig`` of ``c["arch"]`` with every field
    that the configuration file fixes (``fields``, from the file's
    reference module) set as the file states it.  Returns it and the
    fields in which the program's registered entry differs from the
    file, as {field: (registered, run)}."""
    configs, *_ = _import()
    registered = configs.get(c["arch"])
    cfg = dataclasses.replace(registered, **fields)
    bad = {k: v for k, v in fields.items() if getattr(cfg, k) != v}
    if bad:
        raise ValueError(f"the program's configuration does not hold "
                         f"{bad} as {c['name']}.json states them")
    moved = {k: (getattr(registered, k), v) for k, v in fields.items()
             if getattr(registered, k) != v}
    return cfg, moved


def nest(flat: dict) -> dict:
    """The port's ``Model`` parameter tree from flat names."""
    out = {"layers": []}
    for name, t in flat.items():
        parts = name.split(".")
        if parts[0] != "layers":
            out[name] = t
            continue
        i = int(parts[1])
        while len(out["layers"]) <= i:
            out["layers"].append({})
        node = out["layers"][i]
        for p in parts[2:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return out


def model(cfg, flat: dict, trainable: bool):
    _, _, transformer, _ = _import()
    return transformer.Model(cfg, nest(flat), trainable=trainable)


def train_step(cfg, tc: dict):
    configs, steps, _, _ = _import()
    return steps.make_train_step(cfg, configs.TrainConfig(**tc))


def adamw_init(m):
    *_, optim = _import()
    return optim.adamw_init(dict(m.named_parameters()))


def serve_steps(cfg):
    _, steps, _, _ = _import()
    return steps.make_prefill_step(cfg), steps.make_decode_step(cfg)


def launch_counts() -> dict:
    """The kernels' launch counters (one a call of each wrapper)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    return {"flash_attention": fa.flash_attention.launches,
            "flash_attention_bwd": fa.flash_attention_bwd.launches,
            "decode_attention": da.decode_attention.launches}


def set_env(root: Path):
    """Point the compile caches a run might write at fixed directories
    inside the checkout (the kernels themselves build into the package's
    own ``kernels/build/``, inside the checkout too), and let the
    allocator grow its segments, so that batches of changing sizes near
    the card's capacity do not fragment it."""
    base = root / ".perfbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
