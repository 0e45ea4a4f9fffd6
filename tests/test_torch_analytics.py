"""The port's analytic counts (``repro_torch.analytics``) against
``repro.analytics``, and ``chip_smoke.py``'s model-FLOP helper.

For each of ``repro``'s 10 archs (the port's ``ModelConfig`` built from
``dataclasses.asdict`` of ``repro``'s, since xlstm-1.3b is not registered
in the port), every ``SHAPES`` entry and chips in {1, 256}:
``forward_flops``, every field of ``cell_cost`` under both rule sets and
``_cache_bytes`` within rtol 1e-12 (the same float arithmetic), and
``roofline`` with a hardware entry holding ``repro``'s constants equal to
``repro.analytics.roofline``.  A one-card ``cell_cost(..., chips=1)``
counts ``6 N_active`` model FLOPs a trained token and ``2 N_active`` a
served one.  ``chip_smoke.py``'s two rates equal the ``H100_SXM``
entry's.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest

from repro import analytics as JA
from repro import configs as JC
from repro_torch import analytics as TA
from repro_torch.configs.base import SHAPES, ModelConfig

ROOT = Path(__file__).resolve().parent.parent
# a hardware entry with repro's constants, built here: the port has none
REPRO_HW = TA.Hardware(name="repro constants", peak_flops=JA.PEAK_FLOPS,
                       hbm_bw=JA.HBM_BW, link_bw=JA.ICI_BW,
                       dcn_bw=JA.DCN_BW)


def _port_cfg(arch):
    return ModelConfig(**dataclasses.asdict(JC.get(arch)))


def _close(got, want):
    assert got == pytest.approx(want, rel=1e-12, abs=0), (got, want)


@pytest.mark.parametrize("arch", JC.ARCHS)
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("chips", [1, 256])
def test_counts_match_repro(arch, shape, chips):
    jcfg, tcfg = JC.get(arch), _port_cfg(arch)
    sh = SHAPES[shape]
    B, S = sh.global_batch, sh.seq_len
    for n_new in (S, 1):
        _close(TA.forward_flops(tcfg, B, n_new, S),
               JA.forward_flops(jcfg, B, n_new, S))
    _close(TA._cache_bytes(tcfg, B, S, 2), JA._cache_bytes(jcfg, B, S, 2))
    assert TA._layer_kinds(tcfg) == JA._layer_kinds(jcfg)
    for rules in ("fsdp", "baseline"):
        got = TA.cell_cost(tcfg, sh, chips=chips, rules=rules)
        want = JA.cell_cost(jcfg, sh, chips=chips, rules=rules)
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(want)]
        for f in dataclasses.fields(want):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if isinstance(w, str):
                assert g == w
            else:
                _close(g, w)
        r_got = TA.roofline(got, chips=chips, hw=REPRO_HW)
        r_want = JA.roofline(want, chips=chips)
        assert r_got.keys() == r_want.keys()
        assert r_got["dominant"] == r_want["dominant"]
        for k, w in r_want.items():
            if k != "dominant":
                _close(r_got[k], w)


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_one_card_model_flops(arch):
    cfg = _port_cfg(arch)
    n_active = cfg.active_param_count()
    for sh in SHAPES.values():
        cost = TA.cell_cost(cfg, sh, chips=1)
        B, S = sh.global_batch, sh.seq_len
        if sh.kind == "train":
            want = 6.0 * n_active * B * S
        else:
            want = 2.0 * n_active * B * (S if sh.kind == "prefill" else 1)
        _close(cost.model_flops, want)
    if cfg.family == "moe":
        assert n_active < cfg.param_count() / 5


def test_h100_entry():
    hw = TA.H100_SXM
    assert (hw.peak_flops, hw.hbm_bw) == (989e12, 3.35e12)
    cost = TA.CellCost(flops=989e12, hbm_bytes=3.35e12 / 2, ici_bytes=0.0,
                       dcn_bytes=0.0, model_flops=989e12 / 2,
                       params_bytes=0.0)
    r = TA.roofline(cost, chips=1)
    assert r["dominant"] == "compute" and r["step_time_est"] == 1.0
    assert r["roofline_fraction"] == 0.5
    # the port carries no TPU constant
    assert not {"PEAK_FLOPS", "HBM_BW", "ICI_BW", "DCN_BW"} & set(vars(TA))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_rates_are_the_h100_entry():
    cs = _chip_smoke()
    assert cs.HBM_BYTES_PER_S == TA.H100_SXM.hbm_bw
    assert cs.BF16_TENSOR_OPS == TA.H100_SXM.peak_flops


@pytest.mark.parametrize("arch,B,S", [("smollm-135m", 8, 2048),
                                      ("musicgen-medium", 8, 2048),
                                      ("qwen2-vl-2b", 8, 2048),
                                      ("recurrentgemma-2b", 8, 2048),
                                      ("llama3.2-1b", 2, 1000)])
def test_chip_smoke_flop_helper_equals_the_old_expression(arch, B, S):
    """For a dense config ``active_param_count() == param_count()``, which
    is the model's parameter count, so the helper gives what phases 17,
    19 and 20 computed before: ``6 * n_params * tokens`` plus 12 D H a
    visible pair in each attention layer (the window's pairs in a local
    one)."""
    cs = _chip_smoke()
    cfg = _port_cfg(arch)
    n_params = cfg.param_count()
    assert cfg.active_param_count() == n_params
    kinds = TA._layer_kinds(cfg)
    if "local_attn" in kinds:
        w = min(cfg.window or S, S)
        pairs = sum(min(i + 1, w) for i in range(S))
        n_att = kinds.count("local_attn")
    else:
        pairs = S * (S + 1) // 2
        n_att = cfg.n_layers
    attn = 12 * cfg.head_dim * pairs * B * cfg.n_heads * n_att
    assert cs.train_model_flops(cfg, B, S) == (6 * n_params * B * S + attn,
                                               attn)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_chip_smoke_flop_helper_counts_active_parameters(arch):
    cs = _chip_smoke()
    cfg = _port_cfg(arch)
    flops, attn = cs.train_model_flops(cfg, 8, 2048)
    assert flops - attn == 6 * cfg.active_param_count() * 8 * 2048
    assert cfg.active_param_count() < cfg.param_count() / 5
