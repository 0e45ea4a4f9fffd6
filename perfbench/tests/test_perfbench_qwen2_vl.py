"""The qwen2-vl-2b cell on its small copy: a sound run is correct; its
declaration goes through draw, nest and a group's redraw to the port's
own parameter names; its step FLOPs are the hand count; each fault of
``tools/image_faults.py`` planted in the image path fails a limit.  On the
card (``-m chip``), the float8 control fails a limit at the cell's full
size where the program's own run meets them on the same seed."""
import contextlib
import json
import types

import pytest
import torch

import small
from perfbench.generators import image_rows
from perfbench.harness import cell, compare, draw, program
from perfbench.reference import control, qwen2_vl
from perfbench.tools import image_faults
from perfbench.tools.image_readings import control_patch

CELL = "qwen2-vl-2b.doc-sft-2k"
CPU = torch.device("cpu")


def _dims(config=None):
    return qwen2_vl.Dims.from_file(config or small.config("qwen2-vl-2b"))


def test_sound_run_is_correct():
    r, out = small.run_small(CELL, seed=2 ** 33 + 5)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_declaration_draws_nests_and_redraws_to_the_ports_names():
    dm = _dims()
    flat = draw.weights(dm, 2 ** 40 + 9, CPU)
    cfg, _ = program.model_config(
        small.config("qwen2-vl-2b"),
        qwen2_vl.program_fields(dm, small.config("qwen2-vl-2b")))
    model = program.model(cfg, flat, trainable=True)
    names = dict(model.named_parameters())
    assert sorted(names) == sorted(flat)
    for k, v in flat.items():
        assert names[k] is not None and torch.equal(names[k].detach(), v), k
    for tags, prefix in ((("vision_block", 1), "vision.blocks.1."),
                         (("merger",), "merger."), (("patch",), "vision."),
                         (("layer", 0), "layers.0.")):
        again = draw.group(dm, tags, 2 ** 40 + 9, CPU)
        for k, v in again.items():
            assert torch.equal(v, flat[prefix + k]), prefix + k
    # biases and shifts are drawn, norm scales are ones
    assert float(flat["layers.1.attn.bk"].abs().max()) > 0
    assert float(flat["vision.blocks.0.ln2.shift"].abs().max()) > 0
    assert torch.equal(flat["merger.ln.scale"], torch.ones(dm.vd))


@pytest.mark.parametrize("grid", [[(1, 48, 48)] * 8,
                                  [(1, 80, 64), (1, 48, 50)] * 4])
def test_step_flops_are_the_hand_count(grid):
    c = json.loads((cell.BENCH / "configs" / "qwen2-vl-2b.json").read_text())
    dm = _dims(c)
    feed = types.SimpleNamespace(B=8, S=2048, grids=lambda i: grid)
    dec = (28 * (1536 * 1536 * 2 + 2 * 1536 * 256 + 3 * 1536 * 8960)
           + 1536 * 151936)
    want = 6 * dec * 8 * 2048 + 12 * 128 * 12 * 28 * 8 * (2048 * 2049 // 2)
    patches = [h * w for _, h, w in grid]
    tower = 1176 * 1280 + 32 * (3 * 1280 ** 2 + 1280 ** 2 + 2 * 1280 * 5120)
    want += 6 * tower * sum(patches)
    want += 12 * 80 * 16 * 32 * sum(n * n for n in patches)
    want += 6 * (5120 * 5120 + 5120 * 1536) * sum(patches) // 4
    assert qwen2_vl.train_batch_flops(dm, feed, 0) == want


def test_the_cells_grids_span_their_ranges():
    t = json.loads((cell.BENCH / "traffic" / "doc-sft-2k.json").read_text())
    cells = [h * w // 4 for i in range(40)
             for _, h, w in image_rows.grids(t, 2 ** 31 + 3, i)]
    assert 576 <= min(cells) and max(cells) <= 1280
    assert min(cells) < 700 and max(cells) > 1150
    # the sizes are the mix's, the same for every seed; the seed deals them
    a, b = image_rows.grids(t, 5, 3), image_rows.grids(t, 2 ** 40 + 6, 3)
    assert a == image_rows.grids(t, 5, 3) and sorted(a) == sorted(b)
    assert any(a != image_rows.grids(t, s, 3) for s in range(6, 12))
    assert sorted(a) != sorted(image_rows.grids(t, 5, 4))


KERNELS = {"flash_wgmma_kernel<80, true>(CUtensorMap_st, float*)": 1.0,
           "flash_wgmma_kernel<128, false>(CUtensorMap_st, float*)": 2.0,
           "dq_wgmma_kernel<80, true>(CUtensorMap_st, float*)": 3.0,
           "dkdv_wgmma_kernel<80, true>(CUtensorMap_st, float*)": 4.0,
           "dq_wgmma_kernel<128, false>(CUtensorMap_st, float*)": 5.0,
           "dkdv_wgmma_kernel<128, false>(CUtensorMap_st, float*)": 6.0,
           "flash_wgmma_kernel<64, false>(CUtensorMap_st, float*)": 7.0}


@pytest.mark.parametrize("name,seconds", [
    ("vision_flash_fwd_roofline", 1.0), ("vision_flash_bwd_roofline", 7.0),
    ("decoder_flash_fwd_roofline", 2.0), ("decoder_flash_bwd_roofline", 11.0)])
def test_each_roofline_reads_its_own_instances(name, seconds):
    """The tower's rooflines time the D-80 instances and the decoder's the
    D-128 ones, each against its own bound, on one trace that holds both
    (and an instance of neither)."""
    from perfbench.harness import trace, yardstick
    c = json.loads((cell.BENCH / "configs" / "qwen2-vl-2b.json").read_text())
    t = json.loads((cell.BENCH / "traffic" / "doc-sft-2k.json").read_text())
    dm, seed = _dims(c), 2 ** 31 + 11
    r = types.SimpleNamespace(
        traced=trace.Trace(1.0, 1.0, list(KERNELS.items()), {}), dims=dm,
        traffic=t, seed=seed, host={"steps": 5},
        work={"steps": 2, "B": 8, "S": 2048})
    read = cell.reader(cell.BENCH / "metrics" / f"{name}.py")
    if name.startswith("vision"):
        fwd = name == "vision_flash_fwd_roofline"
        first = t["checked_steps"] + 5
        bound = sum(
            (2 if fwd else 1) * dm.v_layers
            * (yardstick.flash_fwd_segments_bound_s if fwd
               else yardstick.flash_bwd_segments_bound_s)(
                [a * b * c for a, b, c in image_rows.grids(t, seed, i)],
                16, 16, 80, causal=False, **({"lse": True} if fwd else {}))
            for i in (first, first + 1))
    elif name == "decoder_flash_fwd_roofline":
        bound = 2 * 28 * 2 * yardstick.flash_fwd_bound_s(8, 2048, 12, 2, 128,
                                                         lse=True)
    else:
        bound = 28 * 2 * yardstick.flash_bwd_bound_s(8, 2048, 12, 2, 128)
    assert read(r) == pytest.approx(100.0 * bound / seconds, rel=1e-12)
    r.traced = trace.Trace(1.0, 1.0, [("elementwise_kernel", 1.0)], {})
    assert read(r) is None


@pytest.mark.parametrize("fault", sorted(image_faults.FAULTS))
def test_planted_image_fault_is_caught(fault):
    with image_faults.FAULTS[fault]():
        _, out = small.run_small(CELL)
    assert not out["correct"], out["checks"]


@pytest.mark.chip
def test_control_fails_where_the_program_passes(card):
    record = {}
    with contextlib.ExitStack() as stack:
        stack.enter_context(control_patch(qwen2_vl, compare, control,
                                          record))
        _, out = cell.run(CELL, 2 ** 31 + 77, 2.0, False)
    limits = json.loads(cell.cell_files(cell.manifest(), CELL)[
        "limits"].read_text())
    assert out["correct"], out["checks"]
    assert any(record[k] > limits[k]["limit"] for k in limits), record
