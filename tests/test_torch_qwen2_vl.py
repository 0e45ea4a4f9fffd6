"""Qwen2-VL-2B whole on the port: the vision tower, the merger, the splice,
the M-RoPE index, Qwen2's q/k/v biases and the flash pair's segments,
held to the benchmark's plain float32 reference
(``perfbench/reference/qwen2_vl.py``), which computes its own index,
segment mask and rotary tables.

At the small copy's size (``perfbench/tests/small_copies/configs/
qwen2-vl-2b.json``): a decoder of 2 layers of 96 with 3 / 1 heads, a tower
of 2 blocks of 160 with 2 heads of 80 and a merger, 2 rows with different
grids, seeded random weights (every bias and LayerNorm shift drawn), in
float32.  The ``chip`` tests run the D-80 segmented kernels at the cell's
shapes and pin the D-128 calls to the kernels before segments came."""
import dataclasses
import hashlib
import itertools
import json
from pathlib import Path

import pytest
import torch

from perfbench.harness import draw, program
from perfbench.reference import qwen2_vl as ref
from repro_torch import configs
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import transformer as T
from repro_torch.models import vision as V

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
GRIDS = [(1, 4, 6), (1, 8, 4)]       # patches: 2 x 3 and 4 x 2 merged cells
S = 28


def _config(dtype="float32") -> dict:
    bench = ROOT / "perfbench"
    c = json.loads((bench / "configs" / "qwen2-vl-2b.json").read_text())
    small = json.loads((bench / "tests" / "small_copies" / "configs" /
                        "qwen2-vl-2b.json").read_text())["replace"]
    c = {**c, **small}
    c["run"] = dict(c["run"], compute_dtype=dtype)
    return c


def _setup(seed=3, dtype="float32"):
    c = _config(dtype)
    dm = ref.Dims.from_file(c)
    cfg = dataclasses.replace(configs.get("qwen2-vl-2b"),
                              **ref.program_fields(dm, c))
    flat = draw.weights(dm, seed, CPU)
    model = T.Model(cfg, program.nest({k: v.clone() for k, v in
                                       flat.items()}), trainable=True)
    return dm, cfg, flat, model


def _batch(dm, grids=GRIDS, seed=0, before=(4, 2)):
    """Rows of text, one image block each (start, pads, end), text after;
    labels the next ids, masked at pads and markers."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.randint(0, 400, (len(grids), S + 1), generator=g)
    for b, ((_, h, w), a) in enumerate(zip(grids, before)):
        n = h * w // dm.merge ** 2
        rows[b, a] = dm.start_id
        rows[b, a + 1:a + 1 + n] = dm.image_id
        rows[b, a + 1 + n] = dm.end_id
    labels = rows[:, 1:]
    vision = ((labels == dm.image_id) | (labels == dm.start_id)
              | (labels == dm.end_id))
    pixels = torch.randn(sum(h * w for _, h, w in grids), dm.patch_dim,
                         generator=g)
    return {"tokens": rows[:, :-1], "labels": labels,
            "mask": (~vision).float(), "pixels": pixels,
            "grids": torch.tensor(grids)}


def _close(a, b, tol):
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= tol * max(scale, 1e-30), (
        float((a - b).abs().max()), scale)


def test_logits_loss_and_every_gradient_match_the_reference():
    dm, cfg, flat, model = _setup()
    batch = _batch(dm)
    logits, _ = model(batch["tokens"], pixels=batch["pixels"],
                      grids=batch["grids"], mode="train")
    params = {k: v.clone() for k, v in flat.items()}
    want = ref.logits(dm, params, batch["tokens"], batch["pixels"], GRIDS)
    _close(logits.detach(), want.detach(), 2e-5)

    loss, _ = T.lm_loss(model, batch)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    for p in params.values():
        p.requires_grad_(True)
    ref_loss, ref_grads = ref.loss_and_grads(dm, params, batch, row_chunk=1)
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=1e-5)
    assert sorted(names) == sorted(ref_grads)
    for n, g in zip(names, grads):
        assert float(g.abs().max()) > 0, n
        _close(g, ref_grads[n], 2e-4)


def test_every_leaf_is_a_parameter_and_the_whole_count_is_the_sources():
    dm, cfg, flat, model = _setup()
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == {k: tuple(v.shape) for k, v in flat.items()}
    assert cfg.param_count() == sum(v.numel() for v in flat.values())
    full = ref.Dims.from_file(json.loads(
        (ROOT / "perfbench" / "configs" / "qwen2-vl-2b.json").read_text()))
    whole = configs.qwen2_vl_2b.whole_config()
    n = sum(leaf.size for g in full.groups() for leaf in g.leaves)
    assert whole.param_count() == n
    assert 2.20e9 < n < 2.22e9
    assert whole.vision_param_count() - 34_087_936 == \
        1_505_280 + 32 * 19_677_440


@pytest.mark.parametrize("grids,before", [
    (GRIDS, (4, 2)),
    ([(1, 4, 4), (1, 6, 8)], (0, 9)),
])
def test_mrope_positions_are_the_references_index(grids, before):
    dm, cfg, _, _ = _setup()
    batch = _batch(dm, grids, before=before)
    got = V.mrope_positions(cfg, batch["tokens"], grids)
    want = ref.rope_index(dm, batch["tokens"], grids)
    assert torch.equal(got.long(), want)
    # the text after an image resumes past its largest position
    n = grids[0][1] * grids[0][2] // 4
    end = before[0] + 1 + n
    img = got[:, 0, before[0] + 1:end]
    assert int(got[0, 0, end]) == int(img.max()) + 1


def test_mrope_positions_of_two_images_in_one_row():
    dm, cfg, _, _ = _setup()
    tok = torch.randint(0, 400, (1, S))
    grids = [(1, 4, 4), (1, 4, 6)]
    tok[0, 1], tok[0, 2:6], tok[0, 6] = dm.start_id, dm.image_id, dm.end_id
    tok[0, 9], tok[0, 10:16], tok[0, 16] = dm.start_id, dm.image_id, dm.end_id
    assert torch.equal(V.mrope_positions(cfg, tok, grids).long(),
                       ref.rope_index(dm, tok, grids))
    with pytest.raises(ValueError):
        V.mrope_positions(cfg, tok, grids[:1])


def test_video_grids_raise():
    dm, cfg, _, model = _setup()
    batch = _batch(dm)
    with pytest.raises(ValueError, match="video"):
        model(batch["tokens"], pixels=batch["pixels"],
              grids=torch.tensor([[2, 4, 6], [1, 8, 4]]))


def test_one_images_pixels_leave_the_others_tower_output_bit_equal():
    dm, cfg, _, model = _setup()
    batch = _batch(dm)
    px = batch["pixels"]
    n0 = GRIDS[0][1] * GRIDS[0][2]
    other = px.clone()
    other[n0:] = torch.randn_like(other[n0:])
    with torch.no_grad():
        a = V.tower(cfg, model.vision, px, GRIDS, remat=False)
        b = V.tower(cfg, model.vision, other, GRIDS, remat=False)
    assert torch.equal(a[:n0], b[:n0])
    assert not torch.equal(a[n0:], b[n0:])


def _masked_reference(q, k, v, lengths, causal):
    T = q.shape[1]
    ids = torch.repeat_interleave(torch.arange(len(lengths)),
                                  torch.tensor(lengths))
    visible = ids[:, None] == ids[None, :]
    if causal:
        visible &= torch.arange(T)[None, :] <= torch.arange(T)[:, None]
    rep = q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(rep, 2))
    s = (s * q.shape[-1] ** -0.5).masked_fill(~visible, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1),
                        v.repeat_interleave(rep, 2))


@pytest.mark.parametrize("causal", [False, True])
def test_plain_flash_with_segments_at_d80_is_a_masked_softmax(causal):
    lengths = [9, 0, 17, 1, 6]
    seg = [0, *itertools.accumulate(lengths)]
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, seg[-1], 4, 80, generator=g)
    k, v = (torch.randn(1, seg[-1], 2, 80, generator=g) for _ in range(2))
    out, lse = FA.flash_attention(q, k, v, causal=causal, return_lse=True,
                                  segments=torch.tensor(seg,
                                                        dtype=torch.int32))
    _close(out, _masked_reference(q, k, v, lengths, causal), 1e-5)
    dout = torch.randn(out.shape, generator=g)
    got = FA.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                 segments=seg)
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(_masked_reference(*x, lengths, causal), x,
                               dout)
    for a, b in zip(got, want):
        _close(a, b, 1e-5)


def test_segments_are_checked():
    q = torch.zeros(1, 10, 2, 80)
    with pytest.raises(ValueError):
        FA.flash_attention(q, q, q, segments=[0, 4, 9])
    with pytest.raises(ValueError):
        FA.flash_attention(torch.zeros(2, 5, 2, 80), torch.zeros(2, 5, 2, 80),
                           torch.zeros(2, 5, 2, 80), segments=[0, 5, 10])


@pytest.mark.parametrize("leaf", ["layers.0.attn.bq", "layers.1.attn.bv",
                                  "vision.blocks.0.attn.qkv_b"])
def test_zeroing_a_bias_changes_the_logits(leaf):
    dm, cfg, flat, model = _setup()
    batch = _batch(dm)
    with torch.no_grad():
        a, _ = model(batch["tokens"], pixels=batch["pixels"],
                     grids=batch["grids"])
        dict(model.named_parameters())[leaf].zero_()
        b, _ = model(batch["tokens"], pixels=batch["pixels"],
                     grids=batch["grids"])
    assert float((a - b).abs().max()) > 1e-3 * float(a.abs().max())


def test_serving_refuses_pixels_naming_what_is_missing():
    from repro_torch.launch import serve
    dm, cfg, _, model = _setup()
    batch = _batch(dm)
    with pytest.raises(ValueError, match="not ported.*tower"):
        serve.serve_batch(cfg, model, batch, device="cpu")


def test_image_rows_train_a_step_and_refuse_microbatches():
    from repro_torch import optim
    from repro_torch.launch import steps
    dm, cfg, _, model = _setup(dtype="bfloat16")
    batch = _batch(dm)
    opt = optim.adamw_init(dict(model.named_parameters()))
    step = steps.make_train_step(cfg, configs.TrainConfig())
    before = model.vision.blocks[1].attn.qkv_b.detach().clone()
    model, opt, m = step(model, opt, batch)
    assert torch.isfinite(m["loss"])
    assert not torch.equal(before, model.vision.blocks[1].attn.qkv_b)
    two = steps.make_train_step(cfg, configs.TrainConfig(grad_accum=2))
    with pytest.raises(ValueError, match="microbatches"):
        two(model, opt, batch)


def test_spans_and_the_pair_counter():
    from repro_torch import tracing
    dm, cfg, _, model = _setup()
    batch = _batch(dm)
    tracing.clear()
    with tracing.recording():
        T.lm_loss(model, batch)[0].backward()
    rows = tracing.summary()
    tracing.clear()
    assert rows["model.vision"]["count"] == 1
    assert rows["model.vision"]["tokens"] == 24 + 32
    assert rows["model.merger"]["count"] == 1
    assert rows["model.mrope_index"]["count"] == 1
    # remat recomputes each block in the backward, outside model.vision
    assert rows["vision.block"]["count"] == 2 * dm.v_layers
    assert rows["vision.attn_pairs"]["tokens"] == 24 ** 2 + 32 ** 2


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_other_configs_and_counts_are_repros(arch):
    from repro import configs as rc
    mine, theirs = configs.get(arch), rc.get(arch)
    for f in dataclasses.fields(theirs):
        assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    assert mine.param_count() == theirs.param_count()
    assert not mine.qkv_bias and not mine.vision_layers
    assert mine.vision_param_count() == 0


# -- on the card ----------------------------------------------------------

CELL_GRIDS = [(1, 2 * h, 2 * w) for h, w in ((24, 24), (40, 32), (28, 28),
                                             (30, 40), (26, 26), (36, 25),
                                             (25, 25), (34, 34))]
# SHA-256 of (out, lse, dq, dk, dv) of the D-128 kernels before segments
# came, on the inputs of ``_d128_case`` (recorded on an H100 80GB HBM3,
# torch 2.11.0+cu128; the kernels with segments gave the same digests)
D128_SHA256 = {
    "out": "38fd8758033dea4be7c08350830cf1a8e696e7f42d547ec2ccf970784b6e1024",
    "lse": "9eeaab5c919ced0ad6f9298a7283cb35f34c4f13c032353b58cf22d7c0e23420",
    "dq": "03706cd83e56a5a0cdb024b2ed6daf0c207fd50adb297c823e95685b7cfebdbd",
    "dk": "462880305209e5b55efa0afe2bfe3e8e9e1fd234e36035811b83ac3a23bf9bf5",
    "dv": "f13cf98f48c87291b399c1d5509a491f178cf1aeb98f918bc896b1f46f82ba2d",
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels run only there")
    return torch.device("cuda")


def _ulps_ok(got, want, ulps=2):
    """Within ``ulps`` bf16 ulps of the plain value, or 2^-8 of the
    tensor's largest element."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
    return bool(((err <= ulps * ulp) | (err <= want.abs().max() / 256)).all())


@pytest.mark.chip
@pytest.mark.parametrize("causal", [False, True])
def test_chip_d80_segmented_pair_at_the_cells_shapes(causal):
    dev = _card()
    lengths = [t * h * w for t, h, w in CELL_GRIDS]
    seg = torch.tensor([0, *itertools.accumulate(lengths)],
                       dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(80)
    q, k, v, dout = (torch.randn((1, seg[-1].item(), 16, 80), generator=g,
                                 device=dev).bfloat16() for _ in range(4))
    out, lse = FA.flash_attention(q, k, v, causal=causal, return_lse=True,
                                  segments=seg)
    pout, plse = FA.flash_attention_plain(q, k, v, causal=causal,
                                          return_lse=True, segments=seg)
    assert _ulps_ok(out, pout)
    assert float((lse - plse).abs().max()) < 1e-4
    got = FA.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                 segments=seg)
    want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                        causal=causal, segments=seg)
    for a, b in zip(got, want):
        assert _ulps_ok(a, b)
    again = FA.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                   segments=seg)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _d128_case(dev):
    g = torch.Generator(device=dev).manual_seed(128)
    q = torch.randn((2, 1000, 12, 128), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((2, 1000, 2, 128), generator=g,
                        device=dev).bfloat16() for _ in range(2))
    dout = torch.randn(q.shape, generator=g, device=dev).bfloat16()
    out, lse = FA.flash_attention(q, k, v, causal=True, return_lse=True)
    return (out, lse, *FA.flash_attention_bwd(q, k, v, out, lse, dout,
                                              causal=True))


def digest(t) -> str:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


@pytest.mark.chip
def test_chip_d128_calls_are_the_kernels_before_segments():
    dev = _card()
    got = dict(zip(("out", "lse", "dq", "dk", "dv"),
                   (digest(t) for t in _d128_case(dev))))
    assert got == D128_SHA256
