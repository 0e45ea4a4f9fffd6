"""Leaf declarations, the tree, step FLOPs and segment bounds.

Pins: Yi's draws, trees, FLOP counts and kernel bounds as the harness gave
them before configurations declared their own leaves (SHA-256 of each
small copy's ``draw.weights`` on seeds 5, 7 and 11; the nested tree's and
the model's names and shapes; the counts at both cells' full shapes).
Then a toy configuration that is not a dense decoder, declared here and
nowhere under ``perfbench/``: a tower of blocks whose vectors are not
``d`` wide under a top-level subtree, a merger, and a FLOP count from each
batch's image sizes.  It goes through the harness's own draw, nest, group
redraw and FLOP sum."""
import hashlib
import json
import types

import pytest
import torch

import small
from perfbench.generators import length_grouped
from perfbench.harness import cell, draw, program, train_loop
from perfbench.harness import yardstick as Y
from perfbench.reference import dense
from perfbench.reference.leaves import Group, Leaf

CPU = torch.device("cpu")

# recorded on the harness before this change
WEIGHTS_SHA256 = {
    ("yi-34b-4l", 5):
        "3a6963bc66ec5fd283e9026d79a4d8e43d7f33b329a0fb927196ea189b3d1cf5",
    ("yi-34b-4l", 7):
        "d5868f2fb315766d1dd362235b3c0fe005a92c29d022107db7fed387d6d7ae00",
    ("yi-34b-4l", 11):
        "cc89c3ac41529ad440e7b72466f0d8c4b5663fa7f90a06cd4ec10f72817083d3",
    ("yi-34b", 5):
        "dd13b22ed4af58240cc176adb64d19e8ee57ba08ad8968629363f13d8e5c2ced",
    ("yi-34b", 7):
        "3f4176cc3f61ac8a34533565e46505244a944a762ead5bc7b4aaea1d64606416",
    ("yi-34b", 11):
        "f5171ad65a0b4a1a3dafc84fd2611b228b49a74e5e3522d210d58ddf922b8a5b",
}
# the dtype each cell's loop draws its matrices in
DTYPE = {"yi-34b-4l": torch.float32, "yi-34b": torch.bfloat16}
# (name, shape) of every leaf at full size, in draw order: SHA-256, count
FULL_LEAVES = {
    "yi-34b-4l": (
        "de8ae8584af3e5a10d77f3ddbbf31905e25a10648c1824b0a26f8cfb7b426326",
        39),
    "yi-34b": (
        "c409d12e862976ba1ea894db73260608ab12c24c5aa909fbad5552dc0fccf260",
        543),
}
TRAIN_STEP_FLOPS = 551_994_834_026_496          # yi-34b-4l, 8 x 4,096
SERVE_CYCLE_FLOPS = (7_657_158_463_324_160,     # prefills of one cycle
                     300_120_219_320_320)       # its decode steps


def _digest(flat: dict) -> str:
    h = hashlib.sha256()
    for k, v in flat.items():
        h.update(k.encode())
        h.update(repr((tuple(v.shape), str(v.dtype))).encode())
        t = v.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def _walk(tree, pre=""):
    """(dotted path, shape) of every leaf of a nested tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{pre}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{pre}{i}.")
    else:
        yield pre[:-1], list(tree.shape)


def _full(name):
    return dense.Dims.from_file(json.loads(
        (cell.BENCH / "configs" / f"{name}.json").read_text()))


@pytest.mark.parametrize("conf,seed", sorted(WEIGHTS_SHA256))
def test_yi_draws_are_the_parents_to_the_bit(conf, seed):
    dm = dense.Dims.from_file(small.config(conf))
    got = draw.weights(dm, seed, CPU, DTYPE[conf])
    assert _digest(got) == WEIGHTS_SHA256[conf, seed]


@pytest.mark.parametrize("conf", sorted(FULL_LEAVES))
def test_yi_full_size_leaves_are_the_parents(conf):
    seq = [[g.prefix + leaf.name, list(leaf.shape)]
           for g in _full(conf).groups() for leaf in g.leaves]
    digest = hashlib.sha256(json.dumps(seq).encode()).hexdigest()
    assert (digest, len(seq)) == FULL_LEAVES[conf]


@pytest.mark.parametrize("conf", sorted(DTYPE))
def test_yi_tree_and_model_names_and_shapes(conf):
    c = small.config(conf)
    dm = dense.Dims.from_file(c)
    flat = draw.weights(dm, 5, CPU)
    tree = program.nest(flat)
    layer = [["attn.wk", [64, 16]], ["attn.wo", [64, 64]],
             ["attn.wq", [64, 64]], ["attn.wv", [64, 16]],
             ["ln1.scale", [64]], ["ln2.scale", [64]],
             ["mlp.down", [128, 64]], ["mlp.gate", [64, 128]],
             ["mlp.up", [64, 128]]]
    want = ([["embed", [96, 64]], ["final_norm", [64]]]
            + [[f"layers.{i}.{n}", s] for i in range(2) for n, s in layer]
            + [["lm_head", [64, 96]]])
    assert sorted(map(list, _walk(tree))) == want
    assert isinstance(tree["layers"], list) and len(tree["layers"]) == 2
    cfg, _ = program.model_config(c, dense.program_fields(dm, c))
    model = program.model(cfg, flat, trainable=True)
    order = ["embed", "final_norm", "lm_head"] + [
        f"layers.{i}.{n}" for i in range(2) for n in
        ("ln1.scale", "ln2.scale", "attn.wq", "attn.wk", "attn.wv",
         "attn.wo", "mlp.gate", "mlp.up", "mlp.down")]
    assert [n for n, _ in model.named_parameters()] == order
    assert all(list(p.shape) == list(flat[n].shape)
               for n, p in model.named_parameters())


def test_yi_flop_counts_at_the_cells_full_shapes():
    dm = _full("yi-34b-4l")
    assert Y.train_step_flops(dm, 8, 4096) == TRAIN_STEP_FLOPS
    feed = types.SimpleNamespace(B=8, S=4096)
    assert dense.train_batch_flops(dm, feed, 3) == TRAIN_STEP_FLOPS
    assert train_loop.window_flops(dense, dm, feed, 2, 7) == \
        7 * TRAIN_STEP_FLOPS
    dm = _full("yi-34b")
    mix = json.loads((cell.BENCH / "traffic" /
                      "code-completion.json").read_text())
    plan, B = length_grouped.plan(mix), mix["batch"]
    assert sum(Y.prefill_flops(dm, B, S) for S, _ in plan) == \
        SERVE_CYCLE_FLOPS[0]
    assert sum(Y.decode_step_flops(dm, B, S + j + 1) for S, a in plan
               for j in range(max(a) - 1)) == SERVE_CYCLE_FLOPS[1]


@pytest.mark.parametrize("B,S,H,KV,D", [(1, 4096, 56, 8, 128),
                                        (8, 4096, 56, 8, 128),
                                        (8, 1500, 56, 8, 128),
                                        (3, 17, 16, 16, 80)])
def test_old_bounds_are_the_segment_forms_at_causal_segments(B, S, H, KV, D):
    assert Y.segment_pairs([S] * B) == B * Y.causal_pairs(S)
    for lse in (False, True):
        assert Y.flash_fwd_bound_s(B, S, H, KV, D, lse=lse) == \
            Y.flash_fwd_segments_bound_s([S] * B, H, KV, D, lse=lse)
    assert Y.flash_bwd_bound_s(B, S, H, KV, D) == \
        Y.flash_bwd_segments_bound_s([S] * B, H, KV, D)


def test_yi_bounds_are_the_parents():
    # the training cell's pair and the serving cell's median prefill
    assert Y.flash_fwd_bound_s(8, 4096, 56, 8, 128, lse=True) == \
        0.0019460213454560163
    assert Y.flash_fwd_bound_s(8, 1500, 56, 8, 128) == 0.0002610920444893832
    assert Y.flash_bwd_bound_s(8, 4096, 56, 8, 128) == 0.00486505336364004
    assert Y.decode_attn_bound_s(8, 56, 8, 128, 1501) == \
        1.4750500298507462e-05


def test_segment_pairs_and_bounds_by_hand():
    # two images of 6 and 4 patches, every patch seeing its whole image
    assert Y.segment_pairs([6, 4], causal=False) == 36 + 16
    assert Y.segment_pairs([6, 4]) == 21 + 10
    # 16 heads of 80 (no GQA), float32 LSE: bound by operations
    T, pairs = 2304 + 5120, 2304 ** 2 + 5120 ** 2
    ops = 4 * 80 * pairs * 16
    nbytes = 4 * T * 16 * 80 * 2 + 4 * T * 16
    want = max(ops / Y.PEAK_FLOPS, nbytes / Y.PEAK_BYTES)
    assert Y.flash_fwd_segments_bound_s([2304, 5120], 16, 16, 80,
                                        causal=False, lse=True) == want
    ops = 10 * 80 * pairs * 16
    nbytes = 8 * T * 16 * 80 * 2 + 4 * T * 16
    assert Y.flash_bwd_segments_bound_s([2304, 5120], 16, 16, 80,
                                        causal=False) == \
        max(ops / Y.PEAK_FLOPS, nbytes / Y.PEAK_BYTES)


# -- a toy configuration that is not a dense decoder --------------------------

class ToyDims:
    """A tower of 2 blocks of width 6 (qkv 18 wide, with biases and
    LayerNorm shifts drawn as normals), a patch embedding and 2 learned
    positions under ``vision``, a merger at the top level, and 2 decoder
    layers of width 8."""
    d, vocab, layers, init_std = 8, 16, 2, 0.1
    tower, patch_in = 6, 12

    def groups(self):
        std = self.init_std
        return [Group(("embed",), "", (Leaf("embed", (self.vocab, self.d),
                                             std),)),
                Group(("patch",), "vision.", (
                    Leaf("patch.w", (self.patch_in, self.tower), std),
                    Leaf("pos.0", (self.tower,), 0.02),
                    Leaf("pos.1", (self.tower,), 0.02))),
                *(self._block(j) for j in range(2)),
                Group(("merger",), "merger.", (
                    Leaf("fc1", (4 * self.tower, 4 * self.tower), std),
                    Leaf("fc1_b", (4 * self.tower,), 0.02),
                    Leaf("fc2", (4 * self.tower, self.d), std))),
                *(self._layer(i) for i in range(self.layers))]

    def _block(self, j):
        w = self.tower
        return Group(("vision_block", j), f"vision.blocks.{j}.", (
            Leaf("norm.scale", (w,), None), Leaf("norm.shift", (w,), 0.02),
            Leaf("attn.qkv", (w, 3 * w), self.init_std),
            Leaf("attn.qkv_b", (3 * w,), 0.02)))

    def _layer(self, i):
        return Group(("layer", i), f"layers.{i}.", (
            Leaf("ln.scale", (self.d,), None),
            Leaf("attn.wq", (self.d, self.d), self.init_std),
            Leaf("attn.k_b", (4,), 0.02)))


class ToyFeed:
    """Host-side facts of each batch: its images' patch counts."""
    B, S = 2, 10

    def patches(self, i: int) -> list[int]:
        return [4 + (i + r) % 3 for r in range(self.B)]


def toy_batch_flops(dm, feed, i):
    """6 a weight a patch through the tower, 12 D a pair of patches of one
    image, each head (1 of 6) and block; 6 a weight a text position."""
    tower = 2 * (dm.tower * 3 * dm.tower)
    sizes = feed.patches(i)
    return (6 * tower * sum(sizes)
            + 12 * 6 * Y.segment_pairs(sizes, causal=False) * 2
            + 6 * dm.layers * dm.d * dm.d * feed.B * feed.S)


def test_a_toy_declaration_draws_nests_and_redraws():
    dm = ToyDims()
    flat = draw.weights(dm, 2 ** 40 + 3, CPU)
    want = {"embed": (16, 8), "vision.patch.w": (12, 6),
            "vision.pos.0": (6,), "vision.pos.1": (6,),
            **{f"vision.blocks.{j}.{n}": s for j in range(2)
               for n, s in (("norm.scale", (6,)), ("norm.shift", (6,)),
                            ("attn.qkv", (6, 18)), ("attn.qkv_b", (18,)))},
            "merger.fc1": (24, 24), "merger.fc1_b": (24,),
            "merger.fc2": (24, 8),
            **{f"layers.{i}.{n}": s for i in range(2)
               for n, s in (("ln.scale", (8,)), ("attn.wq", (8, 8)),
                            ("attn.k_b", (4,)))}}
    assert {k: tuple(v.shape) for k, v in flat.items()} == want
    assert list(flat) == list(want)
    # norm scales are ones; biases, shifts and positions are normals
    assert torch.equal(flat["vision.blocks.1.norm.scale"], torch.ones(6))
    for k in ("vision.blocks.0.attn.qkv_b", "vision.blocks.1.norm.shift",
              "merger.fc1_b", "layers.1.attn.k_b", "vision.pos.1"):
        assert float(flat[k].abs().min()) > 0 and float(flat[k].std()) < 0.1
    assert float(flat["merger.fc1"].std()) == pytest.approx(0.1, rel=0.3)
    assert not torch.equal(flat["vision.blocks.0.attn.qkv"],
                           flat["vision.blocks.1.attn.qkv"])

    tree = program.nest(flat)
    assert sorted(tree) == ["embed", "layers", "merger", "vision"]
    assert sorted(tree["vision"]) == ["blocks", "patch", "pos"]
    assert isinstance(tree["vision"]["blocks"], list)
    assert isinstance(tree["vision"]["pos"], list)
    assert [t.shape for t in tree["vision"]["pos"]] == [(6,), (6,)]
    assert tree["vision"]["blocks"][1]["attn"]["qkv_b"] is \
        flat["vision.blocks.1.attn.qkv_b"]
    assert tree["merger"]["fc2"] is flat["merger.fc2"]
    assert tree["layers"][0]["attn"]["k_b"] is flat["layers.0.attn.k_b"]
    assert sorted(map(tuple, _walk(tree))) == sorted(
        (k, list(s)) for k, s in want.items())

    # one group drawn again alone, bit for bit
    again = draw.group(dm, ("vision_block", 1), 2 ** 40 + 3, CPU)
    assert list(again) == ["norm.scale", "norm.shift", "attn.qkv",
                           "attn.qkv_b"]
    for k, v in again.items():
        assert torch.equal(v, flat[f"vision.blocks.1.{k}"])
    assert torch.equal(draw.group(dm, ("merger",), 2 ** 40 + 3, CPU)["fc1"],
                       flat["merger.fc1"])
    with pytest.raises(KeyError):
        draw.group(dm, ("vision_block", 2), 2 ** 40 + 3, CPU)


def test_a_toy_declaration_sums_its_flops_batch_by_batch():
    dm, feed = ToyDims(), ToyFeed()
    ref = types.SimpleNamespace(train_batch_flops=toy_batch_flops)
    got = train_loop.window_flops(ref, dm, feed, 2, 3)
    assert got == sum(toy_batch_flops(dm, feed, i) for i in (2, 3, 4))
    # batches of other image sizes count other FLOPs
    assert got != 3 * toy_batch_flops(dm, feed, 2)
