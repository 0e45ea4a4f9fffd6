"""The FLOP and byte counts against numbers worked out by hand."""
import json

import pytest

from perfbench.harness import cell, yardstick as Y
from perfbench.reference.dense import Dims

# one Yi-34B layer: q and o 7168 x 7168, k and v 7168 x 1024, and three
# 7168 x 20480 MLP matrices
LAYER = 2 * 7168 * 7168 + 2 * 7168 * 1024 + 3 * 7168 * 20480
HEAD = 7168 * 64_000


def _dims(name):
    return Dims.from_file(json.loads(
        (cell.BENCH / "configs" / f"{name}.json").read_text()))


def test_yi_34b_sizes():
    dm = _dims("yi-34b")
    assert (dm.head_dim, dm.q_dim, dm.kv_dim) == (128, 7168, 1024)
    assert dm.layer_matrix_params() == LAYER == 557_842_432
    # 60 layers, the head, and the embedding table (not a product)
    assert Y.matmul_params(dm) == 60 * LAYER + HEAD
    weights = Y.matmul_params(dm) + HEAD
    assert 2 * weights == pytest.approx(68.78e9, rel=1e-3)   # bf16 bytes


def test_train_step_of_the_depth_cut():
    dm = _dims("yi-34b-4l")
    n = 4 * LAYER + HEAD
    assert Y.matmul_params(dm) == n
    pairs = 4096 * 4097 // 2
    attn = 12 * 128 * pairs * 56 * 4 * 6
    assert Y.train_step_flops(dm, 6, 4096) == 6 * n * 24_576 + attn
    assert Y.train_step_flops(dm, 6, 4096) == pytest.approx(4.14e14, rel=5e-3)


def test_prefill_and_decode():
    dm = _dims("yi-34b")
    pairs = 1500 * 1501 // 2
    want = (2 * 60 * LAYER * 8 * 1500 + 4 * 128 * pairs * 56 * 60 * 8
            + 2 * HEAD * 8)
    assert Y.prefill_flops(dm, 8, 1500) == want
    step = 2 * (60 * LAYER + HEAD) * 8 + 4 * 128 * 1501 * 56 * 60 * 8
    assert Y.decode_step_flops(dm, 8, 1501) == step


def test_kernel_bounds():
    # the training cell's flash forward at 6 x 4096, 56 heads of 128
    pairs = 4096 * 4097 // 2
    ops = 4 * 128 * pairs * 6 * 56
    assert Y.flash_fwd_bound_s(6, 4096, 56, 8, 128, lse=True) == \
        pytest.approx(ops / 989e12)
    # the backward: 10 D a pair
    assert Y.flash_bwd_bound_s(6, 4096, 56, 8, 128) == \
        pytest.approx(10 * 128 * pairs * 6 * 56 / 989e12)
    # decode over 1501 positions, 8 kv heads of 128, bf16: bytes bound
    nbytes = (2 * 8 * 1501 * 8 * 128 + 2 * 8 * 56 * 128) * 2 + 32
    assert Y.decode_attn_bound_s(8, 56, 8, 128, 1501) == \
        pytest.approx(nbytes / 3.35e12)
    # a short sequence is bound by its bytes
    s, nb = 16, (2 * 1 * 16 * 2 * 64 + 2 * 1 * 16 * 2 * 64) * 2
    assert Y.flash_fwd_bound_s(1, s, 2, 2, 64) == pytest.approx(nb / 3.35e12)
