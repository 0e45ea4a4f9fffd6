"""Training rows of text around one image each.  A mix that names this
generator (``"generator": "image_rows"``) gives ``batch`` rows of
``seq_len`` positions a step, each row ``text_before`` text ids, then the
image block (``<|vision_start|>``, one image pad a merged cell,
``<|vision_end|>``), then text to the end, as Qwen2-VL's processor lays
out a document page and its question and answer.  Each image is a grid of
h x w merged cells, h and w drawn uniformly in [``min_side``,
``max_side``] and drawn again while h w > ``max_cells``; its patches
number (merge h) x (merge w), t = 1.  A step's grids are drawn on the
host (:func:`grids`), so the FLOP count and the metric readers know them
without reading the card: their sizes from the mix's own generator
(``plan_seed``), the same for every run, as a serving mix's lengths are,
so that every run does the same work step by step; the run's seed deals
them to the rows.  Text ids are
uniform over the ordinary ids [0, ``text_ids``); pixels are normals.
Both are drawn on the device from generators of their own
(``draw.derive``).  Labels are the row's next ids; ``mask`` is 0 where the
label is an image pad or a vision marker, 1 elsewhere, so the loss is on
text only.
"""
from __future__ import annotations

import random

import torch

from perfbench.harness import draw


def grids(traffic: dict, seed: int, i: int) -> list[tuple[int, int, int]]:
    """Step i's (t, h, w) grids in patches, one a row, drawn on the host:
    the mix's sizes for step i, dealt to the rows by the run's seed."""
    im = traffic["image"]
    rng = random.Random(draw.derive(traffic["plan_seed"], "grids", i))
    out = []
    for _ in range(traffic["batch"]):
        while True:
            h = rng.randint(im["min_side"], im["max_side"])
            w = rng.randint(im["min_side"], im["max_side"])
            if h * w <= im["max_cells"]:
                break
        out.append((1, im["merge"] * h, im["merge"] * w))
    random.Random(draw.derive(seed, "deal", i)).shuffle(out)
    return out


class Feed:
    """``batch(i)``: step i's batch, the same for the program and the
    reference: tokens, labels and mask (B, S) and pixels (patches,
    patch_dim) on the device, grids (images, 3) on the host."""

    def __init__(self, traffic: dict, dm, seed: int, device):
        self.traffic, self.dm, self.seed, self.device = traffic, dm, seed, \
            device
        self.B, self.S = traffic["batch"], traffic["seq_len"]
        self.tokens_per_step = self.B * self.S

    def grids(self, i: int) -> list[tuple[int, int, int]]:
        return grids(self.traffic, self.seed, i)

    def batch(self, i: int) -> dict:
        dm, t, dev = self.dm, self.traffic, self.device
        grid = self.grids(i)
        g = draw.generator(dev, self.seed, "rows", i)
        rows = torch.randint(0, t["text_ids"], (self.B, self.S + 1),
                             generator=g, device=dev)
        a = t["image"]["text_before"]
        for b, (_, h, w) in enumerate(grid):
            cells = h * w // dm.merge ** 2
            rows[b, a] = dm.start_id
            rows[b, a + 1:a + 1 + cells] = dm.image_id
            rows[b, a + 1 + cells] = dm.end_id
        labels = rows[:, 1:]
        vision = ((labels == dm.image_id) | (labels == dm.start_id)
                  | (labels == dm.end_id))
        patches = sum(h * w for _, h, w in grid)
        pixels = torch.randn((patches, dm.patch_dim), device=dev,
                             generator=draw.generator(dev, self.seed,
                                                      "pixels", i))
        return {"tokens": rows[:, :-1], "labels": labels,
                "mask": (~vision).float(), "pixels": pixels,
                "grids": torch.tensor(grid, dtype=torch.int64)}

    reference_batch = batch
