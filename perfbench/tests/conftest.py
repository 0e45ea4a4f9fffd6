"""Test settings of the benchmark's own tests (``pytest perfbench/tests``;
the repository's ``pytest.ini`` collects only ``tests/``, so its tier-1
run does not see these).  Tests marked ``chip`` need an NVIDIA card and
skip elsewhere; on the card: ``python3 -m pytest -q perfbench/tests -m
chip``."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the "
                    "cell's size")
    return torch.device("cuda")
