"""On the card: the inner-loop cell at its own size, one seed, agrees with
the reference within its limits, and the control does not.  Skips without
a card (decided in the fixture)."""
import time

import pytest
import torch

from benchmark import harness
import tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_srloop_at_size_and_its_control(card):
    cell = "svr-4stack-1mm.srloop"
    _, judged, out = harness.run_cell(tiny.ROOT, cell, 2147483600, 0.0,
                                      False, card, time.perf_counter(),
                                      control=True)
    assert all(j["ok"] for j in judged.values()), judged
    ctl = harness.judge(out.control, harness.limits_of(cell))
    assert not all(j["ok"] for j in ctl.values()), ctl
