"""The control comes out not correct, and so does every fault that a cell
can have, planted underneath a run whose look for a chip is skipped (CPU,
tiny sizes; the control's TF32 is emulated by rounding operands)."""
import pytest
import torch

from benchmark import harness
from benchmark.reference.fast_engine import round_tf32
import tiny

FAULTS = ["unchanged_step", "half_batch", "altered_volume"]
RECON_FAULTS = ["half_units"]  # a fault of the recon cells' batch


def test_round_tf32_keeps_ten_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -3.0 - 2 ** -9], dtype=torch.float32)
    assert round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0, 1.0,
                                      -3.0 - 2 ** -9]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_fails(cell):
    _, judged, out = tiny.run(cell, control=True)
    assert tiny.reference_numbers_ok(judged)
    ctl = harness.judge(out.control, harness.limits_of(cell))
    assert not tiny.reference_numbers_ok(ctl)


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in tiny.CELLS
    for f in FAULTS + (RECON_FAULTS if c in tiny.RECON else [])])
def test_fault_fails(cell, fault):
    result, judged, _ = tiny.run(cell, faults=(fault,))
    assert result["correct"] is False
    assert not tiny.reference_numbers_ok(judged)
