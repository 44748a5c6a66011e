"""The exact-engine cell on the CPU at the tiny size (its loop is
`recon_exact`, so tiny.RECON leaves it out): the program agrees with the
exact reference within the cell's limits and its traced run reads
`exact_psf_s` and the recon cells' metrics of the program's rows; the
control (every PSF weight and payload rounded to TF32) and each fault of the cell's own (every other unit left out, registration
returning its transforms, the support cut to the offsets of weight 1e-2
and more) fail a compared number; the traced reconstruction's transfer
stamps take the device operations that start inside them."""
import numpy as np
import pytest
import torch

from benchmark import harness
import tiny

CELL = "svr-4stack-1mm-exact.recon-exact"
# each fault, and the compared number that it fails
FAULTS = {"half_units": "batch_gap", "coarse_offsets": "volume_gap",
          "unchanged_registration": "reg_gain_mm"}
# the per-layer metrics of the recon cells that the cell reports from the
# program's rows, which a CPU run has too
HOST_METRICS = ("stack_registration_s",
                "stack_registration_ms_per_cost_eval",
                "registration_s_per_round",
                "registration_cost_evals_per_round",
                "registration_ms_per_cost_eval", "host_prep_s",
                "recon_phases_s")


@pytest.fixture(scope="module")
def sound():
    return tiny.run(CELL, trace=True, control=True)


def test_program_agrees_with_the_reference(sound):
    result, judged, out = sound
    assert out.failed == 0 and out.attempted == 1
    assert tiny.reference_numbers_ok(judged), judged
    assert result["metrics"]["exact_psf_s"]["value"] > 0
    assert "exact_psf_roofline" not in result["metrics"]  # no device trace
    for name in HOST_METRICS:
        assert result["metrics"][name]["value"] > 0, name


def test_control_fails(sound):
    ctl = harness.judge(sound[2].control, harness.limits_of(CELL))
    assert not ctl["volume_gap"]["ok"], ctl


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_fails(sound, fault):
    result, judged, out = tiny.run(CELL, faults=(fault,))
    number = FAULTS[fault]
    assert result["correct"] is False and not judged[number]["ok"], judged
    if number in tiny.TRUTH:
        # held against the case's truth, which the tiny size misses even
        # when sound: the fault reads lower still
        assert out.checks[number] < sound[2].checks[number]


def test_transfer_stamps_take_what_starts_inside():
    span = harness.driver("recon_exact").TransferSpan(torch.device("cuda",
                                                                   0))
    span.t0, span.t1 = 0, 100
    span.ranges = [(10, 20), (50, 70)]
    span.events = [("a", 5, 4), ("b", 10, 3), ("c", 19, 30), ("d", 20, 5),
                   ("e", 60, 1), ("Memcpy", 69, 2), ("f", 70, 1)]
    psf = span.summary()["psf"]
    assert psf == dict(calls=2, host_s=30e-9, device_s=36e-9, events=4)
    assert np.isclose(span.summary()["busy_s"], 40e-9)
