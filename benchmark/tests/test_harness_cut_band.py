"""The recon cells' slice-weight rule on the CPU at the tiny size: the
units that rounding alone could move across a cut of the E-step's
confident set are chosen by the reference alone, a unit left out is not
compared while a unit kept is, and a rule that leaves out more than the
limit's share fails the run."""
import dataclasses

import numpy as np
import pytest

from benchmark import harness
from benchmark.reference import fast_engine
import tiny


@pytest.fixture(scope="module", params=tiny.RECON)
def window(request):
    return (request.param,) + tiny.recon_window(request.param)


@pytest.fixture
def reference(monkeypatch):
    """Records what each float32 last stage of the reference gives."""
    seen = []
    orig = fast_engine.last_stage

    def spy(*a, **k):
        last = orig(*a, **k)
        if not k.get("tf32"):
            seen.append(last)
        return last
    monkeypatch.setattr(fast_engine, "last_stage", spy)
    return seen


def judged(window, weights=None, volume=None):
    """The cell's numbers judged, with the program's slice weights and
    volume replaced where given."""
    cell, check, run, case, done = window
    (res, batch), = done
    img = res.reconstructed
    if volume is not None:
        img = type(img)(volume, img.attr)
    res = dataclasses.replace(
        res, reconstructed=img,
        slice_weights=res.slice_weights if weights is None else weights)
    _, out, _ = check(run, case, [(res, batch)])
    return harness.judge(out, harness.limits_of(cell))


def test_near_cut_ignores_the_programs_outputs(window, reference):
    res = window[-1][0][0]
    vol = np.asarray(res.reconstructed.data)
    judged(window)
    rng = np.random.default_rng(7)
    judged(window, weights=rng.uniform(0, 1, res.slice_weights.shape),
           volume=np.where(vol != -1.0, vol * 1.25 + 3.0, vol).astype(
               np.float32))
    first, second = reference
    np.testing.assert_array_equal(first.near_cut, second.near_cut)
    np.testing.assert_array_equal(first.cut_distance, second.cut_distance)
    assert first.cut_distance.shape == (len(res.slice_weights), 2)


def test_left_out_unit_is_not_compared(window, reference, monkeypatch):
    """With a band that leaves out the unit nearest the cut: moving that
    unit's weight by 0.5 passes, moving a kept unit's fails."""
    res = window[-1][0][0]
    assert tiny.reference_numbers_ok(judged(window))
    dist = reference[0].cut_distance[:, 0]
    order = np.argsort(dist)
    monkeypatch.setattr(fast_engine, "CUT_BAND",
                        float(np.nextafter(dist[order[0]], np.inf)))
    monkeypatch.setattr(fast_engine, "SUME_BAND", 0.0)
    sw = np.asarray(res.slice_weights, np.float64)
    for unit, ok in ((order[0], True), (order[-1], False)):
        moved = sw.copy()
        moved[unit] += 0.5 if moved[unit] < 0.5 else -0.5
        got = judged(window, weights=moved.astype(np.float32))
        assert reference[-1].near_cut[unit] == ok
        assert got["slice_weight_gap"]["ok"] == ok, got
        assert got["slice_weight_left_out"]["ok"], got


def test_leaving_out_more_than_the_limit_fails(window, reference,
                                               monkeypatch):
    cell = window[0]
    judged(window)
    dist = np.sort(reference[0].cut_distance[:, 0])
    limit = harness.limits_of(cell)["slice_weight_left_out"]["max"]
    k = int(limit * len(dist)) + 1  # units to leave out: over the limit
    assert k < len(dist)
    monkeypatch.setattr(fast_engine, "CUT_BAND",
                        float(np.nextafter(dist[k - 1], np.inf)))
    got = judged(window)
    assert got["slice_weight_left_out"]["value"] > limit
    assert not got["slice_weight_left_out"]["ok"]
    assert got["slice_weight_gap"]["ok"]  # the units kept still agree
