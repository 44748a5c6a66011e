"""The port's CUDA kernels on the card, against their plain versions.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

(--noconftest: tests/conftest.py sets up JAX).  Without a card every test
here skips.  Limits: B1 max|diff| <= 1e-5 * max|ref| (the plain version's
index_add runs its adds in another order); B2 bitwise (the same adds in the
same order); the slice within 1e-4 relative of the CPU run (f32 sums in
another order across the whole sequence).
"""
import numpy as np
import pytest
import torch

from fetalreconstruction_tpu_torch.ops import scatter

SHAPES = [((20, 18, 16), 12, 10, 2), ((33, 33, 33), 7, 17, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(vol, n, hw, n_stacks, device):
    rng = np.random.default_rng(3)
    xp = rng.uniform(-2.0, max(vol) + 1.0, (n, hw, hw, 3)).astype(np.float32)
    sid = rng.integers(0, n_stacks, (n,))
    pa = rng.uniform(-1, 1, (n, hw, hw)).astype(np.float32)
    pb = rng.uniform(0, 1, (n, hw, hw)).astype(np.float32)
    zs, ys, xs = vol
    u = np.floor(xp).astype(np.int64)
    inb = ((u[..., 0] >= -1) & (u[..., 0] < xs) & (u[..., 1] >= -1)
           & (u[..., 1] < ys) & (u[..., 2] >= -1) & (u[..., 2] < zs))
    return [torch.as_tensor(a, device=device)
            for a in (xp, sid, np.where(inb, pa, 0), np.where(inb, pb, 0))]


@pytest.mark.gpu
@pytest.mark.parametrize("vol,n,hw,n_stacks", SHAPES)
def test_kernels_match_plain(cuda, vol, n, hw, n_stacks):
    xp, sid, pa, pb = _inputs(vol, n, hw, n_stacks, cuda)
    plan = scatter.build_scatter_plan(xp, sid, vol, n_stacks)
    before = dict(scatter.LAUNCHES)
    acc = scatter.splat2_blocked(plan, pa, pb)
    dense = scatter.unblock2(acc, vol)
    torch.cuda.synchronize()
    assert scatter.LAUNCHES["splat2_rows"] == before["splat2_rows"] + 1
    assert scatter.LAUNCHES["unblock2"] == before["unblock2"] + 1
    ref = scatter.splat2_blocked_plain(xp, pa, pb, vol, sid, n_stacks)
    err = float((acc - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max()), err
    # the CPU plan and plain path give the same accumulator
    cpu = scatter.splat2_blocked_plain(xp.cpu(), pa.cpu(), pb.cpu(), vol,
                                       sid.cpu(), n_stacks)
    assert float((acc.cpu() - cpu).abs().max()) <= \
        1e-5 * float(cpu.abs().max())
    assert torch.equal(dense, scatter.unblock2_plain(acc, vol))
    # no atomics: two runs are bitwise equal
    assert torch.equal(acc, scatter.splat2_blocked(plan, pa, pb))


@pytest.mark.gpu
def test_wrappers_reject_bad_inputs(cuda):
    vol, n, hw, n_stacks = SHAPES[0]
    xp, sid, pa, pb = _inputs(vol, n, hw, n_stacks, cuda)
    plan = scatter.build_scatter_plan(xp, sid, vol, n_stacks)
    with pytest.raises(TypeError):
        scatter.splat2_blocked(plan, pa.double(), pb.double())
    with pytest.raises(ValueError):
        scatter.splat2_blocked(plan, pa[:1], pb[:1])
    with pytest.raises(ValueError):
        scatter.splat2_blocked(plan, pa, pb.cpu())
    acc = scatter.splat2_blocked(plan, pa, pb)
    with pytest.raises(ValueError):
        scatter.unblock2(acc, (vol[0] + 2,) + vol[1:])


@pytest.mark.gpu
def test_slice_on_card_matches_cpu(cuda):
    """A small canonical-geometry slice: kernel path on the card vs the
    plain path on the CPU."""
    import chip_smoke
    from fetalreconstruction_tpu_torch.pipeline.synthetic import (
        canonical_problem)

    small = dict(n_stacks=4, stack_slices=6, hw=24, vol=24)
    runs = [chip_smoke.run_slice(canonical_problem(d, **small))
            for d in (cuda, "cpu")]
    (rg, eg, *_), (rc, ec, *_) = runs
    for out, ref in ((rg, rc), (eg.weights, ec.weights),
                     (eg.slice_weight, ec.slice_weight),
                     (eg.sigma2, ec.sigma2), (eg.mix, ec.mix), (eg.m, ec.m)):
        out, ref = out.cpu().double(), ref.double()
        assert bool(torch.isfinite(out).all())
        err = float((out - ref).abs().max() / ref.abs().max())
        assert err <= 1e-4, err
