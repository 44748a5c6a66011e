"""The port's CUDA kernels on the card, against their plain versions.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

(--noconftest: tests/conftest.py sets up JAX).  Without a card every test
here skips.  Limits: splat2_dense max|diff| <= 1e-5 * max|ref| of the plain
version on the card (its index_add_ adds a run of 3 or more in another
order), bitwise equal to the plain version on the CPU (which adds in the
kernel's order) and across two runs (no atomics); the slice within 1e-4
relative of the CPU run (f32 sums in another order across the whole
sequence).  The fused registration cost (`frt_reg_ncc_cost`) within 2e-5
of its torch path on the card (the rigid map's float32 products in
another order; NCC's sums in float64 against float32), bitwise equal
across two calls and per row to the full batch, two kernels a call.
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
    dense = scatter.splat2_dense(plan, pa, pb)
    torch.cuda.synchronize()
    assert scatter.LAUNCHES["splat2_dense"] == before["splat2_dense"] + 1
    assert dense.shape == (n_stacks, 2) + vol
    ref = scatter.splat2_dense_plain(xp, pa, pb, vol, sid, n_stacks)
    err = float((dense - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max()), err
    # the CPU plan and plain path give the same volumes: the plain version
    # adds in the kernel's order, in sequence on the CPU, so bit for bit
    cpu_plan = scatter.build_scatter_plan(xp.cpu(), sid.cpu(), vol, n_stacks)
    assert torch.equal(cpu_plan.pix, plan.pix.cpu())
    assert torch.equal(cpu_plan.cell_ptr, plan.cell_ptr.cpu())
    cpu = scatter.splat2_dense(cpu_plan, pa.cpu(), pb.cpu())
    assert float((dense.cpu() - cpu).abs().max()) <= \
        1e-5 * float(cpu.abs().max())
    assert torch.equal(dense.cpu(), cpu)
    # no atomics: two runs are bitwise equal
    assert torch.equal(dense, scatter.splat2_dense(plan, pa, pb))


@pytest.mark.gpu
def test_crowded_tile_matches_plain(cuda):
    """Thousands of slots in one block's tile, runs of dozens of slots:
    the kernel agrees with the plain version and repeats bitwise."""
    vol, n_stacks = (8, 8, 40), 1
    rng = np.random.default_rng(5)
    xp = rng.uniform(1.0, 4.0, (40, 8, 8, 3)).astype(np.float32)
    xp[..., 0] = rng.uniform(-1.0, 39.5, (40, 8, 8))  # spread over 2 tiles
    sid = np.zeros(40, np.int64)
    pa = rng.uniform(-1, 1, (40, 8, 8)).astype(np.float32)
    pb = rng.uniform(0, 1, (40, 8, 8)).astype(np.float32)
    xp, sid, pa, pb = (torch.as_tensor(a, device=cuda)
                       for a in (xp, sid, pa, pb))
    plan = scatter.build_scatter_plan(xp, sid, vol, n_stacks)
    dense = scatter.splat2_dense(plan, pa, pb)
    ref = scatter.splat2_dense_plain(xp, pa, pb, vol, sid, n_stacks)
    err = float((dense - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max()), err
    assert torch.equal(dense, scatter.splat2_dense(plan, pa, pb))


@pytest.mark.gpu
def test_wrappers_reject_bad_inputs(cuda):
    vol, n, hw, n_stacks = SHAPES[0]
    xp, sid, pa, pb = _inputs(vol, n, hw, n_stacks, cuda)
    plan = scatter.build_scatter_plan(xp, sid, vol, n_stacks)
    with pytest.raises(TypeError):
        scatter.splat2_dense(plan, pa.double(), pb.double())
    with pytest.raises(ValueError):
        scatter.splat2_dense(plan, pa[:1], pb[:1])
    with pytest.raises(ValueError):
        scatter.splat2_dense(plan, pa, pb.cpu())
    with pytest.raises(ValueError):
        scatter.splat2_dense(plan._replace(cell_ptr=plan.cell_ptr[:-1]),
                             pa, pb)
    with pytest.raises(ValueError):
        scatter.splat2_dense(plan, pa.transpose(1, 2), pb)


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


# (H = W or (H, W), sigma_pix, volume dtype): SVR slices at levels 0-2
# (r = 2) and a 0.75 mm slice (240^2), a PVR patch at r = 2, 4, 8,
# table_dtype "f32" once, and -1 padded patches of other shapes (as
# superpixel and hierarchical PVR make them)
REG_SHAPES = [(180, 0.5, "bf16"), (90, 0.5, "bf16"), (45, 0.5, "bf16"),
              (240, 0.5, "bf16"), (40, 0.5, "bf16"), (40, 1.0, "bf16"),
              (40, 2.0, "bf16"), (40, 1.0, "f32"), ((52, 37), 1.0, "bf16"),
              ((26, 200), 2.0, "bf16")]


@pytest.mark.gpu
@pytest.mark.parametrize("hw,sigma,dtype", REG_SHAPES)
@pytest.mark.parametrize("level", [0, 1])
def test_fused_cost_matches_torch_path(cuda, hw, sigma, dtype, level):
    """Rows with an all -1 target, samples outside the volume, half
    outside, and a compacted row subset."""
    import chip_smoke
    from fetalreconstruction_tpu_torch.register import slice2vol as s2v

    case = chip_smoke.reg_cost_case(cuda, 12, hw, sigma)
    fused, plain = chip_smoke.reg_cost_fns(case, sigma, level, dtype)
    before = s2v.LAUNCHES["reg_ncc_cost"]
    got = fused(case["params"])
    assert s2v.LAUNCHES["reg_ncc_cost"] == before + 1
    ref = plain(case["params"])
    err = float((got - ref).abs().max())
    assert err <= chip_smoke.REG_COST_TOL, (err, got, ref)
    assert float(got[0]) == 0.0 and float(got[1]) == 0.0
    assert torch.equal(got, fused(case["params"]))
    rows = torch.tensor([9, 1, 2, 5], device=cuda)
    sub = {k: case[k].index_select(0, rows)
           for k in ("ofs", "tgt", "mean", "params")}
    part, _ = chip_smoke.reg_cost_fns(dict(case, **sub), sigma, level,
                                      dtype)
    assert torch.equal(part(sub["params"]), got[rows])


@pytest.mark.gpu
@pytest.mark.parametrize("n,hw,sigma,level", [(1, 180, 0.5, 0),
                                              (40, 90, 0.5, 0),
                                              (300, 40, 2.0, 1),
                                              (3, 240, 0.5, 0),
                                              (20, (52, 37), 1.0, 1)])
def test_fused_cost_enqueues_two_kernels(cuda, n, hw, sigma, level):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke

    case = chip_smoke.reg_cost_case(cuda, n, hw, sigma)
    fused, _ = chip_smoke.reg_cost_fns(case, sigma, level)
    fused(case["params"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fused(case["params"])
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert len(names) == 2, names
    assert all("reg_cost" in k for k in names), names


@pytest.mark.gpu
def test_registration_on_card_runs_fused_without_table(cuda):
    """register_slices_to_volume on the card: the fused cost, no shingle
    table (its peak stays under the table's size), transforms finite and
    no slice's similarity below its start (one level: the sweeps only
    accept gains)."""
    import chip_smoke
    from fetalreconstruction_tpu_torch.core.geometry import (
        rigid_matrix_torch)
    from fetalreconstruction_tpu_torch.register import slice2vol as s2v

    case = chip_smoke.reg_cost_case(cuda, 8, 40, 0.5, spacing=1.0)
    n = case["tgt"].shape[0]
    mo = torch.eye(4, device=cuda).repeat(n, 1, 1)
    cfg = s2v.SliceRegConfig(levels=1, iterations=3)
    tgt, ofs, mean = s2v.level_arrays(1, 0.5, case["tgt"], case["ofs"])
    start = s2v.make_cost_fn(cfg, case["vol"], case["w2i"], ofs, tgt, mean,
                             (40, 40), 0, 0.5)(case["params"])
    table_bytes = 8 * 65 ** 3 * 2
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = s2v.LAUNCHES["reg_ncc_cost"]
    out, sim = s2v.register_slices_to_volume(
        cfg, case["vol"], case["w2i"], rigid_matrix_torch(case["params"]),
        mo, case["ofs"], case["tgt"], 1.0)
    torch.cuda.synchronize()
    assert s2v.LAUNCHES["reg_ncc_cost"] > before
    assert torch.cuda.max_memory_allocated() - base < table_bytes
    assert bool(torch.isfinite(out).all())
    assert bool((sim >= start - 1e-6).all()), (sim, start)
