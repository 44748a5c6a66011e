"""The port's slice-to-volume registration vs the JAX package.

Same seeded numpy inputs through both.  Limits:
- geometry: rigid matrices and the matrix <-> params round trip to 1e-5
  (float32 trigonometry in two libraries), the gimbal branch included;
- blur, generation, the bf16 table: 1e-5 relative to max|ref| (the bf16
  table is compared exactly: the same float32 values round to the same
  bf16);
- the similarity functions (NCC, NMI, the whole cost): 1e-4 relative;
- one coordinate sweep: the same accept decisions;
- full registrations ("coord-scan", "gd") on test_slice2vol's rotation
  problem: final params within 0.05 mm / deg of JAX.
The port's stepped, compacting "coord" loop must equal its own
"coord-scan" (per-slice costs do not depend on the batch).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fetalreconstruction_tpu.core.geometry import rigid_matrix, \
    rigid_matrix_jax
from fetalreconstruction_tpu.register import optimizer as jopt
from fetalreconstruction_tpu.register import slice2vol as js2v
from fetalreconstruction_tpu.register.prepare import \
    prepare_registration_slices as jprepare
from fetalreconstruction_tpu.pipeline.state import create_slices
from fetalreconstruction_tpu_torch.core import geometry
from fetalreconstruction_tpu_torch.register import optimizer, slice2vol
from fetalreconstruction_tpu_torch.register.prepare import \
    prepare_registration_slices

from test_slice2vol import _rotation_problem
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
COST_TOL = 1e-4
PARAM_TOL = 0.05


def _rel(out, ref):
    out = np.asarray(out.float() if isinstance(out, torch.Tensor) else out,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def test_dataclass_fields_match_jax():
    from fetalreconstruction_tpu.register.volume import VolRegConfig as JV
    from fetalreconstruction_tpu_torch.register.volume import VolRegConfig
    import dataclasses as dc
    for ours, theirs in ((slice2vol.SliceRegConfig, js2v.SliceRegConfig),
                         (optimizer.OptimizerConfig, jopt.OptimizerConfig),
                         (VolRegConfig, JV)):
        f = [(x.name, x.default) for x in dc.fields(ours)]
        g = [(x.name, x.default) for x in dc.fields(theirs)]
        assert f == g, ours


def _params(n=32, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-10, 10, (n, 3)),
                           rng.uniform(-40, 40, (n, 3))],
                          axis=1).astype(np.float32)


def test_rigid_matrix_and_round_trip():
    p = _params()
    ref = np.asarray(rigid_matrix_jax(jnp.asarray(p)))
    m = geometry.rigid_matrix_torch(_t(p))
    assert np.abs(m.numpy() - ref).max() <= TOL * 10
    back = geometry.matrix_to_params_torch(m)
    np.testing.assert_allclose(back.numpy(), p, atol=2e-3)
    jback = np.asarray(js2v.matrix_to_params_jax(jnp.asarray(ref)))
    np.testing.assert_allclose(back.numpy(), jback, atol=1e-3)


def test_matrix_to_params_gimbal():
    """ry = +-90 deg takes the gimbal branch in both (rz := 0)."""
    p = np.array([[1, 2, 3, 20, 90, 0], [0, 0, 0, -35, -90, 0]], np.float64)
    m = np.stack([rigid_matrix(q) for q in p])
    m[:, 0, 2] = -np.sign(p[:, 4])  # exactly +-1: |cos(ry)| = 0
    ref = np.asarray(js2v.matrix_to_params_jax(jnp.asarray(m, jnp.float32)))
    out = geometry.matrix_to_params_torch(_t(m)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert np.all(out[:, 5] == 0.0)


def test_invert_and_transform_points():
    m = geometry.rigid_matrix_torch(_t(_params(4)))
    eye = torch.einsum("nij,njk->nik", geometry.invert_rigid_torch(m), m)
    assert torch.allclose(eye, torch.eye(4).expand(4, 4, 4), atol=1e-5)
    pts = torch.randn(4, 3)
    inv = geometry.invert_rigid_torch(m)
    back = geometry.transform_points_torch(
        inv, geometry.transform_points_torch(m, pts))
    assert torch.allclose(back, pts, atol=1e-4)


def _targets(seed=2, n=3, h=20, w=24):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 30, (n, h, w)).astype(np.float32)
    x[:, :3, :] = -1.0
    x[1, 10:, 15:] = -1.0
    return x


@pytest.mark.parametrize("sigma", [0.5, 2.0])
def test_reg_blur(sigma):
    x = _targets()
    ref = js2v.reg_blur(jnp.asarray(x), sigma)
    out = slice2vol.reg_blur(torch.from_numpy(x), sigma)
    assert np.array_equal(out.numpy() == -1.0, np.asarray(ref) == -1.0)
    assert _rel(out, ref) <= TOL


@pytest.fixture(scope="module")
def rot():
    vol, recon_w2i, target, mo, ofs = _rotation_problem()
    return dict(vol=vol, w2i=recon_w2i.astype(np.float32),
                target=np.asarray(target), mo=mo.astype(np.float32),
                ofs=ofs.astype(np.float32))


def _jparams(rng, n):
    return np.concatenate([rng.uniform(-2, 2, (n, 3)),
                           rng.uniform(-5, 5, (n, 3))],
                          axis=1).astype(np.float32)


@pytest.mark.parametrize("insofs", [-1, 0, 1])
def test_generate_slices(rot, insofs):
    p = _jparams(np.random.default_rng(3), 4)
    ofs = np.repeat(rot["ofs"], 4, axis=0)
    shape = rot["target"].shape[1:]
    ref = js2v.generate_slices(jnp.asarray(rot["vol"]),
                               jnp.asarray(rot["w2i"]), jnp.asarray(p),
                               jnp.asarray(ofs), shape, insofs)
    out = slice2vol.generate_slices(_t(rot["vol"]), _t(rot["w2i"]), _t(p),
                                    _t(ofs), shape, insofs)
    assert _rel(out, ref) <= TOL


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_table_and_generate_slices_psf(rot, dtype):
    vol = rot["vol"]
    jtab = js2v._make_reg_table(jnp.asarray(vol), dtype)
    tab = slice2vol.make_reg_table(_t(vol), dtype)
    assert tab.dtype == (torch.bfloat16 if dtype == "bf16"
                         else torch.float32)
    np.testing.assert_array_equal(tab.float().numpy(),
                                  np.asarray(jtab.astype(jnp.float32)))
    p = _jparams(np.random.default_rng(4), 3)
    ofs = np.repeat(rot["ofs"], 3, axis=0)
    shape = rot["target"].shape[1:]
    ref = js2v.generate_slices_psf(jtab, vol.shape, None,
                                   jnp.asarray(rot["w2i"]), jnp.asarray(p),
                                   jnp.asarray(ofs), shape, 1)
    out = slice2vol.generate_slices_psf(tab, vol.shape, None, _t(rot["w2i"]),
                                        _t(p), _t(ofs), shape, 1)
    assert out.dtype == torch.float32
    assert _rel(out, ref) <= TOL


def _cost_inputs(rot, n=4, seed=5):
    rng = np.random.default_rng(seed)
    tgt = np.repeat(rot["target"], n, axis=0)
    tgt = np.where(tgt >= 0, tgt + rng.normal(0, 1, tgt.shape), tgt)
    return (tgt.astype(np.float32), np.repeat(rot["ofs"], n, axis=0),
            _jparams(rng, n))


@pytest.mark.parametrize("metric", ["ncc", "nmi"])
def test_similarity_and_cost(rot, metric):
    tgt, ofs, p = _cost_inputs(rot)
    f, sig = 1, 1.0
    jt, jofs, jmean = js2v._level_arrays(f, sig, jnp.asarray(tgt),
                                         jnp.asarray(ofs))
    tt, tofs, tmean = slice2vol.level_arrays(f, sig, _t(tgt), _t(ofs))
    assert _rel(tt, jt) <= TOL and _rel(tmean, jmean) <= TOL
    gen = np.asarray(js2v.generate_slices(
        jnp.asarray(rot["vol"]), jnp.asarray(rot["w2i"]), jnp.asarray(p),
        jofs, tgt.shape[1:], 0))
    sub = np.ones(tgt.shape[1:], bool)
    if metric == "ncc":
        ref = js2v._ncc(jt, jmean, jnp.asarray(gen), jnp.asarray(sub))
        out = slice2vol._ncc(tt, tmean, _t(gen), torch.from_numpy(sub))
    else:
        ref = js2v._nmi_slices(jt, jnp.asarray(gen), jnp.asarray(sub), 64)
        out = slice2vol._nmi_slices(tt, _t(gen), torch.from_numpy(sub), 64)
    assert _rel(out, ref) <= COST_TOL
    cfg = js2v.SliceRegConfig(metric=metric)
    tcfg = slice2vol.SliceRegConfig(metric=metric)
    jtab = js2v._make_reg_table(jnp.asarray(rot["vol"]), "bf16")
    ttab = slice2vol.make_reg_table(_t(rot["vol"]), "bf16")
    jcost = js2v.make_cost_fn(cfg, None, jnp.asarray(rot["w2i"]), jofs, jt,
                              jmean, tgt.shape[1:], 0, sig, psf_table=jtab,
                              vol_shape=rot["vol"].shape)
    tcost = slice2vol.make_cost_fn(tcfg, None, _t(rot["w2i"]), tofs, tt,
                                   tmean, tgt.shape[1:], 0, sig,
                                   psf_table=ttab,
                                   vol_shape=rot["vol"].shape)
    assert _rel(tcost(_t(p)), jcost(jnp.asarray(p))) <= COST_TOL


def test_level_arrays_pooling(rot):
    tgt, ofs, _ = _cost_inputs(rot, 2)
    j = js2v._level_arrays(2, 2.0, jnp.asarray(tgt), jnp.asarray(ofs))
    t = slice2vol.level_arrays(2, 2.0, _t(tgt), _t(ofs))
    for a, b in zip(t, j):
        assert _rel(a, b) <= TOL


def test_coord_sweep_same_decisions(rot):
    tgt, ofs, p = _cost_inputs(rot, 6)
    jt, jofs, jmean = js2v._level_arrays(1, 1.0, jnp.asarray(tgt),
                                         jnp.asarray(ofs))
    tt, tofs, tmean = slice2vol.level_arrays(1, 1.0, _t(tgt), _t(ofs))
    jtab = js2v._make_reg_table(jnp.asarray(rot["vol"]), "bf16")
    ttab = slice2vol.make_reg_table(_t(rot["vol"]), "bf16")
    cfg = js2v.SliceRegConfig()
    jcost = js2v.make_cost_fn(cfg, None, jnp.asarray(rot["w2i"]), jofs, jt,
                              jmean, tgt.shape[1:], 0, 1.0, psf_table=jtab,
                              vol_shape=rot["vol"].shape)
    tcost = slice2vol.make_cost_fn(slice2vol.SliceRegConfig(), None,
                                   _t(rot["w2i"]), tofs, tt, tmean,
                                   tgt.shape[1:], 0, 1.0, psf_table=ttab,
                                   vol_shape=rot["vol"].shape)
    active = np.array([True, True, True, True, False, True])
    jp, ja, jb = jopt.coord_sweep(
        jcost, jnp.asarray(p), jnp.asarray(active),
        jcost(jnp.asarray(p)), jnp.float32(1.0), cfg.epsilon)
    tp, ta, tb = optimizer.coord_sweep(
        tcost, _t(p), torch.from_numpy(active), tcost(_t(p)),
        torch.tensor(1.0), cfg.epsilon)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert ta.any()  # some slice moved
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    assert _rel(tb, jb) <= COST_TOL


@pytest.mark.parametrize("opt", ["coord-scan", "gd"])
def test_register_rotation_problem_matches_jax(rot, opt):
    kw = dict(levels=2, steps=4, iterations=12, optimizer=opt)
    args = (rot["w2i"], np.eye(4, dtype=np.float32)[None], rot["mo"],
            rot["ofs"], rot["target"])
    ref, _ = js2v.register_slices_to_volume(
        js2v.SliceRegConfig(**kw), jnp.asarray(rot["vol"]),
        *[jnp.asarray(a) for a in args], 1.0)
    out, sim = slice2vol.register_slices_to_volume(
        slice2vol.SliceRegConfig(**kw), _t(rot["vol"]),
        *[_t(a) for a in args], 1.0)
    pj = np.asarray(js2v.matrix_to_params_jax(ref))
    pt = geometry.matrix_to_params_torch(out).numpy()
    assert np.abs(pt - pj).max() <= PARAM_TOL, (pt, pj)
    if opt == "coord-scan":  # and it recovered the motion (6 deg, 1.5 mm)
        assert abs(pt[0, 5] - 6.0) < 1.5 and abs(pt[0, 0] - 1.5) < 0.75
    assert torch.isfinite(sim).all()


@pytest.fixture(scope="module")
def two_stacks():
    from phantom import make_ground_truth, simulate_stacks
    gt = make_ground_truth(n=24, spacing=2.0)
    stacks, _ = simulate_stacks(gt, n_stacks=2, in_plane=2.0, dz=2.0,
                                orientations=[[0, 0, 0], [90, 0, 0]])
    return gt, create_slices(stacks, [4.0, 4.0])


def test_prepare_registration_slices(two_stacks):
    _, batch = two_stacks
    ref = jprepare(batch, 1.5)
    out = prepare_registration_slices(batch, 1.5, device="cpu")
    for a, b in zip(out, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel(a, b) <= TOL


def test_stepped_compaction_equals_scan(two_stacks):
    """The stepped host loop, which compacts the active set onto the bucket
    ladder, gives the uncompacted "coord-scan" result."""
    gt, batch = two_stacks
    targets, mo, ofs = prepare_registration_slices(batch, gt.attr.dx,
                                                   device="cpu")
    n = batch.n_slices
    assert n > 16  # compaction must engage
    rng = np.random.default_rng(3)
    init = np.stack([np.asarray(rigid_matrix_jax(jnp.asarray(
        [rng.uniform(-3, 3), rng.uniform(-3, 3), rng.uniform(-2, 2),
         rng.uniform(-4, 4), rng.uniform(-4, 4), rng.uniform(-4, 4)],
        jnp.float32))) for _ in range(n)])
    args = (_t(gt.data), _t(gt.attr.w2i()), _t(init), _t(mo), _t(ofs),
            _t(targets), gt.attr.dx)
    kw = dict(levels=1, steps=2, iterations=6)
    out_c, sim_c = slice2vol.register_slices_to_volume(
        slice2vol.SliceRegConfig(optimizer="coord", **kw), *args)
    out_s, sim_s = slice2vol.register_slices_to_volume(
        slice2vol.SliceRegConfig(optimizer="coord-scan", **kw), *args)
    assert torch.equal(out_c, out_s) and torch.equal(sim_c, sim_s)
    assert not torch.equal(out_c, _t(init))  # registration moved slices


def test_gd_optimizer_matches_jax_on_quadratic():
    """optimize_level's line search and deactivation on a smooth cost."""
    target = np.array([[0.5, -1.0, 0.25, 2.0, -0.5, 1.0],
                       [1.0, 0.0, 0.0, 0.0, 0.0, -3.0]], np.float32)

    def jcost(p):
        return -jnp.sum((p - target) ** 2, axis=1)

    def tcost(p):
        return -((p - torch.from_numpy(target)) ** 2).sum(dim=1)

    cfg = jopt.OptimizerConfig(steps=3, iterations=6)
    p0 = np.zeros((2, 6), np.float32)
    jp, js = jopt.optimize_level(cfg, jcost, jnp.asarray(p0), 1.0)
    tp, ts = optimizer.optimize_level(optimizer.OptimizerConfig(
        steps=3, iterations=6), tcost, torch.from_numpy(p0), 1.0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    tp2, _ = optimizer.optimize_level_coord(optimizer.OptimizerConfig(
        steps=3, iterations=6), tcost, torch.from_numpy(p0), 1.0)
    jp2, _ = jopt.optimize_level_coord(cfg, jcost, jnp.asarray(p0), 1.0)
    np.testing.assert_allclose(tp2.numpy(), np.asarray(jp2), atol=1e-5)


def test_build_psf_tables_shape():
    """PSF-matched tables: one shingle per stack, normalised blur of a
    constant volume is that constant inside."""
    from fetalreconstruction_tpu_torch.ops import psf_fast
    vol = torch.full((6, 7, 8), 3.0)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    fast = psf_fast.FastPSF.from_terms([[(k, k, k, 1.0)]] * 2,
                                       [(0, 1), (1, 2)], 3)
    tab = slice2vol.build_psf_tables(fast, vol)
    assert tab.shape == (8, 2 * psf_fast.shingle_rows(vol.shape))
    pts = torch.tensor([[[3.0, 3.0, 2.0]], [[4.5, 2.5, 3.0]]])
    (vals,) = psf_fast.shingle_gather(tab, pts, vol.shape, 1,
                                      sid=torch.tensor([0, 1]))
    assert torch.allclose(vals, torch.full_like(vals, 3.0), atol=1e-5)
