"""The port's exact PSF engine (ops/psf.py) against the JAX package's on
test_psf.py's cases: the rotated 3-slice case with padding and a partial
mask, its mass-conservation case, and the fast-engine comparison geometry
of test_psf_fast.py.  Every output agrees to 1e-5 relative to its largest
magnitude; `inside` and the sume gate agree exactly.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fetalreconstruction_tpu.core.geometry import ImageAttributes
from fetalreconstruction_tpu.ops import psf as P
from fetalreconstruction_tpu.pipeline.state import create_slices
from fetalreconstruction_tpu_torch.ops import psf as T

from phantom import make_ground_truth, simulate_stacks
from test_psf import build_case
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def _close(out, ref, tol=TOL):
    out = out.detach().cpu().numpy() if torch.is_tensor(out) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape and np.isfinite(out).all()
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(out.astype(np.float64) - ref).max() / scale
    assert err <= tol, err


def _rotated():
    recon, slices, fwd, dims, vol, mask = build_case()
    support = P.reference_support(dims, recon.dx, quality_factor=1.0,
                                  max_support=10)
    return dict(shape=recon.shape_zyx, slices=slices, fwd=fwd, dims=dims,
                vol=vol, mask=mask, valid=slices != -1.0,
                offsets=P.make_offsets(support))


def _identity():
    recon = ImageAttributes(x=24, y=24, z=24, dx=1.0, dy=1.0, dz=1.0)
    a = ImageAttributes(x=10, y=10, z=1, dx=1.0, dy=1.0, dz=3.0)
    rng = np.random.default_rng(3)
    return dict(shape=recon.shape_zyx,
                slices=rng.uniform(10, 100, (1, 10, 10)).astype(np.float32),
                fwd=np.stack([recon.w2i() @ a.i2w()]),
                dims=np.array([[1.0, 1.0, 3.0]]),
                vol=rng.uniform(0, 50, recon.shape_zyx).astype(np.float32),
                mask=np.ones(recon.shape_zyx, np.float32),
                valid=np.ones((1, 10, 10), bool), offsets=P.make_offsets(12))


def _stacks():
    """test_psf_fast.py's geometry: 2 stacks, support 12, 5 mm slices."""
    gt = make_ground_truth(n=32, spacing=1.25)
    stacks, _ = simulate_stacks(gt, n_stacks=2, in_plane=1.6, dz=2.5)
    batch = create_slices(stacks, [5.0, 5.0])
    ra = gt.attr
    support = P.reference_support(batch.dims, ra.dx, 1.0, 12)
    mask = (gt.data > 1.0).astype(np.float32)
    return dict(shape=ra.shape_zyx, slices=batch.data,
                fwd=np.einsum("ij,njk->nik", ra.w2i(), batch.i2w),
                dims=batch.dims, vol=gt.data, mask=mask,
                valid=batch.data != -1.0, offsets=P.make_offsets(support))


CASES = {"rotated": _rotated, "identity": _identity, "stacks": _stacks}


@pytest.fixture(scope="module", params=list(CASES))
def both(request):
    c = CASES[request.param]()
    fwd = c["fwd"].astype(np.float32)
    dims = np.asarray(c["dims"], np.float32)
    jg = P.make_slice_geom(jnp.asarray(fwd), jnp.asarray(dims),
                           jnp.asarray(c["valid"]))
    tg = T.make_slice_geom(torch.as_tensor(fwd), torch.as_tensor(dims),
                           torch.as_tensor(c["valid"]))
    return c, jg, tg


def test_make_slice_geom(both):
    _, jg, tg = both
    np.testing.assert_array_equal(tg.centre.numpy(), np.asarray(jg.centre))
    assert tg.centre.dtype == torch.int32
    _close(tg.frac, jg.frac)
    _close(tg.a3, jg.a3)
    np.testing.assert_array_equal(tg.slice_dim.numpy(),
                                  np.asarray(jg.slice_dim))


def test_offset_weight_and_lin_index(both):
    c, jg, tg = both
    off = c["offsets"][:7]
    w = T._offset_weight(tg, torch.as_tensor(off))
    for k in range(len(off)):
        _close(w[k], P._offset_weight(jg, jnp.asarray(off[k])))
        vox = jg.centre + jnp.asarray(off[k])[None, None, None, :]
        jl, jin = P._lin_index(vox, c["shape"])
        tl, tin = T._lin_index(tg.centre + torch.as_tensor(off[k]),
                               c["shape"])
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))


def test_psf_sums(both):
    c, jg, tg = both
    js = P.psf_sums(jg, c["offsets"], c["shape"])
    ts = T.psf_sums(tg, c["offsets"], c["shape"])
    _close(ts, js)
    np.testing.assert_array_equal(ts.numpy() > 0, np.asarray(js) > 0)


def test_psf_scatter(both):
    c, jg, tg = both
    js = P.psf_sums(jg, c["offsets"], c["shape"])
    ts = T.psf_sums(tg, c["offsets"], c["shape"])
    gate = c["valid"] & (np.asarray(js) > 0)
    pay = np.where(gate, c["slices"], 0.0).astype(np.float32)
    one = gate.astype(np.float32)
    mask = c["mask"].reshape(-1)
    ref = P.psf_scatter(jg, c["offsets"], js,
                        [jnp.asarray(pay), jnp.asarray(one)],
                        jnp.asarray(mask), c["shape"])
    out = T.psf_scatter(tg, c["offsets"], ts,
                        [torch.as_tensor(pay), torch.as_tensor(one)],
                        torch.as_tensor(mask), c["shape"])
    assert len(out) == 2
    for o, r in zip(out, ref):
        _close(o, r)


def test_psf_gather(both):
    c, jg, tg = both
    js = P.psf_sums(jg, c["offsets"], c["shape"])
    ts = T.psf_sums(tg, c["offsets"], c["shape"])
    vol, mask = c["vol"].reshape(-1), c["mask"].reshape(-1)
    ref = P.psf_gather(jg, c["offsets"], js, jnp.asarray(vol),
                       jnp.asarray(mask), c["shape"])
    out = T.psf_gather(tg, c["offsets"], ts, torch.as_tensor(vol),
                       torch.as_tensor(mask), c["shape"])
    _close(out[0], ref[0])
    _close(out[1], ref[1])
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))


def test_offset_chunks_do_not_change_results(both, monkeypatch):
    """The host loop's chunk size (one offset at a time here) changes no
    value: the per-offset adds keep their order."""
    c, _, tg = both
    whole = T.psf_sums(tg, c["offsets"], c["shape"])
    monkeypatch.setattr(T, "OFFSET_CHUNK_ELEMS", 1)
    np.testing.assert_array_equal(
        T.psf_sums(tg, c["offsets"], c["shape"]).numpy(), whole.numpy())


def test_prune_offsets_matches_jax():
    c = _rotated()
    jg = P.make_slice_geom(jnp.asarray(c["fwd"], jnp.float32),
                           jnp.asarray(c["dims"], jnp.float32),
                           jnp.asarray(c["valid"]))
    offs = P.make_offsets(16)
    args = (np.asarray(jg.a3), np.asarray(jg.slice_dim))
    np.testing.assert_array_equal(T.prune_offsets(offs, *args),
                                  P.prune_offsets(offs, *args))
