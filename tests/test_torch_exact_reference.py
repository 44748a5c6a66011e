"""The port's exact PSF engine against the benchmark's plain exact-engine
reference (benchmark/reference/exact_engine.py), its spans and counters,
and the benchmark's readers of them, on the CPU at tiny sizes.

- psf_sums, psf_gather and psf_scatter against the reference's geometry,
  simulate and scatter on seeded random slices, transforms, volume and
  mask; the reference's TF32 control lies farther off than each limit,
  and the reference in its second order (blocks of offsets summed first)
  within it;
- run_svr on the exact engine, one outer iteration (its last stage, no
  registration round), against the reference's last stage from the same
  batch, transforms and mask;
- the rows `psf sums`, `psf scatter`, `psf gather`, `psf call #` and `psf
  pairs #` filed under the phases that ran them, pairs = offsets x pixels;
- the readers `exact_psf_s` and `exact_psf_roofline` on hand-built
  records, None without the rows.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.inputs import cases
from benchmark.reference import exact_engine as ex
from fetalreconstruction_tpu_torch.core.geometry import ImageAttributes
from fetalreconstruction_tpu_torch.core.image import Image
from fetalreconstruction_tpu_torch.ops import psf
from fetalreconstruction_tpu_torch.pipeline import svr
from fetalreconstruction_tpu_torch.pipeline.svr_core import (
    slice_forward_matrices)

from torch_threads import one_torch_thread  # noqa: F401

VOL = (18, 20, 16)          # [z, y, x]
N, H, W = 5, 12, 10
DIMS = (1.25, 1.25, 3.0)
# relative to the largest magnitude: float32 sums of up to 729 terms in
# other orders (the program's sums run one offset at a time) read up to
# 1.6e-6; the TF32 control 5e-5 and more
TOL = dict(sume=1e-5, simw=1e-5, sim=1e-5, scatter=1e-5)


def _rotation(rng, spread):
    a, b, c = rng.uniform(-spread, spread, 3)
    rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                   [0, np.sin(a), np.cos(a)]])
    ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                   [-np.sin(b), 0, np.cos(b)]])
    rz = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0],
                   [0, 0, 1]])
    return rx @ ry @ rz


def _case(seed):
    """Slices (some padding), their matrices, transforms, a volume and a
    mask with holes."""
    rng = np.random.default_rng(seed)
    w2i = np.eye(4)
    w2i[:3, 3] = [7.6, 9.3, 8.4]
    i2w, tr = np.tile(np.eye(4), (N, 1, 1)), np.tile(np.eye(4), (N, 1, 1))
    for k in range(N):
        i2w[k, :3, :3] = _rotation(rng, 0.5) @ np.diag(DIMS)
        i2w[k, :3, 3] = [-6.0, -7.0, rng.uniform(-3, 3)]
        tr[k, :3, :3] = _rotation(rng, 0.1)
        tr[k, :3, 3] = rng.uniform(-1, 1, 3)
    slices = rng.uniform(10, 100, (N, H, W)).astype(np.float32)
    slices[0, :3] = -1.0
    return dict(w2i=w2i, i2w=i2w, tr=tr, slices=slices,
                dims=np.tile(DIMS, (N, 1)),
                vol=rng.uniform(0, 50, VOL).astype(np.float32),
                mask=(rng.uniform(size=VOL) > 0.3).astype(np.float32))


def _rel(a, b):
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float((a - b).abs().max() / b.abs().max())


def _transfers(c, tf32=False, blocked=False):
    """The program's and the reference's sums, gather and scatter."""
    support = ex.fe.psf_support(c["dims"], 1.0)
    offsets = psf.make_offsets(support)
    valid = torch.as_tensor(c["slices"] != -1.0)
    mask, vol = torch.as_tensor(c["mask"]), torch.as_tensor(c["vol"])
    fwd = slice_forward_matrices(*(torch.as_tensor(c[k])
                                   for k in ("w2i", "tr", "i2w")))
    geom = psf.make_slice_geom(fwd, torch.as_tensor(c["dims"]), valid)
    sume = psf.psf_sums(geom, offsets, VOL)
    sim, simw, inside = psf.psf_gather(geom, offsets, sume, vol.reshape(-1),
                                       mask.reshape(-1), VOL)
    gate = valid & (sume > 0)
    pays = [torch.where(gate, torch.as_tensor(c["slices"]), 0.0),
            torch.where(gate, 1.0, 0.0)]
    scat = psf.psf_scatter(geom, offsets, sume, pays, mask.reshape(-1), VOL)
    eng = ex.Engine(c["dims"], support, VOL, "cpu", tf32=tf32,
                    blocked=blocked)
    g = eng.geometry(c["w2i"], c["tr"], c["i2w"], valid, mask, None)
    rsim, rsimw, rinside = eng.simulate(g, vol, mask)
    rscat = eng.scatter2(g, *pays, mask)
    return dict(sume=(sume, g.sume), sim=(sim, rsim), simw=(simw, rsimw),
                scatter=(torch.stack(scat), torch.stack(rscat)),
                inside=(inside, rinside), centre=(geom.centre, g.centre))


@pytest.fixture(scope="module", params=[3, 11])
def transfers(request):
    c = _case(request.param)
    return (_transfers(c), _transfers(c, tf32=True),
            _transfers(c, blocked=True))


@pytest.mark.parametrize("name", list(TOL))
def test_transfer_agrees_with_the_reference(transfers, name):
    (prog, ref), (_, ctl) = transfers[0][name], transfers[1][name]
    assert _rel(prog, ref) <= TOL[name]
    assert _rel(ctl, ref) > TOL[name]


@pytest.mark.parametrize("name", list(TOL))
def test_blocked_order_within_rounding(transfers, name):
    """The reference's second float32 order stands within each limit of
    its first and of the program, and the control outside it."""
    (prog, ref), (_, ctl), (_, blk) = (t[name] for t in transfers)
    assert _rel(blk, ref) <= TOL[name] and _rel(prog, blk) <= TOL[name]
    assert _rel(ctl, blk) > TOL[name]


def test_centres_and_gates_agree_exactly(transfers):
    t = transfers[0]
    assert torch.equal(t["centre"][0].long(), t["centre"][1])
    assert torch.equal(t["inside"][0], t["inside"][1])
    assert torch.equal(t["sume"][0] > 0, t["sume"][1] > 0)


def test_slice_tiles_change_no_sum_and_fix_a_chunk(monkeypatch):
    """Tiles of 2 slices give the sums and the gather bitwise and the
    scatter to float32 rounding, and a chunk holds as many pairs for 4
    slices as for 5: the working memory does not follow the slice
    count."""
    c = _case(3)
    offsets = psf.make_offsets(ex.fe.psf_support(c["dims"], 1.0))
    mask = torch.as_tensor(c["mask"]).reshape(-1)
    fwd = slice_forward_matrices(*(torch.as_tensor(c[k])
                                   for k in ("w2i", "tr", "i2w")))
    geom = psf.make_slice_geom(fwd, torch.as_tensor(c["dims"]),
                               torch.as_tensor(c["slices"] != -1.0))
    vol = torch.as_tensor(c["vol"]).reshape(-1)

    def transfers(n):
        g = psf.SliceGeom(*(t[:n] for t in geom))
        pay = torch.where(g.valid, torch.as_tensor(c["slices"][:n]), 0.0)
        sume = psf.psf_sums(g, offsets, VOL)
        return (sume, *psf.psf_gather(g, offsets, sume, vol, mask, VOL),
                psf.psf_scatter(g, offsets, sume, [pay], mask, VOL)[0])

    whole = transfers(N)
    chunks = []
    weight = psf._offset_weight

    def counted(g, off):
        w = weight(g, off)
        chunks.append(w.numel())
        return w
    monkeypatch.setattr(psf, "SLICE_TILE", 2)
    monkeypatch.setattr(psf, "OFFSET_CHUNK_ELEMS", 20 * H * W)
    monkeypatch.setattr(psf, "_offset_weight", counted)
    tiled = transfers(N)
    for a, b in zip(whole[:4], tiled[:4]):
        assert torch.equal(a, b)
    assert _rel(tiled[4], whole[4]) < 1e-6
    most = max(chunks)
    chunks.clear()
    transfers(4)
    assert max(chunks) == most == 10 * 2 * H * W


# ----- run_svr's last stage and its rows -------------------------------

def _image(data, grid):
    return Image(np.asarray(data, np.float32),
                 ImageAttributes(**dataclasses.asdict(grid)))


@pytest.fixture(scope="module")
def one_iteration():
    """run_svr on the exact engine, one outer iteration of 2 inner ones,
    on a tiny case (a support of 5^3 keeps it to seconds); its batch is
    tapped."""
    case = cases.motion_case(5, hw=32, gn=32, motion_t=1.0, motion_r=1.0)
    batches = []
    create = svr.create_slices

    def tap(*a, **k):
        batches.append(create(*a, **k))
        return batches[-1]

    cfg = svr.SVRConfig(iterations=1, resolution=1.25,
                        rec_iterations_first=2, rec_iterations_last=2,
                        engine="exact", max_psf_support=5, no_log=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(svr, "create_slices", tap)
        res = svr.run_svr(cfg, stacks=[_image(*s) for s in case["stacks"]],
                          mask=_image(*case["mask"]), device="cpu")
    return cfg, res, batches[-1]


@pytest.mark.parametrize("tf32", [False, True], ids=["reference",
                                                  "control"])
def test_last_stage_agrees_with_run_svr(one_iteration, tf32):
    """The program's volume within 1e-5 of the largest voxel and its slice
    weights within 5e-6 (read: 4.9e-7 and 6.6e-7); the control outside
    both (1.7e-4 and 2.8e-5)."""
    cfg, res, b = one_iteration
    vol = np.asarray(res.reconstructed.data)
    a = res.reconstructed.attr
    r = ex.last_stage(b.data, b.i2w, b.stack_index, b.dims, res.transforms,
                      a.w2i(), a.dx, a.shape_zyx,
                      (vol != -1.0).astype(np.float64), res.stack_factors,
                      cfg.rec_iterations_last, cfg.delta,
                      cfg.last_iter_lambda, "cpu", tf32=tf32,
                      quality=cfg.quality_factor,
                      max_support=cfg.max_psf_support)
    keep = r.settled
    assert keep.all() and 0.0 < res.slice_weights.mean() < 1.0
    gap = np.abs(vol - r.volume)[keep].max() / np.abs(r.volume[keep]).max()
    weights = np.abs(res.slice_weights - r.state.slice_weight.numpy()).max()
    assert (gap < 1e-5 and weights < 5e-6) != tf32


ROWS = {"gaussian reconstruction": ("psf sums", "psf scatter", "psf gather"),
        "simulate+estep": ("psf gather",),
        "superresolution loop": ("psf scatter", "psf gather")}


@pytest.mark.parametrize("phase", list(ROWS))
def test_rows_filed_under_their_phase(one_iteration, phase):
    cfg, res, b = one_iteration
    stats = res.stats
    calls = (len(ROWS[phase]) if phase != "superresolution loop"
             else 2 * cfg.rec_iterations_last)
    support = psf.reference_support(b.dims, res.reconstructed.attr.dx,
                                    cfg.quality_factor, cfg.max_psf_support)
    assert stats.samples(f"{phase}/psf call #") == [calls]
    assert stats.samples(f"{phase}/psf pairs #") == [
        calls * support ** 3 * b.data.size]
    for span in ROWS[phase]:
        (s,) = stats.samples(f"{phase}/{span}")
        assert 0.0 < s <= stats.samples(phase)[0]
    others = {"psf sums", "psf scatter", "psf gather"} - set(ROWS[phase])
    assert not [r for r in stats._samples
                if r.split("/")[0] == phase and r.split("/")[-1] in others]


# ----- the benchmark's readers ---------------------------------------------

PHASES = [
    {"gaussian reconstruction": [1.0], "gaussian reconstruction/psf sums":
     [0.2], "gaussian reconstruction/psf scatter": [0.3],
     "gaussian reconstruction/psf call #": [2],
     "gaussian reconstruction/psf pairs #": [2000],
     "superresolution loop": [5.0, 5.0],
     "superresolution loop/psf gather": [1.0, 2.0],
     "superresolution loop/psf call #": [1, 1],
     "superresolution loop/psf pairs #": [1000, 1000],
     "registration": [3.0]},
    {"gaussian reconstruction": [1.0], "gaussian reconstruction/psf sums":
     [0.4], "gaussian reconstruction/psf pairs #": [4000]},
]
PARENT = [{k: v for k, v in p.items() if "/" not in k} for p in PHASES]
TRACE = {"busy_s": 9.0, "window_s": 10.0, "psf": dict(device_s=2.0)}
PEAKS = json.loads((harness.HERE / "metrics" / "peaks.json").read_text())


def test_exact_psf_s_reads_the_spans():
    read = harness.reader("exact_psf_s")
    assert read({"phases": PHASES}) == pytest.approx((3.5 + 0.4) / 2)
    assert read({"phases": PARENT}) is None and read({}) is None


def test_exact_psf_roofline_reads_pairs_over_device_time():
    read = harness.reader("exact_psf_roofline")
    pairs = (4000 + 4000) / 2
    least = max(pairs * 0.1 / PEAKS["hbm_bytes_per_s"],
                pairs * 40 / PEAKS["fp32_flops_per_s"])
    got = read({"phases": PHASES, "trace": TRACE})
    assert got == pytest.approx(100.0 * least / 2.0)
    assert read({"phases": PARENT, "trace": TRACE}) is None
    assert read({"phases": PHASES, "trace": {"busy_s": 1.0}}) is None
    assert read({"phases": PHASES}) is None and read({}) is None
