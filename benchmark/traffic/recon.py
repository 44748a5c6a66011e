"""The loop `recon`: whole reconstructions of the run's case back to back,
one at a time (a closed loop of one client).  The window starts at the
first and ends when the one in flight at --seconds finishes.

Traffic parameters: `warmup` (settings that replace the configuration's
in the one reconstruction that set-up runs, or null for none).

What is compared, after the window, for each of its reconstructions
(only the numbers that the cell's limits name are worked out):

- `batch_gap`: the program's slice or patch batch against the case's
  stacks: the largest of the share of the case's pixels deep inside its
  mask (`DEEP_MM`) that no unit of the batch carries with the case's value
  (up to each stack's intensity factor), the share of the batch's valid
  pixels that lie on no pixel of the case or carry another value, and,
  where the units are patches, the share of the patches whose centre lies
  deep inside the mask that the batch lacks.
- `mask_gap`: voxels where the program's output mask (the voxels it did
  not set to -1) differs from the reference's, worked out from the case's
  mask (`reference/mask.py`) where rounding decides it.
- `reg_gain_mm`: how much nearer to where the case's motion put them the
  program's final transforms bring the units' pixels than the units' own
  unmoved places are: each unit's mean distance to its true place
  unmoved, less that at its final transform after the one rigid map of
  the whole reconstruction's frame onto the case's that fits best (the
  template frame is the reconstruction's to choose); the median over the
  units that the case moved.
- `volume_gap`, `volume_rms_gap`, `slice_weight_gap`: the reference's last
  outer iteration, from the program's batch and final transforms, on the
  reference's mask, against the program's volume and slice weights.  The
  slice weights leave out, by a rule on the reference alone, the units
  that rounding alone could move across a cut of the E-step's confident
  set: those with a valid pixel whose simw lies within `CUT_BAND` of the
  E-step's cut, or whose PSF sum lies within `SUME_BAND` of its own cut
  (`reference/fast_engine.py`), where the program's float32 sums, in
  another order, may put the pixel on the other side.
- `slice_weight_left_out`: the share of the units that rule left out, so
  that a case or transforms that put many units near a cut fail rather
  than pass by leaving them out.
"""
from __future__ import annotations

import dataclasses
import time
import traceback
from typing import List

import numpy as np
import torch

from benchmark import loops
from benchmark.inputs import cases
from benchmark.inputs.psnr import psnr, truth_on_grid
from benchmark.loops import GIB, Outcome, Run, program
from benchmark.reference import fast_engine as ref
from benchmark.reference import mask as ref_mask
from benchmark.trace import DeviceSpan

DEEP_MM = 20.0  # how deep inside the case's mask a pixel must lie to be
#                 due, at most a sixth of the mask's widest extent


def _to_image(data, grid):
    image = program("core.image.Image")
    attr = program("core.geometry.ImageAttributes")
    return image(np.asarray(data, np.float32),
                 attr(**dataclasses.asdict(grid)))


def run(run: Run) -> Outcome:
    cfgd, dev = run.config, run.device
    case = cases.motion_case(run.seed, **cfgd["case"])
    stacks = [_to_image(d, g) for d, g in case["stacks"]]
    mask = _to_image(*case["mask"])
    entry = program(cfgd["program"]["entry"])
    cfg = program(cfgd["program"]["settings"])(**cfgd["run"])
    warmup = run.traffic.get("warmup")
    batches: List = []  # the slice batch of each reconstruction
    marks: List = []    # (phase, end ns) of the traced reconstruction

    def tap(orig):
        def f(*a, **k):
            b = orig(*a, **k)
            batches.append(b)
            return b
        return f

    def marked(orig):
        def sample(self, name):
            orig(self, name)
            marks.append((name, time.time_ns()))
        return sample

    with loops.planted(run.faults, faults(cfgd)), \
            loops.patched(cfgd["program"]["batch"], tap):
        if warmup is not None:
            t = time.perf_counter()
            entry(dataclasses.replace(cfg, **warmup), stacks=stacks,
                  mask=mask, device=dev)
            loops.sync(dev)
            loops.say(f"warm-up reconstruction: "
                      f"{time.perf_counter() - t:.3f} s")
        setup_s = time.perf_counter() - run.t_start
        loops.reset_peak(dev)
        done, attempted, failed = [], 0, 0
        before = loops.counters()
        t0 = time.perf_counter()
        while True:
            attempted += 1
            batches.clear()
            t = time.perf_counter()
            try:
                res = entry(cfg, stacks=stacks, mask=mask, device=dev)
                loops.sync(dev)
                done.append((res, batches[-1]))
                loops.say(f"reconstruction {attempted}: "
                          f"{time.perf_counter() - t:.3f} s\n"
                          f"{res.stats.table()}")
            except Exception:  # a failed reconstruction is counted
                failed += 1
                traceback.print_exc()
            if time.perf_counter() - t0 >= run.seconds:
                break
        window_s = time.perf_counter() - t0
        peak = loops.read_peak(dev)
        records = dict(phases=[{k: r.stats.samples(k) for k in
                                r.stats._samples} for r, _ in done],
                       counters=loops.counted_since(before))
        breakdown = None
        if run.trace:
            # one more reconstruction under the profiler, each phase's end
            # marked on the host's clock
            with loops.patched("utils.perfstats.PerfStats.sample", marked), \
                    DeviceSpan(dev) as span:
                entry(cfg, stacks=stacks, mask=mask, device=dev)
            breakdown = loops.keep_trace(records, span.summary(marks))
    e2e = dict(setup_s=setup_s, peak_mem_gib=peak / GIB)
    if done:
        e2e["recon_s"] = window_s / len(done)
    low, checks, control = check(run, case, done)
    if low is not None and np.isfinite(low):
        e2e["psnr_db"] = low
    return Outcome(e2e, records, checks, attempted, failed, peak, breakdown,
                   control)


def check(run: Run, case, done):
    """The lowest PSNR of the window's reconstructions against the case's
    truth, the worst of each number compared, and with run.control the
    same numbers of the TF32 reference put in the program's place (else
    None)."""
    if not done:
        return None, {}, None
    cfg, want = run.config["run"], set(run.compare)
    truth, tgrid = case["truth"]
    worst = dict(volume_gap=max, volume_rms_gap=max, slice_weight_gap=max,
                 slice_weight_left_out=max, reg_gain_mm=min, batch_gap=max,
                 mask_gap=max)
    out, ctl, low = {}, {}, np.inf
    patch = ((cfg["patch_size"], cfg["patch_stride"])
             if "patch_size" in cfg else None)

    def fold(acc, vals):
        for k, v in vals.items():
            if k in want:
                acc[k] = worst[k](acc[k], v) if k in acc else v

    for res, batch in done:
        a = res.reconstructed.attr
        grid = cases.Grid(**{f.name: getattr(a, f.name)
                             for f in dataclasses.fields(cases.Grid)})
        vol = np.asarray(res.reconstructed.data)
        if not np.isfinite(vol).all():
            return -np.inf, {k: (-np.inf if k == "reg_gain_mm" else np.inf)
                             for k in want}, None
        low = min(low, psnr(vol, truth_on_grid(truth, tgrid, grid)))
        if "batch_gap" in want:
            fold(out, dict(batch_gap=batch_gap(case, batch, patch)))
        if "reg_gain_mm" in want:
            fold(out, dict(reg_gain_mm=registration_gain(
                case, batch, res.transforms)))
        mdata, mgrid = case["mask"]
        inside, undecided = ref_mask.on_grid(
            mdata, mgrid.w2i(), grid.shape_zyx, grid.i2w(),
            cfg.get("smooth_mask", 4.0), run.device)
        prog = vol != -1.0
        fold(out, dict(mask_gap=int((prog != inside)[~undecided].sum())))
        loops.say(f"reference mask: {int(inside.sum())} voxels, "
                  f"{int(undecided.sum())} left to rounding")
        if not want & {"volume_gap", "volume_rms_gap", "slice_weight_gap",
                       "slice_weight_left_out"}:
            continue
        m = (inside | (undecided & prog)).astype(np.float64)

        def last_stage(tf32):
            return ref.last_stage(
                batch.data, batch.i2w, batch.stack_index, batch.dims,
                res.transforms, grid.w2i(), grid.dx, grid.shape_zyx, m,
                res.stack_factors, cfg.get("rec_iterations_last", 13),
                cfg.get("delta", 150.0), cfg.get("last_iter_lambda", 0.01),
                run.device, tf32=tf32)

        def gaps(v, sw, r):
            each = dict(
                volume_gap=lambda: loops.rel_gap(v, r.volume, r.settled),
                volume_rms_gap=lambda: loops.rms_gap(v, r.volume,
                                                     r.settled & (m > 0)),
                slice_weight_gap=lambda: slice_weight_gap(
                    sw, r.state.slice_weight.cpu().numpy(), r.near_cut),
                slice_weight_left_out=lambda: float(r.near_cut.mean()))
            return {k: f() for k, f in each.items() if k in want}

        r = last_stage(False)
        loops.say(f"reference: {int((~r.settled).sum())} voxels left out "
                  f"(rounding); {left_out(r)}")
        fold(out, gaps(vol, res.slice_weights, r))
        if run.control:
            c = last_stage(True)
            fold(ctl, gaps(c.volume, c.state.slice_weight.cpu().numpy(), r))
    return low, out, (ctl if run.control else None)


def slice_weight_gap(sw, rsw, near) -> float:
    """The largest gap between the program's and the reference's slice
    weights over the units not near a cut (inf where none is left)."""
    keep = ~np.asarray(near, bool)
    if not keep.any():
        return np.inf
    return loops.abs_gap(np.asarray(sw)[keep], np.asarray(rsw)[keep])


def left_out(r) -> str:
    """The units that the slice weights leave out, each with how near its
    pixels come to the confidence cut (simw) and, where nearer than
    SUME_BAND, to the PSF sum's."""
    idx = np.nonzero(r.near_cut)[0]
    each = ", ".join(
        f"{i} at {r.cut_distance[i, 0]:.3g}"
        + (f" (sume {r.cut_distance[i, 1]:.3g})"
           if r.cut_distance[i, 1] < ref.SUME_BAND else "")
        for i in idx[:60])
    more = f", and {len(idx) - 60} more" if len(idx) > 60 else ""
    return (f"{len(idx)} of {len(r.near_cut)} units left out of the slice "
            f"weights, simw within {ref.CUT_BAND:g} of the cut: "
            f"{each}{more}")


def _unit_pixels(case, batch, k):
    """Unit k's stack, the case's (x, y, z) index of its pixel (0, 0), and
    of each of its valid pixels, whether that lies on a whole pixel of the
    case's stack, and the values."""
    s = int(batch.stack_index[k])
    grid = case["stacks"][s][1]
    py, px = np.nonzero(batch.data[k] != -1.0)
    m = grid.w2i() @ np.asarray(batch.i2w[k], np.float64)
    p = np.stack([px, py, np.zeros_like(px), np.ones_like(px)], -1) @ m.T
    idx = np.rint(p[:, :3]).astype(np.int64)
    on = (np.abs(p[:, :3] - idx) < 1e-3).all(1) & (idx >= 0).all(1) & (
        idx < np.array([grid.x, grid.y, grid.z])).all(1)
    return s, tuple(np.rint(m[:3, 3]).astype(int)), idx, on, \
        batch.data[k][py, px]


def _due(case, s, deep, tgrid):
    """The pixels of the case's stack s that lie deep inside its mask."""
    data, grid = case["stacks"][s]
    z, y, x = np.meshgrid(*(np.arange(n) for n in data.shape), indexing="ij")
    pts = np.stack([x, y, z, np.ones_like(x)], -1).reshape(-1, 4)
    src = np.rint(pts @ (tgrid.w2i() @ grid.i2w())[:3].T).astype(np.int64)
    hi = np.array(deep.shape[::-1])
    inb = ((src >= 0) & (src < hi)).all(1)
    sc = np.clip(src, 0, hi - 1)
    return (inb & deep[sc[:, 2], sc[:, 1], sc[:, 0]]).reshape(data.shape)


def batch_gap(case, batch, patch=None) -> float:
    """See the module's docstring.  patch: (size, stride) where the units
    are patches; then also the share of the patches whose central half
    (side by side) lies deep inside the mask, so that the whole patch lies
    inside it, on the lattice of the batch's own patch origins, that the
    batch lacks."""
    mdata, tgrid = case["mask"]
    extent = max(int(np.ptp(np.nonzero(mdata)[a])) + 1 for a in range(3))
    deep = ref_mask.eroded(mdata, min(int(round(DEEP_MM / tgrid.dx)),
                                      extent // 6))
    per_stack = {}
    for k in range(batch.data.shape[0]):
        s, origin, idx, on, vals = _unit_pixels(case, batch, k)
        per_stack.setdefault(s, []).append((origin, idx, on, vals))
    shares, stray, total = [], 0, 0
    missing, required, lacking, whole = 0, 0, 0, 0
    for s, (data, _) in enumerate(case["stacks"]):
        due = _due(case, s, deep, tgrid)
        units = per_stack.get(s, [])
        covered = np.zeros(data.shape, bool)
        if units:
            idx = np.concatenate([u[1] for u in units])
            on = np.concatenate([u[2] for u in units])
            vals = np.concatenate([u[3] for u in units]).astype(np.float64)
            x, y, z = idx[on].T
            want = data[z, y, x].astype(np.float64)
            pos = want > 0
            f = np.median(vals[on][pos] / want[pos]) if pos.any() else 1.0
            exp = np.where(pos, f * want, want)
            same = np.abs(vals[on] - exp) <= 1e-4 * max(np.abs(exp).max(),
                                                        1e-30)
            covered[z[same], y[same], x[same]] = True
            stray += int((~on).sum() + (~same).sum())
            total += len(on)
        required += int(due.sum())
        missing += int((due & ~covered).sum())
        if patch and units:
            size, stride = patch
            have = {u[0] for u in units}
            ox, oy, _ = units[0][0]
            q = size // 4  # the patch's central half, side by side
            for z in range(data.shape[0]):
                for y0 in range(oy % stride, data.shape[1] - size + 1,
                                stride):
                    for x0 in range(ox % stride, data.shape[2] - size + 1,
                                    stride):
                        if due[z, y0 + q:y0 + size - q,
                               x0 + q:x0 + size - q].all():
                            whole += 1
                            lacking += (x0, y0, z) not in have
    shares = [missing / max(required, 1), stray / max(total, 1)]
    if patch:
        shares.append(lacking / max(whole, 1))
    return max(shares)


def registration_gain(case, batch, transforms) -> float:
    """See the module's docstring (mm)."""
    n, h, w = batch.data.shape
    py, px = np.meshgrid(np.arange(0, h, 2), np.arange(0, w, 2),
                         indexing="ij")
    pix = np.stack([px, py, np.zeros_like(px), np.ones_like(px)],
                   -1).astype(np.float64)
    got, true, start, owner, moved = [], [], [], [], []
    for k in range(n):
        s = int(batch.stack_index[k])
        grid = case["stacks"][s][1]
        z = int(round((grid.w2i() @ batch.i2w[k])[2, 3]))
        motion = case["motion"][s, z]
        ok = batch.data[k][::2, ::2] != -1.0
        if not ok.any():
            continue
        world = pix[ok] @ np.asarray(batch.i2w[k], np.float64).T
        start.append(world[:, :3])
        true.append(world[:, :3] @ motion[:3, :3].T + motion[:3, 3])
        t = np.asarray(transforms[k], np.float64)
        got.append(world[:, :3] @ t[:3, :3].T + t[:3, 3])
        owner.append(np.full(int(ok.sum()), len(moved)))
        moved.append(not np.allclose(motion, np.eye(4)))
    got, true, start = (np.concatenate(v) for v in (got, true, start))
    owner, moved = np.concatenate(owner), np.array(moved)
    rot, shift = _rigid_fit(got, true)

    def per_unit(p):
        d = np.linalg.norm(p - true, axis=1)
        return np.bincount(owner, d) / np.bincount(owner)
    gain = per_unit(start) - per_unit(got @ rot.T + shift)
    return float(np.median(gain[moved])) if moved.any() else -np.inf


def _rigid_fit(a, b):
    """The rotation and shift that take points a nearest to b (Kabsch)."""
    ca, cb = a.mean(0), b.mean(0)
    u, _, vt = np.linalg.svd((a - ca).T @ (b - cb))
    d = np.sign(np.linalg.det(vt.T @ u.T))
    rot = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    return rot, cb - rot @ ca


# ----- faults of this loop's cells ------------------------------------------

def _unchanged_registration(orig):
    def f(cfg, recon, recon_w2i, transforms, *a, **k):
        return transforms, torch.zeros(transforms.shape[0],
                                       device=transforms.device)
    return f


def _half_units(orig):
    """The slice or patch batch with every other unit left out."""
    def f(*a, **k):
        b = orig(*a, **k)
        return dataclasses.replace(
            b, data=b.data[::2], i2w=b.i2w[::2], dims=b.dims[::2],
            stack_index=b.stack_index[::2], attrs=b.attrs[::2])
    return f


def faults(cfgd) -> dict:
    """name: (what is replaced, how); `half_units` replaces the entry that
    makes the configuration's batch."""
    return {"unchanged_registration": (
                "register.slice2vol.register_slices_to_volume",
                _unchanged_registration),
            "half_units": (cfgd["program"]["batch"], _half_units)}
