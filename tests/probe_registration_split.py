"""Where the port's stack registration first splits from the JAX package's,
and why --T1PackageSize fails on the small phantom (ROADMAP.md, queue 3).

    JAX_PLATFORMS=cpu python tests/probe_registration_split.py

On svr_parity's problem, stack_registrations runs in both packages as
run_svr calls it (tests/test_torch_svr_options_reg.py), for template 1
with CC and template 0 with NMI, every coordinate sweep recorded.  At the
first sweep whose parameters differ, each DOF's two probes are evaluated
by the JAX package's cost in a scan over the DOFs (the shape of its sweep
program) and alone, the port's, and the port's cost in float64, with the
gain against the sweep's threshold.  For CC it also
prints the spread of the port's float32 cost over 200 orders of its sums;
for NMI the float64 cost a 1e-5 move away along each DOF.  Then the port's
run_svr with --T1PackageSize 2 (the JAX package raises alike,
test_torch_svr_options_t1.py): each pyramid level's parameters of the
first NMI registration of the packages, and each package's voxels in the
ROI at intensity matching.  Not collected by pytest (a CPU run of about
a minute).
"""
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from fetalreconstruction_tpu.core.image import Image  # noqa: E402
from fetalreconstruction_tpu.register import stack as jstack  # noqa: E402
from fetalreconstruction_tpu.register import volume as jvol  # noqa: E402
from fetalreconstruction_tpu_torch.pipeline import svr  # noqa: E402
from fetalreconstruction_tpu_torch.register import stack  # noqa: E402
from fetalreconstruction_tpu_torch.register import volume  # noqa: E402
from fetalreconstruction_tpu_torch.register.optimizer import (  # noqa: E402
    EPS_FACTORS)

from svr_parity import make_problem, svr_cfg  # noqa: E402
from test_torch_svr_options_reg import _registration_inputs  # noqa: E402


def _record_sweeps():
    """Wrap both packages' coordinate sweeps; returns their records."""
    jax_rec, port_rec = [], []
    jax_sweep, port_sweep = jvol._vol_sweep_b_jit, volume.coord_sweep

    def jax_wrapped(metric, bins, shared, eps, *args):
        out = jax_sweep(metric, bins, shared, eps, *args)
        params, active, best, step = args[6:]
        jax_rec.append(dict(args=(metric, bins, shared) + args[:6],
                            step=float(step), p_in=np.asarray(params),
                            b_in=float(np.asarray(best)[0]),
                            p_out=np.asarray(out[0]),
                            b_out=float(np.asarray(out[2])[0])))
        return out

    def port_wrapped(cost, params, active, best, step, eps):
        out = port_sweep(cost, params, active, best, step, eps)
        # the level's tensors, as the closure holds them now
        port_rec.append(dict(
            data={k: c.cell_contents for k, c in zip(
                cost.__code__.co_freevars, cost.__closure__)},
            p_out=out[0].numpy().copy(), b_in=float(best[0])))
        return out

    jvol._vol_sweep_b_jit, volume.coord_sweep = jax_wrapped, port_wrapped
    return jax_rec, port_rec, lambda: (
        setattr(jvol, "_vol_sweep_b_jit", jax_sweep),
        setattr(volume, "coord_sweep", port_sweep))


def _f64(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def first_split(stacks, mask_img, tmpl, metric):
    jax_rec, port_rec, restore = _record_sweeps()
    st, tmask = _registration_inputs(stacks, mask_img, tmpl)
    try:
        a = jstack.stack_registrations(
            st, tmpl, mask=tmask, cfg=jvol.VolRegConfig(metric=metric))
        b = stack.stack_registrations(
            st, tmpl, mask=Image(tmask.data, tmask.attr),
            cfg=volume.VolRegConfig(metric=metric), device="cpu")
    finally:
        restore()
    print(f"\n== template {tmpl}, {metric}: the moved stack ends "
          f"{np.abs(a[1 - tmpl] - b[1 - tmpl]).max():.4g} apart in its "
          f"matrix; {len(jax_rec)} / {len(port_rec)} sweeps")
    i = next(k for k, (rj, rt) in enumerate(zip(jax_rec, port_rec))
             if not np.array_equal(rj["p_out"], rt["p_out"]))
    rj, rt = jax_rec[i], port_rec[i]
    assert np.array_equal(rj["p_in"], port_rec[i - 1]["p_out"] if i else
                          rj["p_in"])
    (metric, bins, shared, tdata, sdata, tgt_i2w, src_w2i, tpad,
     spad) = rj["args"]
    d = rt["data"]

    def cost_jax(p):
        return float(np.asarray(jvol._vol_cost_b_jit(
            metric, bins, shared, tdata, sdata, tgt_i2w, src_w2i, tpad, spad,
            jnp.asarray(p, jnp.float32)))[0])

    @jax.jit
    def scan_costs(tdata, sdata, tgt_i2w, src_w2i, tpad, spad, p, delta):
        """The cost at p + delta * e_k for the 6 DOFs k, as a scan over
        them (the shape of the JAX package's sweep program)."""
        def body(c, e):
            return c, jvol._vol_cost_body_b(
                metric, bins, shared, tdata, sdata, tgt_i2w, src_w2i, tpad,
                spad, p + delta * e[None, :])
        return jax.lax.scan(body, 0, jnp.eye(6, dtype=jnp.float32))[1]

    def cost_jax_scan(p, dof, sgn):
        return float(np.asarray(scan_costs(
            tdata, sdata, tgt_i2w, src_w2i, tpad, spad,
            jnp.asarray(p, jnp.float32), jnp.float32(sgn * step)))[dof, 0])

    def cost_port(p):
        return float(volume._vol_cost(
            metric, bins, shared, d["tdata"], d["sdata"], d["tgt_i2w"],
            d["src_w2i"], d["tpad_t"], d["spad_t"],
            torch.as_tensor(p, dtype=torch.float32))[0])

    def cost_f64(p):
        return float(volume._vol_cost(
            metric, bins, shared, _f64(tdata), _f64(sdata), _f64(tgt_i2w),
            _f64(src_w2i), _f64(tpad), _f64(spad), _f64(p))[0])

    step = np.float32(rj["step"])
    p = rj["p_in"].astype(np.float32)
    print(f"first differing sweep: #{i + 1}, step {step}, from params "
          f"{np.round(p[0], 4).tolist()}; JAX's sweep program ends at best "
          f"{rj['b_out']:.9g}, the port's at {port_rec[i]['p_out'][0]}")
    best = {"jax": rj["b_in"], "port": rt["b_in"], "f64": cost_f64(p)}
    print(f"best at the start: JAX {best['jax']:.9g}, port "
          f"{best['port']:.9g}, float64 {best['f64']:.9g}")
    for dof in range(6):
        e = np.zeros((1, 6), np.float32)
        e[0, dof] = step
        eps = 1e-4 * max(float(step), 1.0) * EPS_FACTORS[dof]
        row = {"jax": (cost_jax_scan(p, dof, 1), cost_jax_scan(p, dof, -1)),
               "port": (cost_port(p + e), cost_port(p - e)),
               "f64": (cost_f64(p + e), cost_f64(p - e))}
        takes = {}
        for name, (cp, cm) in row.items():
            b0 = best[name]
            takes[name] = ("+" if cp > b0 + eps and cp >= cm + eps else
                           "-" if cm > b0 + eps and cm >= cp + eps else "0")
        if len(set(takes.values())) > 1:
            print(f"DOF {dof} (threshold {eps:.3g}):")
            for name, (cp, cm) in row.items():
                print(f"  {name:4s} +step {cp:.9g} (gain "
                      f"{cp - best[name]:.5g})  -step {cm:.9g} (gain "
                      f"{cm - best[name]:.5g})  -> {takes[name]}")
            print(f"  the JAX package's stand-alone cost program: +step "
                  f"{cost_jax(p + e):.9g}, -step {cost_jax(p - e):.9g}")
            trial = p + e if "+" in takes.values() else p - e
            if metric == "cc":
                _cc_spread(d, p, trial, cost_f64)
            else:
                _nmi_nudges(trial, cost_f64)
            return
        for name, (cp, cm) in row.items():  # the same move on every side
            if takes[name] != "0":
                best[name] = cp if takes[name] == "+" else cm
        p = p + e * {"+": 1, "-": -1, "0": 0}[takes["jax"]]
    print("no DOF decided differently")


def _cc_spread(d, p0, p1, cost_f64, orders=200):
    """The port's float32 CC at p0 and p1 over `orders` orders of its
    sums, and the gain p1 - p0 they span."""
    g = torch.Generator().manual_seed(0)
    vals = []
    for p in (p0, p1):
        zs, ys, xs = d["tdata"].shape[1:]
        m = torch.einsum("nij,njk,nkl->nil", d["src_w2i"],
                         volume.rigid_matrix_torch(torch.as_tensor(p)),
                         d["tgt_i2w"])
        ax = [torch.arange(n, dtype=torch.float32) for n in (xs, ys, zs)]
        pts = (m[:, None, None, None, :3, 0] * ax[0][None, None, None, :, None]
               + m[:, None, None, None, :3, 1] * ax[1][None, None, :, None, None]
               + m[:, None, None, None, :3, 2] * ax[2][None, :, None, None, None]
               + m[:, None, None, None, :3, 3])
        spad = d["spad_t"][:, None, None, None]
        sv = volume.sample_linear_padded(d["sdata"][0], pts, padding=spad)
        ok = (d["tdata"] > d["tpad_t"][:, None, None, None]) & (sv > spad)
        t, s, ok = d["tdata"].reshape(-1), sv.reshape(-1), ok.reshape(-1)
        got = []
        for _ in range(orders):
            k = torch.randperm(t.numel(), generator=g)
            got.append(float(volume._cc_metric(t[k][None], s[k][None],
                                               ok[k][None])[0]))
        vals.append((min(got), max(got)))
        print(f"  port float32 over {orders} sum orders: {min(got):.9g} .. "
              f"{max(got):.9g} (spread {max(got) - min(got):.3g}); float64 "
              f"{cost_f64(p):.9g}")
    print(f"  gain spans {vals[1][0] - vals[0][1]:.5g} .. "
          f"{vals[1][1] - vals[0][0]:.5g}")


def _nmi_nudges(p, cost_f64, h=1e-5):
    vals = {}
    for dof in range(6):
        for sgn in (-1, 1):
            q = p.astype(np.float64).copy()
            q[0, dof] += sgn * h
            vals[(dof, sgn)] = round(cost_f64(q), 7)
    print(f"  float64 at the trial {cost_f64(p):.9g}; moved by {h} along "
          f"each DOF: {vals}")


def t1_package_cause(gt, stacks, mask_img):
    print("\n== --T1PackageSize 2, the port's run_svr on the phantom")
    level_opt, match = volume._optimize_level, svr.match_stack_intensities
    seen = []

    def optimize(cfg, level, cost, params, ok):
        out = level_opt(cfg, level, cost, params, ok)
        if len(seen) < 3:  # the first registration's three levels
            seen.append(level)
            print(f"level {level} ({cfg.metric}): params out "
                  f"{np.round(out[0].numpy(), 2).tolist()}, similarity "
                  f"{np.round(out[1].numpy(), 4).tolist()}")
        return out

    def matching(sts, transforms, mask, *args, **kw):
        for i, (s, t) in enumerate(zip(sts, transforms)):
            zs, ys, xs = s.attr.shape_zyx
            z, y, x = np.meshgrid(np.arange(zs), np.arange(ys),
                                  np.arange(xs), indexing="ij")
            w = s.attr.image_to_world(
                np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float64))
            inb, mval = svr._mask_values(mask, w @ t[:3, :3].T + t[:3, 3])
            print(f"package {i} {s.data.shape}: {int(inb.sum())} voxels in "
                  f"bounds, {int((inb & (mval == 1)).sum())} in the ROI")
        return match(sts, transforms, mask, *args, **kw)

    volume._optimize_level, svr.match_stack_intensities = optimize, matching
    try:
        svr.run_svr(svr_cfg(t1_package_size=2), stacks=stacks, mask=mask_img,
                    reference_volume=gt, device="cpu")
        print("run_svr finished")
    except ValueError as err:
        print(f"run_svr raised {err!r}")
    finally:
        volume._optimize_level, svr.match_stack_intensities = (level_opt,
                                                               match)


def main():
    torch.set_num_threads(1)
    gt, stacks, mask_img = make_problem()
    first_split(stacks, mask_img, 1, "cc")
    first_split(stacks, mask_img, 0, "nmi")
    t1_package_cause(gt, stacks, mask_img)


if __name__ == "__main__":
    main()
