"""Which slice-to-volume cost runs, on the CPU.

On a CUDA device, for NCC and generating from the volume itself, a cost
evaluation is the fused kernel pair (csrc/register.cu, tested on the card
in test_torch_kernels.py); everywhere else the torch path runs.  Here:

- the rule (`slice2vol.fused_cost_applies`) over device, metric and a
  PSF-matched table;
- the cases that keep the torch path (CPU tensors, metric "nmi", a
  per-stack PSF table with stack ids) give outputs bitwise equal to the
  torch path's parts composed as the cost composed them before the kernel
  existed, and file a `registration/cost eval #` row but no
  `registration/fused cost eval #` row;
- the fused cost's wrapper raises for CPU tensors (no fallback).
"""
import pytest
import torch

import chip_smoke
from fetalreconstruction_tpu_torch.register import slice2vol as s2v
from fetalreconstruction_tpu_torch.utils.perfstats import PerfStats

from torch_threads import one_torch_thread  # noqa: F401

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
HW, SIGMA, LEVEL = 24, 1.0, 1


@pytest.mark.parametrize("device,metric,table,fused", [
    (CUDA, "ncc", False, True),
    (CPU, "ncc", False, False),
    (CUDA, "nmi", False, False),
    (CUDA, "ncc", True, False),
])
def test_fused_cost_rule(device, metric, table, fused):
    cfg = s2v.SliceRegConfig(metric=metric)
    got = s2v.fused_cost_applies(cfg, device, object() if table else None)
    assert got is fused


def _case():
    case = chip_smoke.reg_cost_case(CPU, 6, HW, SIGMA, vol_n=32)
    # two stacks' tables: the volume's and half of it
    table = torch.cat([s2v.make_reg_table(case["vol"]),
                       s2v.make_reg_table(0.5 * case["vol"])], dim=1)
    return case, table, torch.tensor([0, 1, 0, 1, 1, 0])


def _composed(cfg, case, table, sid):
    """The cost as the torch path composes it: per offset generate, blur,
    similarity, added in the offsets' order."""
    vs = tuple(case["vol"].shape)
    lin = torch.arange(HW)[:, None] * HW + torch.arange(HW)[None, :]
    sub = (lin % (LEVEL + 1)) == 0
    sim = torch.zeros(case["params"].shape[0])
    for o in cfg.through_plane_offsets:
        if table is None:
            gen = s2v.generate_slices(case["vol"], case["w2i"],
                                      case["params"], case["ofs"],
                                      (HW, HW), o)
        else:
            gen = s2v.generate_slices_psf(table, vs, sid, case["w2i"],
                                          case["params"], case["ofs"],
                                          (HW, HW), o)
        gen = s2v.reg_blur(gen, SIGMA)
        if cfg.metric == "nmi":
            sim = sim + s2v._nmi_slices(case["tgt"], gen, sub, cfg.bins)
        else:
            sim = sim + s2v._ncc(case["tgt"], case["mean"], gen, sub)
    return sim


@pytest.mark.parametrize("kind", ["cpu", "nmi", "psf_matched"])
def test_torch_path_cases(kind):
    """Each case is sent to the torch path, which the rule shows for a
    CUDA device too (for "cpu", the CPU alone decides)."""
    case, two_stacks, sid = _case()
    cfg = s2v.SliceRegConfig(metric="nmi" if kind == "nmi" else "ncc")
    table = {"cpu": None, "nmi": s2v.make_reg_table(case["vol"]),
             "psf_matched": two_stacks}[kind]
    sid = sid if kind == "psf_matched" else None
    rule_device = CPU if kind == "cpu" else CUDA
    assert not s2v.fused_cost_applies(cfg, rule_device, table)
    cost = s2v.make_cost_fn(cfg, case["vol"], case["w2i"], case["ofs"],
                            case["tgt"], case["mean"], (HW, HW), LEVEL,
                            SIGMA, psf_table=table,
                            vol_shape=tuple(case["vol"].shape), sid=sid)
    stats = PerfStats()
    before = s2v.LAUNCHES["reg_ncc_cost"]
    with stats.recording():
        got = cost(case["params"])
    stats.sample("registration")
    assert torch.equal(got, _composed(cfg, case, table, sid))
    assert bool(got.abs().sum() > 0)
    assert stats.samples("registration/cost eval #") == [1]
    assert stats.samples("registration/fused cost eval #") == []
    assert s2v.LAUNCHES["reg_ncc_cost"] == before


def test_registration_on_cpu_builds_the_table_and_files_no_fused_row(
        monkeypatch):
    case = chip_smoke.reg_cost_case(CPU, 4, 32, 0.5, vol_n=32, spacing=1.0)
    n = case["tgt"].shape[0]
    built = []
    make = s2v.make_reg_table

    def counted(*a, **k):
        built.append(1)
        return make(*a, **k)

    monkeypatch.setattr(s2v, "make_reg_table", counted)
    cfg = s2v.SliceRegConfig(levels=1, steps=1, iterations=1)
    stats = PerfStats()
    eye = torch.eye(4).repeat(n, 1, 1)
    with stats.recording():
        out, sim = s2v.register_slices_to_volume(
            cfg, case["vol"], case["w2i"], eye, eye, case["ofs"],
            case["tgt"], 1.0)
    stats.sample("registration")
    assert built == [1]
    assert stats.samples("registration/cost eval #")[0] > 0
    assert stats.samples("registration/fused cost eval #") == []
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(sim).all())


def test_fused_cost_raises_for_cpu_tensors():
    case = chip_smoke.reg_cost_case(CPU, 2, 16, 0.5, vol_n=16)
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        s2v.fused_ncc_cost(s2v.reg_volume(case["vol"]), case["w2i"],
                           case["ofs"], case["tgt"], case["mean"], 0, 0.5,
                           (-1, 0, 1))

