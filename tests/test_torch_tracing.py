"""The port's utils/tracing.py vs the JAX package's, and run_svr's --debug
guard.

- `check_finite` raises JAX's FloatingPointError message, leaf index in
  JAX's tree order, on the same trees;
- `trace` writes a Chrome trace per rank with the `annotate` spans in it
  as ranges, also when the block raises; `svr-reconstruct-torch --trace`
  on the CPU writes one (test_torch_spans.py holds the spans inside
  run_svr);
- run_svr's --debug guard checks JAX's six leaves (recon, em.weights,
  em.bias, em.scale, em.slice_weight, sim; fetalreconstruction_tpu/
  pipeline/svr.py:841-844) and raises on a non-finite bias field.
"""
import json
import os

import numpy as np
import pytest

import torch

from fetalreconstruction_tpu.io.nifti import write_nifti
from fetalreconstruction_tpu.utils import tracing as jtracing
from fetalreconstruction_tpu_torch.cli import svr_main
from fetalreconstruction_tpu_torch.pipeline import svr, svr_core
from fetalreconstruction_tpu_torch.pipeline.config import SVRConfig
from fetalreconstruction_tpu_torch.utils import tracing
from fetalreconstruction_tpu_torch.utils.convert import image_from

from phantom import make_ground_truth, simulate_stacks
from torch_threads import one_torch_thread  # noqa: F401

NAN, INF = float("nan"), float("inf")
TREES = [
    (np.ones(3, np.float32), np.zeros((2, 2)), np.array([1.0, NAN, INF])),
    {"b": np.array([NAN]), "a": np.ones(2), "c": (np.arange(3),
                                                   np.array([INF, 1.0]))},
    [np.arange(4), (np.ones(1), [np.array([NAN, NAN, 2.0])])],
    (np.ones((2, 3)), np.arange(5, dtype=np.int32)),
]


def _message(fn, tree):
    try:
        fn(tree, name="iteration 3")
    except FloatingPointError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", range(len(TREES)))
def test_check_finite_matches_jax(case):
    tree = TREES[case]
    want = _message(jtracing.check_finite, tree)
    assert _message(tracing.check_finite, tree) == want
    as_tensors = _map(tree, torch.as_tensor)
    assert _message(tracing.check_finite, as_tensors) == want
    assert (want is None) == (case == 3)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_writes_a_chrome_trace_per_rank(tmp_path):
    with tracing.trace(str(tmp_path / "t"), rank=3):
        with tracing.annotate("frt_region"):
            torch.ones(64).cumsum(0)
    assert os.listdir(tmp_path / "t") == ["trace_rank3.json"]
    assert "frt_region" in _names(tmp_path / "t" / "trace_rank3.json")


def test_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(ValueError, match="inside"):
        with tracing.trace(str(tmp_path)):
            with tracing.annotate("before_error"):
                torch.ones(8).sum()
            raise ValueError("inside")
    assert "before_error" in _names(tmp_path / "trace_rank0.json")


@pytest.fixture(scope="module")
def data():
    gt = make_ground_truth(n=24, spacing=1.8)
    stacks, _ = simulate_stacks(gt, n_stacks=2, in_plane=2.2, dz=3.6,
                                noise=1.0)
    mask = image_from(gt)
    mask.data[:] = gt.data > 1.0
    return stacks, [image_from(s) for s in stacks], mask


def _cfg(tmp_path, **kw):
    return SVRConfig(iterations=1, resolution=1.8, rec_iterations_first=2,
                     rec_iterations_last=1, smooth_mask=2.0,
                     multires_levels=2, no_log=True, debug=True,
                     log_prefix=str(tmp_path / "d_"), **kw)


def test_debug_checks_jax_six_leaves(data, tmp_path, monkeypatch):
    _, stacks, mask = data
    seen = []
    monkeypatch.setattr(svr, "check_finite",
                        lambda tree, name: seen.append((name, tree)))
    res = svr.run_svr(_cfg(tmp_path), stacks=stacks, mask=mask,
                      device="cpu")
    ((name, leaves),) = seen
    assert name == "iteration 0" and len(leaves) == 6
    n = len(res.slice_weights)
    recon, weights, bias, scale, slice_weight, sim = leaves
    assert recon.shape == res.reconstructed.data.shape
    assert weights.shape == bias.shape == sim.shape and len(bias) == n
    assert scale.shape == slice_weight.shape == (n,)
    np.testing.assert_array_equal(slice_weight.numpy(), res.slice_weights)
    assert (bias == 0).all()  # bias correction is off by default


def test_debug_raises_on_a_non_finite_bias(data, tmp_path, monkeypatch):
    """The inner iteration's bias field made NaN: leaf 2 (em.bias)."""
    _, stacks, mask = data
    inner = svr_core.inner_iteration

    def nan_bias(*a, **kw):
        em, sim, recon = inner(*a, **kw)
        return em._replace(bias=torch.full_like(em.bias, NAN)), sim, recon

    monkeypatch.setattr(svr_core, "inner_iteration", nan_bias)
    with pytest.raises(FloatingPointError,
                       match="iteration 0: leaf 2 has [0-9]+ non-finite"):
        svr.run_svr(_cfg(tmp_path), stacks=stacks, mask=mask, device="cpu")


def test_cli_trace_on_the_cpu(data, tmp_path):
    jstacks, _, mask = data
    paths = []
    for i, st in enumerate(jstacks):
        paths.append(str(tmp_path / f"stack{i}.nii.gz"))
        write_nifti(st, paths[-1])
    rc = svr_main.main(["-o", str(tmp_path / "r.nii.gz"), "-i", *paths,
                        "--useCPU", "--trace", str(tmp_path / "tr"),
                        "--iterations", "1", "--resolution", "1.8",
                        "--rec_iterations_last", "1", "--no_log",
                        "--log_prefix", str(tmp_path / "p_")])
    assert rc == 0
    assert os.listdir(tmp_path / "tr") == ["trace_rank0.json"]
    assert "aten::matmul" in _names(tmp_path / "tr" / "trace_rank0.json")
