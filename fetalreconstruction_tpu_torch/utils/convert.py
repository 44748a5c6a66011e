"""Carry state from the JAX package into the port.

Each function takes the JAX side's values as numpy arrays (`np.asarray` of
a jax.Array) and returns the port's structure on `device`, so that both
packages can run on identical taps and state.
"""
from __future__ import annotations

import numpy as np
import torch

from fetalreconstruction_tpu.pipeline.state import EMState, SimState

from ..ops import psf_fast, scatter


def _t(a, device, dtype=None):
    # np.array copies: a jax.Array's numpy view is read-only
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def fast_psf(terms, ranges, support: int) -> psf_fast.FastPSF:
    """FastPSF from the JAX FastPSF's `terms` (per stack, a list of
    (kz, ky, kx, coeff)), `ranges` and `support`."""
    return psf_fast.FastPSF.from_terms(terms, ranges, support)


def fast_geom(xp, valid, sume, sid, den, vol_shape, n_stacks: int,
              device) -> psf_fast.FastGeom:
    """FastGeom from the JAX FastGeom's xp, valid, sume, sid and den; the
    scatter plan is built anew from xp and sid."""
    xp_t = _t(xp, device, torch.float32)
    sid_t = _t(sid, device, torch.int64)
    plan = scatter.build_scatter_plan(xp_t, sid_t, vol_shape, n_stacks)
    return psf_fast.FastGeom(
        xp=xp_t, valid=_t(valid, device, torch.bool),
        sume=_t(sume, device, torch.float32), sid=sid_t,
        den=_t(den, device, torch.float32), plan=plan)


def em_state(weights, bias, scale, slice_weight, sigma2, m, mix, mix_s,
             device) -> EMState:
    """EMState of float32 tensors from the JAX EMState's fields."""
    f = torch.float32
    return EMState(weights=_t(weights, device, f), bias=_t(bias, device, f),
                   scale=_t(scale, device, f),
                   slice_weight=_t(slice_weight, device, f),
                   sigma2=_t(sigma2, device, f), m=_t(m, device, f),
                   mix=_t(mix, device, f), mix_s=_t(mix_s, device, f))


def sim_state(sim, simw, inside, slice_inside, device) -> SimState:
    """SimState from the JAX SimState's fields."""
    return SimState(sim=_t(sim, device, torch.float32),
                    simw=_t(simw, device, torch.float32),
                    inside=_t(inside, device, torch.bool),
                    slice_inside=_t(slice_inside, device, torch.bool))
