"""Batched rigid optimizers, as host loops over tensors.

Port of fetalreconstruction_tpu/register/optimizer.py:28-196.  A batch of
independent rigid problems advances in lock-step with per-problem active
masks; `cost` maps (N, 6) params to (N,) similarity (maximised).  The JAX
version's `lax.scan` / `while_loop` become Python loops of the same trip
counts, so every cost evaluation, accept rule and update order is the
same:

- `optimize_level` ("gd", the reference's irtkGradientDescentOptimizer /
  registerMultipleSlicesToVolume scheme): per iteration a 6-DOF central
  difference, normalised, then a line search of at most `max_linesearch`
  trials accepting `sim_new > best + epsilon`;
- `coord_sweep` / `optimize_level_coord` ("coord"): Gauss-Seidel sweeps
  over the 6 DOFs with the scale-aware threshold epsilon * max(step, 1),
  4x stiffer on the through-plane DOFs 2-4, and the directional-contrast
  gate (cp - cm itself must be decisive).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    steps: int = 4
    iterations: int = 20
    epsilon: float = 1e-4
    max_linesearch: int = 16


# through-plane DOFs of a thick slice (tz, rx, ry) get a 4x stiffer
# accept threshold (optimizer.py:118-123)
EPS_FACTORS = (1.0, 1.0, 4.0, 4.0, 4.0, 1.0)


def _step_sizes(step0, steps: int, like: torch.Tensor):
    """The step-halving schedule as scalars of the params' dtype."""
    return torch.tensor([step0 / (2.0 ** s) for s in range(steps)],
                        dtype=like.dtype, device=like.device)


def optimize_level(cfg: OptimizerConfig, cost: Callable, params0, step0):
    """Gradient scheme over the full step-halving schedule at one pyramid
    level.  Returns (params (N, 6), similarity (N,))."""
    n = params0.shape[0]
    eye6 = torch.eye(6, dtype=params0.dtype, device=params0.device)
    params = params0
    sim = torch.zeros((n,), dtype=params0.dtype, device=params0.device)
    for step_size in _step_sizes(step0, cfg.steps, params0):
        active = torch.ones((n,), dtype=torch.bool, device=params0.device)
        best = torch.zeros_like(sim)
        for _ in range(cfg.iterations):
            sim0 = cost(params)
            grad = torch.stack([cost(params + step_size * e[None, :])
                                - cost(params - step_size * e[None, :])
                                for e in eye6], dim=-1)
            norm = torch.linalg.vector_norm(grad, dim=-1, keepdim=True)
            grad = torch.where(norm > 0, grad / torch.clamp(norm, min=1e-30),
                               0.0)
            best, ls_active = sim0, active
            for _ in range(cfg.max_linesearch):
                if not bool(ls_active.any()):
                    break
                trial = params + step_size * grad * ls_active[:, None]
                sim_new = cost(trial)
                improved = ls_active & (sim_new > best + cfg.epsilon)
                params = torch.where(improved[:, None], trial, params)
                best = torch.where(improved, sim_new, best)
                ls_active = improved
            active = active & (best > sim0 + cfg.epsilon)
        sim = best
    return params, sim


def coord_sweep(cost: Callable, params, active, best, step_size,
                epsilon: float):
    """One Gauss-Seidel sweep over the 6 DOFs (12 cost evaluations).
    step_size: a scalar tensor of the params' dtype.

    Returns (params, active & improved, best)."""
    n = params.shape[0]
    eye6 = torch.eye(6, dtype=params.dtype, device=params.device)
    eps_base = epsilon * torch.clamp(step_size, min=1.0)
    improved = torch.zeros((n,), dtype=torch.bool, device=params.device)
    for e_p, fac in zip(eye6, EPS_FACTORS):
        eps_eff = eps_base * fac
        delta = step_size * e_p[None, :]
        cp = cost(params + delta)
        cm = cost(params - delta)
        take_p = active & (cp > best + eps_eff) & (cp >= cm + eps_eff)
        take_m = active & (cm > best + eps_eff) & (cm >= cp + eps_eff) \
            & ~take_p
        sign = take_p.to(params.dtype) - take_m.to(params.dtype)
        params = params + delta * sign[:, None]
        best = torch.where(take_p, cp, torch.where(take_m, cm, best))
        improved = improved | take_p | take_m
    return params, active & improved, best


def optimize_level_coord(cfg: OptimizerConfig, cost: Callable, params0,
                         step0):
    """Per-DOF coordinate search at one pyramid level over the whole batch
    (no compaction).  A step round ends early once no problem is active:
    the scanned JAX program runs those sweeps too, but a sweep with no
    active problem changes nothing.  Returns (params, similarity)."""
    n = params0.shape[0]
    params = params0
    sim = torch.zeros((n,), dtype=params0.dtype, device=params0.device)
    for step_size in _step_sizes(step0, cfg.steps, params0):
        best = cost(params)
        active = torch.ones((n,), dtype=torch.bool, device=params0.device)
        for _ in range(cfg.iterations):
            params, active, best = coord_sweep(cost, params, active, best,
                                               step_size, cfg.epsilon)
            if not bool(active.any()):
                break
        sim = best
    return params, sim
