"""fetalreconstruction_tpu_torch — the PyTorch + CUDA port of
fetalreconstruction_tpu, for one NVIDIA Hopper card (sm_90a).

The JAX package beside it is the reference: every ported function is tested
against its JAX counterpart on the same numpy inputs.  This package imports
`torch` and never `jax`; the numpy-only host modules of the JAX package
(`core.geometry`, `core.image`, `pipeline.state`, `pipeline.config`,
`io`, `patches`, `ops.morphology`, `native`) load no JAX at import time and
are imported from there, not copied.

Ported so far: both reconstruction programs on one device with the fast
PSF engine — SVR (`pipeline.svr`, with bias correction, `em.bias`) and PVR
(`pipeline.pvr`, with the evaluation harness, `evaluation`) — and what
they run: registration (`register`), resampling and blurs, the
reconstruction core (`pipeline.svr_core`), the PSF engine (`ops.psf`,
`ops.psf_fast`), the scatter plan and its two CUDA kernels (`ops.scatter`,
`csrc/scatter.cu`), EM robust statistics (`em.robust`) and the SR update
with its regulariser (`sr.superresolution`), plus the CLIs (`cli`).

Devices are explicit: builders take `device=`, everything else computes on
its inputs' device.  A kernel wrapper runs its plain PyTorch version only
for CPU tensors; for CUDA tensors it launches its kernel or raises.
"""

__version__ = "0.1.0"
