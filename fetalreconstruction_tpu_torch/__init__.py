"""fetalreconstruction_tpu_torch — the PyTorch + CUDA port of
fetalreconstruction_tpu, for one NVIDIA Hopper card (sm_90a).

The JAX package beside it is the reference: every ported function is tested
against its JAX counterpart on the same numpy inputs.  This package imports
`torch` and never `jax`, and nothing of the JAX package: it keeps its own
copies of the host modules (`core.geometry`, `core.image`, `pipeline.state`,
`pipeline.config`, `pipeline.checkpoint`, `io`, `patches`, `ops.morphology`,
`utils.motion`, `utils.perfstats`, `native` with its C++ sources in `csrc/`,
built with g++ into `_build/` at first use).

Ported so far: both reconstruction programs on one device with both PSF
engines — SVR (`pipeline.svr`, with bias correction, `em.bias`,
--manualMask, `ops.manual_mask`, and --bspline, `sr.bspline`) and PVR
(`pipeline.pvr`, with the evaluation harness, `evaluation`) — and what they
run: registration (`register`), resampling and blurs, the reconstruction
core (`pipeline.svr_core`), the exact PSF engine (`ops.psf`), the fast one
(`ops.psf_fast`) with its scatter plan and two CUDA kernels (`ops.scatter`,
`csrc/scatter.cu`), EM robust statistics (`em.robust`) and the SR update
with its regulariser (`sr.superresolution`), plus the CLIs (`cli`).

Devices are explicit: builders take `device=`, everything else computes on
its inputs' device.  A kernel wrapper runs its plain PyTorch version only
for CPU tensors; for CUDA tensors it launches its kernel or raises.
"""

__version__ = "0.1.0"
