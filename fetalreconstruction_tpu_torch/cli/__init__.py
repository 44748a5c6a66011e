"""Command-line entry points of the port."""
from __future__ import annotations

import torch


def pick_device(use_cpu: bool, prog: str) -> torch.device:
    """The device a CLI runs on: the CPU when the user passed --useCPU,
    else the first CUDA device.  There is no fallback: without --useCPU a
    machine with no CUDA device is refused."""
    if use_cpu:
        return torch.device("cpu")
    if torch.cuda.is_available():
        return torch.device("cuda", 0)
    raise RuntimeError(f"no CUDA device: {prog} runs on a GPU "
                       "(pass --useCPU to run on the CPU)")
