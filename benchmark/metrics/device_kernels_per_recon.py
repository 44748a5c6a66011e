"""Kernels the device ran in one whole reconstruction, traced after the
window (torch.profiler, CUDA activity; copies and fills not counted)."""


def read(records):
    t = records.get("trace")
    if not t or "phases" not in records:
        return None
    return t["kernels"]
