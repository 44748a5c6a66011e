"""Share of one whole reconstruction, traced after the window, in which no
operation ran on the device, in %: 1 - busy / wall, busy the union of the
device's operation intervals (torch.profiler, CUDA activity)."""


def read(records):
    t = records.get("trace")
    if not t or "phases" not in records or not t["window_s"] > 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
