"""Device milliseconds an inner iteration takes: the sum of every device
operation's time in the traced blocks (torch.profiler, CUDA activity) over
the iterations they hold."""


def read(records):
    t, n = records.get("trace"), records.get("trace_iterations")
    if not t or not n or not t["device_sum_s"] > 0:
        return None
    return t["device_sum_s"] * 1e3 / n
