"""Seconds PVR's patch extraction takes: the program's PerfStats span row
"create slices/patch extraction", the mean over the window's
reconstructions.  None where the program has no such row (SVR, or a
program without the span)."""


def read(records):
    s = [sum(p["create slices/patch extraction"])
         for p in records.get("phases", ())
         if "create slices/patch extraction" in p]
    return sum(s) / len(s) if s else None
