"""Seconds of host preparation a reconstruction takes: the program's
PerfStats rows "template+mask", "intensity matching" and "create slices"
(in PVR the patch extraction runs in the last), the mean over the window's
reconstructions."""

ROWS = ("template+mask", "intensity matching", "create slices")


def read(records):
    s = [sum(sum(p[r]) for r in ROWS if r in p)
         for p in records.get("phases", ()) if any(r in p for r in ROWS)]
    return sum(s) / len(s) if s else None
