"""Seconds of the reconstruction phases a reconstruction takes: the
program's PerfStats rows "gaussian reconstruction", "simulate+estep" and
"superresolution loop", the mean over the window's reconstructions."""

ROWS = ("gaussian reconstruction", "simulate+estep", "superresolution loop")


def read(records):
    s = [sum(sum(p[r]) for r in ROWS if r in p)
         for p in records.get("phases", ()) if any(r in p for r in ROWS)]
    return sum(s) / len(s) if s else None
