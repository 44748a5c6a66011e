"""Seconds of stack registration a reconstruction takes: the program's
PerfStats "stack registration" row, the mean over the window's
reconstructions."""


def read(records):
    s = [sum(p["stack registration"]) for p in records.get("phases", ())
         if "stack registration" in p]
    return sum(s) / len(s) if s else None
