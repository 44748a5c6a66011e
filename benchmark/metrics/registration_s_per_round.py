"""Seconds a slice- or patch-to-volume registration round takes: the
program's PerfStats "registration" samples over the window's
reconstructions, summed, over the number of rounds."""


def read(records):
    s = [v for p in records.get("phases", ()) for v in p.get("registration",
                                                             ())]
    return sum(s) / len(s) if s else None
