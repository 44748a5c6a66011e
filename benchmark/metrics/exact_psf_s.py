"""Seconds of the exact PSF engine a reconstruction takes: the program's
spans "psf sums", "psf scatter" and "psf gather" (ops/psf.py), summed over
every phase that ran them, the mean over the window's reconstructions.
Host seconds: the scatter's `nonzero` and a full launch queue keep them
near the device's.  None where the program has no such span."""

SPANS = ("psf sums", "psf scatter", "psf gather")


def read(records):
    s = [sum(sum(v) for k, v in p.items() if k.rpartition("/")[2] in SPANS)
         for p in records.get("phases", ())
         if any(k.rpartition("/")[2] in SPANS for k in p)]
    return sum(s) / len(s) if s else None
