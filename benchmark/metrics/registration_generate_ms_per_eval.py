"""Host milliseconds a registration cost evaluation spends generating its
slices from the volume: the program's PerfStats span row
"registration/generate" over its "registration/cost eval #" count, both
summed over the window's reconstructions.  None where the program has
no such rows."""


def read(records):
    ps = [p for p in records.get("phases", ())
          if "registration/cost eval #" in p and "registration/generate" in p]
    evals = sum(sum(p["registration/cost eval #"]) for p in ps)
    if not evals:
        return None
    return 1e3 * sum(sum(p["registration/generate"]) for p in ps) / evals
