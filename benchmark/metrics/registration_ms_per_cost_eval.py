"""Milliseconds of a registration round per cost evaluation: the program's
PerfStats "registration" seconds (synchronised wall of the rounds) over
its "registration/cost eval #" count, both summed over the window's
reconstructions.  None where the program counts no cost evaluations."""


def read(records):
    ps = [p for p in records.get("phases", ())
          if "registration/cost eval #" in p]
    evals = sum(sum(p["registration/cost eval #"]) for p in ps)
    if not evals:
        return None
    return 1e3 * sum(sum(p.get("registration", ())) for p in ps) / evals
