"""Milliseconds of stack registration per cost evaluation: the program's
PerfStats "stack registration" seconds over its "stack registration/cost
eval #" count, both summed over the window's reconstructions.  None where
the program counts no cost evaluations."""

ROW = "stack registration"


def read(records):
    ps = [p for p in records.get("phases", ()) if ROW + "/cost eval #" in p]
    evals = sum(sum(p[ROW + "/cost eval #"]) for p in ps)
    if not evals:
        return None
    return 1e3 * sum(sum(p.get(ROW, ())) for p in ps) / evals
