"""Share of the registration cost evaluations that ran as the fused kernel
pair (csrc/register.cu): the program's PerfStats row
"registration/fused cost eval #" over its "registration/cost eval #",
both summed over the window's reconstructions.  None where the program
has no fused counter row (a program without the kernel, or a run where
it never launched)."""


def read(records):
    ps = [p for p in records.get("phases", ())
          if "registration/cost eval #" in p]
    if not any("registration/fused cost eval #" in p for p in ps):
        return None
    evals = sum(sum(p["registration/cost eval #"]) for p in ps)
    if not evals:
        return None
    return sum(sum(p.get("registration/fused cost eval #", ()))
               for p in ps) / evals
