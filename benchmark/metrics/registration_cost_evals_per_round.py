"""Cost evaluations a slice- or patch-to-volume registration round makes:
the program's PerfStats row "registration/cost eval #" over the window's
reconstructions, summed, over the number of "registration" samples
(rounds).  None where the program counts no cost evaluations."""


def read(records):
    ps = [p for p in records.get("phases", ())
          if "registration/cost eval #" in p]
    rounds = sum(len(p.get("registration", ())) for p in ps)
    if not rounds:
        return None
    return sum(sum(p["registration/cost eval #"]) for p in ps) / rounds
