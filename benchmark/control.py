"""Readings that set the limits of a cell's comparison, on the card.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3
        [--seconds 0] [--faults unchanged_registration,...] [--out FILE]

For each seed, in one process: the cell's run as the benchmark makes it
(with --seconds 0 the window holds one reconstruction or one block), its
numbers compared, and the same numbers of the control, the plain reference
computed in TF32 (the precision below the configuration's float32 with
TF32 off) put in the program's place; then one run per fault named, each
planted in the program (the faults of `loops.py` and of the cell's
driver).  One JSON line per run on standard output and in FILE.  The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from .run import ROOT, set_environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--faults", default="")
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    set_environment()
    import torch

    from . import harness
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    faults = [f for f in args.faults.split(",") if f]
    with contextlib.ExitStack() as stack:
        sink = stack.enter_context(open(args.out, "a")) if args.out else None
        for seed in (int(s) for s in args.seeds.split(",")):
            for fault in [None] + faults:
                t = time.perf_counter()
                result, _, out = harness.run_cell(
                    ROOT, args.workload, seed, args.seconds, False, dev, t,
                    faults=(fault,) if fault else (),
                    control=fault is None and not args.no_control)
                line = json.dumps(dict(
                    workload=args.workload, seed=seed, fault=fault,
                    program=out.checks,
                    control=out.control, correct=result["correct"],
                    seconds=time.perf_counter() - t))
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
