"""The benchmark of the PyTorch and CUDA port, one cell per process.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout on a machine with a CUDA card.  Builds the
cell's case from the seed, warms up, measures the window, checks the
window's outputs against the plain reference, and prints as its last line
one JSON object (correct, attempted, failed, metrics, device, with
--trace 1 breakdown, and last the numbers compared with their limits).
With --trace 0 the metrics are the cell's end-to-end metrics, with
--trace 1 its per-layer ones.  The numbers compared also end standard
error.  Exits non-zero, printing no result, without a CUDA card, when a
module of JAX or of the JAX package is loaded, or when the program is not
in the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"


def process_age() -> float:
    """Seconds since this process started (Linux), else since this module
    was imported."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(uptime - start, time.perf_counter() - T_START)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_START


def set_environment():
    """Build and kernel caches at fixed paths inside the checkout; no
    library of the program's may load JAX."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_line() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def main(argv=None) -> int:
    args = parse(argv)
    set_environment()
    import torch

    from . import harness, loops
    importlib.import_module(loops.PROGRAM)  # the program under test
    manifest = harness.load_manifest(ROOT)
    cell = harness.cell_of(manifest, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: the cell needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # the configurations state float32: no TF32 in matrix products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", file=sys.stderr, flush=True)
    result, judged, out = harness.run_cell(
        ROOT, args.workload, args.seed, args.seconds, bool(args.trace), dev,
        time.perf_counter() - process_age(), manifest=manifest)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    for name, v in out.checks.items():
        if name not in judged:
            print(f"reading {name}: {v} (not compared: no limit)",
                  file=sys.stderr)
    for name, j in judged.items():
        print(f"check {name}: {j['value']} limit {j['limit']} "
              f"{'ok' if j['ok'] else 'FAILED'}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
