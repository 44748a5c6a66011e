"""The splat's share of its roofline, in %: the least time the card could
take for the splat's work over the mean time of one launch of the kernel
that does it (KERNEL in the traced blocks' kernel names).

The work is counted from the problem's shapes, not from how the program
plans it: each slot (a slice pixel whose trilinear footprint touches the
grid) reads its position (3 x 4 B) and its two payloads (2 x 4 B) once,
and the two dense volumes of every stack (2 x 4 B a voxel) are written
once; each slot makes 8 corner weights (2 multiplications each) and adds
each of its two payloads times each weight to a corner (2 operations), 48
float32 operations.  The least time is the larger of bytes over the HBM
bandwidth and operations over the float32 peak (peaks.json)."""
import json
from pathlib import Path

KERNEL = "splat2_dense"
SLOT_BYTES = 3 * 4 + 2 * 4
VOXEL_BYTES = 2 * 4
SLOT_FLOPS = 8 * 2 + 8 * 2 * 2
PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def least_seconds(slots: int, stacks: int, voxels: int) -> float:
    nbytes = slots * SLOT_BYTES + stacks * voxels * VOXEL_BYTES
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               slots * SLOT_FLOPS / PEAKS["fp32_flops_per_s"])


def read(records):
    t, work = records.get("trace"), records.get("splat")
    if not t or not work:
        return None
    names = [n for n in t["by_name"] if KERNEL in n]
    launches = sum(t["count_by_name"][n] for n in names)
    if not launches:
        return None
    per_launch = sum(t["by_name"][n] for n in names) / launches
    return 100.0 * least_seconds(**work) / per_launch
