"""The exact PSF engine's share of its roofline, in %: the least time the
card could take for the pixel-offset pairs that the program counts
("psf pairs #", offsets x pixels of each transfer, the mean over the
window's reconstructions) over the device time of the operations that
started inside the traced reconstruction's ranges around its three
transfers (benchmark/traffic/recon_exact.py: records["trace"]["psf"]).

Work per pair, from calcPSF (reconstruction_cuda2.cu:112-131) and the
transfer: the support voxel's place in the slice's frame, A_s (o - frac)
(3 subtractions, 9 multiplications, 6 additions) times the slice's
(dx, dy, thickness) (3); calcPSF: x and y times their sizes over 2.3548
(4), pi sqrt(x^2 + y^2) (5), sin(R) / R (2), its square (1), the
through-plane exp(-z^2 / (2 sigma^2)) (3) and the product (1); then the
weight over the pixel's sum and its product with one payload or volume
value into a sum (3): 40 float32 operations, each transcendental
counted as one.  Bytes: each pixel's and each voxel's data once a
transfer (a pixel's centre, place, sum and two payloads, 44 B; a voxel's
mask and two values, 12 B), under 0.1 B a pair at the cell's 1728
offsets a pixel and at most 4 voxels a pixel, so the operations bound it
by 20 times and more.  The
least time is the larger of bytes over the HBM bandwidth and operations
over the float32 peak (peaks.json).  None where the program counts no
pairs or the run kept no such trace."""
import json
from pathlib import Path

PAIR_FLOPS = 40
PAIR_BYTES = 0.1
PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def least_seconds(pairs: float) -> float:
    return max(pairs * PAIR_BYTES / PEAKS["hbm_bytes_per_s"],
               pairs * PAIR_FLOPS / PEAKS["fp32_flops_per_s"])


def read(records):
    psf = (records.get("trace") or {}).get("psf")
    pairs = [sum(sum(v) for k, v in p.items() if k.endswith("/psf pairs #"))
             for p in records.get("phases", ())]
    if not psf or not psf["device_s"] > 0 or not any(pairs):
        return None
    return 100.0 * least_seconds(sum(pairs) / len(pairs)) / psf["device_s"]
