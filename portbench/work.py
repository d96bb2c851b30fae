"""The work of each call, reckoned from the shapes of the spec and never
from what the program's kernels declare, and the table of peaks it is
set against.

A kernel roofline share is the least time the card could take for the
window's work, the larger of bytes over the HBM rate and operations
over the arithmetic rate, divided by the device's busy time: each input
byte read once and each output byte written once, whatever the kernels
read again.
"""
from __future__ import annotations

# Published peaks (NVIDIA's data sheet, SXM part, dense rates): HBM3
# bytes/s and float32 FLOP/s outside the tensor cores. A card of another
# name has no entry, and its roofline shares are left out.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "float32_flops_per_s": 67e12},
}
F32 = 4


def axpydot_call(n: int) -> tuple:
    """(bytes, flops) of one AXPYDOT call: w, v and u read once; z never
    reaches HBM; 2n operations for z and 2n for its dot."""
    return 3 * n * F32, 4 * n


def least_seconds(nbytes: float, flops: float, peak: dict) -> float:
    return max(nbytes / peak["hbm_bytes_per_s"],
               flops / peak["float32_flops_per_s"])
