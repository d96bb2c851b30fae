"""The benchmark's frozen plain reference: the AXPYDOT arithmetic and
TF32 rounding for the control. Plain PyTorch; it imports nothing of the
program, and takes from a run only the inputs the harness made and the
answers it judges.

Every sum that decides `correct` is taken in float64, a chunk of the
vectors at a time.
"""
from __future__ import annotations

import torch

# Rows rounded to TF32 at a time
BLOCK_ROWS = 4096


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """A float32 copy of `x` rounded to TF32 (10 mantissa bits), to
    nearest with ties away from zero, as the tensor cores' `cvt.rna`
    rounds an operand. Works in blocks of rows, in place on the copy."""
    out = x.detach().to(torch.float32, copy=True).contiguous()
    flat = out.view(-1, out.shape[-1]) if out.ndim > 1 else out.view(1, -1)
    for i in range(0, flat.shape[0], BLOCK_ROWS):
        bits = flat[i:i + BLOCK_ROWS].view(torch.int32)
        bits.add_(0x1000).bitwise_and_(-0x2000)
    return out


# ---------------------------------------------------------------------------
# AXPYDOT: z = w − α v, r = zᵀ u
# ---------------------------------------------------------------------------

CHUNK = 1 << 24


def axpydot_sums(w: torch.Tensor, v: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
    """The float64 sums that give r(α) = Σ (w − α v) u for any α, and the
    size of its terms: [Σ w u, Σ v u, Σ w²u², Σ w v u², Σ v²u²]."""
    acc = torch.zeros(5, dtype=torch.float64, device=w.device)
    for i in range(0, w.shape[0], CHUNK):
        w64, v64, u64 = (t[i:i + CHUNK].to(torch.float64)
                         for t in (w, v, u))
        acc += torch.stack([(w64 * u64).sum(), (v64 * u64).sum(),
                            (w64 * w64 * u64 * u64).sum(),
                            (w64 * v64 * u64 * u64).sum(),
                            (v64 * v64 * u64 * u64).sum()])
    return acc


def axpydot_errors(sums: torch.Tensor, alpha: torch.Tensor,
                   r: torch.Tensor) -> torch.Tensor:
    """|r − r_ref(α)| / sqrt(Σ (z_i u_i)²) for each call: the error of
    each answer against the float64 value, over the size of its terms
    (the scale at which rounding each term once shows)."""
    a = alpha.to(torch.float64)
    ref = sums[0] - a * sums[1]
    scale = torch.sqrt(sums[2] - 2.0 * a * sums[3] + a * a * sums[4])
    return (r.to(torch.float64) - ref).abs() / scale


def axpydot_tf32(w: torch.Tensor, v: torch.Tensor, u: torch.Tensor,
                 alpha: torch.Tensor) -> torch.Tensor:
    """The control: each call's r with z = w − α v in float32 and the
    dot's operands rounded to TF32, summed in float32."""
    ut = round_tf32(u)
    out = []
    for a in alpha.tolist():
        z = round_tf32(w - a * v)
        out.append(torch.dot(z, ut))
    return torch.stack(out)
