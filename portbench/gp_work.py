"""The work of one preconditioned CG solve of the GP cell, reckoned from
the shapes of the configuration and never from what the program's
kernels declare.

An iteration must read the float32 operator K̂ once (n² values) and
the two (n, k) factors L and W once each (the Woodbury application),
and read and write the three state vectors x, r and p once each. A
solve of i iterations from x0 = 0 does i of them and one more operator
product for its first residual. The iterations counted are the float64
reference's on the same right-hand side (`gp_solve.check`), so that a
program that takes more iterations than it needs reads lower.
"""
from __future__ import annotations

F32 = 4
STATE_VECTORS = 3          # x, r, p, each read once and written once


def iteration_bytes(n: int, k: int) -> int:
    """Bytes one PCG iteration must move: K̂, L and W read, and the
    state vectors read and written."""
    return F32 * (n * n + 2 * n * k + 2 * STATE_VECTORS * n)


def iteration_flops(n: int, k: int) -> int:
    """Operations of one iteration: the operator product (2n²), the
    two factor products (4nk), and the vector updates and dots (10n)."""
    return 2 * n * n + 4 * n * k + 10 * n


def solve_work(n: int, k: int, iterations: int) -> tuple:
    """(bytes, flops) of a solve of `iterations` iterations from x0 = 0:
    one more operator product and application for its first residual."""
    return ((iterations + 1) * iteration_bytes(n, k),
            (iterations + 1) * iteration_flops(n, k))
