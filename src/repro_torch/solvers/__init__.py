"""Iterative solvers as AIEBLAS dataflow applications on the card.

Each solver's iteration body is assembled from registry routines via
ProgramSpec JSON, lowered through the fusion planner and the kernel
generators, and driven by a host loop that keeps the state, the
residual history and the status on the device (`driver.py`):

    from repro_torch.solvers import LoopProgram, specs
    res = LoopProgram(specs.CG_LOOP).solve(A=A, b=b, x0=x0, tol=1e-6)
    res.x, res.iterations, res.history, res.status_names()

The class-based solvers (`iterative.py`) run the same stage programs
from Python hooks:

    from repro_torch.solvers import cg
    res = cg(A, b, tol=1e-6)                 # on the card
    res = cg(A, b, tol=1e-6, device="cpu")   # plain versions, CPU tensors
"""
from . import specs  # noqa: F401
from .driver import LoopProgram, SolverProgram, SolverResult  # noqa: F401
from .iterative import (BiCGStab, CG, Jacobi, PowerIteration,  # noqa: F401
                        bicgstab, cg, jacobi, power_iteration)
