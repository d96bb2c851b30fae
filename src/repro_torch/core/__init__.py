"""The port's core: JSON routine spec -> dataflow graph -> fusion plan ->
generated Triton kernels (dataflow mode) / per-routine kernels
(nodataflow) / torch oracles (reference).
"""
from . import codegen, distributed, expr, fusion, graph  # noqa: F401
from . import lowering, placement, routines, spec  # noqa: F401
from .runtime import (AXPY_SPEC, AXPYDOT_SPEC, GEMV_SPEC, Program,  # noqa
                      Results, axpy_program, axpydot_program,
                      gemv_program, inputs_from_numpy, results_to_numpy)
