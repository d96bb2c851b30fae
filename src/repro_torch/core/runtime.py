"""Runtime façade: JSON spec in, executable program out.

    prog = Program.from_spec(spec_dict_or_json_or_path)   # on the card
    beta = prog(neg_alpha=-0.5, w=w, v=v, u=u)["beta"]

Modes (paper Fig. 3 matrix):
    mode="dataflow" | "nodataflow" | "reference"

A program runs on the CUDA card unless it is built with
`device="cpu"`, where every kernel wrapper runs its plain version.
`inputs_from_numpy` / `results_to_numpy` carry data to and from the
numpy form the reference package's inputs and results take.
"""
from __future__ import annotations

import dataclasses
import pathlib
from numbers import Number
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

from . import lowering, spec as spec_mod
from .graph import DataflowGraph


def _synth_vector(n, dtype, seed, device):
    """Deterministic operand generation on the device (iota-based)."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return (torch.sin(i * 0.001 + seed) + 0.5).to(dtype)


def _synth_matrix(m, n, dtype, seed, device):
    i = torch.arange(m * n, dtype=torch.float32,
                     device=device).reshape(m, n)
    return (torch.sin(i * 1e-4 + seed) * 0.1).to(dtype)


class Results(dict):
    """Program results: a plain mapping of public output name -> tensor
    with single-output sugar, so one-output programs don't force users
    through `out["my_dot.out"]`."""

    def one(self) -> torch.Tensor:
        """The single output value; raises if the program has more."""
        if len(self) != 1:
            raise ValueError(
                f"one() needs a single-output program; this one "
                f"produced {sorted(self)} — index the result instead")
        return next(iter(self.values()))


@dataclasses.dataclass
class Program:
    """A compiled program on one device."""
    spec: spec_mod.ProgramSpec
    graph: DataflowGraph
    mode: str
    device: torch.device
    _fn: object = None
    ir: Optional[lowering.ProgramIR] = None

    # -- construction ---------------------------------------------------

    @classmethod
    def from_spec(cls, raw: Union[str, Mapping, pathlib.Path], *,
                  mode: str = "dataflow", fuse: Optional[bool] = None,
                  anchor: Optional[bool] = None,
                  device=None) -> "Program":
        """Lower a spec through the pass pipeline (parse -> graph ->
        infer -> fuse -> place -> emit; see core.lowering). Lowered
        programs are cached by (spec digest, mode, fuse, anchor,
        device). `device` defaults to the CUDA card and raises when
        there is none; pass device="cpu" for the plain versions."""
        ir = lowering.compile_cached(raw, mode=mode, fuse=fuse,
                                     anchor=anchor, device=device)
        return cls.from_ir(ir)

    @classmethod
    def from_ir(cls, ir: lowering.ProgramIR) -> "Program":
        prog = cls(spec=ir.spec, graph=ir.graph, mode=ir.mode,
                   device=ir.device, _fn=ir.fn, ir=ir)
        prog.groups = ir.groups
        return prog

    # -- introspection ----------------------------------------------------

    @property
    def input_names(self):
        return self.graph.input_names()

    @property
    def output_names(self):
        return self.graph.output_names()

    def describe(self) -> str:
        lines = [f"program {self.spec.name!r} mode={self.mode} "
                 f"device={self.device}"]
        for gi, g in enumerate(self.groups):
            if g.anchor:
                kind = f"FUSED {g.anchor}-anchored streaming group"
            elif g.fused:
                kind = "FUSED on-chip group"
            else:
                kind = "kernel"
            lines.append(f"  group {gi} [{kind}]: {' -> '.join(g.nodes)}")
        lines.append(f"  inputs:  {self.input_names}")
        lines.append(f"  outputs: {self.output_names}")
        return "\n".join(lines)

    # -- execution --------------------------------------------------------

    def _check_inputs(self, inputs: Mapping) -> None:
        kinds = {pi.name: pi.kind for pi in self.graph.inputs}
        for name, value in inputs.items():
            kind = kinds.get(name)
            if kind is None:
                continue
            if kind == "scalar" and isinstance(value, Number):
                continue
            if not torch.is_tensor(value):
                raise TypeError(f"input {name!r} must be a tensor, got "
                                f"{type(value).__name__}")
            if kind != "scalar" and value.device.type != self.device.type:
                raise ValueError(
                    f"input {name!r} lies on {value.device}, but the "
                    f"program runs on {self.device}; move it with "
                    f".to({str(self.device)!r})")

    def __call__(self, **inputs) -> Results:
        self._check_inputs(inputs)
        return Results(self._fn(inputs))

    def jitted(self):
        """The callable form of the program. PyTorch runs eagerly, so
        this is the plain callable; CUDA graphs come later."""
        return lambda **inputs: self(**inputs)

    def synthetic_inputs(self, sizes: Mapping[str, tuple],
                         seed: float = 0.0) -> Dict[str, torch.Tensor]:
        """Generate operands on the program's device.

        sizes maps public input name -> shape tuple (() for scalars).
        """
        out = {}
        k = 0.0
        for pi in self.graph.inputs:
            if pi.name in out:
                continue
            shape = sizes[pi.name]
            if pi.kind == "scalar" or shape == ():
                out[pi.name] = torch.tensor(1.0 + 0.25 * k + seed,
                                            dtype=torch.float32,
                                            device=self.device)
            elif len(shape) == 1:
                out[pi.name] = _synth_vector(shape[0], self.spec.dtype,
                                             seed + k, self.device)
            else:
                out[pi.name] = _synth_matrix(shape[0], shape[1],
                                             self.spec.dtype, seed + k,
                                             self.device)
            k += 1.0
        return out


# ---------------------------------------------------------------------------
# Data carried across from the reference package's numpy form
# ---------------------------------------------------------------------------


def _array_to_tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 (the reference's): reinterpret the bits
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16).copy()
        ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def inputs_from_numpy(inputs: Mapping, *, dtype=None,
                      device=None) -> Dict[str, torch.Tensor]:
    """The reference's inputs (numpy arrays, ml_dtypes bfloat16 read
    through an int16 view, and Python or numpy scalars) as the port's
    tensors on `device` (default: the CUDA card). Floating arrays of
    rank >= 1 are cast to `dtype` when it is given; scalars become
    float32 0-d tensors."""
    dev = resolve_device(device)
    out = {}
    for name, value in inputs.items():
        arr = np.asarray(value) if not isinstance(value, np.ndarray) \
            else value
        if arr.ndim == 0:
            out[name] = torch.tensor(float(arr), dtype=torch.float32,
                                     device=dev)
            continue
        t = _array_to_tensor(arr)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[name] = t.to(dev)
    return out


def results_to_numpy(results: Mapping) -> Dict[str, np.ndarray]:
    """Program results as numpy arrays; bfloat16 and float16 values are
    widened to float32 (exactly), since numpy has no bfloat16."""
    out = {}
    for name, value in results.items():
        t = torch.as_tensor(value).detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        out[name] = t.numpy()
    return out


# ---------------------------------------------------------------------------
# Canned specs (the paper's evaluated programs)
# ---------------------------------------------------------------------------

AXPYDOT_SPEC = {
    "name": "axpydot",
    "dtype": "float32",
    "routines": [
        {
            "blas": "axpy", "name": "zcalc",
            # z = w - alpha*v == axpy(neg_alpha, v, w) with
            # neg_alpha = -alpha supplied on the scalar stream.
            "scalars": {"alpha": {"input": "neg_alpha"}},
            "inputs": {"x": "v", "y": "w"},
            "connections": {"out": "zdot.x"},
        },
        {
            "blas": "dot", "name": "zdot",
            "inputs": {"y": "u"},
            "outputs": {"out": "beta"},
        },
    ],
}

AXPY_SPEC = {
    "name": "axpy",
    "dtype": "float32",
    "routines": [
        {"blas": "axpy", "name": "axpy0",
         "scalars": {"alpha": {"input": "alpha"}},
         "inputs": {"x": "x", "y": "y"},
         "outputs": {"out": "out"}},
    ],
}

GEMV_SPEC = {
    "name": "gemv",
    "dtype": "float32",
    "routines": [
        {"blas": "gemv", "name": "gemv0",
         "scalars": {"alpha": {"input": "alpha"},
                     "beta": {"input": "beta"}},
         "inputs": {"A": "A", "x": "x", "y": "y"},
         "outputs": {"out": "out"}},
    ],
}


def axpydot_program(**kw) -> Program:
    return Program.from_spec(AXPYDOT_SPEC, **kw)


def axpy_program(**kw) -> Program:
    return Program.from_spec(AXPY_SPEC, **kw)


def gemv_program(**kw) -> Program:
    return Program.from_spec(GEMV_SPEC, **kw)
