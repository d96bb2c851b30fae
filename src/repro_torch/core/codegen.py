"""Code generation: fusion groups -> executable torch/Triton callables.

The GPU analogue of AIEBLAS's template-based generators (Fig. 1): from a
level-1 fusion group it *generates a Triton kernel* by splicing each
routine's `tl` expression template into one window walk
(kernels/window.py), with internal edges becoming register values
(never HBM). Standalone level-1 routines dispatch to their hand-written
kernels in repro_torch.kernels.

The reference also generates level-2 anchored groups
(`make_anchored_callable`) and level-3 tiled groups
(`make_tiled_callable`); their Hopper generators come with slices 2 and
4, and until then such a group raises NotImplementedError outside
`reference` mode — as does any level-2/3 routine whose kernel is not
ported (`RoutineDef.pending`).

Three modes mirror the paper's evaluation matrix:
  dataflow     — fused groups, on-chip intermediates   ("w/ DF")
  nodataflow   — one kernel per routine, HBM handoffs  ("w/o DF")
  reference    — torch oracle path                     (the baseline)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch

from repro_torch.kernels import common, ops, window

from . import routines as R
from .fusion import FusionGroup
from .graph import DataflowGraph

# ---------------------------------------------------------------------------
# Standalone dispatch (non-fused nodes)
# ---------------------------------------------------------------------------

_KERNEL_CALL: Dict[str, Callable] = {
    "axpy": lambda s, i: ops.axpy(s["alpha"], i["x"], i["y"]),
    "scal": lambda s, i: ops.scal(s["alpha"], i["x"]),
    "waxpby": lambda s, i: ops.waxpby(s["alpha"], i["x"], s["beta"],
                                      i["y"]),
    "vsub": lambda s, i: ops.axpy(-1.0, i["y"], i["x"]),
    "vmul": lambda s, i: ops.vmul(i["x"], i["y"]),
    "copy": lambda s, i: ops.copy(i["x"]),
    "rot": lambda s, i: ops.rot(s["c"], s["s"], i["x"], i["y"]),
    "dot": lambda s, i: ops.dot(i["x"], i["y"]),
    "asum": lambda s, i: ops.asum(i["x"]),
    "nrm2": lambda s, i: ops.nrm2(i["x"]),
    "iamax": lambda s, i: ops.iamax(i["x"]),
}


def _call_standalone(rspec, scalars, inputs, mode):
    rdef = rspec.rdef
    if mode == "reference" or rdef.kernel is None:
        # routines without a kernel in the reference run their oracle
        # in every mode; unported kernels were refused at emit time
        args = [inputs[p] for p in rdef.inputs]
        return rdef.reference(scalars, *args)
    return _KERNEL_CALL[rspec.blas](scalars, inputs)


def _check_ported(graph: DataflowGraph, groups: List[FusionGroup],
                  mode: str) -> None:
    """Refuse, before anything runs, a program that needs a kernel the
    port does not have yet. The oracle is never substituted for it."""
    if mode == "reference":
        return
    for g in groups:
        if mode == "dataflow" and g.fused and g.anchor is not None:
            two_d = R.OUT_MAT in set(
                graph.nodes[g.anchor].rdef.outputs.values())
            kind, item = (("tiled", R.SLICE4) if two_d
                          else ("anchored", R.SLICE2))
            raise NotImplementedError(
                f"the {kind} fusion group {'+'.join(g.nodes)} (anchor "
                f"{g.anchor!r}) has no Hopper kernel generator yet "
                f"({item}); run it with mode='reference'")
        if g.fused and mode == "dataflow":
            continue
        for name in g.nodes:
            rdef = graph.nodes[name].rdef
            if rdef.pending is not None:
                raise NotImplementedError(
                    f"routine {name!r} ({rdef.name}) has no Hopper kernel "
                    f"yet ({rdef.pending}); run it with mode='reference'")


# ---------------------------------------------------------------------------
# Fused-group kernel generation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GroupSignature:
    scalar_keys: List[tuple]   # (routine, scalar_name)
    vec_in_keys: List[tuple]   # (routine, port)
    elt_out_keys: List[tuple]  # (routine, port) eltwise window outputs
    red_out_keys: List[tuple]  # (routine, port) reduction outputs


def _group_signature(graph: DataflowGraph, group: FusionGroup
                     ) -> GroupSignature:
    members = set(group.nodes)
    scalar_keys, vec_in, elt_out, red_out = [], [], [], []
    for name in group.nodes:
        rspec = graph.nodes[name]
        rdef = rspec.rdef
        for sname in rdef.scalars:
            scalar_keys.append((name, sname))
        for port in rdef.inputs:
            e = graph.producer_of(name, port)
            if e is None or e.src not in members:
                vec_in.append((name, port))
        for port, kind in rdef.outputs.items():
            if kind == R.OUT_SCALAR:
                red_out.append((name, port))
                continue
            consumers = graph.consumers_of(name, port)
            external = [e for e in consumers if e.dst not in members]
            is_pub = (not consumers) or bool(external) or \
                port in rspec.output_aliases
            if is_pub:
                elt_out.append((name, port))
    return GroupSignature(scalar_keys, vec_in, elt_out, red_out)


def _splice_routine(graph, members, name, scal_env, env):
    """Run one member routine's torch emitter on the current env and
    propagate its value(s) along internal edges (the on-chip handoff)."""
    rdef = graph.nodes[name].rdef
    s = {sn: scal_env[(name, sn)] for sn in rdef.scalars}
    args = [env[(name, p)] for p in rdef.inputs]
    val = rdef.emitter(s, *args)
    vals = val if isinstance(val, tuple) else (val,)
    assert len(vals) == len(rdef.outputs), rdef.name
    for port, v in zip(rdef.outputs, vals):
        for e in graph.consumers_of(name, port):
            if e.dst in members:
                env[(e.dst, e.dst_port)] = v
        env[(name, port)] = v


def group_body(graph: DataflowGraph, group: FusionGroup,
               sig: GroupSignature) -> window.WindowBody:
    """Splice the members' `tl` templates into one window-walk body.

    Kernel variables: `s{i}` per scalar key and `x{i}` per external
    input key (signature order), `t{k}` per element-wise value. Sum
    reductions become partial terms, index reductions argmax values, in
    `red_out_keys` order within each kind."""
    members = set(group.nodes)
    var = {k: f"x{i}" for i, k in enumerate(sig.vec_in_keys)}
    svar = {k: f"s{i}" for i, k in enumerate(sig.scalar_keys)}
    lines, sums, argmaxes = [], [], []
    for name in group.nodes:   # topo order inside the group
        rdef = graph.nodes[name].rdef
        fmt = {sn: svar[(name, sn)] for sn in rdef.scalars}
        fmt.update({p: var[(name, p)] for p in rdef.inputs})
        if rdef.index_reduction:
            argmaxes.append(fmt["x"])
            continue
        if rdef.reduction:
            sums.append((rdef.tl_template.format(**fmt), rdef.tl_post))
            continue
        for port, template in zip(rdef.outputs, rdef.tl_template):
            v = f"t{len(lines)}"
            lines.append(f"{v} = {template.format(**fmt)}")
            var[(name, port)] = v
            for e in graph.consumers_of(name, port):
                if e.dst in members:
                    var[(e.dst, e.dst_port)] = v
    return window.WindowBody(
        n_scalars=len(sig.scalar_keys), n_inputs=len(sig.vec_in_keys),
        lines=tuple(lines),
        stores=tuple(var[k] for k in sig.elt_out_keys),
        sums=tuple(sums), argmaxes=tuple(argmaxes))


@common.counted
def group_kernel(body: window.WindowBody, scalars: List,
                 vecs: List[torch.Tensor], out_dtype: torch.dtype):
    """Launch one generated group kernel on the card (plus the combine
    of its reduction partials). Scalars stay float32, as in the
    reference (codegen.py:397)."""
    dev = vecs[0].device
    scal = common.scalar_block(scalars, dev) if scalars else None
    outs, sums, idxs, finished = window.launch(
        "group", body, scal, vecs, [out_dtype] * len(body.stores))
    group_kernel.launches += 1
    group_kernel.finish_launches += finished
    return outs, sums, idxs


def make_group_callable(graph: DataflowGraph, group: FusionGroup, dtype):
    """Returns fn(scalars: {(r,s): val}, vec_ins: {(r,p): 1-D tensor})
    -> {(r,p): value} for a fused level-1 group: the generated kernel on
    CUDA tensors, the splice of torch emitters on CPU tensors."""
    sig = _group_signature(graph, group)
    body = group_body(graph, group, sig)
    members = set(group.nodes)

    def plain(scalars, vec_ins):
        dev = vec_ins[sig.vec_in_keys[0]].device
        env = {k: v.float() for k, v in vec_ins.items()}
        scal_env = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                    for k, v in scalars.items()}
        for name in group.nodes:
            _splice_routine(graph, members, name, scal_env, env)
        results = {k: env[k].to(dtype) for k in sig.elt_out_keys}
        for key in sig.red_out_keys:
            post = graph.nodes[key[0]].rdef.post
            results[key] = post(env[key]) if post is not None else env[key]
        return results

    def run(scalars, vec_ins):
        vecs = [vec_ins[k] for k in sig.vec_in_keys]
        n = vecs[0].shape[0]
        for k, v in zip(sig.vec_in_keys, vecs):
            if v.shape[0] != n:
                raise ValueError(
                    f"fused group vectors disagree on length: "
                    f"{sig.vec_in_keys[0]}={n}, {k}={v.shape[0]}")
        common.check_vectors(*vecs, same_dtype=False)
        if not common.on_card(*vecs):
            group_kernel.plain_calls += 1
            return plain(scalars, vec_ins)
        outs, sums, idxs = group_kernel(
            body, [scalars[k] for k in sig.scalar_keys], vecs, dtype)
        results = dict(zip(sig.elt_out_keys, outs))
        si = ii = 0
        for key in sig.red_out_keys:
            if graph.nodes[key[0]].rdef.index_reduction:
                results[key] = idxs[ii]
                ii += 1
            else:
                results[key] = sums[si]
                si += 1
        return results

    run.signature = sig
    run.body = body
    run.plain = plain
    return run


# ---------------------------------------------------------------------------
# Whole-program emission
# ---------------------------------------------------------------------------


def emit_program(graph: DataflowGraph, groups: List[FusionGroup],
                 mode: str):
    """Lower (graph, fusion plan) to one python callable over a dict of
    program inputs, returning a dict of program outputs."""
    if mode not in ("dataflow", "nodataflow", "reference"):
        raise ValueError(f"unknown mode {mode!r}")
    _check_ported(graph, groups, mode)
    dtype = graph.spec.dtype

    # public-input bindings: name -> list[(routine, port)]
    input_bindings: Dict[str, list] = {}
    for pi in graph.inputs:
        input_bindings.setdefault(pi.name, []).append((pi.routine, pi.port))

    fused_callables = {}
    if mode == "dataflow":
        for gi, g in enumerate(groups):
            if g.fused:
                fused_callables[gi] = make_group_callable(graph, g, dtype)

    def program(inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        missing = [n for n in graph.input_names() if n not in inputs]
        if missing:
            raise ValueError(f"missing program inputs: {missing}")
        # values produced so far, keyed by (routine, port)
        env: Dict[tuple, torch.Tensor] = {}
        for pub, bindings in input_bindings.items():
            for key in bindings:
                env[key] = inputs[pub]

        def scalar_value(rspec, sname):
            b = rspec.scalars[sname]
            if b.kind == "value":
                return b.value
            return inputs[b.input_name]

        for gi, g in enumerate(groups):
            if gi in fused_callables:
                run = fused_callables[gi]
                sig = run.signature
                scalars = {
                    (rn, sn): scalar_value(graph.nodes[rn], sn)
                    for (rn, sn) in sig.scalar_keys}
                vec_ins = {k: env[k] for k in sig.vec_in_keys}
                env.update(run(scalars, vec_ins))
            else:
                for name in g.nodes:
                    rspec = graph.nodes[name]
                    rdef = rspec.rdef
                    s = {sn: scalar_value(rspec, sn)
                         for sn in rdef.scalars}
                    ins = {p: env[(name, p)] for p in rdef.inputs}
                    out = _call_standalone(rspec, s, ins, mode)
                    outs = out if isinstance(out, tuple) else (out,)
                    for port, val in zip(rdef.outputs, outs):
                        env[(name, port)] = val
            # propagate along edges leaving this group
            for name in g.nodes:
                for port in graph.nodes[name].rdef.outputs:
                    for e in graph.consumers_of(name, port):
                        if (e.src, e.src_port) in env:
                            env[(e.dst, e.dst_port)] = env[
                                (e.src, e.src_port)]

        return {o.name: env[(o.routine, o.port)] for o in graph.outputs}

    return program
