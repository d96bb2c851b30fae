"""Code generation: fusion groups -> executable torch/Triton/CUDA
callables.

The GPU analogue of AIEBLAS's template-based generators (Fig. 1). Three
generated-kernel shapes, each splicing the member routines' `tl`
expression templates into one Triton kernel, with internal edges
becoming register values (never HBM):

* level-1 groups — one window walk over the vectors
  (`make_group_callable`, kernels/window.py);
* level-2 anchored groups — a gemv anchor streams its matrix through
  one program per output block, producers of its y run in the row
  phase and consumers of its output in the finish phase; a symv or
  gemvt anchor's product runs on the standalone kernel's CUDA mainloop
  (csrc/symv.cu, csrc/gemv.cu) and one Triton epilogue splices the
  members around it (`make_anchored_callable`, kernels/anchored.py);
* level-3 tiled groups — the gemm anchor's product runs on gemm's CUDA
  mainloop (csrc/gemm.cu), then one Triton epilogue finishes each
  (bm, bn) output tile and splices the panel epilogues and column
  reductions against it (`make_tiled_callable`, kernels/tiled.py).

Standalone routines dispatch to their hand-written kernels in
repro_torch.kernels (Triton for level 1, CUDA C++ for gemv, gemvt, symv,
ger, transpose and gemm).

A resolved tile plan (`emit_program(tiles=)`, from `core.lowering`)
gives each site its `tune.TileConfig` at call time, bucketed on the
operands' dims (sites `g{i}` for a fused group, `g{i}:{routine}` for a
standalone node); the kernel wrapper maps it to its own knobs. The
empty plan resolves nothing per call.

Three modes mirror the paper's evaluation matrix:
  dataflow     — fused groups, on-chip intermediates   ("w/ DF")
  nodataflow   — one kernel per routine, HBM handoffs  ("w/o DF")
  reference    — torch oracle path                     (the baseline)

While `repro_torch.obs` records, emission tags every group with one
`codegen.group` event, and each program call wraps each group's launch
in a `kernel.group` span that waits for the group's outputs, so the
span times the work; outside a CUDA-graph capture only (`obs.concrete`).
In a registry that does not wait (`obs.capture(wait=False)`) the span
times the group's issue and nothing waits. With recording off a call
checks one attribute and waits for nothing.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch import obs
from repro_torch.kernels import anchored, common, gemm as gemm_mod, \
    gemv as gemv_mod, ops, symv as symv_mod, tiled, window

from . import routines as R
from .fusion import FusionGroup
from .graph import DataflowGraph

# ---------------------------------------------------------------------------
# Standalone dispatch (non-fused nodes)
# ---------------------------------------------------------------------------

_KERNEL_CALL: Dict[str, Callable] = {
    "axpy": lambda s, i, t: ops.axpy(s["alpha"], i["x"], i["y"], tiles=t),
    "scal": lambda s, i, t: ops.scal(s["alpha"], i["x"], tiles=t),
    "waxpby": lambda s, i, t: ops.waxpby(s["alpha"], i["x"], s["beta"],
                                         i["y"], tiles=t),
    "vsub": lambda s, i, t: ops.axpy(-1.0, i["y"], i["x"], tiles=t),
    "vmul": lambda s, i, t: ops.vmul(i["x"], i["y"], tiles=t),
    "copy": lambda s, i, t: ops.copy(i["x"], tiles=t),
    "rot": lambda s, i, t: ops.rot(s["c"], s["s"], i["x"], i["y"],
                                   tiles=t),
    "dot": lambda s, i, t: ops.dot(i["x"], i["y"], tiles=t),
    "asum": lambda s, i, t: ops.asum(i["x"], tiles=t),
    "nrm2": lambda s, i, t: ops.nrm2(i["x"], tiles=t),
    "iamax": lambda s, i, t: ops.iamax(i["x"], tiles=t),
    "gemv": lambda s, i, t: ops.gemv(s["alpha"], i["A"], i["x"],
                                     s["beta"], i["y"], tiles=t),
    "gemvt": lambda s, i, t: ops.gemvt(s["alpha"], i["A"], i["x"],
                                       s["beta"], i["y"], tiles=t),
    "symv": lambda s, i, t: ops.symv(s["alpha"], i["A"], i["x"],
                                     s["beta"], i["y"], tiles=t),
    "gemm": lambda s, i, t: ops.gemm(s["alpha"], i["A"], i["B"],
                                     s["beta"], i["C"], tiles=t),
    # no tile knob: the config is not read
    "ger": lambda s, i, t: ops.ger(s["alpha"], i["x"], i["y"], i["A"]),
    "transpose": lambda s, i, t: ops.transpose(i["A"]),
}


def _call_standalone(rspec, scalars, inputs, mode, tile_cfg=None):
    rdef = rspec.rdef
    if mode == "reference" or rdef.kernel is None:
        # routines without a kernel in the reference run their oracle
        # in every mode
        args = [inputs[p] for p in rdef.inputs]
        return rdef.reference(scalars, *args)
    return _KERNEL_CALL[rspec.blas](scalars, inputs, tile_cfg)


def _standalone_dims(rspec, ins):
    """The dims a standalone node's tile config is bucketed against, as
    the autotuner's `_discover_sites` keys them: the matrix shape for
    level 2 (gemm appends its contraction dim), else the vector
    length."""
    rdef = rspec.rdef
    for port, kind in rdef.inputs.items():
        if kind == R.MAT:
            sh = tuple(int(d) for d in ins[port].shape)
            if rspec.blas == "gemm" and len(sh) == 2:
                b = ins.get("B")
                n = (int(b.shape[1]) if getattr(b, "ndim", 0) == 2
                     else sh[1])
                sh = (sh[0], n, sh[1])
            return sh
    for port in rdef.inputs:
        v = ins[port]
        if getattr(v, "ndim", 0) >= 1:
            return (int(v.shape[0]),)
    return ()


def _memo(resolve):
    """A call-time tile resolver (`TilePlan.lookup`) memoized by dims,
    or None for none: a program run with the default plan resolves
    nothing."""
    if resolve is None:
        return None
    return functools.lru_cache(maxsize=64)(resolve)


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


def _bind(graph, members, env, name, port, value):
    """Bind one output of a member to `value` in `env` and hand it to the
    member ports it feeds (an internal edge: the on-chip handoff). `env`
    maps (routine, port) to a torch value in a plain splice, to a kernel
    variable name in a generated body."""
    env[(name, port)] = value
    for e in graph.consumers_of(name, port):
        if e.dst in members:
            env[(e.dst, e.dst_port)] = value


def _splice_routine(graph, members, name, scal_env, env):
    """Run one member routine's torch emitter on the current env and
    propagate its value(s) along internal edges."""
    rdef = graph.nodes[name].rdef
    s = {sn: scal_env[(name, sn)] for sn in rdef.scalars}
    args = [env[(name, p)] for p in rdef.inputs]
    val = rdef.emitter(s, *args)
    vals = val if isinstance(val, tuple) else (val,)
    assert len(vals) == len(rdef.outputs), rdef.name
    for port, v in zip(rdef.outputs, vals):
        _bind(graph, members, env, name, port, v)


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
            _bind(graph, members, var, name, port, v)
    return window.WindowBody(
        n_scalars=len(sig.scalar_keys), n_inputs=len(sig.vec_in_keys),
        lines=tuple(lines),
        stores=tuple(var[k] for k in sig.elt_out_keys),
        sums=tuple(sums), argmaxes=tuple(argmaxes))


@common.counted
def group_kernel(body: window.WindowBody, scalars: List,
                 vecs: List[torch.Tensor], out_dtype: torch.dtype,
                 block: int = window.BLOCK):
    """Launch one generated group kernel on the card (its last program
    combines its reduction partials), in steps of `block` elements.
    Scalars stay float32, as in the reference (codegen.py:397)."""
    outs, sums, idxs, folded = window.launch(
        "group", body, scalars, vecs, [out_dtype] * len(body.stores),
        block=block)
    group_kernel.launches += 1
    group_kernel.folded += folded
    return outs, sums, idxs


def _scalar_env(scalars, dev):
    return {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
            for k, v in scalars.items()}


def _plain_results(graph, sig, env, dtype):
    """A plain splice's outputs: element-wise values rounded to the
    program dtype, reductions with their `post` hook (nrm2's sqrt)."""
    results = {k: env[k].to(dtype) for k in sig.elt_out_keys}
    for key in sig.red_out_keys:
        post = graph.nodes[key[0]].rdef.post
        results[key] = post(env[key]) if post is not None else env[key]
    return results


def _kernel_results(graph, sig, outs, sums, idxs):
    """A generated kernel's outputs by (routine, port): element-wise
    buffers in `elt_out_keys` order, then sums and index reductions,
    each kind in `red_out_keys` order."""
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


def make_group_callable(graph: DataflowGraph, group: FusionGroup, dtype,
                        tile_resolve=None):
    """Returns fn(scalars: {(r,s): val}, vec_ins: {(r,p): 1-D tensor})
    -> {(r,p): value} for a fused level-1 group: the generated kernel on
    CUDA tensors, the splice of torch emitters on CPU tensors.
    `tile_resolve` (a `TilePlan.lookup` resolver, or None) gives the
    walk's step per vector-length bucket (`block_rows`)."""
    tile_resolve = _memo(tile_resolve)
    sig = _group_signature(graph, group)
    body = group_body(graph, group, sig)
    members = set(group.nodes)

    def plain(scalars, vec_ins):
        dev = vec_ins[sig.vec_in_keys[0]].device
        env = {k: v.float() for k, v in vec_ins.items()}
        scal_env = _scalar_env(scalars, dev)
        for name in group.nodes:
            _splice_routine(graph, members, name, scal_env, env)
        return _plain_results(graph, sig, env, dtype)

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
        block = window.BLOCK
        if tile_resolve is not None:
            block = window.block_of(tile_resolve(n))
        outs, sums, idxs = group_kernel(
            body, [scalars[k] for k in sig.scalar_keys], vecs, dtype,
            block)
        return _kernel_results(graph, sig, outs, sums, idxs)

    run.signature = sig
    run.body = body
    run.plain = plain
    return run


# ---------------------------------------------------------------------------
# Level-2 anchored group kernel generation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AnchoredSignature:
    """Operand layout of a level-2 anchored fused kernel. vec_in_keys
    is the set emit_program binds (it includes the matrix operand, so
    emit_program's plumbing is identical to level-1 groups);
    win_in_keys are the *vector* operands, in signature order."""
    anchor: str
    scalar_keys: List[tuple]
    vec_in_keys: List[tuple]        # all external ins, incl. the matrix
    win_in_keys: List[tuple]        # vector ins only
    elt_out_keys: List[tuple]
    red_out_keys: List[tuple]
    mat_key: tuple                  # (anchor, A)
    cols_key: tuple                 # (anchor, x): the reduction axis
    rows_key: tuple                 # (anchor, y): aligned with the output
    pre: Tuple[str, ...]            # members emitted in the row phase
    post: Tuple[str, ...]           # members emitted in the finish phase


def _anchored_signature(graph: DataflowGraph, group: FusionGroup
                        ) -> AnchoredSignature:
    base = _group_signature(graph, group)
    anchor = group.anchor
    ports = graph.nodes[anchor].rdef.anchor_ports
    mat_key = (anchor, ports["mat"])
    cols_key = (anchor, ports["cols"])
    rows_key = (anchor, ports["rows"])
    win_in = [k for k in base.vec_in_keys if k != mat_key]
    # members feeding the anchor run in the row phase. Group convexity
    # keeps member-to-member paths inside the group, so a walk back
    # over in-group producer edges finds exactly the anchor's in-group
    # ancestors.
    members = set(group.nodes)
    pre_set, stack = set(), [anchor]
    while stack:
        node = stack.pop()
        for port in graph.nodes[node].rdef.inputs:
            e = graph.producer_of(node, port)
            if e is not None and e.src in members and \
                    e.src != anchor and e.src not in pre_set:
                pre_set.add(e.src)
                stack.append(e.src)
    pre = tuple(m for m in group.nodes if m in pre_set)
    post = tuple(m for m in group.nodes
                 if m != anchor and m not in pre_set)
    return AnchoredSignature(
        anchor=anchor, scalar_keys=base.scalar_keys,
        vec_in_keys=base.vec_in_keys, win_in_keys=win_in,
        elt_out_keys=base.elt_out_keys, red_out_keys=base.red_out_keys,
        mat_key=mat_key, cols_key=cols_key, rows_key=rows_key,
        pre=pre, post=post)


def _out_port(graph, name):
    return next(iter(graph.nodes[name].rdef.outputs))


def anchored_body(graph: DataflowGraph, group: FusionGroup,
                  sig: AnchoredSignature) -> anchored.AnchoredBody:
    """Splice the members' `tl` templates around the anchor's matrix
    walk. Kernel variables: `s{i}` per scalar key, `xc` for the
    reduction-axis vector, `x{i}` per other external vector (win_in_keys
    order without `cols_key`), `t{k}` per element-wise value and `yo`
    for the anchor's output block."""
    members = set(group.nodes)
    var = {sig.cols_key: "xc"}
    var.update({k: f"x{i}" for i, k in enumerate(
        k for k in sig.win_in_keys if k != sig.cols_key)})
    svar = {k: f"s{i}" for i, k in enumerate(sig.scalar_keys)}
    sums, argmaxes, values = [], [], itertools.count()

    def link(name, port, v):
        _bind(graph, members, var, name, port, v)

    def splice(name, lines):
        rdef = graph.nodes[name].rdef
        fmt = {sn: svar[(name, sn)] for sn in rdef.scalars}
        fmt.update({p: var[(name, p)] for p in rdef.inputs})
        if rdef.index_reduction:
            argmaxes.append(fmt["x"])
        elif rdef.reduction:
            sums.append((rdef.tl_template.format(**fmt), rdef.tl_post))
        else:
            for port, template in zip(rdef.outputs, rdef.tl_template):
                v = f"t{next(values)}"
                lines.append(f"{v} = {template.format(**fmt)}")
                link(name, port, v)

    pre, post = [], []
    for name in sig.pre:
        splice(name, pre)
    link(sig.anchor, _out_port(graph, sig.anchor), "yo")
    for name in sig.post:
        splice(name, post)
    return anchored.AnchoredBody(
        anchor=graph.nodes[sig.anchor].blas,
        n_scalars=len(sig.scalar_keys), n_inputs=len(sig.win_in_keys) - 1,
        alpha=svar[(sig.anchor, "alpha")], beta=svar[(sig.anchor, "beta")],
        rows=var[sig.rows_key], pre=tuple(pre), post=tuple(post),
        stores=tuple(var[k] for k in sig.elt_out_keys),
        sums=tuple(sums), argmaxes=tuple(argmaxes))


# the anchor's float32 product before alpha and beta, for the plain
# splice (the same functions the standalone plain versions use)
_ANCHOR_ACC = {"gemv": gemv_mod.gemv_acc, "gemvt": gemv_mod.gemvt_acc,
               "symv": symv_mod.symv_acc}


@common.counted
def anchored_kernel(body: anchored.AnchoredBody, scalars: List,
                    a: torch.Tensor, xc: torch.Tensor,
                    vecs: List[torch.Tensor], out_dtype: torch.dtype,
                    tiles=None):
    """Launch one anchored group on the card: for a symv or gemvt
    anchor the product (counted per anchor and route) and the generated
    epilogue, for a gemv anchor the generated kernel (counted in
    `launches`, one per group call); then the folds and the combine of
    its reduction partials (a launch of its own after the gemv anchor's
    kernel, the epilogue's last program after a product's). Scalars
    stay float32."""
    outs, sums, idxs, finished, folded, route = anchored.launch(
        body, scalars, a, xc, vecs, out_dtype, tiles)
    anchored_kernel.launches += 1
    anchored_kernel.finish_launches += finished
    anchored_kernel.folded += folded
    if route is not None:
        anchored_kernel.route_launches[route] += 1
    return outs, sums, idxs


# the products' launches (csrc/symv.cu's repro_symv_acc, csrc/gemv.cu's
# repro_gemvt_acc) per anchor and route, one per symv- or
# gemvt-anchored group call; never counted under `symv` or `gemvt`
anchored_kernel.route_launches = dict.fromkeys(anchored.ROUTES, 0)


def make_anchored_callable(graph: DataflowGraph, group: FusionGroup,
                           dtype, tile_resolve=None):
    """Returns fn(scalars: {(r,s): val}, vec_ins: {(r,p): tensor}) ->
    {(r,p): value} for a level-2 anchored group; vec_ins carries the
    matrix under (anchor, A) beside the vectors. The generated kernel
    runs on CUDA tensors, the splice of torch emitters on CPU ones.
    `tile_resolve` gives the group's config per (m, n) bucket."""
    tile_resolve = _memo(tile_resolve)
    sig = _anchored_signature(graph, group)
    body = anchored_body(graph, group, sig)
    blas = body.anchor
    members = set(group.nodes)
    row_keys = [k for k in sig.win_in_keys if k != sig.cols_key]

    def plain(scalars, vec_ins):
        a = vec_ins[sig.mat_key]
        env = {k: vec_ins[k].float() for k in sig.win_in_keys}
        scal_env = _scalar_env(scalars, a.device)
        for name in sig.pre:
            _splice_routine(graph, members, name, scal_env, env)
        acc = _ANCHOR_ACC[blas](a, env[sig.cols_key])
        block = scal_env[(sig.anchor, "alpha")] * acc \
            + scal_env[(sig.anchor, "beta")] * env[sig.rows_key]
        _bind(graph, members, env, sig.anchor, _out_port(graph, sig.anchor),
              block)
        for name in sig.post:
            _splice_routine(graph, members, name, scal_env, env)
        return _plain_results(graph, sig, env, dtype)

    def run(scalars, vec_ins):
        a = vec_ins[sig.mat_key]
        m, n = common.check_matrix(a)
        if blas == "symv" and m != n:
            raise ValueError(f"symv needs a square matrix, got {a.shape}")
        # gemvt's output (and every output-aligned vector) runs over A's
        # columns, its reduction-axis operand x over A's rows
        out_len, red_len = (n, m) if blas == "gemvt" else (m, n)
        for key in sig.win_in_keys:
            v = vec_ins[key]
            want = red_len if key == sig.cols_key else out_len
            if v.ndim != 1 or v.shape[0] != want:
                raise ValueError(
                    f"anchored group vectors disagree on length: {key} "
                    f"has shape {tuple(v.shape)}, the {blas} anchor "
                    f"wants ({want},)")
        xc = vec_ins[sig.cols_key]
        vecs = [vec_ins[k] for k in row_keys]
        common.check_vectors(xc, same_dtype=False)
        if not common.on_card(a, xc, *vecs):
            anchored_kernel.plain_calls += 1
            return plain(scalars, vec_ins)
        cfg = tile_resolve(m, n) if tile_resolve is not None else None
        outs, sums, idxs = anchored_kernel(
            body, [scalars[k] for k in sig.scalar_keys], a, xc, vecs,
            dtype, cfg)
        return _kernel_results(graph, sig, outs, sums, idxs)

    run.signature = sig
    run.body = body
    run.plain = plain
    return run


# ---------------------------------------------------------------------------
# Level-3 tiled (gemm-anchored) group kernel generation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TiledSignature:
    """Operand layout of a level-3 gemm-anchored fused kernel.
    vec_in_keys is the set emit_program binds (the three anchor
    matrices included, so emit_program's plumbing is identical to the
    other group shapes); the rest partitions it by tile shape."""
    anchor: str
    scalar_keys: List[tuple]
    vec_in_keys: List[tuple]      # all external ins
    mat_in_keys: List[tuple]      # member panel ins, (bm, bn) tiles
    col_in_keys: List[tuple]      # member vector ins, (1, bn) rows
    elt_out_keys: List[tuple]     # (m, n) outputs
    colred_out_keys: List[tuple]  # column reductions, (n,) float32
    red_out_keys: List[tuple]     # scalar reductions
    mat_key: tuple                # (anchor, A)
    cols_key: tuple               # (anchor, B)
    rows_key: tuple               # (anchor, C)
    post: Tuple[str, ...]         # members spliced on the finished tile


def _tiled_signature(graph: DataflowGraph, group: FusionGroup
                     ) -> TiledSignature:
    base = _group_signature(graph, group)
    anchor = group.anchor
    ports = graph.nodes[anchor].rdef.anchor_ports
    mat_key = (anchor, ports["mat"])
    cols_key = (anchor, ports["cols"])
    rows_key = (anchor, ports["rows"])
    anchor_keys = {mat_key, cols_key, rows_key}
    mat_in, col_in = [], []
    for k in base.vec_in_keys:
        if k in anchor_keys:
            continue
        kind = graph.nodes[k[0]].rdef.inputs[k[1]]
        (mat_in if kind == R.MAT else col_in).append(k)
    # column reductions (coldot) have vector outputs, which the base
    # signature files with the element-wise ones; split them off
    elt_out, colred_out = [], []
    for k in base.elt_out_keys:
        if graph.nodes[k[0]].rdef.reduction:
            colred_out.append(k)
        else:
            elt_out.append(k)
    post = tuple(m for m in group.nodes if m != anchor)
    return TiledSignature(
        anchor=anchor, scalar_keys=base.scalar_keys,
        vec_in_keys=base.vec_in_keys, mat_in_keys=mat_in,
        col_in_keys=col_in, elt_out_keys=elt_out,
        colred_out_keys=colred_out, red_out_keys=base.red_out_keys,
        mat_key=mat_key, cols_key=cols_key, rows_key=rows_key,
        post=post)


def tiled_body(graph: DataflowGraph, group: FusionGroup,
               sig: TiledSignature) -> tiled.TiledBody:
    """Splice the members' `tl` templates against the anchor's finished
    tile `yo`. Kernel variables: `s{i}` per scalar key, `m{i}` per
    member panel and `v{i}` per member vector (signature order), `t{k}`
    per element-wise value. Index reductions are refused, as in the
    reference."""
    members = set(group.nodes)
    var = {k: f"m{i}" for i, k in enumerate(sig.mat_in_keys)}
    var.update({k: f"v{i}" for i, k in enumerate(sig.col_in_keys)})
    svar = {k: f"s{i}" for i, k in enumerate(sig.scalar_keys)}
    lines, terms, values = [], {}, itertools.count()

    def link(name, port, v):
        _bind(graph, members, var, name, port, v)

    link(sig.anchor, _out_port(graph, sig.anchor), "yo")
    for name in sig.post:
        rdef = graph.nodes[name].rdef
        if rdef.index_reduction:
            raise NotImplementedError(
                f"index reductions cannot ride a tiled group ({name!r} "
                f"under the gemm anchor {sig.anchor!r})")
        fmt = {sn: svar[(name, sn)] for sn in rdef.scalars}
        fmt.update({p: var[(name, p)] for p in rdef.inputs})
        if rdef.reduction:
            terms[(name, _out_port(graph, name))] = (
                rdef.tl_template.format(**fmt), rdef.tl_post)
            continue
        for port, template in zip(rdef.outputs, rdef.tl_template):
            v = f"t{next(values)}"
            lines.append(f"{v} = {template.format(**fmt)}")
            link(name, port, v)
    return tiled.TiledBody(
        n_scalars=len(sig.scalar_keys), n_mats=len(sig.mat_in_keys),
        n_cols=len(sig.col_in_keys),
        alpha=svar[(sig.anchor, "alpha")], beta=svar[(sig.anchor, "beta")],
        post=tuple(lines), stores=tuple(var[k] for k in sig.elt_out_keys),
        colsums=tuple(terms[k] for k in sig.colred_out_keys),
        sums=tuple(terms[k] for k in sig.red_out_keys))


@common.counted
def tiled_kernel(body: tiled.TiledBody, scalars: List, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor,
                 mats: List[torch.Tensor], cols: List[torch.Tensor],
                 out_dtype: torch.dtype, tiles=None):
    """Launch one tiled group on the card: the product, the generated
    epilogue (counted in `launches`) and the fixed-order folds of its
    column and scalar partials. Scalars stay float32."""
    scal = common.scalar_block(scalars, a.device)
    outs, colres, sums, folds, route = tiled.launch(
        body, scal, a, b, c, mats, cols, out_dtype, tiles)
    tiled_kernel.launches += 1
    tiled_kernel.route_launches[route] += 1
    tiled_kernel.finish_launches += folds
    return outs, colres, sums


# the product's launches (csrc/gemm.cu's repro_gemm_acc) per route, one
# per tiled group call beside its epilogue; never counted under `gemm`
tiled_kernel.route_launches = dict.fromkeys(gemm_mod.ROUTES, 0)


def make_tiled_callable(graph: DataflowGraph, group: FusionGroup, dtype,
                        tile_resolve=None):
    """Returns fn(scalars: {(r,s): val}, vec_ins: {(r,p): tensor}) ->
    {(r,p): value} for a level-3 gemm-anchored group; vec_ins carries
    the anchor's A, B and C beside the member panels and vectors. The
    generated kernel runs on CUDA tensors, the splice of torch emitters
    on CPU ones. Column reductions come back float32, as in the
    reference. `tile_resolve` gives the product's config per (m, n, k)
    bucket."""
    tile_resolve = _memo(tile_resolve)
    sig = _tiled_signature(graph, group)
    body = tiled_body(graph, group, sig)
    members = set(group.nodes)

    def plain(scalars, vec_ins):
        a = vec_ins[sig.mat_key]
        env = {k: vec_ins[k].float()
               for k in sig.mat_in_keys + sig.col_in_keys}
        scal_env = _scalar_env(scalars, a.device)
        tile = scal_env[(sig.anchor, "alpha")] * gemm_mod.gemm_acc(
            a, vec_ins[sig.cols_key]) \
            + scal_env[(sig.anchor, "beta")] * vec_ins[sig.rows_key].float()
        _bind(graph, members, env, sig.anchor, _out_port(graph, sig.anchor),
              tile)
        for name in sig.post:
            _splice_routine(graph, members, name, scal_env, env)
        results = _plain_results(graph, sig, env, dtype)
        for key in sig.colred_out_keys:
            post = graph.nodes[key[0]].rdef.post
            results[key] = post(env[key]) if post is not None else env[key]
        return results

    def run(scalars, vec_ins):
        a, b, c = (vec_ins[k] for k in (sig.mat_key, sig.cols_key,
                                         sig.rows_key))
        if a.ndim != 2 or b.ndim != 2 or c.ndim != 2:
            raise ValueError(
                f"tiled group {sig.anchor!r}: A/B/C must be 2-D, got "
                f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(c.shape)}")
        m, n, kdim = gemm_mod.check_operands(a, b, c)
        mats = [vec_ins[k] for k in sig.mat_in_keys]
        cols = [vec_ins[k] for k in sig.col_in_keys]
        for key, v in zip(sig.mat_in_keys, mats):
            if tuple(v.shape) != (m, n):
                raise ValueError(
                    f"tiled group panels disagree on shape: {key} has "
                    f"{tuple(v.shape)}, the {sig.anchor} anchor tiles "
                    f"(m, n)=({m}, {n})")
        for key, v in zip(sig.col_in_keys, cols):
            if v.ndim != 1 or v.shape[0] != n:
                raise ValueError(
                    f"tiled group column vectors disagree on length: "
                    f"{key} has shape {tuple(v.shape)}, want ({n},)")
        if not common.on_card(a, b, c, *mats, *cols):
            tiled_kernel.plain_calls += 1
            return plain(scalars, vec_ins)
        cfg = tile_resolve(m, n, kdim) if tile_resolve is not None \
            else None
        outs, colres, sums = tiled_kernel(
            body, [scalars[k] for k in sig.scalar_keys], a, b, c, mats,
            cols, dtype, cfg)
        results = dict(zip(sig.elt_out_keys, outs))
        results.update({k: colres[i]
                        for i, k in enumerate(sig.colred_out_keys)})
        results.update({k: sums[i]
                        for i, k in enumerate(sig.red_out_keys)})
        return results

    run.signature = sig
    run.body = body
    run.plain = plain
    return run


# ---------------------------------------------------------------------------
# Whole-program emission
# ---------------------------------------------------------------------------


def emit_program(graph: DataflowGraph, groups: List[FusionGroup],
                 mode: str, tiles=None):
    """Lower (graph, fusion plan) to one python callable over a dict of
    program inputs, returning a dict of program outputs. `tiles` is the
    resolved `tune.TilePlan` (sites `g{i}` for fused groups,
    `g{i}:{routine}` for standalone nodes); None or the empty plan keeps
    the kernels' default plans everywhere and resolves nothing per
    call."""
    if mode not in ("dataflow", "nodataflow", "reference"):
        raise ValueError(f"unknown mode {mode!r}")
    dtype = graph.spec.dtype

    # public-input bindings: name -> list[(routine, port)]
    input_bindings: Dict[str, list] = {}
    for pi in graph.inputs:
        input_bindings.setdefault(pi.name, []).append((pi.routine, pi.port))

    fused_callables = {}
    if mode == "dataflow":
        for gi, g in enumerate(groups):
            if not g.fused:
                continue
            if g.anchor is None:
                make = make_group_callable
            elif R.OUT_MAT in set(
                    graph.nodes[g.anchor].rdef.outputs.values()):
                make = make_tiled_callable
            else:
                make = make_anchored_callable
            fused_callables[gi] = make(
                graph, g, dtype,
                tile_resolve=tiles.lookup(f"g{gi}") if tiles else None)

    # call-time tile resolvers for standalone dispatches
    standalone_resolvers = {}
    if tiles and mode != "reference":
        for gi, g in enumerate(groups):
            if gi in fused_callables:
                continue
            for name in g.nodes:
                standalone_resolvers[(gi, name)] = _memo(
                    tiles.lookup(f"g{gi}:{name}"))

    if obs.enabled():
        # one tag per generated kernel / standalone dispatch so JSONL
        # traces carry the whole emitted-kernel inventory
        for gi, g in enumerate(groups):
            kind = ("anchored" if g.anchor else
                    "fused" if gi in fused_callables else "standalone")
            obs.event("codegen.group", program=graph.spec.name,
                      mode=mode, group=gi, kind=kind,
                      anchor=g.anchor, routines=list(g.nodes))

    # each group's span attributes, built once: a call's span builds
    # no dict
    group_attrs = [
        {"program": graph.spec.name, "mode": mode, "group": gi,
         "anchor": g.anchor, "fused": g.fused,
         "routines": "+".join(g.nodes)} for gi, g in enumerate(groups)]

    def _group_span(gi, timed):
        """A `kernel.group` span around one group's launch while
        recording outside a capture, else the shared no-op."""
        if not timed:
            return obs.NULL_SPAN
        return obs.span_with("kernel.group", group_attrs[gi])

    def program(inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        missing = [n for n in graph.input_names() if n not in inputs]
        if missing:
            raise ValueError(f"missing program inputs: {missing}")
        # values produced so far, keyed by (routine, port)
        env: Dict[tuple, torch.Tensor] = {}
        for pub, bindings in input_bindings.items():
            for key in bindings:
                env[key] = inputs[pub]

        timed = obs.enabled() and obs.concrete(inputs.values())
        wait = timed and obs.waiting()

        def scalar_value(rspec, sname):
            b = rspec.scalars[sname]
            if b.kind == "value":
                return b.value
            return inputs[b.input_name]

        for gi, g in enumerate(groups):
            with _group_span(gi, timed):
                if gi in fused_callables:
                    run = fused_callables[gi]
                    sig = run.signature
                    scalars = {
                        (rn, sn): scalar_value(graph.nodes[rn], sn)
                        for (rn, sn) in sig.scalar_keys}
                    vec_ins = {k: env[k] for k in sig.vec_in_keys}
                    out = run(scalars, vec_ins)
                    if wait:
                        obs.block(out.values())
                    env.update(out)
                else:
                    for name in g.nodes:
                        rspec = graph.nodes[name]
                        rdef = rspec.rdef
                        s = {sn: scalar_value(rspec, sn)
                             for sn in rdef.scalars}
                        ins = {p: env[(name, p)] for p in rdef.inputs}
                        resolve = standalone_resolvers.get((gi, name))
                        cfg = None
                        if resolve is not None:
                            cfg = resolve(*_standalone_dims(rspec, ins))
                        out = _call_standalone(rspec, s, ins, mode, cfg)
                        outs = out if isinstance(out, tuple) else (out,)
                        for port, val in zip(rdef.outputs, outs):
                            env[(name, port)] = val
                        if wait:
                            obs.block(outs)
            # propagate along edges leaving this group
            for name in g.nodes:
                for port in graph.nodes[name].rdef.outputs:
                    for e in graph.consumers_of(name, port):
                        if (e.src, e.src_port) in env:
                            env[(e.dst, e.dst_port)] = env[
                                (e.src, e.src_port)]

        return {o.name: env[(o.routine, o.port)] for o in graph.outputs}

    return program
