"""Train and serve step factories, the port of `repro/train/step.py`.

The train state is {"params": the `Model` (its parameters requiring
grad), "opt": {"m", "v"} float32 moments under the Model's parameter
names, "step": an int}. The reference's step is functional; here
`train_step(state, batch)` writes the state in place (the optimizer
updates the weights and moments where they lie) and returns it with the
metrics. `state_tree` and `load_state_tree` give the state as a tree of
whole tensors for the checkpoint manager and back.

Sharded training: `make_train_state` made under `partition.use_mesh`
(and `parallelism_style`) keeps on each rank only its block of every
parameter and of both moments, under `sharding.param_specs`, and records
the placement on the model (`model.layout`). The step then takes this
rank's block of the batch (`sharding.batch_specs`); each block's weights
are gathered for its compute (`partition.Layout.gather`), and their
gradients come back summed over the ranks whose gradients differ and
reduce-scattered onto this rank's blocks, in a fixed order: the same
numbers on every rank. That is what the reference's `grad_specs` asks
GSPMD for; its default without them, an all-reduce, gives the same
numbers, so the port reduce-scatters either way and takes `grad_specs`
only to check them against the state's specs. AdamW then updates each
rank's blocks in place, its clip reading the global norm over every
rank's blocks. A world of one runs no collective and copies nothing: its
step is bitwise the unsharded one. `step_traffic` reckons the bytes a
step's collectives move on a mesh.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ArchConfig
from ..core.distributed import gather_live, live, psum, reduce_plan, shard
from ..models import model as M
from ..models import partition
from ..optim import AdamW
from ..optim.adamw import global_norm


def make_train_state(cfg: ArchConfig, params: M.Model, optim: AdamW):
    """The train state of a Model: its parameters made to require grad,
    zero moments, step 0. Under `partition.use_mesh(mesh)` each
    parameter is first cut to this rank's block under `param_specs` in
    the current `parallelism_style` (in place; a block over one rank is
    the tensor itself), and the placement recorded as `params.layout`."""
    mesh = partition.current_mesh()
    if mesh is not None:
        M.shard_model(cfg, params, mesh, partition.current_style())
    for p in params.parameters():
        p.requires_grad_(True)
    return {"params": params,
            "opt": optim.init(dict(params.named_parameters())), "step": 0}


@torch.no_grad()
def _whole(layout, name, t):
    """A parameter or moment whole, from this rank's block; gathered to
    the host, one tensor at a time, when it is split over ranks."""
    if layout is None:
        return t.detach()
    spec = layout.specs[name]
    if not any(live(layout.mesh, e) for e in spec):
        return t.detach()
    return gather_live(layout.mesh, t.detach(), spec).cpu()


def state_tree(state):
    """The state as a tree of whole tensors (the step a 0-d int64
    tensor): what the checkpoint manager saves, and the `like` it
    restores into. On a sharded state every rank must call it (it
    gathers)."""
    layout = state["params"].layout
    return {"params": {n: _whole(layout, n, p) for n, p in
                       state["params"].named_parameters()},
            "opt": {key: {n: _whole(layout, n, t)
                          for n, t in state["opt"][key].items()}
                    for key in ("m", "v")},
            "step": torch.tensor(state["step"], dtype=torch.int64)}


@torch.no_grad()
def load_state_tree(state, tree):
    """Write a tree of `state_tree`'s layout (whole tensors) into the
    state, in place; a sharded state takes its blocks of them, whatever
    mesh the tree was saved from (the elastic restore)."""
    layout = state["params"].layout

    def put(dst, name, whole):
        whole = whole.to(dst.device)
        if layout is not None:
            whole = shard(layout.mesh, whole, layout.specs[name])
        dst.copy_(whole)

    for n, p in state["params"].named_parameters():
        put(p, n, tree["params"][n])
    for key in ("m", "v"):
        for n, t in state["opt"][key].items():
            put(t, n, tree["opt"][key][n])
    state["step"] = int(tree["step"])
    return state


@torch.no_grad()
def sharded_global_norm(layout, names, grads):
    """The global norm of a sharded state's gradients (this rank's
    blocks), as `global_norm` of the whole ones: each parameter's sum of
    squares over the ranks that hold distinct blocks of it (the others
    add zeros), one fixed-order sum of the vector of them, then the sum
    over the parameters in their order."""
    mesh = layout.mesh
    axes = live(mesh, mesh.mesh_dim_names)
    if not axes:
        return global_norm(grads)
    sq = [g.float().square().sum() for g in grads]
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    own = []
    for name, v in zip(names, sq):
        split = {n for e in layout.specs[name] for n in live(mesh, e)}
        holder = all(coord[a] == 0 for a in axes if a not in split)
        own.append(v if holder else torch.zeros_like(v))
    total = psum(mesh, torch.stack(own), axes)
    return torch.sqrt(sum(total.unbind()))


def make_train_step(cfg: ArchConfig, optim: AdamW, *, remat: bool = True,
                    grad_specs=None):
    """state, batch -> state (updated in place), {"loss": 0-d tensor}.

    grad_specs: optional {parameter name: spec}, the reference's
    argument: the sharded state's `param_specs`, onto which the gradients
    are reduce-scattered with or without it. Specs that differ from the
    state's, or a state not placed on a mesh, are refused."""
    def train_step(state, batch):
        model = state["params"]
        layout = model.layout
        if grad_specs is not None:
            if layout is None:
                raise ValueError("grad_specs needs a train state placed on "
                                 "a mesh (make_train_state under "
                                 "partition.use_mesh)")
            if dict(grad_specs) != dict(layout.specs):
                raise ValueError("grad_specs differ from the state's "
                                 "parameter specs")
        named = dict(model.named_parameters())
        with torch.enable_grad():
            loss = M.train_loss(model, cfg, batch, remat=remat)
            grads = torch.autograd.grad(loss, list(named.values()))
        gnorm = None
        if layout is not None and optim.grad_clip is not None:
            gnorm = sharded_global_norm(layout, list(named), grads)
        optim.update(named, dict(zip(named, grads)), state["opt"],
                     state["step"], gnorm=gnorm)
        del grads
        state["step"] += 1
        return state, {"loss": loss.detach()}

    return train_step


def step_traffic(cfg: ArchConfig, mesh, *, style: str = "2d",
                 batch=None, clip: bool = True) -> dict:
    """The bytes each rank receives in one train step's collectives on
    `mesh` (a `sharding.MeshShape` will do), under remat, reckoned from
    the step's own plan of every parameter (`models.model.make_layout`,
    `partition.Layout.plan`) and the config's dtypes, not measured:
    {"gather": the parameters' gathers, "grad_sum": the gradients' sums}.

    A gather receives what it rebuilds less this rank's block; a block's
    weights are gathered twice a step (the forward and remat's
    recompute), the top-level ones once. A gradient sum follows
    `core.distributed.reduce_plan`: the dimensions no summed rank splits
    are cut first; a reduce-scatter over a dimension of s ranks receives
    (s - 1) / s of the current extent and keeps 1 / s; an all-reduce (an
    all_gather and a sum in rank order) receives s - 1 copies.

    With `batch`, the global (batch, sequence) of a step without a mask,
    also "other": the rest of the step's collectives, each an all_gather
    and a sum in rank order. The loss's float32 sum over the DP ranks;
    with `clip` (an optimizer that clips: `AdamW`'s `grad_clip` set, as
    by default), the clip norm's vector of one float32 a parameter,
    summed over every dimension; and under the "2d"
    MoE variants, each attn_moe layer's token sums over "model" of this
    rank's (tokens, d) block: the output's in the forward (remat's
    recompute stops at the last tensor the backward saved, before it),
    the input gradient's in the backward. Their total is what the cost
    counter's collectives move (`launch.cost`)."""
    layout = M.make_layout(cfg, mesh, style)
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    elem = M.torch_dtype(cfg.dtype).itemsize

    def ranks(spec):
        return math.prod(sizes[n] for e in spec for n in live(mesh, e))

    gather = grad = 0
    for name, shape in M.param_shapes(cfg).items():
        size = math.prod(shape) * (4 if name.split(".")[-1] in M.FLOAT32
                                   else elem)
        spec, axes, _ = layout.plan(name)
        local = size // ranks(layout.specs[name])
        built = local * ranks(spec)                 # what the gather makes
        gather += (2 if name.startswith("blocks.") else 1) * (built - local)
        first, stages, _ = reduce_plan(mesh, spec, axes)
        cur = built // ranks(first)
        for n, dim in stages:
            if dim is None:
                grad += (sizes[n] - 1) * cur
            else:
                grad += (sizes[n] - 1) * cur // sizes[n]
                cur //= sizes[n]
    out = {"gather": gather, "grad_sum": grad}
    if batch is None:
        return out
    every = live(mesh, mesh.mesh_dim_names)
    other = 4 * (math.prod(sizes[n] for n in live(mesh, layout.dp)) - 1)
    if every and clip:
        other += 4 * len(layout.specs) * (math.prod(
            sizes[n] for n in every) - 1)
    if cfg.moe is not None and layout.moe_sharded() and live(mesh, "model"):
        rows, seq = batch
        dp = layout.dp_total
        tokens = (rows // dp if rows % dp == 0 else rows) * seq
        moe_layers = sum(c for k, c in cfg.segments if k == "attn_moe")
        other += (2 * moe_layers * (sizes["model"] - 1) * tokens
                  * cfg.d_model * elem)
    out["other"] = other
    return out


def make_serve_step(cfg: ArchConfig):
    """One greedy decode step: (params, caches, token or embedding, pos)
    -> (logits, caches)."""
    def serve_step(params, caches, inputs_t, pos):
        return M.decode_step(params, cfg, inputs_t, caches, pos)

    return serve_step


def make_prefill_step(cfg: ArchConfig, max_len: int):
    def prefill_step(params, inputs):
        return M.prefill(params, cfg, inputs, max_len)

    return prefill_step
