"""Parallelism style and mesh for the train step, the port of
`repro/models/partition.py`.

The reference sets its mesh with `jax.set_mesh` and reads it back with
`jax.sharding.get_abstract_mesh()`; its `constrain_*` functions pin
GSPMD's choices (the batch dimension of activations on the DP axes, the
per-layer weights on their FSDP shards) while the step is traced. The
port runs one explicit program per rank over a `DeviceMesh`:

* `use_mesh(mesh)` and `parallelism_style(style)` set the mesh and the
  style for `train.make_train_state`, which places the state under
  `sharding.param_specs` and records the placement on the model
  (`Layout`, made by `models.model.make_layout`); the step and the loss
  read it from there, so a step may run outside these contexts (and
  remat's recompute, which runs in the backward pass, sees the same
  placement);
* a rank's activations are already its own batch block, so there is
  nothing to pin: the reference's `constrain_*` functions have no
  counterpart. `constrain_param_tree`'s job, the per-layer weights
  gathered for compute and their gradients summed onto the shards, is
  `Layout.gather` (`core.distributed.gather_param`).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Mapping, Optional, Tuple

_STYLE = contextvars.ContextVar("parallelism_style", default="2d")
_MESH = contextvars.ContextVar("mesh", default=None)


@contextlib.contextmanager
def parallelism_style(style: str):
    """"2d" (DP x TP, the baseline) or "fsdp" (pure ZeRO-3: batch and
    weights sharded over every mesh dimension). Active while the train
    state is made."""
    if style not in ("2d", "fsdp"):
        raise ValueError(f"unknown parallelism style {style!r}")
    tok = _STYLE.set(style)
    try:
        yield
    finally:
        _STYLE.reset(tok)


def current_style() -> str:
    return _STYLE.get()


@contextlib.contextmanager
def use_mesh(mesh):
    """The mesh for the train state made inside (the reference's
    `jax.set_mesh`)."""
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


def current_mesh():
    """The mesh `use_mesh` set, or None."""
    return _MESH.get()


def dp_axes_of(mesh, style: str) -> tuple:
    """The dimensions whose ranks hold distinct batch blocks: ("pod",)
    "data" in "2d", every dimension in "fsdp"."""
    names = ("pod", "data", "model") if style == "fsdp" else ("pod", "data")
    return tuple(a for a in names if a in mesh.mesh_dim_names)


def size_of(mesh, names) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    n = 1
    for a in names:
        n *= sizes[a]
    return n


@dataclasses.dataclass(frozen=True)
class Layout:
    """A sharded model's placement: its mesh, style and {parameter name:
    spec} (`sharding.param_specs`). Each rank stores only its block of
    every parameter; `gather` rebuilds a parameter for compute.

    `moe` names the MoE weights that the "2d" TP/EP variants take: each
    with the variant's split over "model" (`models.moe.TP_SPECS`,
    `EP_SPECS`, `SHARED_SPECS`), the router with None. `plan` is the one
    place that decides what a parameter's gather rebuilds and which ranks
    sum its gradient."""
    mesh: Any
    style: str
    specs: Mapping[str, tuple]
    moe: Mapping[str, Optional[tuple]] = dataclasses.field(
        default_factory=dict)
    # {name: (plan, whether its gather is the block itself)}, filled by
    # `gather`: the plan is a function of the name alone, and the serve
    # path asks for it every layer of every step
    _plans: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @property
    def dp(self) -> tuple:
        return dp_axes_of(self.mesh, self.style)

    @property
    def dp_total(self) -> int:
        return size_of(self.mesh, self.dp)

    def moe_sharded(self) -> bool:
        """Whether the MoE layers take the reference's TP/EP variants
        (style "2d" on a mesh with "data" and "model")."""
        names = self.mesh.mesh_dim_names
        return self.style == "2d" and "data" in names and "model" in names

    def plan(self, name: str) -> Tuple[tuple, tuple, Optional[tuple]]:
        """(gather spec, summed axes, cut) of parameter `name`: its block
        is gathered over the gather spec's dimensions, its gradient
        summed over the summed axes (the ranks whose gradients differ)
        and reduce-scattered back onto the block, and the gathered tensor
        cut by `cut` where that is not None.

        * Every parameter but the MoE variants': gathered whole, summed
          over the DP dimensions.
        * The router under the variants: every "model" rank computes part
          of its gradient, so it is summed over every dimension.
        * A routed or shared expert weight under the variants, where its
          stored "model" split is the variant's (a dimension split over
          "model" alone): gathered over its other dimensions only (the
          reference's FSDP gather over "data"), so each "model" rank holds
          only its part, and summed over the DP dimensions.
        * One stored otherwise: gathered whole, summed over every
          dimension, and cut to the variant's split (GSPMD's reshard)."""
        from ..core.distributed import live

        spec = self.specs[name]
        if name not in self.moe:
            return spec, self.dp, None
        every = tuple(self.mesh.mesh_dim_names)
        split = self.moe[name]
        if split is None:
            return spec, every, None
        own = [live(self.mesh, e) == ("model",) for e in spec]
        if all(o == (live(self.mesh, e) == ("model",)) and
               (o or "model" not in live(self.mesh, s))
               for o, e, s in zip(own, split, spec)):
            return (tuple(None if o else s for o, s in zip(own, spec)),
                    self.dp, None)
        return spec, every, split

    def gather(self, name: str, local):
        """Parameter `name` for compute from this rank's block `local`
        (`plan`; see `core.distributed.gather_param`)."""
        from ..core.distributed import gather_param, live, shard

        hit = self._plans.get(name)
        if hit is None:
            spec, axes, cut = plan = self.plan(name)
            hit = self._plans[name] = (plan, cut is None and not live(
                self.mesh, axes) and not any(live(self.mesh, e)
                                             for e in spec))
        (spec, axes, cut), whole = hit
        if whole:          # no rank to gather from or sum over
            return local
        full = gather_param(self.mesh, local, spec, axes)
        return full if cut is None else shard(self.mesh, full, cut)
