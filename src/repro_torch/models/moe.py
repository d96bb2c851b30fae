"""Mixture-of-Experts FFN, the port of `repro/models/moe.py`: top-k
routing with renormalised gates, sort-based capacity dispatch into an
(E, C, d) buffer, three grouped products and a gated combine, and
optional DeepSeek-style shared experts.

The reference computes all of it in plain jnp, outside any Pallas
kernel, so here it is torch ops: the grouped products are `torch.bmm`
(float32 accumulation, the output in x's dtype, as the reference's
einsums with `preferred_element_type=float32` then cast). Every step of
the dispatch is the reference's, so the same (token, expert) pairs are
kept and dropped:

* ties in the router's probabilities go to the lower expert index, as
  `jax.lax.top_k` breaks them (a stable descending sort; `torch.topk`
  promises no order among equal values);
* tokens are placed by a stable argsort of the flat expert ids, each
  expert's capacity C = max(k, T k cf / E) filled in token order, and
  the overflow goes to a trash row;
* the combine adds each token's k gated contributions in x's dtype one
  after another in ascending expert order, the order in which the
  reference's scatter-add `y.at[st_].add(contrib)` meets them in its
  expert-sorted list. No atomics: the sum is the same from run to run.

The reference's shard_map variants run over a device mesh here
(`core.distributed`'s calling convention: every rank is passed the
global weights and tokens and takes its blocks): `moe_ffn_tp_shard_map`
splits each expert's hidden size over "model" (tensor parallel) and
`moe_ffn_ep_shard_map` gives each "model" rank E / model experts whole
(expert parallel). Both gather the expert weights' "data" blocks back
(FSDP), route and dispatch their own tokens locally as above, and finish
with ONE fixed-order sum over "model" on token-shaped data.
"""
from __future__ import annotations

from typing import Mapping

import torch

from ..core.distributed import gather, psum, shard
from .layers import _act, dense, glu_ffn


def route_topk(logits, k: int):
    """Softmax-then-top-k routing with renormalised gates.

    logits: (T, E) -> gates (T, k) float32, experts (T, k) int64, the
    experts in descending probability and, among equal ones, ascending
    index."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :k], experts[:, :k]
    return gates / gates.sum(dim=-1, keepdim=True), experts


def capacity(t: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Tokens an expert takes from a shard of t tokens (Python floats, as
    the reference computes it)."""
    return int(max(top_k, t * top_k * capacity_factor / n_experts))


def dispatch(experts, n_experts: int, cap: int):
    """Sort-based capacity dispatch of the (T, k) expert ids.

    Returns (order, slot, keep), each of T k entries in expert-sorted
    order: `order` the flat (token, rank) index (token = index // k) of
    each entry (a stable argsort: equal experts keep token order),
    `slot` its row of the (E cap) buffer or the trash row E cap, `keep`
    whether it is within its expert's capacity. Nothing is read back to
    the host."""
    flat_e = experts.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    # a bincount without a read-back (torch.bincount on the card waits
    # for the largest id); integer sums, so the order does not matter
    counts = torch.zeros(n_experts, dtype=flat_e.dtype,
                         device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(flat_e.numel(), device=flat_e.device) - starts[se]
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos,
                       torch.full_like(pos, n_experts * cap))
    return order, slot, keep


def _shared(params: Mapping[str, torch.Tensor]):
    return {"w_gate": params["ws_gate"], "w_up": params["ws_up"],
            "w_down": params["ws_down"]}


def _moe_local(params, x, *, n_experts: int, top_k: int,
               capacity_factor: float, act: str, first_expert: int = 0):
    """Dispatch and expert FFN over one token shard. x: (T, d). The
    we_* weights may hold a run of the experts, from `first_expert` on
    (an expert-parallel rank's): only the pairs routed to those are
    dispatched, with every expert's capacity as before."""
    t, d = x.shape
    e = n_experts
    logits = dense(x, params["router"])
    gates, experts = route_topk(logits, top_k)             # (T, k)
    cap = capacity(t, top_k, e, capacity_factor)

    order, slot, keep = dispatch(experts, e, cap)
    sg = gates.reshape(-1)[order]
    st_ = order // top_k                                   # each one's token
    # the kept pairs of the experts held here, in rows from 0
    e_loc = params["we_gate"].shape[0]
    lo = first_expert * cap
    keep = keep & (slot >= lo) & (slot < lo + e_loc * cap)
    slot = torch.where(keep, slot - lo, e_loc * cap)

    buf = torch.zeros((e_loc * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = x[st_] * keep[:, None].to(x.dtype)
    buf = buf[:e_loc * cap].reshape(e_loc, cap, d)

    g = torch.bmm(buf, params["we_gate"].to(x.dtype))
    u = torch.bmm(buf, params["we_up"].to(x.dtype))
    out_buf = torch.bmm(_act(g, act) * u, params["we_down"].to(x.dtype))

    out_flat = out_buf.reshape(e_loc * cap, d)
    contrib = (out_flat[slot.clamp(0, e_loc * cap - 1)]
               * (sg * keep)[:, None].to(x.dtype))
    # each token's k contributions in ascending expert order (a stable
    # sort by token of the expert-sorted list), summed in x's dtype in
    # that order
    by_token = torch.argsort(st_, stable=True)
    per_token = contrib[by_token].reshape(t, top_k, d)
    y = per_token[:, 0]
    for j in range(1, top_k):
        y = y + per_token[:, j]

    if "ws_gate" in params:
        y = y + glu_ffn(_shared(params), x, act=act)
    return y


def moe_ffn(params, x, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, act: str = "silu",
            groups: int = 1):
    """x: (T, d) -> (T, d) through top-k routed experts.

    params: router (d, E); we_gate/we_up (E, d, de); we_down (E, de, d);
    optional ws_gate/ws_up/ws_down shared-expert weights. groups > 1:
    each of `groups` equal token shards is dispatched on its own (its
    own capacity), as the reference's vmap over them."""
    t, d = x.shape
    kw = dict(n_experts=n_experts, top_k=top_k,
              capacity_factor=capacity_factor, act=act)
    if groups > 1 and t % groups == 0 and t // groups >= top_k:
        return torch.cat([_moe_local(params, xg, **kw)
                          for xg in x.reshape(groups, t // groups, d)])
    return _moe_local(params, x, **kw)


def moe_ffn_reference(params, x, *, n_experts: int, top_k: int,
                      act: str = "silu"):
    """Dense oracle: every expert on every token, gate-weighted (no
    capacity drops). For tests against moe_ffn at a large cf."""
    logits = dense(x, params["router"])
    gates, experts = route_topk(logits, top_k)
    y = torch.zeros_like(x)
    for ei in range(n_experts):
        g = dense(x, params["we_gate"][ei])
        u = dense(x, params["we_up"][ei])
        o = dense(_act(g, act) * u, params["we_down"][ei])
        w = torch.where(experts == ei, gates, 0.0).sum(dim=-1)[:, None]
        y = y + o * w.to(x.dtype)
    if "ws_gate" in params:
        y = y + glu_ffn(_shared(params), x, act=act)
    return y


# ---------------------------------------------------------------------------
# The sharded variants over a device mesh. Tensor-parallel experts (too
# few experts for EP, e.g. Mixtral's 8 on a 16-way model dimension): the
# experts' hidden size is split over "model", each rank computes PARTIAL
# expert outputs, combines them into its own tokens, and one sum over
# "model" finishes. Expert-parallel (E % model == 0, e.g. DeepSeekMoE's
# 64): each rank owns E / model experts whole and dispatches only their
# tokens. Either way no (E, C, d) buffer crosses ranks.
# ---------------------------------------------------------------------------

# the weights' specs, as stored: the routed experts' by variant, and the
# shared experts' (their hidden size over "model" in both)
_TP_SPECS = {"we_gate": (None, "data", "model"),
             "we_up": (None, "data", "model"),
             "we_down": (None, "model", "data")}
_EP_SPECS = {"we_gate": ("model", "data", None),
             "we_up": ("model", "data", None),
             "we_down": ("model", "data", None)}
_SHARED_SPECS = {"ws_gate": ("data", "model"), "ws_up": ("data", "model"),
                 "ws_down": ("model", "data")}


def _sharded_moe(params, x, specs, mesh, *, first_expert: int, **kw):
    """x: (B, S, d) -> this rank's (B / dp, S, d) block of the output
    (spec (dp, None, None)): its tokens through its blocks of the expert
    weights, their "data" blocks gathered back (FSDP), and one
    fixed-order sum over "model"."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    x_loc = shard(mesh, x, (dp, None, None))
    local = {"router": params["router"]}
    for name, spec in {**specs, **_SHARED_SPECS}.items():
        if name in params:
            fsdp = tuple(a if a == "data" else None for a in spec)
            local[name] = gather(mesh, shard(mesh, params[name], spec), fsdp)
    b, s, d = x_loc.shape
    y = _moe_local(local, x_loc.reshape(b * s, d),
                   first_expert=first_expert, **kw)
    return psum(mesh, y, "model").reshape(b, s, d)


def moe_ffn_tp_shard_map(params, x, *, n_experts: int, top_k: int,
                         capacity_factor: float, act: str, mesh):
    """x: (B, S, d) -> this rank's (B / dp, S, d) block of the output,
    the experts' hidden size split over "model" (tensor parallel)."""
    return _sharded_moe(params, x, _TP_SPECS, mesh, first_expert=0,
                        n_experts=n_experts, top_k=top_k,
                        capacity_factor=capacity_factor, act=act)


def moe_ffn_ep_shard_map(params, x, *, n_experts: int, top_k: int,
                         capacity_factor: float, act: str, mesh):
    """x: (B, S, d) -> this rank's (B / dp, S, d) block of the output,
    each "model" rank owning E / model experts (expert parallel); the
    routing is computed on every rank, the capacity is every expert's."""
    msize = mesh.shape[mesh.mesh_dim_names.index("model")]
    if n_experts % msize:
        raise ValueError(f"expert parallelism needs n_experts ({n_experts}) "
                         f"divisible by the model dimension ({msize})")
    rank = mesh.get_coordinate()[mesh.mesh_dim_names.index("model")]
    return _sharded_moe(params, x, _EP_SPECS, mesh,
                        first_expert=rank * (n_experts // msize),
                        n_experts=n_experts, top_k=top_k,
                        capacity_factor=capacity_factor, act=act)
