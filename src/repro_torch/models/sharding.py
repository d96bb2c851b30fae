"""Sharding rules, the port of `repro/models/sharding.py`: the parameter,
batch, cache and decode-input specs of a model on a device mesh.

Baseline parallelism, as in the reference:
  - DP over ("pod",) "data" -- the batch dimension of every input;
  - TP over "model" -- the Megatron column/row split of every projection,
    EP over "model" for MoE when n_experts divides it, the decode caches'
    sequence dimension over "model";
  - "pod" carries only the gradient sum (pure DP).
Style "fsdp" shards every parameter over ALL mesh dimensions at once
(ZeRO-3) and the batch over all of them too.

A spec is a tuple with one entry per tensor dimension, the form
`core.distributed.shard`/`gather` take: None (not split), a mesh
dimension's name, or a tuple of names (split over their product, the
first one major). Entries are normalised as `jax.sharding.PartitionSpec`
normalises them: a one-name tuple is the name.

The rules read a mesh only through its dimension names and sizes
(`mesh_dim_names` and `shape`, as `DeviceMesh` has them), so they run for
the 256- and 512-rank production meshes with no process group: pass a
`MeshShape`.

The reference's rules see the parameters stacked per segment, (L, ...).
The port's `Model` keeps one layer per `Block`, so a block parameter's
spec is the rule applied to (count of its segment, *shape) with the
leading entry dropped. In "fsdp" style the largest divisible dimension of
the STACKED shape is sharded; where that is the layer dimension the
reference replaces it with None, and the parameter stays whole: applying
the rule to the per-layer shape would shard it instead.
"""
from __future__ import annotations

from typing import Mapping, Sequence

from ..configs.base import ArchConfig


class MeshShape:
    """A mesh's names and sizes, what the rules read, with no process
    group: `MeshShape({"data": 16, "model": 16})`. It also stands in for
    a mesh in the cost counter's runs on `meta` tensors (`launch.cost`,
    `core.distributed`): the collectives then move nothing, and this rank
    is the first one."""

    stand_in = True

    def __init__(self, shape: Mapping[str, int]):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(int(n) for n in shape.values())

    def get_coordinate(self):
        return [0] * len(self.shape)

    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def __repr__(self):
        return f"MeshShape({dict(zip(self.mesh_dim_names, self.shape))})"


def mesh_sizes(mesh) -> dict:
    """{dimension name: size} of a DeviceMesh or MeshShape."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _entry(e):
    """A spec entry as PartitionSpec keeps it: a one-name tuple is the
    name, an empty one None."""
    if isinstance(e, tuple):
        if not e:
            return None
        return e[0] if len(e) == 1 else e
    return e


def P(*entries) -> tuple:
    return tuple(_entry(e) for e in entries)


# -- helpers ----------------------------------------------------------------


def dp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _model_size(mesh) -> int:
    return mesh_sizes(mesh)["model"]


def _data_size(mesh) -> int:
    return mesh_sizes(mesh)["data"]


def _divides(n: int, m: int) -> bool:
    return m > 0 and n % m == 0


# -- parameter specs --------------------------------------------------------

# name -> rule (cfg, mesh, stacked shape) -> spec of the STACKED parameter


def _col():
    """TP: last dimension over "model"; FSDP: the contraction dimension
    over "data" (stored sharded, gathered for compute: ZeRO-3)."""
    def rule(cfg, mesh, shape):
        spec = [None] * len(shape)
        if _divides(shape[-1], _model_size(mesh)):
            spec[-1] = "model"
        if len(shape) >= 2 and _divides(shape[-2], _data_size(mesh)):
            spec[-2] = "data"
        return P(*spec)
    return rule


def _row():
    """TP: the second-to-last (contraction) dimension over "model"; FSDP:
    the output dimension over "data"."""
    def rule(cfg, mesh, shape):
        spec = [None] * len(shape)
        if _divides(shape[-2], _model_size(mesh)):
            spec[-2] = "model"
        if _divides(shape[-1], _data_size(mesh)):
            spec[-1] = "data"
        return P(*spec)
    return rule


def _replicated(cfg, mesh, shape):
    return P(*([None] * len(shape)))


def _expert(cfg, mesh, shape):
    """(L, E, d_in, d_out): EP on E where "model" divides it (FSDP on
    d_in), else TP on the wider of (d_in, d_out), FSDP on the other."""
    msize, dsize = _model_size(mesh), _data_size(mesh)
    e = shape[1]
    din_data = "data" if _divides(shape[-2], dsize) else None
    if _divides(e, msize):
        return P(None, "model", din_data, None)
    if shape[-1] >= shape[-2] and _divides(shape[-1], msize):
        return P(None, None, din_data, "model")
    if _divides(shape[-2], msize):
        dout_data = "data" if _divides(shape[-1], dsize) else None
        return P(None, None, "model", dout_data)
    return P(None, None, din_data, None)


_PARAM_RULES = {
    # attention
    "wq": _col(), "wk": _col(), "wv": _col(),
    "wo": _row(),
    "wq_a": _col(), "wq_b": _col(),
    "wkv_a": _replicated, "wkv_b": _col(),
    # dense ffn
    "w_gate": _col(), "w_up": _col(), "w_down": _row(),
    # moe
    "router": _replicated,
    "we_gate": _expert, "we_up": _expert, "we_down": _expert,
    "ws_gate": _col(), "ws_up": _col(), "ws_down": _row(),
    # mlstm
    "conv_w": _col(),
    "w_i": _replicated, "w_f": _replicated, "b_f": _replicated,
    # slstm (tiny: replicated)
    "w_z": _replicated, "w_o": _replicated, "r_gates": _replicated,
    # hybrid ssm branch
    "w_ssm_in": _col(), "w_bc": _row(), "w_dt": _row(),
    "a_log": _replicated, "d_skip": _replicated,
    "wo_ssm": _row(), "wo_attn": _row(),
}

_TOP_LEVEL = {
    "embed": lambda cfg, mesh, shape: P(
        "model" if _divides(shape[0], _model_size(mesh)) else None,
        "data" if _divides(shape[1], _data_size(mesh)) else None),
    "lm_head": lambda cfg, mesh, shape: P(
        "data" if _divides(shape[0], _data_size(mesh)) else None,
        "model" if _divides(shape[-1], _model_size(mesh)) else None),
    "wkv_a": lambda cfg, mesh, shape: P(
        None,
        "data" if _divides(shape[-2], _data_size(mesh)) else None,
        None),
}

# the names the ssm family keeps replicated (its heads run on a
# model-sharded width otherwise); w_up and w_down keep their rules
_SSM_WHOLE = ("wq", "wk", "wv", "conv_w", "w_gate", "wo")


def fsdp_axes(mesh) -> tuple:
    """Every mesh dimension, combined: the pure ZeRO-3 domain."""
    return tuple(a for a in ("pod", "data", "model")
                 if a in mesh.mesh_dim_names)


def _fsdp_spec(mesh, shape):
    """Pure FSDP: the largest dimension that every mesh dimension
    together divides, split over all of them; else the largest that
    "data" divides, over "data"; else whole."""
    sizes = mesh_sizes(mesh)
    axes = fsdp_axes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    dims = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in dims:
        if shape[i] % n == 0 and shape[i] >= n:
            spec = [None] * len(shape)
            spec[i] = axes
            return P(*spec)
    d = sizes["data"]
    for i in dims:
        if shape[i] % d == 0 and shape[i] >= d:
            spec = [None] * len(shape)
            spec[i] = "data"
            return P(*spec)
    return P(*([None] * len(shape)))


def _spec_2d(cfg, mesh, name, shape):
    if name in _TOP_LEVEL:
        return _TOP_LEVEL[name](cfg, mesh, shape)
    rule = _PARAM_RULES.get(name)
    if rule is None or (cfg.family == "ssm" and name in _SSM_WHOLE):
        return P(*([None] * len(shape)))
    return rule(cfg, mesh, shape)


def _spec_fsdp(name, mesh, shape):
    spec = _fsdp_spec(mesh, shape)
    if name not in _TOP_LEVEL and spec and spec[0] is not None:
        spec = P(None, *spec[1:])
    return spec


def _stacked(cfg: ArchConfig, shapes: Mapping[str, Sequence[int]]):
    """(parameter name, leaf name, the shape the reference's rule sees,
    whether it is a block parameter) for each of a Model's parameter
    names: a block parameter's shape stacked over its segment's count."""
    counts = [count for _kind, count in cfg.segments for _ in range(count)]
    for full, shape in shapes.items():
        parts = full.split(".")
        if parts[0] == "blocks":
            yield full, parts[-1], (counts[int(parts[1])], *shape), True
        else:
            yield full, parts[-1], tuple(shape), False


def param_specs(cfg: ArchConfig, mesh, model_or_shapes, *,
                style: str = "2d") -> dict:
    """{parameter name: spec} for a `Model`'s parameters (or a mapping
    {name: shape} under the Model's names, `model.param_shapes(cfg)`).
    style: "2d" (FSDP over "data" x TP over "model", the baseline) or
    "fsdp" (pure ZeRO-3 over every dimension; the batch shards over every
    dimension too, see `batch_specs`). A block parameter's spec is its
    segment's stacked spec with the layer entry dropped."""
    if style not in ("2d", "fsdp"):
        raise ValueError(f"unknown parallelism style {style!r}; use '2d' "
                         f"or 'fsdp'")
    if hasattr(model_or_shapes, "named_parameters"):
        shapes = {n: tuple(p.shape)
                  for n, p in model_or_shapes.named_parameters()}
    else:
        shapes = {n: tuple(s) for n, s in model_or_shapes.items()}
    out = {}
    for full, name, shape, block in _stacked(cfg, shapes):
        if style == "fsdp":
            spec = _spec_fsdp(name, mesh, shape)
        else:
            spec = _spec_2d(cfg, mesh, name, shape)
        if block:
            if spec[0] is not None:
                raise ValueError(
                    f"{full}: the stacked spec {spec} shards the layer "
                    f"dimension, which a per-layer block cannot hold")
            spec = spec[1:]
        out[full] = spec
    return out


# -- batch / activation specs -----------------------------------------------


def batch_specs(cfg: ArchConfig, mesh, *, batch_divisible: bool = True,
                style: str = "2d") -> dict:
    """Specs of a train batch {"inputs", "labels"}: the batch over the DP
    dimensions ("2d") or every dimension ("fsdp")."""
    if style == "fsdp":
        dp = fsdp_axes(mesh) if batch_divisible else (None,)
    else:
        dp = dp_axes(mesh) if batch_divisible else (None,)
    tok = P(dp, None) if cfg.input_mode == "tokens" else P(dp, None, None)
    return {"inputs": tok, "labels": P(dp, None)}


def _dp_batch(mesh, batch: int):
    dpa = dp_axes(mesh)
    sizes = mesh_sizes(mesh)
    dp_total = 1
    for a in dpa:
        dp_total *= sizes[a]
    return dpa if batch % dp_total == 0 else None


def cache_specs(cfg: ArchConfig, mesh, cache_shape, *, batch: int):
    """Decode-cache specs, in the cache's layout (one dict per segment of
    (count, B, ...) tensors or shapes, `model.init_cache`): the batch over
    DP where it divides, the attention caches' sequence dimension over
    "model" where it divides, the recurrent states DP only."""
    bdim = _dp_batch(mesh, batch)
    msize = _model_size(mesh)
    out = []
    for seg in cache_shape:
        specs = {}
        for name, leaf in seg.items():
            shape = tuple(getattr(leaf, "shape", leaf))
            if name in ("k", "v", "ckv", "krope"):
                s_ax = "model" if _divides(shape[2], msize) else None
                specs[name] = P(None, bdim, s_ax,
                                *([None] * (len(shape) - 3)))
            else:
                specs[name] = P(None, bdim, *([None] * (len(shape) - 2)))
        out.append(specs)
    return out


def decode_input_specs(cfg: ArchConfig, mesh, *, batch: int) -> tuple:
    bdim = _dp_batch(mesh, batch)
    if cfg.input_mode == "tokens":
        return P(bdim)
    return P(bdim, None)
