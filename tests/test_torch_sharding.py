"""Rule parity of `repro_torch.models.sharding` with `repro.models.sharding`,
with no process group: the rules read only the mesh's names and sizes
(`MeshShape` here, the reference's `_FakeMesh` stand-in there).

* `param_specs` for all 10 architectures x both styles x the 16 x 16 and
  2 x 16 x 16 production meshes: each parameter's spec equals the
  reference's, a block parameter's the reference's stacked spec (from
  `jax.eval_shape` over its stacked params) with the layer entry
  dropped;
* `cache_specs`, `batch_specs` and `decode_input_specs` the same on the
  same meshes (the cache in the reference's layout, which the port's
  keeps);
* the invariants of tests/test_sharding_rules.py on the port's specs:
  real mesh dimensions only, divisible dimensions only, and one entry per
  dimension of the per-layer parameter (so the layer dimension is never
  sharded);
* the fsdp trap: a block parameter's spec is the rule on the STACKED
  shape, which differs from the rule on the per-layer shape.
"""
import dataclasses
import functools

import jax
import pytest

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import sharding as JS
from repro_torch import configs as tconfigs
from repro_torch.models import model as tmodel
from repro_torch.models import sharding as TS

ARCHS = list(tconfigs.ARCH_NAMES)
MESHES = {"pod16x16": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16}}
STYLES = ("2d", "fsdp")
DECODE_BATCH, DECODE_LEN = 128, 32768       # the decode_32k shape


class _FakeMesh:
    """The reference's mesh stand-in: axis names and sizes."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _tuple(spec):
    return tuple(spec)


def _segment_layer(cfg, i):
    """(segment, layer) of block i."""
    for si, (_kind, count) in enumerate(cfg.segments):
        if i < count:
            return si, i
        i -= count
    raise IndexError(i)


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch):
    return jax.eval_shape(lambda: jmodel.init_params(
        jconfigs.get_config(arch), jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _ref_param_specs(arch, mesh_name, style):
    return JS.param_specs(jconfigs.get_config(arch),
                          _FakeMesh(MESHES[mesh_name]),
                          _ref_param_shapes(arch), style=style)


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh_name, style):
    cfg = tconfigs.get_config(arch)
    got = TS.param_specs(cfg, TS.MeshShape(MESHES[mesh_name]),
                         tmodel.param_shapes(cfg), style=style)
    ref = _ref_param_specs(arch, mesh_name, style)
    assert list(got) == list(tmodel.param_shapes(cfg))
    for name, spec in got.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            si, _li = _segment_layer(cfg, int(parts[1]))
            want = _tuple(ref["segments"][si][parts[-1]])
            assert want[0] is None, (name, want)
            want = want[1:]
        else:
            want = _tuple(ref[name])
        assert spec == want, (name, spec, want)


def _size(sizes, entry):
    if entry is None:
        return 1
    n = 1
    for a in (entry,) if isinstance(entry, str) else entry:
        assert a in sizes, f"unknown mesh dimension {a}"
        n *= sizes[a]
    return n


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_are_valid(arch, mesh_name, style):
    """Real dimensions only, divisible dimensions only, one entry per
    dimension of the per-layer tensor (never the layer dimension)."""
    cfg = tconfigs.get_config(arch)
    sizes = MESHES[mesh_name]
    shapes = tmodel.param_shapes(cfg)
    specs = TS.param_specs(cfg, TS.MeshShape(sizes), shapes, style=style)
    for name, shape in shapes.items():
        spec = specs[name]
        assert len(spec) == len(shape), (name, spec, shape)
        for dim, entry in zip(shape, spec):
            assert dim % _size(sizes, entry) == 0, (name, spec, shape)


def test_param_shapes_are_the_models():
    cfg = tconfigs.get_config("deepseek-moe-16b").reduced()
    model = tmodel.Model(cfg, device="meta")
    assert tmodel.param_shapes(cfg) == {
        n: tuple(p.shape) for n, p in model.named_parameters()}


def test_fsdp_rule_runs_on_the_stacked_shape():
    """A small segment whose leaves' largest divisible dimension is the
    layer dimension: the reference replaces that entry with None and the
    leaf stays whole; the rule on the per-layer shape would shard it."""
    cfg = dataclasses.replace(tconfigs.get_config("llama3-8b").reduced(),
                              segments=(("attn", 16),), n_layers=16)
    mesh = TS.MeshShape({"data": 4, "model": 4})
    specs = TS.param_specs(cfg, mesh, tmodel.param_shapes(cfg),
                           style="fsdp")
    # attn_norm (64,): stacked (16, 64), the largest dimension 64 -> split
    assert specs["blocks.0.p.attn_norm"] == (("data", "model"),)
    # a (16, 8) leaf stacked as (16, 16, 8): the layer dimension ties the
    # largest and comes first, so the rule picks it and the reference
    # drops it; the rule on the per-layer shape would split dimension 0
    assert TS._fsdp_spec(mesh, (16, 16, 8)) == (("data", "model"), None,
                                                None)
    assert TS._fsdp_spec(mesh, (16, 8)) == (("data", "model"), None)
    shapes = {"blocks.0.p.w_x": (16, 8)}
    got = TS.param_specs(cfg, mesh, shapes, style="fsdp")
    assert got["blocks.0.p.w_x"] == (None, None)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh_name):
    jcfg = jconfigs.get_config(arch)
    shapes = jax.eval_shape(lambda: jmodel.init_cache(jcfg, DECODE_BATCH,
                                                      DECODE_LEN))
    want = JS.cache_specs(jcfg, _FakeMesh(MESHES[mesh_name]), shapes,
                          batch=DECODE_BATCH)
    layout = [{n: tuple(leaf.shape) for n, leaf in seg.items()}
              for seg in shapes]
    got = TS.cache_specs(tconfigs.get_config(arch),
                         TS.MeshShape(MESHES[mesh_name]), layout,
                         batch=DECODE_BATCH)
    assert [set(s) for s in got] == [set(s) for s in want]
    for g, w in zip(got, want):
        for name in g:
            assert g[name] == _tuple(w[name]), (name, g[name], w[name])


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_decode_input_specs_match_reference(arch, mesh_name,
                                                      style):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    fake, shape = _FakeMesh(MESHES[mesh_name]), TS.MeshShape(
        MESHES[mesh_name])
    for divisible in (True, False):
        want = JS.batch_specs(jcfg, fake, batch_divisible=divisible,
                              style=style)
        got = TS.batch_specs(tcfg, shape, batch_divisible=divisible,
                             style=style)
        assert got == {k: _tuple(v) for k, v in want.items()}
    for batch in (DECODE_BATCH, 3):
        assert TS.decode_input_specs(tcfg, shape, batch=batch) == _tuple(
            JS.decode_input_specs(jcfg, fake, batch=batch))


MOE_ARCHS = [a for a in ARCHS if any(kind == "attn_moe" for kind, _ in
                                     tconfigs.get_config(a).segments)]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_variant_weights_are_gathered_over_data_only(arch, mesh_name):
    """On a "2d" production mesh the MoE layers take the reference's EP or
    TP variant, whose shard_map gathers the expert and shared-expert
    weights over "data" only: each "model" rank keeps its part, stored
    where the variant reads it, and its gradient is summed over the DP
    dimensions. The router's is summed over every dimension."""
    from repro_torch.models import moe as tmoe

    cfg = tconfigs.get_config(arch)
    mesh = TS.MeshShape(MESHES[mesh_name])
    layout = tmodel.make_layout(cfg, mesh, "2d")
    _, split = tmoe.shard_map_variant(cfg.moe.n_experts,
                                      MESHES[mesh_name]["model"])
    dp = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    seen = set()
    for name, spec in layout.specs.items():
        short = name.split(".")[-1]
        if name not in layout.moe:
            assert short not in tmodel.MOE_NAMES or not name.startswith(
                "blocks."), name
            continue
        seen.add(short)
        gathered, axes, cut = layout.plan(name)
        if short == "router":
            assert axes == mesh.mesh_dim_names and cut is None, name
            continue
        assert cut is None and axes == dp, (name, spec)
        assert all(e is None or "model" not in
                   ((e,) if isinstance(e, str) else e) for e in gathered)
        assert [e == "model" for e in spec] == \
            [e == "model" for e in split[short]], (name, spec)
    assert seen >= {"router", "we_gate", "we_up", "we_down"}, seen
