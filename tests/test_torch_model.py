"""Port parity for the LM stack of the serve path: configs, layers, the
decoder model and the parameter conversion. The same numpy weights and
token ids go through the reference's JAX model (its jnp attention, the
twin of its Pallas kernels) and through repro_torch on the CPU (the
attention kernels' plain versions).

The sliding-window and MoE configs (mixtral-8x22b, deepseek-moe-16b,
h2o-danube-3-4b) run reduced: window 16, 4 experts top-2, one shared
expert for deepseek and its dense first layer. Their prompts of 24
tokens take the reference's masked-chunk branch (window >= S // 2), of
40 its banded branch; a prompt of 12 with 10 decode steps wraps the
16-slot ring while decoding, a prompt of 40 wraps it in prefill.

Tolerance: float32, |got - want| <= 1e-5 max|want| (layers: 1e-6 of
their operands' scale). The two packages sum the same products in
another order (XLA's dot against torch's CPU BLAS, sums of at most
d_ff = 128 terms) and take RoPE's cos and sin from two libraries; each
costs about one float32 unit (6e-8) per operation, and two layers carry
that to about 1e-6 of the logits' scale (measured), ten times under the
bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers, model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.kernels import gemm as t_gemm
from repro_torch.models import (Model, decode_step, forward_logits,
                                init_cache, init_params, layers as tlayers,
                                params_from_numpy, params_to_numpy, prefill)

VARIANTS = {
    "llama3-8b": {},
    "starcoder2-3b": {},
    "llama3-8b-gqa4": dict(n_heads=8, n_kv_heads=2),
    "llama3-8b-tied": dict(tie_embeddings=True),
    "mixtral-8x22b": dict(segments=(("attn_moe", 2),)),
    "deepseek-moe-16b": dict(segments=(("attn", 1), ("attn_moe", 1))),
    "h2o-danube-3-4b": {},
}
SWA_MOE = ["mixtral-8x22b", "deepseek-moe-16b", "h2o-danube-3-4b"]


def _cfgs(name):
    """The same two-layer float32 config from both packages."""
    arch = name.split("-gqa")[0].split("-tied")[0]
    kw = dict(n_layers=2, segments=(("attn", 2),), dtype="float32")
    kw.update(VARIANTS[name])
    return (dataclasses.replace(jconfigs.get_config(arch).reduced(), **kw),
            dataclasses.replace(tconfigs.get_config(arch).reduced(), **kw))


def _models(name, seed=0):
    jcfg, tcfg = _cfgs(name)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tcfg, tree, device="cpu")


def _close(got, want, rel=1e-5):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# Configs: the port's own copy, equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_configs_equal_reference(arch):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(
        jc.reduced())
    assert (tc.head_dim, tc.n_params(), tc.n_active_params()) == (
        jc.head_dim, jc.n_params(), jc.n_active_params())
    assert ([dataclasses.asdict(s) for s in tconfigs.shape_cells(tc)]
            == [dataclasses.asdict(s) for s in jconfigs.shape_cells(jc)])


def test_config_registry_equal_reference():
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-2")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_rmsnorm():
    x, s = _arrays(1, (3, 7, 64), (64,))
    _close(tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(s)),
           jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(s)), 1e-6)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope_is_interleaved(theta):
    (x,) = _arrays(2, (2, 3, 40, 16))
    pos = np.arange(40, dtype=np.int32) + 1000
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(got, want, 1e-6)
    # pairs (2i, 2i+1) rotate together: a pair's norm is kept
    pairs = got.reshape(2, 3, 40, 8, 2).norm(dim=-1)
    _close(pairs, np.linalg.norm(x.reshape(2, 3, 40, 8, 2), axis=-1), 1e-6)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_act_and_glu_ffn(act):
    x, wg, wu, wd = _arrays(3, (2, 5, 64), (64, 128), (64, 128), (128, 64))
    # jax.nn.gelu's default is the tanh approximation
    _close(tlayers._act(torch.from_numpy(x), act),
           jlayers._act(jnp.asarray(x), act), 1e-6)
    jp = {"w_gate": wg, "w_up": wu, "w_down": wd}
    tp = {k: torch.from_numpy(v) for k, v in jp.items()}
    _close(tlayers.glu_ffn(tp, torch.from_numpy(x), act),
           jlayers.glu_ffn({k: jnp.asarray(v) for k, v in jp.items()},
                           jnp.asarray(x), act), 1e-5)


def test_embed_lookup_and_dense():
    table, x, w = _arrays(4, (50, 16), (3, 4, 16), (16, 24))
    ids = np.array([[0, 7, 49], [3, 3, 1]], np.int32)
    _close(tlayers.embed_lookup(torch.from_numpy(table),
                                torch.from_numpy(ids)),
           jlayers.embed_lookup(jnp.asarray(table), jnp.asarray(ids)), 0)
    want = jlayers.dense(jnp.asarray(x), jnp.asarray(w))
    _close(tlayers.dense(torch.from_numpy(x), torch.from_numpy(w)), want)


def test_use_gemm_kernel_routes_dense_through_gemm():
    x, w = _arrays(5, (3, 4, 16), (16, 24))
    t_gemm.gemm.plain_calls = 0
    assert not tlayers.use_gemm_kernel_now()
    with tlayers.use_gemm_kernel():
        assert tlayers.use_gemm_kernel_now()
        got = tlayers.dense(torch.from_numpy(x), torch.from_numpy(w))
    assert not tlayers.use_gemm_kernel_now()
    assert t_gemm.gemm.plain_calls == 1       # CPU tensors: gemm's plain
    with jlayers.use_pallas():
        want = jlayers.dense(jnp.asarray(x), jnp.asarray(w))
    _close(got, want)


def test_init_dense_scale():
    gen = torch.Generator().manual_seed(0)
    w = tlayers.init_dense(gen, (256, 512), dtype=torch.bfloat16)
    assert w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    e = tlayers.init_dense(gen, (1000, 64), scale=0.02)
    assert abs(float(e.std()) - 0.02) < 0.001


# ---------------------------------------------------------------------------
# Parameters: init and conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["llama3-8b", "llama3-8b-tied", *SWA_MOE])
def test_params_from_numpy_round_trip(name):
    jcfg, tcfg, jparams, model = _models(name)
    tree = jax.tree.map(np.asarray, jparams)
    back = params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert (model.lm_head is None) == jcfg.tie_embeddings
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(a.size for a in jax.tree.leaves(tree))


def test_params_from_numpy_rejects_a_wrong_tree():
    jcfg, tcfg, jparams, _ = _models("llama3-8b")
    tree = jax.tree.map(np.asarray, jparams)
    bad = dict(tree, lm_head=tree["lm_head"][:, :10])
    with pytest.raises(ValueError, match="lm_head"):
        params_from_numpy(tcfg, bad, device="cpu")
    with pytest.raises(ValueError, match="lm_head"):
        params_from_numpy(dataclasses.replace(tcfg, tie_embeddings=True),
                          tree, device="cpu")
    seg = dict(tree["segments"][0])
    seg.pop("wq")
    with pytest.raises(ValueError, match="wq"):
        params_from_numpy(tcfg, dict(tree, segments=[seg]), device="cpu")


def test_init_params_is_seeded():
    _, tcfg = _cfgs("llama3-8b")
    a, b = (init_params(tcfg, 7, device="cpu") for _ in range(2))
    c = init_params(tcfg, 8, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                b.parameters()))
    assert not torch.equal(a.blocks[0].p["wq"], c.blocks[0].p["wq"])
    assert torch.equal(a.blocks[1].p["attn_norm"],
                       torch.ones(tcfg.d_model))
    assert a.embed.dtype == torch.float32 and a.device.type == "cpu"


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-moe-16b"])
def test_moe_blocks_keep_the_router_in_float32(arch):
    cfg = tconfigs.get_config(arch).reduced()       # bfloat16
    model = init_params(cfg, 0, device="cpu")
    for kind, blocks in model.segment_blocks():
        for block in blocks:
            assert ("router" in block.p) == (kind == "attn_moe")
            for name, t in block.p.items():
                want = torch.float32 if name == "router" else torch.bfloat16
                assert t.dtype == want, name
    mo = cfg.moe
    moe_block = model.blocks[-1].p
    assert tuple(moe_block["we_down"].shape) == (mo.n_experts, mo.d_expert,
                                                 cfg.d_model)
    assert ("ws_gate" in moe_block) == bool(mo.n_shared_experts)
    # the reference's scales: d**-0.5 into the experts, d_expert**-0.5 out
    for name, fan_in in (("we_gate", cfg.d_model), ("we_up", cfg.d_model),
                         ("we_down", mo.d_expert)):
        std = float(moe_block[name].float().std())
        assert abs(std - fan_in ** -0.5) < 0.1 * fan_in ** -0.5, name


def test_entry_points_need_a_card_or_the_cpu(monkeypatch):
    _, tcfg = _cfgs("llama3-8b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(tcfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(tcfg, 2, 16)


# ---------------------------------------------------------------------------
# The model against the reference's
# ---------------------------------------------------------------------------


def _tokens(cfg, seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_logits_match_reference(name):
    jcfg, tcfg, jparams, model = _models(name)
    toks = _tokens(jcfg, 1)
    want = jmodel.forward_logits(jparams, jcfg, jnp.asarray(toks))
    _close(forward_logits(model, tcfg, torch.from_numpy(toks)), want)


@pytest.mark.parametrize("s", [24, 40])
@pytest.mark.parametrize("name", SWA_MOE)
def test_swa_and_moe_forward_logits_in_both_branches(name, s):
    jcfg, tcfg, jparams, model = _models(name, seed=5)
    if jcfg.window:      # S 24: the masked chunks; S 40: the band
        assert (jcfg.window < s // 2) == (s == 40)
    toks = _tokens(jcfg, 6, s=s)
    want = jmodel.forward_logits(jparams, jcfg, jnp.asarray(toks))
    _close(forward_logits(model, tcfg, torch.from_numpy(toks)), want)


@pytest.mark.parametrize("prompt,steps", [(12, 10), (40, 6), (32, 4)])
@pytest.mark.parametrize("name", SWA_MOE)
def test_ring_cache_prefill_and_decode_match_reference(name, prompt, steps):
    """Prompt 12 and 10 steps wraps the ring while decoding; prompt 40
    wraps it in prefill; prompt 32, twice the window of 16, ends the
    prefill on a whole turn of the ring. The device lengths (clamped to
    W under a window) give the same logits as the host position."""
    jcfg, tcfg, jparams, model = _models(name, seed=7)
    toks = _tokens(jcfg, 8, s=prompt)
    max_len = prompt + steps + 1
    jlog, jcache, jpos = jmodel.prefill(jparams, jcfg, jnp.asarray(toks),
                                        max_len)
    tlog, tcache, tpos = prefill(model, tcfg, torch.from_numpy(toks),
                                 max_len)
    _close(tlog, jlog)
    w = jmodel._swa_cache_len(jcfg, max_len)
    for seg in range(len(jcfg.segments)):
        for key in ("k", "v"):
            assert tuple(tcache[seg][key].shape) == jcache[seg][key].shape
            assert tcache[seg][key].shape[2] == w
            _close(tcache[seg][key], jcache[seg][key])
    tok = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)
    lens = torch.full((2,), tpos + 1, dtype=torch.int32)
    for t in range(steps):
        jlog, jcache = jmodel.decode_step(jparams, jcfg, jnp.asarray(tok),
                                          jcache, jpos + t)
        tlog, tcache = decode_step(model, tcfg, torch.from_numpy(tok),
                                   tcache, tpos + t, cache_len=lens)
        lens.add_(1)
        _close(tlog, jlog)
        tok = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)
    assert int(lens[0]) == prompt + steps + 1      # never clamped in place
    for seg in range(len(jcfg.segments)):
        for key in ("k", "v"):
            _close(tcache[seg][key], jcache[seg][key])


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_prefill_and_decode_match_reference(name):
    jcfg, tcfg, jparams, model = _models(name, seed=3)
    toks = _tokens(jcfg, 2, s=21)
    max_len = 32
    jlog, jcache, jpos = jmodel.prefill(jparams, jcfg, jnp.asarray(toks),
                                        max_len)
    tlog, tcache, tpos = prefill(model, tcfg, torch.from_numpy(toks),
                                 max_len)
    assert tpos == int(jpos) == 21
    _close(tlog, jlog)
    for key in ("k", "v"):
        assert tuple(tcache[0][key].shape) == jcache[0][key].shape
        _close(tcache[0][key], jcache[0][key])
    tok = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)
    for t in range(6):
        jlog, jcache = jmodel.decode_step(jparams, jcfg, jnp.asarray(tok),
                                          jcache, jpos + t)
        tlog, tcache = decode_step(model, tcfg, torch.from_numpy(tok),
                                   tcache, tpos + t)
        _close(tlog, jlog)
        tok = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)
    for key in ("k", "v"):            # written in place at each position
        _close(tcache[0][key], jcache[0][key])


def test_decode_step_takes_device_lengths():
    jcfg, tcfg, jparams, model = _models("llama3-8b")
    toks = torch.from_numpy(_tokens(jcfg, 4, s=9))
    logits, cache, pos = prefill(model, tcfg, toks, 16)
    tok = logits.argmax(-1)
    lens = torch.full((2,), pos + 1, dtype=torch.int32)
    copy = [{k: v.clone() for k, v in c.items()} for c in cache]
    a, _ = decode_step(model, tcfg, tok, copy, pos)
    b, _ = decode_step(model, tcfg, tok, cache, pos, cache_len=lens)
    assert torch.equal(a, b)


def test_decode_step_refuses_a_position_past_a_full_cache():
    """Without a window the cache is a ring of max_len slots that never
    wraps: a position at or past max_len raises, where a window would
    take slot pos % W."""
    _, tcfg, _, model = _models("llama3-8b")
    toks = torch.from_numpy(_tokens(tcfg, 4, s=9))
    logits, cache, pos = prefill(model, tcfg, toks, 10)
    tok = logits.argmax(-1)
    decode_step(model, tcfg, tok, cache, pos)
    with pytest.raises(ValueError, match="past the cache of 10"):
        decode_step(model, tcfg, tok, cache, pos + 1)


@pytest.mark.parametrize("arch,item", [
    ("minicpm3-4b", "item 14.3"), ("xlstm-125m", "item 14.4"),
    ("hymba-1.5b", "item 14.4"), ("musicgen-medium", "item 14.5"),
    ("llava-next-34b", "item 14.5"),
])
def test_unported_families_raise_with_their_roadmap_item(arch, item):
    cfg = tconfigs.get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1, {item}"):
        Model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        init_cache(cfg, 1, 8, device="cpu")
