"""Port parity for MLA (multi-head latent attention) on the serve path:
the same seeded numpy inputs and weights go through the reference's JAX
functions (`repro.models.attention`, `repro.models.model`,
`repro.serve`) and through repro_torch on the CPU, where `mha` runs its
plain version.

* attention with a value width of its own: `mha_plain` and
  `chunked_attention` at dv != d against the reference's
  `chunked_attention` (causal and not, a window, GQA 1:1 and 4:1,
  Sq < Skv), and the wgmma route that d and dv pick (`mha_route`, on
  CPU tensors: shapes, dtypes and addresses only);
* `decode_attention_mla`, the absorbed decode in the latent space, at
  the first slot, mid-cache and the last slot;
* minicpm3-4b reduced (one layer, 2 heads, q_lora 32, kv_lora 16,
  qk_nope 8, qk_rope 8, v_head 8; and a two-layer variant):
  `forward_logits`, `prefill` and 6 `decode_step`s with the latent
  caches' shapes and values, the parameter round trip, `ServeEngine`'s
  greedy tokens against the reference engine's, and the launcher.

Tolerances: float32 attention as in tests/test_torch_attention.py,
|got - want| <= 1e-5 + 1e-5 |want| (softmaxes over at most 70 keys in
another summation order); bfloat16 caches in the latent decode,
2**-8 max|ckv| + 1e-5: both sides round the same float32 query parts
and probabilities to bfloat16, and a float32 unit of difference before
a rounding can move a probability by one bfloat16 unit, which moves the
context by at most 2**-8 of that probability times max|ckv|.
The model: |got - want| <= 1e-5 max|want|, as tests/test_torch_model.py
holds the GQA models (measured about 1e-6 here). Greedy tokens: equal
(argmax over logits that agree to about 1e-6 of their scale).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn, model as jmodel
from repro.serve import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.kernels import attention as t_attn, common, ops as tops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (Model, attention as tattn, decode_step,
                                forward_logits, init_cache, init_params,
                                params_from_numpy, params_to_numpy, prefill)
from repro_torch.serve import ServeEngine

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(arrays, dtype="float32"):
    """The same values for both packages: jax arrays and CPU tensors."""
    jx = [jnp.asarray(a, dtype=_JNP[dtype]) for a in arrays]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        _TORCH[dtype]) for a in jx]
    return jx, tx


def _close_attn(got, want, rel=1e-5):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel, atol=1e-5)


def _close(got, want, rel=1e-5):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# Attention with a value width of its own
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["mha_plain", "chunked_attention"])
@pytest.mark.parametrize("d,dv", [(24, 16), (12, 20)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 8), (False, 8)])
@pytest.mark.parametrize("sq,skv", [(24, 24), (40, 40), (16, 40)])
def test_value_width_of_its_own_matches_reference(fn, d, dv, hq, hkv,
                                                  causal, window, sq, skv):
    """(40, 40) causal with window 8 takes the reference's banded branch,
    the rest its masked chunks; Sq < Skv aligns the queries at the end.
    `chunked_attention` goes through the `mha` wrapper."""
    rng = np.random.default_rng(d * 100 + dv + hq + sq + skv)
    (jq, jk, jv), (tq, tk, tv) = _both([
        _normal(rng, 2, hq, sq, d), _normal(rng, 2, hkv, skv, d),
        _normal(rng, 2, hkv, skv, dv)])
    want = jattn.chunked_attention(jq, jk, jv, causal=causal, window=window,
                                   block_q=16, block_k=32)
    if fn == "mha_plain":
        got = t_attn.mha_plain(tq, tk, tv, causal=causal, window=window)
    else:
        common.reset_counts(tops.mha)
        got = tattn.chunked_attention(tq, tk, tv, causal=causal,
                                      window=window)
        assert tops.mha.plain_calls == 1 and tops.mha.launches == 0
    assert tuple(got.shape) == (2, hq, sq, dv)
    _close_attn(got, want)


def test_value_width_is_checked():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="dv"):
        tops.mha(q, q[:, :2], q[:, :2, :7])            # v's rows
    with pytest.raises(ValueError, match="dv <= 256"):
        tops.mha(q, q, torch.zeros(1, 4, 8, 260))


def _route_operands(d, dv, dtype=torch.bfloat16, v_width=None):
    """q (2, 4, 9, d) and k (2, 2, 9, d) as the transpose(1, 2) views the
    model passes; v (2, 2, 9, dv) as the value columns of a (2, 9, 2,
    v_width) up-projection (default 64 + dv), from column 64 on."""
    def view(h, w, cols):
        t = torch.zeros(2, 9, h, w, dtype=dtype).transpose(1, 2)
        return t[..., cols]
    return (view(4, d, slice(0, d)), view(2, d, slice(0, d)),
            view(2, v_width or 64 + dv, slice(64, 64 + dv)))


@pytest.mark.parametrize("kw,route", [
    (dict(d=96, dv=64), "wgmma"),        # MiniCPM3: (128, 64) padded
    (dict(d=120, dv=120), "wgmma"),      # H2O-Danube3: (128, 128)
    (dict(d=128, dv=64), "wgmma"),
    (dict(d=40, dv=24), "wgmma"),        # (64, 64)
    (dict(d=96, dv=64, dtype=torch.float16), "wgmma"),
    (dict(d=136, dv=64), "ffma"),        # d past 128
    (dict(d=100, dv=64), "ffma"),        # q and k rows of 200 bytes
    (dict(d=128, dv=136), "ffma"),       # dv past 128
    (dict(d=64, dv=128), "ffma"),        # v wider than q's 64-column box
    (dict(d=96, dv=63, v_width=136), "ffma"),   # odd dv: the epilogue's
    (dict(d=96, dv=62, v_width=136), "wgmma"),  # column pairs
    (dict(d=96, dv=64, dtype=torch.float32), "ffma"),
])
def test_mha_route_takes_the_value_width(kw, route):
    assert t_attn.mha_route(*_route_operands(**kw)) == route


# ---------------------------------------------------------------------------
# The absorbed decode in the latent space
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 17, 39])
def test_decode_attention_mla_matches_reference(dtype, pos):
    """Cache of 40 slots (R 16, Dr 8, 4 heads); the slots past pos hold
    values that must weigh nothing. q_lat stays float32, as the model
    passes it; q_rope and the caches are in `dtype`."""
    rng = np.random.default_rng(71 + pos)
    q_lat = _normal(rng, 2, 4, 16)
    (jr, jc, jk), (tr, tc, tk) = _both([
        _normal(rng, 2, 4, 8), _normal(rng, 2, 40, 16),
        _normal(rng, 2, 40, 8)], dtype)
    scale = 24 ** -0.5
    want = jattn.decode_attention_mla(jnp.asarray(q_lat), jr, jc, jk,
                                      jnp.int32(pos), scale=scale)
    got = tattn.decode_attention_mla(torch.from_numpy(q_lat), tr, tc, tk,
                                     pos, scale=scale)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 4, 16)
    # a probability rounded to bfloat16 one unit apart moves the output
    # by at most 2**-8 of it times max|ckv|
    tol = 1e-5 + (2.0 ** -8 * float(tc.float().abs().max())
                  if dtype == "bfloat16" else 1e-5 * np.abs(want))
    assert bool(np.all(np.abs(got.numpy() - np.asarray(want)) <= tol))


# ---------------------------------------------------------------------------
# minicpm3-4b reduced against the reference
# ---------------------------------------------------------------------------

VARIANTS = {"minicpm3-4b": {},
            "minicpm3-4b-2layers": dict(n_layers=2,
                                        segments=(("attn", 2),))}


def _models(name, seed=0):
    kw = dict(dtype="float32", **VARIANTS[name])
    jcfg = dataclasses.replace(jconfigs.get_config("minicpm3-4b").reduced(),
                               **kw)
    tcfg = dataclasses.replace(tconfigs.get_config("minicpm3-4b").reduced(),
                               **kw)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tcfg, tree, device="cpu")


def _tokens(cfg, seed, b=2, s=12):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_mla_block_holds_the_reference_parameters():
    _, tcfg, jparams, model = _models("minicpm3-4b")
    m = tcfg.mla
    assert sorted(model.blocks[0].p) == sorted(jparams["segments"][0])
    assert tuple(model.blocks[0].p["wkv_b"].shape) == (
        m.kv_lora_rank, tcfg.n_heads * (m.qk_nope_dim + m.v_head_dim))
    assert tuple(model.blocks[0].p["wo"].shape) == (
        tcfg.n_heads * m.v_head_dim, tcfg.d_model)
    assert model.lm_head is None and model.embed is not None   # tied


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_params_from_numpy_round_trip(name):
    _, _, jparams, model = _models(name)
    tree = jax.tree.map(np.asarray, jparams)
    back = params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("s", [12, 33])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_logits_match_reference(name, s):
    jcfg, tcfg, jparams, model = _models(name, seed=1)
    toks = _tokens(jcfg, 5, s=s)
    want = jmodel.forward_logits(jparams, jcfg, jnp.asarray(toks))
    _close(forward_logits(model, tcfg, torch.from_numpy(toks)), want)


@pytest.mark.parametrize("prompt", [12, 21])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_prefill_and_decode_match_reference(name, prompt):
    """Prefill, then 6 decode steps fed the reference's greedy tokens:
    the logits of each, and the latent caches (count, B, max_len, R) and
    (count, B, max_len, Dr), written at positions [0, S) by the prefill
    and at pos by each step, zeros past it."""
    jcfg, tcfg, jparams, model = _models(name, seed=3)
    toks = _tokens(jcfg, 2, s=prompt)
    max_len = prompt + 10
    jlog, jcache, jpos = jmodel.prefill(jparams, jcfg, jnp.asarray(toks),
                                        max_len)
    tlog, tcache, tpos = prefill(model, tcfg, torch.from_numpy(toks),
                                 max_len)
    assert tpos == int(jpos) == prompt
    _close(tlog, jlog)
    m, count = tcfg.mla, tcfg.n_layers
    for key, width in (("ckv", m.kv_lora_rank), ("krope", m.qk_rope_dim)):
        assert tuple(tcache[0][key].shape) == jcache[0][key].shape == (
            count, 2, max_len, width)
        _close(tcache[0][key], jcache[0][key])
    tok = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)
    for t in range(6):
        jlog, jcache = jmodel.decode_step(jparams, jcfg, jnp.asarray(tok),
                                          jcache, jpos + t)
        tlog, tcache = decode_step(model, tcfg, torch.from_numpy(tok),
                                   tcache, tpos + t)
        _close(tlog, jlog)
        tok = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)
    for key in ("ckv", "krope"):
        _close(tcache[0][key], jcache[0][key])
        assert not bool(tcache[0][key][:, :, prompt + 6:].any())


def test_decode_step_refuses_a_position_past_the_latent_cache():
    _, tcfg, _, model = _models("minicpm3-4b")
    toks = torch.from_numpy(_tokens(tcfg, 4, s=9))
    logits, cache, pos = prefill(model, tcfg, toks, 10)
    tok = logits.argmax(-1)
    decode_step(model, tcfg, tok, cache, pos)
    with pytest.raises(ValueError, match="past the cache of 10"):
        decode_step(model, tcfg, tok, cache, pos + 1)


def test_init_cache_is_the_latent_cache():
    cfg = tconfigs.get_config("minicpm3-4b").reduced()
    cache = init_cache(cfg, 3, 20, device="cpu")
    m = cfg.mla
    assert sorted(cache[0]) == ["ckv", "krope"]
    assert tuple(cache[0]["ckv"].shape) == (1, 3, 20, m.kv_lora_rank)
    assert tuple(cache[0]["krope"].shape) == (1, 3, 20, m.qk_rope_dim)
    assert cache[0]["ckv"].dtype == torch.bfloat16
    Model(cfg, device="cpu")        # no refusal: MLA is ported


@pytest.mark.parametrize("prompt,new", [(12, 10), (30, 6)])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_greedy_tokens_equal_reference_engine(name, prompt, new):
    jcfg, tcfg, jparams, model = _models(name, seed=4)
    prompts = _tokens(jcfg, 11, s=prompt)
    max_len = prompt + new
    want = JEngine(jcfg, jparams, max_len=max_len, batch_size=2).generate(
        prompts, max_new_tokens=new)
    got = ServeEngine(tcfg, model, max_len=max_len, batch_size=2,
                      device="cpu").generate(prompts, max_new_tokens=new)
    assert got.tokens == want.tokens
    assert got.steps == want.steps == new


def test_launch_cli_serves_minicpm_reduced_on_the_cpu(capsys):
    launch_serve.main(["--arch", "minicpm3-4b", "--reduced", "--device",
                       "cpu", "--batch", "3", "--prompt-len", "9",
                       "--new-tokens", "5"])
    out = capsys.readouterr().out
    assert "generated 5 tokens x 3 seqs" in out and "on cpu" in out


def test_init_params_builds_an_mla_model_in_bfloat16():
    cfg = tconfigs.get_config("minicpm3-4b").reduced()       # bfloat16
    model = init_params(cfg, 0, device="cpu")
    for name, t in model.blocks[0].p.items():
        assert t.dtype == torch.bfloat16, name
        if name.endswith("_norm"):
            assert bool((t == 1).all()), name
    logits, cache, pos = prefill(model, cfg, torch.from_numpy(
        _tokens(cfg, 1, s=7)), 12)
    logits, cache = decode_step(model, cfg, logits.argmax(-1), cache, pos)
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())
