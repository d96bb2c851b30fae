"""Port parity for embedding inputs on the serve path: musicgen-medium
(EnCodec frame embeddings, MHA, GELU) and llava-next-34b (anyres patch
embeddings and text, GQA 7:1), both reduced, whose frontends are stubs
in the reference too. The same seeded numpy weights and (B, S, d)
embeddings go through the reference's JAX model and through repro_torch
on the CPU (the attention kernels' plain versions).

As in the reference, such a model has no `embed` table and always an
`lm_head`; `prefill` takes (B, S, d) and `decode_step` (B, d). The
serving engine feeds token ids back, so it refuses these configs, as
the reference's launcher and the port's do.

Tolerance: |got - want| <= 1e-5 max|want|, as tests/test_torch_model.py
holds the token models (the same sums in another order; measured about
1e-6 here).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.models import (Model, decode_step, forward_logits,
                                init_params, params_from_numpy,
                                params_to_numpy, prefill)
from repro_torch.serve import ServeEngine

ARCHS = ["musicgen-medium", "llava-next-34b"]
VARIANTS = {"": {}, "-2layers": dict(n_layers=2, segments=(("attn", 2),)),
            "-tied": dict(tie_embeddings=True)}


def _models(arch, variant="", seed=0):
    kw = dict(dtype="float32", **VARIANTS[variant])
    jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(), **kw)
    tcfg = dataclasses.replace(tconfigs.get_config(arch).reduced(), **kw)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tcfg, tree, device="cpu")


def _embeddings(cfg, seed, *lead):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((*lead, cfg.d_model)).astype(np.float32)


def _close(got, want, rel=1e-5):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_the_tree_has_no_embed_and_an_lm_head(arch, variant):
    """Tied or not, an embedding model has no table to tie to: the
    reference gives it an lm_head, and so does the port."""
    _, tcfg, jparams, model = _models(arch, variant)
    assert "embed" not in jparams and "lm_head" in jparams
    assert model.embed is None and model.lm_head is not None
    assert model.device.type == "cpu"
    tree = jax.tree.map(np.asarray, jparams)
    back = params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(a.size for a in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_a_tree_with_an_embed_is_refused(arch):
    _, tcfg, jparams, _ = _models(arch)
    tree = jax.tree.map(np.asarray, jparams)
    bad = dict(tree, embed=np.zeros((tcfg.vocab_size, tcfg.d_model),
                                    np.float32))
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(tcfg, bad, device="cpu")
    with pytest.raises(ValueError, match="lm_head"):
        params_from_numpy(tcfg, {k: v for k, v in tree.items()
                                 if k != "lm_head"}, device="cpu")


@pytest.mark.parametrize("s", [12, 33])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_on_embeddings_match_reference(arch, variant, s):
    jcfg, tcfg, jparams, model = _models(arch, variant, seed=1)
    x = _embeddings(tcfg, 5, 2, s)
    want = jmodel.forward_logits(jparams, jcfg, jnp.asarray(x))
    _close(forward_logits(model, tcfg, torch.from_numpy(x)), want)


@pytest.mark.parametrize("prompt", [12, 21])
@pytest.mark.parametrize("variant", ["", "-2layers"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_on_embeddings_match_reference(arch, variant,
                                                          prompt):
    """prefill on (B, S, d), then 6 decode steps each fed a seeded (B, d)
    embedding: the logits of each and the K and V caches, written in
    place."""
    jcfg, tcfg, jparams, model = _models(arch, variant, seed=3)
    x = _embeddings(tcfg, 2, 2, prompt)
    max_len = prompt + 8
    jlog, jcache, jpos = jmodel.prefill(jparams, jcfg, jnp.asarray(x),
                                        max_len)
    tlog, tcache, tpos = prefill(model, tcfg, torch.from_numpy(x), max_len)
    assert tpos == int(jpos) == prompt
    _close(tlog, jlog)
    steps = _embeddings(tcfg, 9, 6, 2)
    lens = torch.full((2,), tpos + 1, dtype=torch.int32)
    for t in range(6):
        jlog, jcache = jmodel.decode_step(jparams, jcfg,
                                          jnp.asarray(steps[t]), jcache,
                                          jpos + t)
        tlog, tcache = decode_step(model, tcfg, torch.from_numpy(steps[t]),
                                   tcache, tpos + t, cache_len=lens)
        lens.add_(1)
        _close(tlog, jlog)
    for key in ("k", "v"):
        assert tuple(tcache[0][key].shape) == jcache[0][key].shape
        _close(tcache[0][key], jcache[0][key])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_refuses_embedding_archs(arch):
    _, tcfg, _, model = _models(arch)
    with pytest.raises(ValueError, match="embeddings inputs"):
        ServeEngine(tcfg, model, max_len=16, batch_size=2, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_builds_the_model_in_bfloat16(arch):
    cfg = tconfigs.get_config(arch).reduced()       # bfloat16
    model = init_params(cfg, 0, device="cpu")
    assert model.embed is None
    assert model.lm_head.dtype == torch.bfloat16
    x = torch.from_numpy(_embeddings(cfg, 1, 2, 7)).to(torch.bfloat16)
    logits, cache, pos = prefill(model, cfg, x, 12)
    assert tuple(logits.shape) == (2, cfg.vocab_size) and pos == 7
    logits, cache = decode_step(model, cfg, x[:, -1], cache, pos)
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())
    Model(cfg, device="cpu")        # no refusal: embeddings are ported
