"""Port parity for the SSM, xLSTM and hybrid serve path: xlstm-125m and
hymba-1.5b reduced, in float32, with the reference's weights carried
across by `params_from_numpy`, against `repro.models` and `repro.serve`
on the CPU (the attention kernels' plain versions; the scans of
`models/ssm.py`).

Configs: xlstm-125m reduced (six layers: mLSTM, sLSTM, three times; d
64, mLSTM 2 heads of 64, sLSTM 2 heads of 32), hymba-1.5b reduced (one
hybrid layer: attention 2 heads on 2 of 16 under a window of 16, SSD 2
heads of P 64, N 4) and a two-layer hymba, whose caches stack two
layers. hymba's prompts of 24 tokens take the reference's masked-chunk
attention (window >= S // 2) and wrap the 16-slot ring in prefill, of 40
its banded branch; a prompt of 12 with 6 decode steps wraps the ring
while decoding. xlstm's prompt of 130 passes one 128-row chunk.

Tolerance: |got - want| <= 2e-5 max|want| for logits and every cache
entry (the reference's own prefill-against-forward check allows 2e-3).
The scans match to a few 1e-6 of their scale (tests/test_torch_ssm.py);
six xLSTM layers of gates, exponentials and norms carry that to up to
6.6e-6 of the logits' scale (measured; hymba's one layer 1e-6), three
times under the bound. Greedy tokens: equal.

A prompt shorter than d_conv - 1 = 3 tokens: the reference's prefill
slices a conv cache of fewer than 3 rows, which its decode step cannot
take (it raises on the shapes); the port left-pads the cache with zeros,
as the causal conv does (ROADMAP Queue 3, item 5). Those prompts are
held to the reference's `forward_logits` over the longer sequence.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.serve import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (Model, decode_step, forward_logits,
                                init_cache, init_params, model as tmodel,
                                params_from_numpy, params_to_numpy, prefill)
from repro_torch.serve import ServeEngine

TOL = 2e-5
VARIANTS = {"xlstm-125m": {}, "hymba-1.5b": {},
            "hymba-1.5b-2layers": dict(n_layers=2,
                                       segments=(("hybrid", 2),))}
ARCHS = ["xlstm-125m", "hymba-1.5b"]

# the reference's prefill and decode step, compiled once per config and
# shape (eager, each call would trace its layer scans anew)
_jprefill = jax.jit(jmodel.prefill, static_argnums=(1, 3))
_jdecode = jax.jit(jmodel.decode_step, static_argnums=(1,))
_jforward = jax.jit(jmodel.forward_logits, static_argnums=(1,))


def _cfgs(name, dtype="float32"):
    arch = name.split("-2layers")[0]
    kw = dict(dtype=dtype, **VARIANTS[name])
    return (dataclasses.replace(jconfigs.get_config(arch).reduced(), **kw),
            dataclasses.replace(tconfigs.get_config(arch).reduced(), **kw))


def _models(name, seed=0):
    jcfg, tcfg = _cfgs(name)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tcfg, tree, device="cpu")


def _tokens(cfg, seed, b=2, s=12):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want, rel=TOL):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()) + 1e-30)


def _close_caches(tcache, jcache):
    """Every entry of every segment: the same names, shapes and values."""
    assert len(tcache) == len(jcache)
    for t_seg, j_seg in zip(tcache, jcache):
        assert sorted(t_seg) == sorted(j_seg)
        for name, want in j_seg.items():
            assert tuple(t_seg[name].shape) == want.shape, name
            _close(t_seg[name], want)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_blocks_hold_the_reference_parameters(name):
    _, tcfg, jparams, model = _models(name)
    assert [kind for kind, _ in model.segment_blocks()] == [
        kind for kind, _ in tcfg.segments]
    for (_, blocks), seg in zip(model.segment_blocks(),
                                jparams["segments"]):
        for block in blocks:
            assert sorted(block.p) == sorted(seg)
            for pname, arr in seg.items():
                assert tuple(block.p[pname].shape) == arr.shape[1:], pname


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_params_from_numpy_round_trip(name):
    _, _, jparams, model = _models(name)
    tree = jax.tree.map(np.asarray, jparams)
    back = params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(a.size for a in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_parameters_survive_a_bfloat16_round_trip(arch):
    """In a bfloat16 model the reference's float32 parameters (w_i, w_f,
    b_f, r_gates, w_dt, a_log, d_skip) stay float32 and come back
    bitwise; the rest are bfloat16 in both."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(1))
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    back = params_to_numpy(model)
    seen = set()
    for j_seg, t_seg, blocks in zip(jparams["segments"], back["segments"],
                                    (b for _, b in model.segment_blocks())):
        for pname, arr in j_seg.items():
            want = np.asarray(arr.astype(jnp.float32))
            np.testing.assert_array_equal(t_seg[pname], want)
            f32 = arr.dtype == jnp.float32
            assert f32 == (pname in tmodel.FLOAT32), pname
            assert blocks[0].p[pname].dtype == (
                torch.float32 if f32 else torch.bfloat16), pname
            seen.update([pname] if f32 else [])
    assert seen == ({"w_i", "w_f", "b_f", "r_gates"} if arch == "xlstm-125m"
                    else {"w_dt", "a_log", "d_skip"})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_sets_the_reference_constants(arch, dtype):
    """Norms 1 (norm, gnorm and every *_norm), b_f 3, a_log 0, d_skip 1;
    conv_w drawn at 0.3, r_gates at hd**-0.5, the rest at fan_in**-0.5;
    the float32 names in float32 whatever the model's dtype."""
    cfg = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                              dtype=dtype)
    model = init_params(cfg, 0, device="cpu")
    fills = {"norm": 1.0, "gnorm": 1.0, "b_f": 3.0, "a_log": 0.0,
             "d_skip": 1.0}
    convs = []
    for block in model.blocks:
        for name, t in block.p.items():
            assert t.dtype == (torch.float32 if name in tmodel.FLOAT32
                               else getattr(torch, dtype)), name
            if name in fills or name.endswith("_norm"):
                assert bool((t == fills.get(name, 1.0)).all()), name
            elif name == "conv_w":
                convs.append(t.float().reshape(-1))
            elif name == "r_gates":
                hd = t.shape[-1]
                assert abs(float(t.std()) * hd ** 0.5 - 1) < 0.05, name
            else:
                fan_in = t.shape[-2]
                assert abs(float(t.float().std()) * fan_in ** 0.5 - 1) \
                    < 0.15, name
    assert abs(float(torch.cat(convs).std()) / 0.3 - 1) < 0.1


def test_check_ported_refuses_what_the_model_does_not_know():
    cfg = tconfigs.get_config("xlstm-125m").reduced()
    with pytest.raises(ValueError, match="need cfg.ssm"):
        Model(dataclasses.replace(cfg, ssm=None), device="cpu")
    with pytest.raises(ValueError, match="mamba"):
        init_cache(dataclasses.replace(cfg, segments=(("mamba", 6),)), 1,
                   8, device="cpu")


# ---------------------------------------------------------------------------
# Forward, prefill and decode against the reference
# ---------------------------------------------------------------------------

FORWARD = [("xlstm-125m", 24), ("xlstm-125m", 130), ("hymba-1.5b", 24),
           ("hymba-1.5b", 40), ("hymba-1.5b-2layers", 40)]


@pytest.mark.parametrize("name,s", FORWARD)
def test_forward_logits_match_reference(name, s):
    jcfg, tcfg, jparams, model = _models(name, seed=1)
    toks = _tokens(jcfg, 5, s=s)
    want = _jforward(jparams, jcfg, jnp.asarray(toks))
    _close(forward_logits(model, tcfg, torch.from_numpy(toks)), want)


PREFILL = [("xlstm-125m", 12), ("xlstm-125m", 130), ("hymba-1.5b", 12),
           ("hymba-1.5b", 24), ("hymba-1.5b", 40),
           ("hymba-1.5b-2layers", 12), ("hymba-1.5b-2layers", 40)]


@pytest.mark.parametrize("name,prompt", PREFILL)
def test_prefill_and_decode_match_reference(name, prompt):
    """Prefill, then 6 decode steps fed the reference's greedy tokens:
    the logits of each and every cache entry (the K and V rings, the
    SSD state, mLSTM's C, n, m, sLSTM's h, c, n, m, the conv windows)
    after the prefill and after each step."""
    jcfg, tcfg, jparams, model = _models(name, seed=3)
    toks = _tokens(jcfg, 2, s=prompt)
    max_len = prompt + 10
    jlog, jcache, jpos = _jprefill(jparams, jcfg, jnp.asarray(toks),
                                   max_len)
    tlog, tcache, tpos = prefill(model, tcfg, torch.from_numpy(toks),
                                 max_len)
    assert tpos == int(jpos) == prompt
    _close(tlog, jlog)
    _close_caches(tcache, jcache)
    tok = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)
    for t in range(6):
        jlog, jcache = _jdecode(jparams, jcfg, jnp.asarray(tok), jcache,
                                jpos + t)
        tlog, tcache = decode_step(model, tcfg, torch.from_numpy(tok),
                                   tcache, tpos + t)
        _close(tlog, jlog)
        _close_caches(tcache, jcache)
        tok = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_pure_decode_chain_from_init_cache(arch):
    """init_cache, then 20 decode steps (hymba's 16-slot ring wraps at
    step 16): each step's logits against the reference's own chain and
    its forward logits over the 20 tokens."""
    jcfg, tcfg, jparams, model = _models(arch, seed=4)
    n = 20
    toks = _tokens(jcfg, 6, s=n)
    full = _jforward(jparams, jcfg, jnp.asarray(toks))
    tcache = init_cache(tcfg, 2, n + 2, device="cpu")
    jcache = jmodel.init_cache(jcfg, 2, n + 2)
    _close_caches(tcache, jcache)
    for t in range(n):
        jlog, jcache = _jdecode(jparams, jcfg, jnp.asarray(toks[:, t]),
                                jcache, jnp.int32(t))
        tlog, tcache = decode_step(model, tcfg, torch.from_numpy(toks[:, t]),
                                   tcache, t)
        _close(tlog, jlog)
        _close(tlog, full[:, t])
    _close_caches(tcache, jcache)


@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_prompts_shorter_than_the_conv_window(arch, s):
    """Prompts of 1 and 2 tokens: the conv caches hold the reference's
    rows left-padded with zeros to d_conv - 1 = 3, and prefill then 4
    decode steps give the reference's forward logits over the s + 4
    tokens."""
    jcfg, tcfg, jparams, model = _models(arch, seed=5)
    toks = _tokens(jcfg, 7, s=s + 4)
    full = _jforward(jparams, jcfg, jnp.asarray(toks))
    jlog, jcache, _ = _jprefill(jparams, jcfg, jnp.asarray(toks[:, :s]), 12)
    tlog, tcache, pos = prefill(model, tcfg, torch.from_numpy(toks[:, :s]),
                                12)
    _close(tlog, jlog)
    _close(tlog, full[:, s - 1])
    for t_seg, j_seg in zip(tcache, jcache):
        conv = np.asarray(j_seg["conv"])
        assert conv.shape[2] == s                    # the reference's rows
        assert tuple(t_seg["conv"].shape[2:3]) == (3,)
        assert not bool(t_seg["conv"][:, :, :3 - s].any())
        _close(t_seg["conv"][:, :, 3 - s:], conv)
    for t in range(4):
        tlog, tcache = decode_step(model, tcfg,
                                   torch.from_numpy(toks[:, s + t]), tcache,
                                   pos + t)
        _close(tlog, full[:, s + t])


def test_xlstm_decodes_past_max_len():
    """No segment of xLSTM keeps an attention cache: a step has no
    position limit, and cache_len, when given, is left alone."""
    jcfg, tcfg, jparams, model = _models("xlstm-125m", seed=6)
    toks = _tokens(jcfg, 8, s=12)
    full = _jforward(jparams, jcfg, jnp.asarray(toks))
    _, cache, pos = prefill(model, tcfg, torch.from_numpy(toks[:, :8]), 8)
    lens = torch.full((2,), pos + 1, dtype=torch.int32)
    for t in range(4):
        logits, cache = decode_step(model, tcfg,
                                    torch.from_numpy(toks[:, 8 + t]), cache,
                                    pos + t, cache_len=lens)
        _close(logits, full[:, 8 + t])
    assert lens.tolist() == [9, 9]


def test_hybrid_decode_step_takes_device_lengths():
    """hymba's ring takes the engine's (B,) lengths as danube's does,
    clamped to W once the ring is full: the same logits as from pos."""
    _, tcfg, _, model = _models("hymba-1.5b")
    toks = torch.from_numpy(_tokens(tcfg, 4, s=20))
    logits, cache, pos = prefill(model, tcfg, toks, 30)
    tok = logits.argmax(-1)
    lens = torch.full((2,), pos + 1, dtype=torch.int32)
    copy = [{k: v.clone() for k, v in c.items()} for c in cache]
    a, _ = decode_step(model, tcfg, tok, copy, pos)
    b, _ = decode_step(model, tcfg, tok, cache, pos, cache_len=lens)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_follows_the_reference_layout(arch):
    """Names, shapes and dtypes of the reference's bfloat16 cache: the
    states float32, the conv windows and the rings bfloat16; sLSTM's m
    -1e30."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    tcache = init_cache(tcfg, 3, 20, device="cpu")
    jcache = jmodel.init_cache(jcfg, 3, 20)
    for t_seg, j_seg in zip(tcache, jcache):
        assert list(t_seg) == list(j_seg)
        for name, want in j_seg.items():
            got = t_seg[name]
            assert tuple(got.shape) == want.shape, name
            assert str(got.dtype)[6:] == str(want.dtype), name
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_model_serves_on_the_cpu(arch):
    cfg = tconfigs.get_config(arch).reduced()                # bfloat16
    model = init_params(cfg, 0, device="cpu")
    logits, cache, pos = prefill(model, cfg, torch.from_numpy(
        _tokens(cfg, 1, s=7)), 12)
    logits, cache = decode_step(model, cfg, logits.argmax(-1), cache, pos)
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())
    for seg in cache:
        for name in ("C", "n", "m", "h", "c", "ssm_state"):
            if name in seg:
                assert seg[name].dtype == torch.float32, name


# ---------------------------------------------------------------------------
# The engine and the launcher
# ---------------------------------------------------------------------------


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


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_cli_serves_reduced_on_the_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "3", "--prompt-len", "9",
                       "--new-tokens", "5"])
    out = capsys.readouterr().out
    assert "generated 5 tokens x 3 seqs" in out and "on cpu" in out
    assert out.count("seq") == 4
