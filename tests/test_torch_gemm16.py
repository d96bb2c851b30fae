"""gemm's 16-bit tensor-core route ("wgmma", csrc/gemm.cu) on the CPU:
the route and plan choices, and the model stack's dense() through the
port's gemm against the reference's through its Pallas gemm.

* Route and plan: aligned bfloat16 and float16 operands take "wgmma",
  float32 ones "tma" or "ldg", misaligned 16-bit ones "ldg"; the plan
  gives every SM of an H100 (132) a block at llama3-8b's decode shapes
  (M = 8), splits no prefill shape, and its shared memory stays inside
  the per-block budget.
* Parity: llama3-8b reduced to 2 layers, the same numpy weights and
  prompts through the reference's jitted prefill and decode_step traced
  inside `use_pallas(True)` (the flag is read at trace time, so the
  functions are built and traced inside the block, and the Pallas matmul
  is counted there: 8 products a trace, the 7 of the layers' scan body
  and the LM head) and
  through the port's inside `use_gemm_kernel()` (on CPU tensors gemm's
  plain version, counted by `plain_calls`). float32: the logits within
  1e-5 of their scale, the two sides summing the same float32 products
  in other orders. bfloat16: relative RMS within 2e-2 and each element
  within 4 units of 2**-8 of the logits' scale: both sides accumulate in
  float32 and round each projection's output to bfloat16 once, but the
  elementwise ops between them (rotary, softmax, SiLU, norms) round to
  bfloat16 at other places in the two frameworks, and a rounding flip
  is one unit of 2**-8 that the next layers carry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import (decode_step as jdecode, init_params as jinit,
                          layers as jlayers, prefill as jprefill)
from repro.serve import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.kernels import common, gemm as t_gemm
from repro_torch.models import (decode_step, layers as tlayers,
                                params_from_numpy, prefill)
from repro_torch.serve import ServeEngine

SMS = 132                                   # an H100 SXM
BUDGET = common.SM90_SMEM_PER_BLOCK
STEPS = 4
# llama3-8b's dense products: (m, k, n) at phase 2c's prefill (B 8 x
# padded S 1781 = 14248 tokens) and at a decode step (M = 8)
PREFILL = [(14248, 4096, 4096), (14248, 4096, 1024), (14248, 4096, 14336),
           (14248, 14336, 4096)]
DECODE = [(8, 4096, 4096), (8, 4096, 1024), (8, 4096, 14336),
          (8, 14336, 4096), (8, 4096, 128256)]


def _operands(dtype, k, n, a_offset=0, b_offset=0):
    a = torch.zeros(4 * k + a_offset, dtype=dtype)[a_offset:].view(4, k)
    b = torch.zeros(k * n + b_offset, dtype=dtype)[b_offset:].view(k, n)
    return a, b


@pytest.mark.parametrize("dtype,k,n,a_offset,b_offset,route", [
    (torch.bfloat16, 4096, 14336, 0, 0, "wgmma"),
    (torch.float16, 4096, 128256, 0, 0, "wgmma"),
    (torch.bfloat16, 1000, 520, 0, 0, "wgmma"),   # k, n multiples of 8
    (torch.float32, 4096, 4096, 0, 0, "tma"),     # never TF32
    (torch.float32, 4095, 4096, 0, 0, "ldg"),
    (torch.bfloat16, 4100, 4096, 0, 0, "ldg"),    # A's rows of 8200 bytes
    (torch.float16, 4096, 4100, 0, 0, "ldg"),     # B's rows of 8200 bytes
    (torch.bfloat16, 4096, 4096, 3, 0, "ldg"),    # A's base 6 bytes off
    (torch.float16, 4096, 4096, 0, 4, "ldg"),     # B's base 8 bytes off
])
def test_wgmma_route_follows_dtype_shape_and_alignment(dtype, k, n, a_offset,
                                                       b_offset, route):
    a, b = _operands(dtype, k, n, a_offset, b_offset)
    assert t_gemm.gemm_route(a, b) == route
    # gemv's and symv's loads ask TMA's conditions only
    assert t_gemm.load_route(a, b) == ("ldg" if route == "ldg" else "tma")


@pytest.mark.parametrize("shape", DECODE, ids=["x".join(map(str, s))
                                               for s in DECODE])
def test_wgmma_plan_fills_the_card_at_decode_shapes(shape):
    m, k, n = shape
    plan = t_gemm.gemm_plan(m, n, k, 2, SMS, route="wgmma")
    assert plan == t_gemm.wgmma_plan(m, n, k, SMS)
    assert plan.bm == 64                       # M = 8: one 64-row tile
    tiles = common.cdiv(m, plan.bm) * common.cdiv(n, plan.bn)
    # every SM gets a block, or K is cut to the shortest split (wk and
    # wv: 8 tiles of 128 columns, 16 splits of 256)
    assert tiles * plan.splits >= SMS or \
        plan.chunk == t_gemm.WG_MIN_K_PER_SPLIT
    if n >= 4096:
        assert tiles * plan.splits >= SMS
    assert plan.chunk % t_gemm.WG_BK == 0
    assert (plan.splits - 1) * plan.chunk < k <= plan.splits * plan.chunk
    assert plan.splits == 1 or plan.chunk >= t_gemm.WG_MIN_K_PER_SPLIT


@pytest.mark.parametrize("shape", PREFILL + [(4096, 4096, 4096)],
                         ids=["x".join(map(str, s))
                              for s in PREFILL + [(4096, 4096, 4096)]])
def test_wgmma_plan_does_not_split_the_prefill(shape):
    m, k, n = shape
    plan = t_gemm.wgmma_plan(m, n, k, SMS)
    assert (plan.bm, plan.splits, plan.chunk) == (128, 1, k)
    assert plan.bn == (128 if n > 64 else 64)


def test_wgmma_plan_takes_tuned_knobs_and_block_cg_splits():
    # block-CG's bfloat16 product: 128 row tiles of 64 columns, K split
    # in two so that all 132 SMs get a block
    plan = t_gemm.wgmma_plan(16384, 32, 16384, SMS)
    assert (plan.bm, plan.bn, plan.splits, plan.chunk) == (128, 64, 2, 8192)
    # the tuner's gemm knobs map onto the route: widths 32 and 64 to 64,
    # 128 to 128; block_k to whole 64-deep stages
    for width, bn in ((32, 64), (64, 64), (128, 128)):
        assert t_gemm.wgmma_plan(16384, 32, 16384, SMS, width=width).bn == bn
    plan = t_gemm.wgmma_plan(16384, 32, 16384, SMS, split_k=1000)
    assert (plan.chunk, plan.splits) == (1024, 16)
    with pytest.raises(ValueError, match="tile width"):
        t_gemm.wgmma_plan(8, 64, 64, SMS, width=96)


def test_wgmma_footprint_stays_inside_the_budget():
    (wg,) = [fp for fp in t_gemm.footprint(2)
             if fp.kernel == "gemm_wgmma_kernel"]
    assert wg.bytes <= BUDGET and wg.bytes < 227 * 1024
    assert wg.bytes == max(t_gemm.wg_smem_bytes(128, w)
                           for w in t_gemm.WG_WIDTHS) + common.STATIC_SLACK
    # two 64-row blocks an SM (the byte-bound decode products), one at 128
    assert 2 * (t_gemm.wg_smem_bytes(64, 128) + 1024) <= 228 * 1024
    assert t_gemm.wg_smem_bytes(128, 128) > 114 * 1024
    # float32 has no wgmma kernel to price
    assert all(fp.kernel != "gemm_wgmma_kernel"
               for fp in t_gemm.footprint(4))


def test_wgmma_launch_takes_the_plan(monkeypatch):
    """A 16-bit tensor taken for the card's reaches `repro_gemm_wgmma`
    with the route's plan, and is counted on "wgmma" (no card: the C
    call is recorded, not made)."""
    from repro_torch.kernels import cuda, ops as tops
    calls = []
    monkeypatch.setattr(common, "on_card", lambda *t: True)
    monkeypatch.setattr(common, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(cuda, "launch", lambda *args: calls.append(args))
    common.reset_counts(tops.gemm)
    m, k, n = 8, 4096, 1024
    a = torch.ones(m, k, dtype=torch.bfloat16)
    b = torch.ones(k, n, dtype=torch.bfloat16)
    tops.gemm(1.0, a, b, 0.0, torch.zeros(m, n, dtype=torch.bfloat16))
    (stem, entry, _, *args), = calls
    plan = t_gemm.wgmma_plan(m, n, k, SMS)
    assert (stem, entry) == ("gemm", "repro_gemm_wgmma")
    assert args[6:] == [m, n, k, plan.bm, plan.bn, plan.chunk, plan.splits]
    assert plan.splits > 1
    assert tops.gemm.route_launches == {r: int(r == "wgmma")
                                        for r in t_gemm.ROUTES}
    assert (tops.gemm.launches, tops.gemm.finish_launches,
            tops.gemm.plain_calls) == (1, 1, 0)


# ---------------------------------------------------------------------------
# dense() through the port's gemm against the reference's Pallas gemm
# ---------------------------------------------------------------------------


def _pair(dtype):
    kw = dict(n_layers=2, segments=(("attn", 2),), dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.get_config("llama3-8b").reduced(),
                               **kw)
    tcfg = dataclasses.replace(tconfigs.get_config("llama3-8b").reduced(),
                               **kw)
    jparams = jinit(jcfg, jax.random.PRNGKey(3))
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, model


def _count_pallas(monkeypatch):
    """Count the reference's Pallas matmul calls (at trace time)."""
    calls = []
    real = jlayers.kops.matmul

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(jlayers.kops, "matmul", counted)
    return calls


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_steps_match_reference_under_gemm(monkeypatch, dtype):
    jcfg, tcfg, jparams, model = _pair(dtype)
    per_pass = 7 * jcfg.n_layers + 1
    b, s, max_len = 2, 12, 12 + STEPS + 1
    prompts = np.random.default_rng(5).integers(
        1, jcfg.vocab_size, (b, s)).astype(np.int32)
    calls = _count_pallas(monkeypatch)
    with jlayers.use_pallas(True):
        jpre = jax.jit(lambda p, x: jprefill(p, jcfg, x, max_len))
        jstep = jax.jit(lambda p, c, t, pos: jdecode(p, jcfg, t, c, pos))
        logits, cache, pos = jpre(jparams, jnp.asarray(prompts))
        want = [_f32(logits)]
        toks = [np.asarray(jnp.argmax(logits, -1)).astype(np.int32)]
        for t in range(STEPS):
            logits, cache = jstep(jparams, cache, jnp.asarray(toks[-1]),
                                  pos + t)
            want.append(_f32(logits))
            toks.append(np.asarray(jnp.argmax(logits, -1)).astype(np.int32))
    # one trace of each pass: the layers are a lax.scan, whose body (7
    # products) is traced once, then the LM head
    assert len(calls) == 2 * 8

    t_gemm.gemm.plain_calls = 0
    got = []
    with tlayers.use_gemm_kernel():
        logits, tcache, tpos = prefill(model, tcfg, torch.from_numpy(prompts),
                                       max_len)
        got.append(logits.float().numpy())
        for t in range(STEPS):    # fed the reference's tokens
            logits, tcache = decode_step(model, tcfg,
                                         torch.from_numpy(toks[t]), tcache,
                                         tpos + t)
            got.append(logits.float().numpy())
    assert t_gemm.gemm.plain_calls == (STEPS + 1) * per_pass
    assert tpos == int(pos)
    for g, w in zip(got, want):
        scale = float(np.abs(w).max())
        err = np.abs(g - w)
        if dtype == "float32":
            assert err.max() <= 1e-5 * scale
        else:
            assert np.sqrt((err ** 2).mean() / (w ** 2).mean()) <= 2e-2
            assert err.max() <= 4 * 2.0 ** -8 * scale


def test_engines_built_under_the_flags_agree():
    """The reference's engine built and run inside `use_pallas(True)`
    and the port's inside `use_gemm_kernel()` give the same greedy
    tokens (float32: the logits agree to 1e-5 of their scale, far inside
    these seeded runs' top-1/top-2 margins)."""
    jcfg, tcfg, jparams, model = _pair("float32")
    prompts = np.random.default_rng(8).integers(
        1, jcfg.vocab_size, (2, 10)).astype(np.int32)
    with jlayers.use_pallas(True):
        want = JEngine(jcfg, jparams, max_len=20, batch_size=2).generate(
            prompts, max_new_tokens=6)
    t_gemm.gemm.plain_calls = 0
    with tlayers.use_gemm_kernel():
        got = ServeEngine(tcfg, model, max_len=20, batch_size=2,
                          device="cpu").generate(prompts, max_new_tokens=6)
    assert got.tokens == want.tokens and got.steps == want.steps == 6
    assert t_gemm.gemm.plain_calls == 6 * (7 * tcfg.n_layers + 1)
