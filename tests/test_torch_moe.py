"""Port parity for the MoE FFN (`repro_torch.models.moe` against
`repro.models.moe`): the same seeded numpy weights and tokens go through
both packages on the CPU.

Tolerances:
* routing: the chosen experts are equal, ties included (both break them
  toward the lower expert index); the gates, float32 softmaxes of the
  same logits renormalised over k, within 1e-6.
* moe_ffn, float32: |got - want| <= 1e-5 max|want|. Both sides run the
  same dispatch and sum each token's k contributions in the same order
  (ascending expert, in x's dtype); they differ only in the order in
  which the products sum d <= 32 and d_expert <= 16 terms (XLA's dot
  against torch's CPU BLAS), a few float32 units of the output's scale.
  A (token, expert) pair kept on one side and dropped on the other
  would move that token's output by a whole gated expert output, far
  above the bound; the kept pairs are also compared exactly.
* against the dense oracle (no drops): 2e-4, as tests/test_moe.py holds
  the reference to its oracle (the oracle sums the experts in another
  order and rounds each one's gate product separately).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe


def _params(seed, d, e, de, shared=False):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((d, e)) * d ** -0.5,
         "we_gate": rng.standard_normal((e, d, de)) * d ** -0.5,
         "we_up": rng.standard_normal((e, d, de)) * d ** -0.5,
         "we_down": rng.standard_normal((e, de, d)) * de ** -0.5}
    if shared:
        p["ws_gate"] = rng.standard_normal((d, de)) * d ** -0.5
        p["ws_up"] = rng.standard_normal((d, de)) * d ** -0.5
        p["ws_down"] = rng.standard_normal((de, d)) * de ** -0.5
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _tokens(seed, t, d):
    x = np.random.default_rng(seed).standard_normal((t, d)).astype(
        np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want, rel):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _kept_pairs(experts, n_experts, cap):
    """The reference's capacity rule on its own routing, step by step
    (repro/models/moe.py `_moe_local`): a stable sort of the flat expert
    ids, each expert's first `cap` entries kept. -> {(token, expert)}."""
    flat = np.asarray(experts).reshape(-1)
    k = np.asarray(experts).shape[1]
    order = np.argsort(flat, kind="stable")
    seen = np.zeros(n_experts, np.int64)
    kept = set()
    for i in order:
        e = int(flat[i])
        if seen[e] < cap:
            kept.add((int(i) // k, e))
        seen[e] += 1
    return kept


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def _tie_logits(kind, t, e):
    rng = np.random.default_rng(7)
    if kind == "zeros":
        return np.zeros((t, e), np.float32)
    if kind == "repeated":    # a few distinct values: ties everywhere
        return rng.integers(-2, 3, (t, e)).astype(np.float32)
    # bfloat16 logits of a narrow spread: ties of the rounded values
    return np.asarray(jnp.asarray(rng.standard_normal((t, e)) * 0.05,
                                  jnp.bfloat16))


@pytest.mark.parametrize("kind", ["zeros", "repeated", "bfloat16"])
@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (8, 6), (64, 6)])
def test_route_topk_breaks_ties_as_jax_top_k(kind, e, k):
    logits = _tie_logits(kind, 96, e)
    jg, je = jmoe.route_topk(jnp.asarray(logits), k)
    if kind == "bfloat16":
        tl = torch.from_numpy(logits.astype(np.float32)).to(torch.bfloat16)
    else:
        tl = torch.from_numpy(logits)
    tg, te = tmoe.route_topk(tl, k)
    assert tg.dtype == torch.float32 and tuple(te.shape) == (96, k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6)
    if kind == "zeros":       # every expert ties: the first k win
        assert (te.numpy() == np.arange(k)).all()


def test_route_topk_normalized():
    logits = np.random.default_rng(4).standard_normal((32, 8)).astype(
        np.float32)
    gates, experts = tmoe.route_topk(torch.from_numpy(logits), 2)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert int(experts.max()) < 8
    assert (gates[:, 0] >= gates[:, 1]).all()


# ---------------------------------------------------------------------------
# moe_ffn against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (8, 6)])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_ffn_matches_reference(e, k, shared, cf):
    d, de, t = 32, 16, 64
    jp, tp = _params(e + k, d, e, de, shared)
    jx, tx = _tokens(1, t, d)
    want = jmoe.moe_ffn(jp, jx, n_experts=e, top_k=k, capacity_factor=cf,
                        act="silu")
    got = tmoe.moe_ffn(tp, tx, n_experts=e, top_k=k, capacity_factor=cf,
                       act="silu")
    _close(got, want, 1e-5)


@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (8, 6)])
@pytest.mark.parametrize("cf", [0.5, 1.0])
def test_capacity_keeps_the_references_pairs(e, k, cf):
    """Low capacity factors drop tokens: the kept (token, expert) pairs
    are the reference's, exactly."""
    d, de, t = 16, 8, 128
    jp, tp = _params(3 * e + k, d, e, de)
    jx, tx = _tokens(2, t, d)
    cap = tmoe.capacity(t, k, e, cf)
    assert cap == int(max(k, t * k * cf / e))
    _, jexp = jmoe.route_topk(jmoe.dense(jx, jp["router"]), k)
    _, texp = tmoe.route_topk(tmoe.dense(tx, tp["router"]), k)
    np.testing.assert_array_equal(texp.numpy(), np.asarray(jexp))
    order, slot, keep = tmoe.dispatch(texp, e, cap)
    got = {(int(i) // k, int(texp.reshape(-1)[i]))
           for i in order[keep].tolist()}
    want = _kept_pairs(jexp, e, cap)
    assert got == want
    assert len(want) < t * k            # something was dropped
    assert sorted(slot[keep].tolist()) == sorted(set(slot[keep].tolist()))
    assert (slot[~keep] == e * cap).all()
    _close(tmoe.moe_ffn(tp, tx, n_experts=e, top_k=k, capacity_factor=cf),
           jmoe.moe_ffn(jp, jx, n_experts=e, top_k=k, capacity_factor=cf),
           1e-5)


@pytest.mark.parametrize("e,k", [(4, 2), (8, 6)])
def test_capacity_with_tied_routing(e, k):
    """All-equal router logits: every token picks experts 0..k-1, and the
    first tokens in token order fill each one's capacity."""
    d, de, t = 16, 8, 32
    jp, tp = _params(11, d, e, de)
    jp["router"] = jnp.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    jx, tx = _tokens(5, t, d)
    want = jmoe.moe_ffn(jp, jx, n_experts=e, top_k=k, capacity_factor=1.0)
    got = tmoe.moe_ffn(tp, tx, n_experts=e, top_k=k, capacity_factor=1.0)
    _close(got, want, 1e-5)
    cap = tmoe.capacity(t, k, e, 1.0)
    _, texp = tmoe.route_topk(torch.zeros(t, e), k)
    order, _, keep = tmoe.dispatch(texp, e, cap)
    kept_tokens = sorted({int(i) // k for i in order[keep].tolist()})
    assert kept_tokens == list(range(cap))
    assert (got[cap:].abs().max() == 0).item()   # dropped on every expert


@pytest.mark.parametrize("groups", [2, 4])
def test_groups_dispatch_each_shard_on_its_own(groups):
    d, de, e, k, t = 16, 8, 8, 2, 64
    jp, tp = _params(9, d, e, de, shared=True)
    jx, tx = _tokens(6, t, d)
    want = jmoe.moe_ffn(jp, jx, n_experts=e, top_k=k, capacity_factor=1.0,
                        groups=groups)
    got = tmoe.moe_ffn(tp, tx, n_experts=e, top_k=k, capacity_factor=1.0,
                       groups=groups)
    _close(got, want, 1e-5)
    one = tmoe.moe_ffn(tp, tx, n_experts=e, top_k=k, capacity_factor=1.0)
    assert not torch.equal(got, one)     # shard capacities differ


@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (8, 6)])
@pytest.mark.parametrize("shared", [False, True])
def test_moe_matches_dense_oracle_no_drops(e, k, shared):
    d, de, t = 32, 16, 64
    jp, tp = _params(20 + e + k, d, e, de, shared)
    jx, tx = _tokens(1, t, d)
    got = tmoe.moe_ffn(tp, tx, n_experts=e, top_k=k,
                       capacity_factor=float(e), act="silu")
    oracle = tmoe.moe_ffn_reference(tp, tx, n_experts=e, top_k=k,
                                    act="silu")
    _close(got, oracle.numpy(), 2e-4)
    _close(oracle, jmoe.moe_ffn_reference(jp, jx, n_experts=e, top_k=k,
                                          act="silu"), 1e-5)


def test_combine_repeats_bitwise():
    d, de, e, k, t = 32, 16, 8, 6, 256
    _, tp = _params(13, d, e, de, shared=True)
    tp = {n: v.to(torch.bfloat16) if n != "router" else v
          for n, v in tp.items()}
    _, tx = _tokens(8, t, d)
    tx = tx.to(torch.bfloat16)
    a = tmoe.moe_ffn(tp, tx, n_experts=e, top_k=k, capacity_factor=1.25)
    b = tmoe.moe_ffn(tp, tx, n_experts=e, top_k=k, capacity_factor=1.25)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_moe_ffn_gelu_matches_reference():
    d, de, e, k, t = 16, 8, 4, 2, 32
    jp, tp = _params(17, d, e, de, shared=True)
    jx, tx = _tokens(9, t, d)
    _close(tmoe.moe_ffn(tp, tx, n_experts=e, top_k=k, act="gelu"),
           jmoe.moe_ffn(jp, jx, n_experts=e, top_k=k, act="gelu"), 1e-5)
