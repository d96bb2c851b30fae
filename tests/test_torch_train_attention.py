"""Attention's gradient in the port against the reference's.

The reference trains through its plain-jnp `chunked_attention`, which
JAX differentiates; the port's `mha` goes through `MhaFunction` under
grad (the kernel forward, here its plain version on CPU tensors, and
`mha_backward_plain`). The same seeded numpy q, k, v and output
cotangent go through `jax.vjp` of `repro.models.attention.
chunked_attention` and through the port's backward, in float32: causal,
with no window and with a window in both of the reference's branches
(its banded walk when window < Skv // 2, its masked chunks otherwise),
GQA groups of 1, 2 and 4, S not a multiple of the 512-row query chunk
(600, 1100: ragged chunks), v at q's width and at its own (MLA).

Tolerance: |got - want| <= 1e-5 max|want| for each of dq, dk and dv.
Both sides sum float32 products over at most 1100 keys of width <= 24
in another order (the reference over 1024-key blocks with an online
softmax, the port over a chunk's keys at once); measured ~1e-6.

Also: `gradcheck` of `MhaFunction` in float64 (the plain versions
compute in float64 for float64 operands), the model's two refusals (a
grad path never gets an `mha` output cut off from q, k and v; `dense`
under grad refuses the gemm kernel, which has no backward), and remat's
second forward (two `mha` calls per layer under `train_loss`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch import configs as tconfigs
from repro_torch.kernels import attention as t_attn
from repro_torch.models import init_params, layers as tlayers, train_loss
from repro_torch.train import make_train_state
from repro_torch.optim import AdamW

from _torch_train import one_torch_thread  # noqa: F401 (autouse)

REL = 1e-5


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# (Sq, Skv, Hq, Hkv, d, dv, window): the reference's branch in the name
CASES = {
    "causal-600-g1": (600, 600, 2, 2, 16, 16, None),
    "causal-1100-g4": (1100, 1100, 8, 2, 16, 16, None),
    "banded-1100-w64-g2": (1100, 1100, 4, 2, 16, 16, 64),
    "banded-600-w100-g4-mla": (600, 600, 4, 1, 24, 8, 100),
    "masked-600-w400-g2": (600, 600, 4, 2, 16, 16, 400),
    "masked-1100-w700-g1-mla": (1100, 1100, 2, 2, 24, 16, 700),
    "masked-300q-600k-w250-g4": (300, 600, 8, 2, 16, 16, 250),
    "causal-1100-g2-mla": (1100, 1100, 4, 2, 24, 16, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_attention_grads_match_jax(case):
    sq, skv, hq, hkv, d, dv, window = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k = _normal(rng, 1, hq, sq, d), _normal(rng, 1, hkv, skv, d)
    v, ct = _normal(rng, 1, hkv, skv, dv), _normal(rng, 1, hq, sq, dv)
    banded = window is not None and sq == skv and window < skv // 2
    assert banded == case.startswith("banded")
    want_out, vjp = jax.vjp(lambda a, b_, c: jattn.chunked_attention(
        a, b_, c, causal=True, window=window), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(ct))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = t_attn.mha(tq, tk, tv, causal=True, window=window)
    assert out.grad_fn is not None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=0, atol=REL * float(
                                   np.abs(np.asarray(want_out)).max()))
    out.backward(torch.from_numpy(ct))
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        w = np.asarray(w)
        assert got.shape == w.shape, name
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=REL * float(np.abs(w).max()),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("sq,skv,hq,hkv,d,dv,causal,window", [
    (5, 5, 2, 2, 4, 4, True, None),
    (6, 6, 4, 2, 4, 3, True, 2),
    (4, 7, 3, 1, 5, 5, False, 3),
    (7, 4, 2, 1, 3, 3, True, None),      # three rows see no key
    (9, 9, 2, 2, 4, 4, True, 1),
])
def test_mha_function_gradcheck_float64(sq, skv, hq, hkv, d, dv, causal,
                                        window):
    gen = torch.Generator().manual_seed(sq * 31 + skv)
    q, k, v = (torch.randn(*shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)
               for shape in ((2, hq, sq, d), (2, hkv, skv, d),
                             (2, hkv, skv, dv)))
    assert torch.autograd.gradcheck(
        lambda a, b_, c: t_attn.MhaFunction.apply(a, b_, c, causal, window),
        (q, k, v))


@pytest.mark.parametrize("window", [None, 3, 700])
def test_backward_plain_matches_autograd_of_reference(window):
    """The hand-written gradient against autograd through the
    out-of-place float32 reference (the yardstick of the card tests), at
    S 1100: three query chunks, each with its own range of keys in
    reach."""
    gen = torch.Generator().manual_seed(7)
    q = torch.randn(1, 4, 1100, 8, generator=gen, requires_grad=True)
    k = torch.randn(1, 2, 1100, 8, generator=gen, requires_grad=True)
    v = torch.randn(1, 2, 1100, 6, generator=gen, requires_grad=True)
    ct = torch.randn(1, 4, 1100, 6, generator=gen)
    ref = t_attn.attention_reference(q, k, v, causal=True, window=window)
    want = torch.autograd.grad(ref, (q, k, v), ct)
    out = t_attn.mha_plain(q.detach(), k.detach(), v.detach(),
                           window=window)
    torch.testing.assert_close(out, ref.detach(), rtol=0, atol=1e-6)
    got = t_attn.mha_backward_plain(q.detach(), k.detach(), v.detach(), out,
                                    ct, causal=True, window=window)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


def test_mha_on_a_grad_path_is_never_detached():
    q, k, v = (torch.randn(1, 2, 8, 4, requires_grad=r)
               for r in (True, False, False))
    before = t_attn.mha.plain_calls
    out = t_attn.mha(q, k, v)
    assert out.requires_grad and type(out.grad_fn).__name__ == \
        "MhaFunctionBackward"
    assert t_attn.mha.plain_calls == before + 1
    out.sum().backward()
    assert q.grad is not None and bool(q.grad.abs().sum() > 0)
    with torch.no_grad():
        assert t_attn.mha(q, k, v).grad_fn is None
    plain = t_attn.mha(q.detach(), k, v)
    assert plain.grad_fn is None and torch.equal(plain, out.detach())


def test_dense_refuses_the_gemm_kernel_under_grad():
    x = torch.randn(3, 8)
    w = torch.randn(8, 5, requires_grad=True)
    with tlayers.use_gemm_kernel():
        with pytest.raises(RuntimeError, match="no backward"):
            tlayers.dense(x, w)
        with torch.no_grad():
            got = tlayers.dense(x, w)
    torch.testing.assert_close(got, x @ w.detach(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("remat,want", [(True, 2), (False, 1)])
def test_train_loss_runs_mha_twice_a_layer_under_remat(remat, want):
    cfg = dataclasses.replace(tconfigs.get_config("llama3-8b").reduced(),
                              dtype="float32", n_layers=2,
                              segments=(("attn", 2),))
    model = init_params(cfg, 0, device="cpu")
    make_train_state(cfg, model, AdamW())
    batch = {"inputs": torch.randint(0, cfg.vocab_size, (2, 12)),
             "labels": torch.randint(0, cfg.vocab_size, (2, 12))}
    before = t_attn.mha.plain_calls
    loss = train_loss(model, cfg, batch, remat=remat)
    loss.backward()
    assert t_attn.mha.plain_calls - before == want * cfg.n_layers
    assert all(p.grad is not None for p in model.parameters())
