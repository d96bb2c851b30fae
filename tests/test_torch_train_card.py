"""Attention's gradient on the card: `mha` under grad (`MhaFunction`: the
CUDA kernel forward, `mha_backward_plain` backward) against autograd
through the out-of-place float32 reference
(`kernels/attention.attention_reference`) on the same inputs. This file
imports torch and numpy only, so that it runs on a card host:

    python -m pytest -q -m cuda tests/test_torch_train_card.py

Every test skips on a host without a card. The CPU parity with the
reference's `jax.grad` is tests/test_torch_train_attention.py.

Edges: S 1, 511, 513 and 4097 (around the backward's 512-row query
chunks and the kernel's 128-row tiles), GQA groups 1, 4 and 8, windows
1, 64 and none, d != dv (MLA's 96 and 64), bfloat16 and float16 (the
wgmma route) and float32 (the FFMA route), q strided as the model's
transposes leave it, and bitwise repeats of the backward.

Bound, on each of dq, dk, dv: relative RMS |got - want| / |want| <= 1e-2
in 16-bit (the output the backward reads and the gradients it returns
are rounded to the operands' dtype, 2**-8 relative each, against a
reference that keeps float32 throughout), 1e-4 in float32 (the kernel's
online softmax against one softmax a row, float32 sums in another
order; TF32 off). For dq and dk the denominator is the larger of |want|
and the norm of the same product without the softmax's subtraction of
delta (dS = P dP in place of P (dP - delta)): where a row sees one key
(S 1, window 1) P is 1 and dq and dk are exactly 0, so their error,
the rounding of the output inside delta, is measured against the size
of the terms that cancel.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import attention as t_attn

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
BOUND = {"float32": 1e-4, "bfloat16": 1e-2, "float16": 1e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _inputs(dev, dtype, s, hq, hkv, d, dv, seed):
    rng = np.random.default_rng(seed)
    q, k, v, ct = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev, _TORCH[dtype])
        for shape in ((1, hq, s, d), (1, hkv, s, d), (1, hkv, s, dv),
                      (1, hq, s, dv)))
    return q, k, v, ct


def _grads_on_card(q, k, v, ct, window):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    before = t_attn.mha.launches
    out = t_attn.mha(q, k, v, causal=True, window=window)
    assert t_attn.mha.launches == before + 1
    assert out.grad_fn is not None and out.dtype == q.dtype
    out.backward(ct)
    return out.detach(), (q.grad, k.grad, v.grad)


def _grads_reference(q, k, v, ct, window):
    q, k, v = (t.detach().float().requires_grad_() for t in (q, k, v))
    out = t_attn.attention_reference(q, k, v, causal=True, window=window)
    out.backward(ct.float())
    return out.detach(), (q.grad, k.grad, v.grad)


def _uncancelled_norms(q, k, v, ct, window):
    """|dq| and |dk| with dS = P dP (delta not subtracted), float32."""
    qf, kf, vf, cf = (t.float() for t in (q, k, v, ct))
    b, hq, s, d = qf.shape
    hkv = kf.shape[1]
    qg = qf.reshape(b, hkv, hq // hkv, s, d)
    i = torch.arange(s, device=q.device)
    mask = i[:, None] >= i[None]
    if window is not None:
        mask &= (i[:, None] - i[None]) < window
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * d ** -0.5
    p = torch.softmax(scores.masked_fill(~mask, -torch.inf), dim=-1)
    ds = p * torch.einsum("bhgqd,bhkd->bhgqk",
                          cf.reshape(b, hkv, hq // hkv, s, -1), vf)
    return (float(torch.einsum("bhgqk,bhkd->bhgqd", ds, kf).norm())
            * d ** -0.5,
            float(torch.einsum("bhgqk,bhgqd->bhkd", ds, qg).norm())
            * d ** -0.5)


def _check(q, k, v, ct, window, dtype):
    out, got = _grads_on_card(q, k, v, ct, window)
    want_out, want = _grads_reference(q, k, v, ct, window)
    floors = (*_uncancelled_norms(q, k, v, ct, window), 0.0)
    errs = {}
    for name, g, w, t, floor in zip(("dq", "dk", "dv"), got, want,
                                    (q, k, v), floors):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        assert bool(torch.isfinite(g).all()), name
        errs[name] = float((g.float() - w).norm()) / max(
            float(w.norm()), floor, 1e-30)
    assert max(errs.values()) <= BOUND[dtype], errs
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("window", [None, 1, 64])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("s", [1, 511, 513, 4097])
def test_mha_gradient_matches_reference_on_card(cuda_device, s, group,
                                                window, dtype):
    q, k, v, ct = _inputs(cuda_device, dtype, s, 2 * group, 2, 128, 128,
                          seed=s + 10 * group + (window or 0))
    want_route = "ffma" if dtype == "float32" else "wgmma"
    assert t_attn.mha_route(q, k, v) == want_route
    _check(q, k, v, ct, window, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("s", [1, 513, 4097])
def test_mha_gradient_mla_widths_on_card(cuda_device, s, window, dtype):
    """q and k at 96, v at 64 (the widths of minicpm3-4b's MLA heads),
    8 heads on 8."""
    q, k, v, ct = _inputs(cuda_device, dtype, s, 8, 8, 96, 64, seed=s)
    _check(q, k, v, ct, window, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mha_gradient_of_strided_operands_on_card(cuda_device, dtype):
    """q, k and v as the model hands them over: (B, S, H, D) projections
    transposed to (B, H, S, D) views; the gradients come back in the
    views' shapes and reach the projections."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    b, s, hq, hkv, d = 2, 777, 16, 4, 64
    x = torch.randn(b, s, (hq + 2 * hkv) * d, generator=gen,
                    device=cuda_device).to(_TORCH[dtype])
    x.requires_grad_()
    qkv = x.view(b, s, hq + 2 * hkv, d)
    q = qkv[:, :, :hq].transpose(1, 2)
    k = qkv[:, :, hq:hq + hkv].transpose(1, 2)
    v = qkv[:, :, hq + hkv:].transpose(1, 2)
    assert not q.is_contiguous() and q.stride(-1) == 1
    ct = torch.randn(b, hq, s, d, generator=gen,
                     device=cuda_device).to(_TORCH[dtype])
    out = t_attn.mha(q, k, v, causal=True, window=100)
    out.backward(ct)
    xr = x.detach().float().requires_grad_()
    qkv_r = xr.view(b, s, hq + 2 * hkv, d)
    ref = t_attn.attention_reference(
        qkv_r[:, :, :hq].transpose(1, 2),
        qkv_r[:, :, hq:hq + hkv].transpose(1, 2),
        qkv_r[:, :, hq + hkv:].transpose(1, 2), causal=True, window=100)
    ref.backward(ct.float())
    rel = float((x.grad.float() - xr.grad).norm() / xr.grad.norm())
    assert rel <= BOUND[dtype], rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mha_backward_repeats_bitwise_on_card(cuda_device, dtype):
    q, k, v, ct = _inputs(cuda_device, dtype, 1300, 8, 2, 128, 128, seed=5)
    first = _grads_on_card(q, k, v, ct, 64)
    for _ in range(2):
        again = _grads_on_card(q, k, v, ct, 64)
        assert torch.equal(again[0], first[0])
        for a, b in zip(again[1], first[1]):
            assert torch.equal(a, b)
