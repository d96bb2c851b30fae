"""The two attention kernels against their plain versions on the card
(CUDA C++, built from src/repro_torch/csrc at first use). This file
imports torch and numpy only, so that it runs on a card host:

    python -m pytest -q -m cuda tests/test_torch_attention_card.py

Every test skips on a host without a card. The CPU parity with the
reference's Pallas kernels is tests/test_torch_attention.py.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import attention as t_attn, \
    decode_attention as t_dec, ops as tops

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_close(got, want, q, k, v, dtype):
    """The bound chip_smoke.py states: float32, 1e-5 max|v| (1 + 2 scale
    max|q_i| max|k_j|), the softmax-weighted sum's rounding plus the
    scores' carried through exp(); bfloat16, plus one bfloat16 unit of
    the output (each side rounds once)."""
    scale = q.shape[-1] ** -0.5
    spread = scale * float(q.float().norm(dim=-1).max()) * float(
        k.float().norm(dim=-1).max())
    tol = 1e-5 * float(v.float().abs().max()) * (1 + 2 * spread)
    err = (got.float() - want.float()).abs()
    if dtype != "float32":
        tol = tol + 2.0 ** -7 * torch.maximum(got.float().abs(),
                                              want.float().abs())
    assert bool((err <= tol).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (5, 1)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 8), (False, 32)])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_mha_kernel_matches_plain_on_card(cuda_device, dtype, hq, hkv,
                                          causal, window, d):
    rng = np.random.default_rng(d + hq)
    q, k, v = (torch.from_numpy(_normal(rng, 2, h, s, d)).to(
        cuda_device, _TORCH[dtype]) for h, s in ((hq, 33), (hkv, 70),
                                                 (hkv, 70)))
    before = tops.mha.launches
    got = tops.mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tops.mha.launches == before + 1
    want = t_attn.mha_plain(q, k, v, causal=causal, window=window)
    _card_close(got, want, q, k, v, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (5, 1)])
@pytest.mark.parametrize("window", [None, 8, 64])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_decode_kernel_matches_plain_on_card(cuda_device, dtype, hq, hkv,
                                             window, d):
    rng = np.random.default_rng(d + hq + 1)
    smax = 1500
    q = torch.from_numpy(_normal(rng, 4, hq, d)).to(cuda_device,
                                                    _TORCH[dtype])
    k, v = (torch.from_numpy(_normal(rng, 4, smax, hkv, d)).to(
        cuda_device, _TORCH[dtype]).permute(0, 2, 1, 3) for _ in range(2))
    lens = torch.tensor([0, 1, 70, smax], dtype=torch.int32,
                        device=cuda_device)
    before = tops.decode_attention.launches
    got = tops.decode_attention(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    assert tops.decode_attention.launches == before + 1
    want = t_dec.decode_attention_plain(q, k, v, lens, window=window)
    _card_close(got, want, q, k, v, dtype)
    assert bool((got[0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("sq,skv", [(1, 1), (64, 64), (130, 130), (33, 200)])
def test_mha_tensor_core_path_and_its_fallback(cuda_device, dtype, sq, skv):
    """D 64 and 128 in 16-bit types take the tensor-core path when every
    row starts on 16 bytes; a view with rows of 68 elements takes the
    FFMA path. Both agree with the plain version."""
    rng = np.random.default_rng(sq + skv)
    for d, width in ((64, 64), (128, 128), (64, 68)):
        q, k, v = (torch.from_numpy(_normal(rng, 2, h, s, width)).to(
            cuda_device, _TORCH[dtype])[..., :d]
            for h, s in ((8, sq), (2, skv), (2, skv)))
        got = tops.mha(q, k, v, causal=True)
        want = t_attn.mha_plain(q, k, v, causal=True)
        _card_close(got, want, q, k, v, dtype)
