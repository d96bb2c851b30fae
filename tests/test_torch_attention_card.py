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

from repro_torch.kernels import attention as t_attn, common, \
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
    """D 64 and 128 in 16-bit types take the wgmma route when every row
    starts on 16 bytes; a view with rows of 68 elements takes the FFMA
    route. Both agree with the plain version."""
    rng = np.random.default_rng(sq + skv)
    for d, width, route in ((64, 64, "wgmma"), (128, 128, "wgmma"),
                            (64, 68, "ffma")):
        q, k, v = (torch.from_numpy(_normal(rng, 2, h, s, width)).to(
            cuda_device, _TORCH[dtype])[..., :d]
            for h, s in ((8, sq), (2, skv), (2, skv)))
        assert t_attn.mha_route(q, k, v) == route
        before = tops.mha.route_launches[route]
        got = tops.mha(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert tops.mha.route_launches[route] == before + 1
        want = t_attn.mha_plain(q, k, v, causal=True)
        _card_close(got, want, q, k, v, dtype)


def _model_views(rng, b, h, s, d, dtype, device):
    """A (B, H, S, D) operand as the model passes it: the transpose(1, 2)
    view of a contiguous (B, S, H, D) tensor."""
    return torch.from_numpy(_normal(rng, b, s, h, d)).to(
        device, _TORCH[dtype]).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (5, 1)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 8), (False, 100)])
@pytest.mark.parametrize("sq,skv", [(1, 1), (63, 63), (64, 65),
                                    (127, 129), (128, 128), (300, 333),
                                    (1781, 1781), (200, 70)])
def test_mha_wgmma_route_at_ragged_multi_tile_shapes(cuda_device, dtype, d,
                                                     hq, hkv, causal, window,
                                                     sq, skv):
    """The wgmma route on the model's strided views: ragged query and key
    tiles, the diagonal mid-tile (skv > sq), windows narrower than a
    tile, and (200, 70) causal, whose first 130 rows see no key and give
    0. One launch on the wgmma route; a second call repeats bitwise."""
    rng = np.random.default_rng(sq * 7 + skv + d + hq)
    b = 1 if sq > 1000 else 2
    q = _model_views(rng, b, hq, sq, d, dtype, cuda_device)
    k = _model_views(rng, b, hkv, skv, d, dtype, cuda_device)
    v = _model_views(rng, b, hkv, skv, d, dtype, cuda_device)
    assert t_attn.mha_route(q, k, v) == "wgmma"
    routes = dict(tops.mha.route_launches)
    got = tops.mha(q, k, v, causal=causal, window=window)
    again = tops.mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tops.mha.route_launches == dict(
        routes, wgmma=routes["wgmma"] + 2)
    assert torch.equal(got, again)
    want = t_attn.mha_plain(q, k, v, causal=causal, window=window)
    _card_close(got, want, q, k, v, dtype)
    if causal and sq - skv > 0:
        assert bool((got[:, :, :sq - skv] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("window", [None, 8, 100])
@pytest.mark.parametrize("b,hkv,smax", [(8, 8, 1813), (1, 1, 1500),
                                        (2, 4, 40), (66, 8, 300)])
def test_decode_lengths_plans_and_repeats_on_card(cuda_device, dtype, window,
                                                  b, hkv, smax):
    """Lengths 0, 1, 63, 64, 65, the capacity and the capacity + 7
    (capped; the window still counts back from the length) on the
    model's strided cache views, at shapes whose decode_plan gives 4, 46
    (23 on the mma route's 64-key tiles), 1 and 1 splits on an H100 SXM,
    on the mma route (16-bit) or the simt route (float32). One launch per call: the last block of each (b, head
    group) folds the splits. A second call repeats bitwise."""
    rng = np.random.default_rng(b * 31 + hkv + smax)
    hq, d = 4 * hkv, 128
    q = torch.from_numpy(_normal(rng, b, hq, d)).to(cuda_device,
                                                    _TORCH[dtype])
    k, v = (torch.from_numpy(_normal(rng, b, smax, hkv, d)).to(
        cuda_device, _TORCH[dtype]).permute(0, 2, 1, 3) for _ in range(2))
    pick = [0, 1, 63, 64, 65, smax, smax + 7]
    lens = torch.tensor([pick[i % len(pick)] for i in range(b)],
                        dtype=torch.int32, device=cuda_device)
    route = "simt" if dtype == "float32" else "mma"
    assert t_dec.decode_route(q, k, v) == route
    splits = t_dec.decode_plan(b, hkv, smax, t_dec.TILE_KEYS[route],
                               common.sm_count(q.device))
    if common.sm_count(q.device) == 132:    # an H100 SXM
        assert splits == {(8, 8, 1813): 4, (1, 1, 1500): 46 if route ==
                          "simt" else 23, (2, 4, 40): 1,
                          (66, 8, 300): 1}[(b, hkv, smax)]
    before = (tops.decode_attention.launches,
              tops.decode_attention.finish_launches,
              tops.decode_attention.route_launches[route])
    got = tops.decode_attention(q, k, v, lens, window=window)
    again = tops.decode_attention(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    assert (tops.decode_attention.launches,
            tops.decode_attention.finish_launches,
            tops.decode_attention.route_launches[route]) == (
        before[0] + 2, before[1], before[2] + 2)
    assert torch.equal(got, again)
    want = t_dec.decode_attention_plain(q, k, v, lens, window=window)
    _card_close(got, want, q, k, v, dtype)
    assert bool((got[0] == 0).all())


# ---------------------------------------------------------------------------
# The sliding-window serve path: windowed prefill and decode over a ring
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("d,route", [(128, "wgmma"), (120, "ffma")])
@pytest.mark.parametrize("s", [512, 777])
def test_windowed_mha_past_twice_the_window(cuda_device, d, route, s):
    """Window 256 over S >= 2W, on the model's strided views, bfloat16:
    D 128 on the wgmma route, D 120 (h2o-danube-3-4b's heads) on the
    FFMA route; the key tiles below each query tile's window are
    skipped, and the result is the plain version's."""
    rng = np.random.default_rng(s + d)
    q = _model_views(rng, 2, 8, s, d, "bfloat16", cuda_device)
    k = _model_views(rng, 2, 2, s, d, "bfloat16", cuda_device)
    v = _model_views(rng, 2, 2, s, d, "bfloat16", cuda_device)
    assert t_attn.mha_route(q, k, v) == route
    before = tops.mha.route_launches[route]
    got = tops.mha(q, k, v, causal=True, window=256)
    torch.cuda.synchronize()
    assert tops.mha.route_launches[route] == before + 1
    want = t_attn.mha_plain(q, k, v, causal=True, window=256)
    _card_close(got, want, q, k, v, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("d,route", [(128, "mma"), (120, "simt")])
@pytest.mark.parametrize("filled", ["short", "full"])
def test_decode_over_a_ring_view(cuda_device, d, route, filled):
    """decode_attention over the (B, Hkv, W, D) view of a (B, W, Hkv, D)
    ring, as the model's ring decode calls it: lengths below W (before
    the ring wraps: slots [0, pos]) and equal to W (after: every slot),
    no window argument; the slots past a short length hold values that
    must not be read."""
    rng = np.random.default_rng(d + len(filled))
    w, b, hkv = 256, 4, 2
    q = torch.from_numpy(_normal(rng, b, 8, d)).to(cuda_device,
                                                   torch.bfloat16)
    k, v = (torch.from_numpy(_normal(rng, b, w, hkv, d)).to(
        cuda_device, torch.bfloat16).permute(0, 2, 1, 3) for _ in range(2))
    lens = (torch.tensor([1, 17, 200, w - 1], dtype=torch.int32,
                         device=cuda_device) if filled == "short" else
            torch.full((b,), w, dtype=torch.int32, device=cuda_device))
    assert t_dec.decode_route(q, k, v) == route
    before = tops.decode_attention.route_launches[route]
    got = tops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert tops.decode_attention.route_launches[route] == before + 1
    want = t_dec.decode_attention_plain(q, k, v, lens)
    _card_close(got, want, q, k, v, "bfloat16")
