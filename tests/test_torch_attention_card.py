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


def _value_views(rng, b, h, s, dv, dtype, device):
    """v (B, H, S, dv) as MLA's prefill passes it: the value columns of
    the (B, S, H, 64 + dv) up-projection, transposed (base 128 bytes in,
    rows of 64 + dv elements)."""
    return _model_views(rng, b, h, s, 64 + dv, dtype, device)[..., 64:]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("d,dv", [(96, 64), (120, 120), (128, 64),
                                  (72, 72)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 8), (False, 100)])
@pytest.mark.parametrize("sq,skv", [(1, 1), (64, 65), (300, 333),
                                    (200, 70)])
def test_mha_wgmma_route_at_head_widths_other_than_64_and_128(
        cuda_device, dtype, d, dv, hq, hkv, causal, window, sq, skv):
    """q and k of d columns padded to 64 or 128 in shared memory by TMA's
    zero fill, v of dv columns (its own view, as MLA's prefill gives it
    where dv != d): MiniCPM3's (96, 64), H2O-Danube3's (120, 120), the
    (128, 64) pair and (72, 72). Ragged query and key tiles, causal and
    windowed. One launch per call on the wgmma route; a second call
    repeats bitwise; the output is (B, Hq, Sq, dv)."""
    rng = np.random.default_rng(sq * 7 + skv + d + dv + hq)
    q = _model_views(rng, 2, hq, sq, d, dtype, cuda_device)
    k = _model_views(rng, 2, hkv, skv, d, dtype, cuda_device)
    v = (_value_views(rng, 2, hkv, skv, dv, dtype, cuda_device) if dv != d
         else _model_views(rng, 2, hkv, skv, dv, dtype, cuda_device))
    assert t_attn.mha_route(q, k, v) == "wgmma"
    routes = dict(tops.mha.route_launches)
    got = tops.mha(q, k, v, causal=causal, window=window)
    again = tops.mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tops.mha.route_launches == dict(
        routes, wgmma=routes["wgmma"] + 2)
    assert torch.equal(got, again)
    assert got.shape == (2, hq, sq, dv)
    want = t_attn.mha_plain(q, k, v, causal=causal, window=window)
    _card_close(got, want, q, k, v, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 8), (False, 100)])
@pytest.mark.parametrize("sq,skv", [(1, 1), (64, 65), (300, 333),
                                    (200, 70)])
def test_mha_ffma_route_with_a_value_width_of_its_own(cuda_device, causal,
                                                      window, sq, skv):
    """MiniCPM3's (96, 64) in float32, on the FFMA route: Q and K staged
    at width 96, V at 64, in the 128-column bucket."""
    rng = np.random.default_rng(sq * 5 + skv)
    q = _model_views(rng, 2, 8, sq, 96, "float32", cuda_device)
    k = _model_views(rng, 2, 2, skv, 96, "float32", cuda_device)
    v = _value_views(rng, 2, 2, skv, 64, "float32", cuda_device)
    assert t_attn.mha_route(q, k, v) == "ffma"
    before = tops.mha.route_launches["ffma"]
    got = tops.mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tops.mha.route_launches["ffma"] == before + 1
    assert got.shape == (2, 8, sq, 64)
    want = t_attn.mha_plain(q, k, v, causal=causal, window=window)
    _card_close(got, want, q, k, v, "float32")


# ---------------------------------------------------------------------------
# The sliding-window serve path: windowed prefill and decode over a ring
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype,route", [(128, "bfloat16", "wgmma"),
                                           (120, "bfloat16", "wgmma"),
                                           (120, "float32", "ffma")])
@pytest.mark.parametrize("s", [512, 777])
def test_windowed_mha_past_twice_the_window(cuda_device, d, dtype, route, s):
    """Window 256 over S >= 2W, on the model's strided views: D 128 and
    D 120 (h2o-danube-3-4b's heads, padded to 128 by TMA's zero fill) in
    bfloat16 on the wgmma route, D 120 in float32 on the FFMA route; the
    key tiles below each query tile's window are skipped, and the result
    is the plain version's."""
    rng = np.random.default_rng(s + d)
    q = _model_views(rng, 2, 8, s, d, dtype, cuda_device)
    k = _model_views(rng, 2, 2, s, d, dtype, cuda_device)
    v = _model_views(rng, 2, 2, s, d, dtype, cuda_device)
    assert t_attn.mha_route(q, k, v) == route
    before = tops.mha.route_launches[route]
    got = tops.mha(q, k, v, causal=True, window=256)
    torch.cuda.synchronize()
    assert tops.mha.route_launches[route] == before + 1
    want = t_attn.mha_plain(q, k, v, causal=True, window=256)
    _card_close(got, want, q, k, v, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype,route", [(128, "bfloat16", "mma"),
                                           (120, "bfloat16", "mma"),
                                           (96, "bfloat16", "mma"),
                                           (32, "bfloat16", "mma"),
                                           (32, "float16", "mma"),
                                           (8, "bfloat16", "mma"),
                                           (8, "float16", "mma"),
                                           (120, "float32", "simt")])
@pytest.mark.parametrize("filled", ["short", "full"])
def test_decode_over_a_ring_view(cuda_device, d, dtype, route, filled):
    """decode_attention over the (B, Hkv, W, D) view of a (B, W, Hkv, D)
    ring, as the model's ring decode calls it: lengths below W (before
    the ring wraps: slots [0, pos]) and equal to W (after: every slot),
    no window argument; the slots past a short length hold values that
    must not be read. 16-bit heads of 96 and 120 columns take the mma
    route in a 128-column tile, of 32 and 8 in a 64-column one (TMA
    zero-fills the box past D); float32 keeps the simt route."""
    rng = np.random.default_rng(d + len(filled))
    w, b, hkv = 256, 4, 2
    q = torch.from_numpy(_normal(rng, b, 8, d)).to(cuda_device,
                                                   _TORCH[dtype])
    k, v = (torch.from_numpy(_normal(rng, b, w, hkv, d)).to(
        cuda_device, _TORCH[dtype]).permute(0, 2, 1, 3) for _ in range(2))
    lens = (torch.tensor([1, 17, 200, w - 1], dtype=torch.int32,
                         device=cuda_device) if filled == "short" else
            torch.full((b,), w, dtype=torch.int32, device=cuda_device))
    assert t_dec.decode_route(q, k, v) == route
    before = tops.decode_attention.route_launches[route]
    got = tops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert tops.decode_attention.route_launches[route] == before + 1
    want = t_dec.decode_attention_plain(q, k, v, lens)
    _card_close(got, want, q, k, v, dtype)


def _danube_ring(rng, b, hkv, w, d, dtype, device):
    """q (B, 4 Hkv, D) and the (B, Hkv, W, D) views of two (B, W, Hkv, D)
    rings, as h2o-danube-3-4b's ring decode passes them."""
    q = torch.from_numpy(_normal(rng, b, 4 * hkv, d)).to(device,
                                                         _TORCH[dtype])
    k, v = (torch.from_numpy(_normal(rng, b, w, hkv, d)).to(
        device, _TORCH[dtype]).permute(0, 2, 1, 3) for _ in range(2))
    return q, k, v


def _splits_and_lse(device, d, dtype, b, hkv, w, window, h100_splits):
    """decode_attention on the mma route at head width d over
    `_danube_ring`'s operands, with and without `return_lse`: the output
    bitwise the same, within the plain version's bound, the lse within
    2e-5 of the plain version's (chip_smoke.py's LSE_TOL, relative to its
    largest value where that exceeds 1), -inf exactly where a row has no
    valid key; on an H100 SXM (132 SMs) the plan takes `h100_splits`."""
    rng = np.random.default_rng(b + hkv + w)
    q, k, v = _danube_ring(rng, b, hkv, w, d, dtype, device)
    pick = [w, 0, 1, 700, w - 1, 0, 64, 65] * (b // 8 + 1)
    lens = torch.tensor(pick[:b], dtype=torch.int32, device=device)
    assert t_dec.decode_route(q, k, v) == "mma"
    splits = t_dec.decode_plan(b, hkv, w, t_dec.TILE_KEYS["mma"],
                               common.sm_count(q.device))
    if common.sm_count(q.device) == 132:    # an H100 SXM
        assert splits == h100_splits
    before = (tops.decode_attention.route_launches["mma"],
              tops.decode_attention.lse_launches)
    out0 = tops.decode_attention(q, k, v, lens, window=window)
    out, lse = tops.decode_attention(q, k, v, lens, window=window,
                                     return_lse=True)
    torch.cuda.synchronize()
    assert (tops.decode_attention.route_launches["mma"],
            tops.decode_attention.lse_launches) == (before[0] + 2,
                                                    before[1] + 1)
    assert torch.equal(out, out0)
    want, plse = t_dec.decode_attention_plain(q, k, v, lens, window=window,
                                              return_lse=True)
    _card_close(out, want, q, k, v, dtype)
    fin = torch.isfinite(plse)
    assert torch.equal(torch.isfinite(lse), fin)
    assert bool((lse[~fin] == -torch.inf).all())
    assert bool((out[~fin] == 0).all())
    tol = 2e-5 * max(1.0, float(plse[fin].abs().max()))
    assert float((lse[fin] - plse[fin]).abs().max()) <= tol
    return splits


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("b,hkv,w", [(8, 8, 4096), (1, 1, 1500)])
@pytest.mark.parametrize("window", [None, 100])
def test_decode_d120_splits_and_lse_on_card(cuda_device, dtype, b, hkv, w,
                                            window):
    """D 120 on the mma route with several splits (4 at danube's ring
    view, 23 at one row of 1500 slots on an H100 SXM), rows of length 0,
    held as `_splits_and_lse` says."""
    splits = _splits_and_lse(cuda_device, 120, dtype, b, hkv, w, window,
                             {8: 4, 1: 23}[b])
    assert splits > 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 8])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("b,hkv,w,h100_splits", [(8, 8, 4096, 4),
                                                 (1, 1, 1500, 23),
                                                 (64, 5, 1024, 1)])
@pytest.mark.parametrize("window", [None, 100])
def test_decode_narrow_heads_splits_and_lse_on_card(cuda_device, d, dtype,
                                                    b, hkv, w, h100_splits,
                                                    window):
    """Heads narrower than 64 on the mma route, in a 64-column tile that
    TMA zero-fills past D: one split and several, rows of length 0, held
    as `_splits_and_lse` says."""
    _splits_and_lse(cuda_device, d, dtype, b, hkv, w, window, h100_splits)


@pytest.mark.cuda
@pytest.mark.parametrize("return_lse", [False, True])
@pytest.mark.parametrize("b,hkv,w", [(8, 8, 4096), (4, 2, 256)])
def test_decode_d120_graph_replay_equals_eager_on_card(cuda_device,
                                                       return_lse, b, hkv,
                                                       w):
    """A D 120 decode captured in a CUDA graph (its tickets and scratch
    included, several splits at danube's view, one at the small one)
    replays to the eager result, bitwise, again and again; with new
    lengths copied into the captured length tensor, the replay equals
    the eager call at those lengths."""
    rng = np.random.default_rng(b + w)
    q, k, v = _danube_ring(rng, b, hkv, w, 120, "bfloat16", cuda_device)
    assert t_dec.decode_route(q, k, v) == "mma"
    lens = torch.tensor([(i * 997) % w + 1 for i in range(b)],
                        dtype=torch.int32, device=cuda_device)

    def call():
        return tops.decode_attention(q, k, v, lens, return_lse=return_lse)

    def same(x, y):
        return (all(map(torch.equal, x, y)) if return_lse
                else torch.equal(x, y))

    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = call()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert same(got, eager)
    lens.copy_(torch.tensor([w, 0] * (b // 2), dtype=torch.int32))
    eager = call()
    graph.replay()
    torch.cuda.synchronize()
    assert same(got, eager)
