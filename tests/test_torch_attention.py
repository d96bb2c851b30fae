"""Port parity for the two attention kernels and the model-stack
attention: the same seeded numpy inputs go through the reference's Pallas
kernels in interpret mode (`repro.kernels.attention.mha`,
`repro.kernels.decode_attention.decode_attention`) or its jnp model
functions (`repro.models.attention`) and through repro_torch on the CPU,
where each wrapper runs its plain PyTorch version. The kernels
themselves are held to their plain versions on the card by
`tests/test_torch_attention_card.py` (which imports no JAX, so that it
runs on a card host) and by chip_smoke.py.

Tolerances:
* float32: |got - want| <= 1e-5 + 1e-5 |want|. Both sides are float32
  softmaxes over at most 256 keys of width D <= 64 with float32
  accumulation, in another order (the Pallas kernel walks 32-key
  windows, the plain version sums a row at once); the outputs are
  convex combinations of unit-normal values, so 1e-5 is about a hundred
  float32 units of their scale.
* bfloat16 (inputs and output): both compute in float32 from the same
  bfloat16 inputs and round once, so they differ by at most one
  bfloat16 unit of the output, at most 2**-7 |want|, plus the float32
  term.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import mha as jmha
from repro.kernels.decode_attention import decode_attention as jdecode
from repro.models import attention as jattn
from repro_torch.kernels import attention as t_attn, common, \
    decode_attention as t_dec, ops as tops
from repro_torch.models import attention as tattn

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


def _qkv(seed, b, hq, hkv, sq, skv, d, dtype="float32"):
    rng = np.random.default_rng(seed)
    return _both([_normal(rng, b, hq, sq, d), _normal(rng, b, hkv, skv, d),
                  _normal(rng, b, hkv, skv, d)], dtype)


def _close(got, want, dtype="float32"):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(
        got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    rel = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got, want, rtol=rel, atol=1e-5)


# ---------------------------------------------------------------------------
# mha against the Pallas flash kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (5, 1)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(16, 64), (64, 64), (33, 70)])
def test_mha_matches_pallas(hq, hkv, causal, sq, skv):
    (jq, jk, jv), (tq, tk, tv) = _qkv(sq + skv + hq, 2, hq, hkv, sq, skv, 32)
    want = jmha(jq, jk, jv, causal=causal, block_q=16, block_k=32)
    _close(tops.mha(tq, tk, tv, causal=causal), want)


@pytest.mark.parametrize("window", [8, 32, None])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_mha_sliding_window(window, causal, hq, hkv):
    (jq, jk, jv), (tq, tk, tv) = _qkv(5, 1, hq, hkv, 33, 70, 64)
    want = jmha(jq, jk, jv, causal=causal, window=window, block_q=16,
                block_k=32)
    _close(tops.mha(tq, tk, tv, causal=causal, window=window), want)


@pytest.mark.parametrize("causal", [True, False])
def test_mha_bf16(causal):
    (jq, jk, jv), (tq, tk, tv) = _qkv(7, 1, 4, 2, 128, 128, 64, "bfloat16")
    want = jmha(jq, jk, jv, causal=causal, block_q=64, block_k=64)
    got = tops.mha(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")


def test_fully_masked_rows_give_zero():
    # 8 queries aligned at the end of 4 keys: the first 4 see no key
    (jq, jk, jv), (tq, tk, tv) = _qkv(17, 1, 2, 1, 8, 4, 16)
    want = np.asarray(jmha(jq, jk, jv, causal=True, block_q=8, block_k=8))
    got = tops.mha(tq, tk, tv, causal=True)
    assert np.all(want[:, :, :4] == 0) and torch.all(got[:, :, :4] == 0)
    assert torch.isfinite(got).all()
    _close(got, want)


def test_mha_takes_strided_views():
    """The model hands mha v as a transposed (B, S, H, D) view."""
    rng = np.random.default_rng(19)
    q, k, v = (_normal(rng, 2, 24, h, 32) for h in (4, 2, 2))
    (jq, jk, jv), (tq, tk, tv) = _both([a.transpose(0, 2, 1, 3)
                                       for a in (q, k, v)])
    tv = torch.from_numpy(v).transpose(1, 2)
    assert not tv.is_contiguous()
    _close(tops.mha(tq, tk, tv), jmha(jq, jk, jv, block_q=8, block_k=32))


# ---------------------------------------------------------------------------
# decode_attention against the Pallas decode kernel (interpret mode)
# ---------------------------------------------------------------------------


def _cache_case(seed, hq, hkv, b=3, smax=256, d=32, dtype="float32"):
    rng = np.random.default_rng(seed)
    return _both([_normal(rng, b, hq, d), _normal(rng, b, hkv, smax, d),
                  _normal(rng, b, hkv, smax, d)], dtype)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (5, 1)])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("lens", [(256, 100, 17), (0, 1, 255)])
def test_decode_attention_matches_pallas(hq, hkv, window, lens):
    (jq, jk, jv), (tq, tk, tv) = _cache_case(11, hq, hkv)
    want = jdecode(jq, jk, jv, jnp.asarray(lens, jnp.int32), window=window,
                   block_k=128)
    got = tops.decode_attention(tq, tk, tv,
                                torch.tensor(lens, dtype=torch.int32),
                                window=window)
    _close(got, want)
    if 0 in lens:                     # no valid key: 0, not NaN
        assert torch.all(got[list(lens).index(0)] == 0)


def test_decode_attention_bf16_and_scalar_len():
    (jq, jk, jv), (tq, tk, tv) = _cache_case(23, 8, 2, d=64,
                                             dtype="bfloat16")
    want = jdecode(jq, jk, jv, jnp.int32(200), block_k=128)
    got = tops.decode_attention(tq, tk, tv, 200)
    assert got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")


def test_decode_matches_mha_last_row():
    """Decode over a full cache == the last row of causal prefill."""
    (_, _, _), (tq, tk, tv) = _qkv(13, 2, 4, 2, 64, 64, 32)
    full = tops.mha(tq, tk, tv, causal=True)
    got = tops.decode_attention(tq[:, :, -1].contiguous(), tk, tv,
                                torch.full((2,), 64, dtype=torch.int32))
    _close(got, full[:, :, -1].numpy())


def test_decode_takes_the_strided_cache_view():
    """The model hands the kernel its (B, S, Hkv, D) cache as a (B, Hkv,
    S, D) view; the result equals the one on a contiguous copy."""
    rng = np.random.default_rng(29)
    q = torch.from_numpy(_normal(rng, 2, 4, 32))
    k = torch.from_numpy(_normal(rng, 2, 50, 2, 32)).permute(0, 2, 1, 3)
    v = torch.from_numpy(_normal(rng, 2, 50, 2, 32)).permute(0, 2, 1, 3)
    lens = torch.tensor([50, 31], dtype=torch.int32)
    got = tops.decode_attention(q, k, v, lens)
    want = jdecode(*(jnp.asarray(t.contiguous().numpy()) for t in (q, k, v)),
                   jnp.asarray(lens.numpy()), block_k=128)
    _close(got, want)


# ---------------------------------------------------------------------------
# The model-stack functions against the reference's jnp ones
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hq,hkv,s", [(4, 2, 24), (8, 2, 70), (4, 4, 33)])
def test_chunked_attention_matches_reference(hq, hkv, s):
    (jq, jk, jv), (tq, tk, tv) = _qkv(31 + s, 2, hq, hkv, s, s, 16)
    want = jattn.chunked_attention(jq, jk, jv, causal=True, block_q=16,
                                   block_k=32)
    _close(tattn.chunked_attention(tq, tk, tv, causal=True), want)


@pytest.mark.parametrize("hq,hkv,pos", [(4, 2, 0), (8, 2, 37), (4, 4, 63)])
def test_decode_attention_full_matches_reference(hq, hkv, pos):
    rng = np.random.default_rng(41 + pos)
    (jq, jk, jv), (tq, tk, tv) = _both([
        _normal(rng, 2, hq, 16), _normal(rng, 2, 64, hkv, 16),
        _normal(rng, 2, 64, hkv, 16)])
    want = jattn.decode_attention_full(jq, jk, jv, jnp.int32(pos))
    _close(tattn.decode_attention_full(tq, tk, tv, pos), want)
    lens = torch.full((2,), pos + 1, dtype=torch.int32)
    _close(tattn.decode_attention_full(tq, tk, tv, pos, cache_len=lens),
           want)


@pytest.mark.parametrize("window,s", [(8, 24), (8, 70), (16, 33),
                                      (32, 40), (100, 70)])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4)])
def test_windowed_chunked_attention_matches_reference(hq, hkv, window, s):
    """Both of the reference's branches: the band when window < S // 2,
    the masked chunks otherwise (and a window past S, which masks
    nothing)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(51 + s + window, 2, hq, hkv, s, s, 16)
    want = jattn.chunked_attention(jq, jk, jv, causal=True, window=window,
                                   block_q=16, block_k=32)
    _close(tattn.chunked_attention(tq, tk, tv, causal=True, window=window),
           want)


def _ring(rng, hq, hkv, w):
    """A (B, W, Hkv, D) ring of unit normals: slots past pos (before the
    first wrap) hold garbage that a correct mask never reads."""
    return _both([_normal(rng, 2, hq, 16), _normal(rng, 2, w, hkv, 16),
                  _normal(rng, 2, w, hkv, 16)])


@pytest.mark.parametrize("w,pos", [(16, 0), (16, 5), (16, 15), (16, 16),
                                   (16, 37), (24, 100)])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 2)])
def test_decode_attention_ring_matches_reference(hq, hkv, w, pos):
    rng = np.random.default_rng(61 + pos + w)
    (jq, jk, jv), (tq, tk, tv) = _ring(rng, hq, hkv, w)
    want = jattn.decode_attention_ring(jq, jk, jv, jnp.int32(pos), window=w)
    _close(tattn.decode_attention_ring(tq, tk, tv, pos, window=w), want)
    lens = torch.full((2,), min(pos + 1, w), dtype=torch.int32)
    _close(tattn.decode_attention_ring(tq, tk, tv, pos, window=w,
                                       ring_len=lens), want)


def test_decode_attention_ring_refuses_a_ring_past_its_window():
    t = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="window"):
        tattn.decode_attention_ring(t[:, :4, 0], t, t, 3, window=4)


@pytest.mark.parametrize("call", [
    lambda t: tattn.chunked_attention(t, t, t[..., :8]),
    lambda t: tattn.decode_attention_mla(t, t, t, t, 3, scale=1.0),
])
def test_unported_attention_paths_raise(call):
    t = torch.zeros((1, 2, 4, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, item 14"):
        call(t)


# ---------------------------------------------------------------------------
# Wrappers: device rule, counters, operand checks
# ---------------------------------------------------------------------------


def test_cpu_tensors_run_the_plain_versions():
    (_, _, _), (tq, tk, tv) = _qkv(3, 1, 4, 2, 8, 8, 16)
    common.reset_counts(tops.mha, tops.decode_attention)
    tops.mha(tq, tk, tv)
    tops.decode_attention(tq[:, :, 0].contiguous(), tk, tv, 8)
    assert (tops.mha.plain_calls, tops.decode_attention.plain_calls) == (1, 1)
    assert tops.mha.launches == tops.decode_attention.launches == 0
    assert tops.KERNELS["mha"] is tops.mha
    assert tops.KERNELS["decode_attention"] is tops.decode_attention


@pytest.mark.parametrize("bad", [
    lambda q: tops.mha(q[0], q, q),                          # not 4-D
    lambda q: tops.mha(q, q[:, :3], q[:, :3]),               # 4 % 3 heads
    lambda q: tops.mha(q, q, q.double()),                    # dtypes
    lambda q: tops.mha(q, q, q, window=0),                   # window
    lambda q: tops.mha(q.transpose(2, 3), q, q),             # D stride
    lambda q: tops.mha(*(torch.zeros(1, 1, 2, 300),) * 3),   # D > 256
    lambda q: tops.decode_attention(q, q, q, 4),             # q not 3-D
    lambda q: tops.decode_attention(q[:, :, 0], q, q,
                                    torch.zeros(3, dtype=torch.int32)),
])
def test_bad_operands_raise(bad):
    with pytest.raises(ValueError):
        bad(torch.zeros((2, 4, 8, 16)))


def test_decode_plan_fills_the_card():
    # Llama-3-8B at B 8 on an H100 SXM (132 SMs), the mma route's 64-key
    # tiles: 64 (b, KV head) pairs, a ~2100-token cache: 4 splits, 256
    # blocks, one wave at two per SM
    mma, simt = t_dec.TILE_KEYS["mma"], t_dec.TILE_KEYS["simt"]
    assert t_dec.decode_plan(8, 8, 2080, mma, 132) == 4
    assert t_dec.decode_plan(1, 1, 100, simt, 132) == 3   # no split below
    assert t_dec.decode_plan(1, 1, 100, mma, 132) == 1    # a tile
    assert t_dec.decode_plan(64, 8, 1 << 15, mma, 132) == 1   # enough blocks
    assert t_dec.decode_plan(8, 8, 2080, mma, 114) == 3   # an H100 PCIe


def _plan_holds(b, hkv, smax, route, sms, want):
    tile = t_dec.TILE_KEYS[route]
    splits = t_dec.decode_plan(b, hkv, smax, tile, sms)
    assert splits == want
    assert splits == 1 or b * hkv * splits <= t_dec.BLOCKS_PER_SM * sms
    assert splits == 1 or smax // splits >= tile


@pytest.mark.parametrize("b,hkv,smax,want", [
    (8, 8, 1813, 4),          # the serve step: 256 blocks
    (1, 8, 1813, 33),         # 264 blocks
    (1, 1, 1813, 56),         # no split below 32 keys
    (1, 1, 31, 1),            # a cache shorter than a tile
    (1, 1, 64, 2),
    (4, 8, 1 << 16, 8),       # 256 blocks
    (132, 4, 4096, 1),        # more than one wave already
])
def test_decode_plan_keeps_one_wave_and_whole_tiles(b, hkv, smax, want):
    # the simt route's 32-key tiles on 132 SMs
    _plan_holds(b, hkv, smax, "simt", 132, want)


@pytest.mark.parametrize("b,hkv,smax,sms,want", [
    (8, 8, 1813, 132, 4),     # the serve step: 256 blocks
    (1, 8, 1813, 132, 28),    # no split below 64 keys: 224 blocks
    (1, 1, 1813, 132, 28),
    (1, 1, 63, 132, 1),       # a cache shorter than a tile
    (1, 1, 128, 132, 2),
    (4, 8, 1 << 16, 132, 8),  # 256 blocks
    (4, 8, 1 << 16, 114, 7),  # 224 blocks on 114 SMs
    (132, 4, 4096, 132, 1),   # more than one wave already
])
def test_decode_plan_on_the_mma_tile(b, hkv, smax, sms, want):
    _plan_holds(b, hkv, smax, "mma", sms, want)


@pytest.mark.parametrize("kw,route", [
    (dict(), "mma"),                                    # the model's view
    (dict(d=64), "mma"),
    (dict(dtype=torch.float16), "mma"),
    (dict(contiguous=True), "mma"),
    (dict(dtype=torch.float32), "simt"),
    (dict(d=96), "simt"),
    (dict(d=64, width=68), "simt"),                     # rows of 136 bytes
    (dict(offset=4), "simt"),                           # base off 16 bytes
    (dict(offset=8), "mma"),
    (dict(q_offset=4), "simt"),
])
def test_decode_route_follows_tma_conditions(kw, route):
    dtype, d = kw.get("dtype", torch.bfloat16), kw.get("d", 128)
    width, offset = kw.get("width", d), kw.get("offset", 0)
    flat = torch.zeros(2 * 40 * 4 * width + offset, dtype=dtype)[offset:]
    if kw.get("contiguous"):
        cache = flat.view(2, 4, 40, width)[..., :d]
    else:
        cache = flat.view(2, 40, 4, width).permute(0, 2, 1, 3)[..., :d]
    q = torch.zeros(2 * 8 * d + kw.get("q_offset", 0),
                    dtype=dtype)[kw.get("q_offset", 0):].view(2, 8, d)
    assert t_dec.decode_route(q, cache, cache) == route


def _route_operands(dtype=torch.bfloat16, d=128, width=None, offset=0,
                    model_view=True):
    """q, k, v of 2 x (4, 2) heads over 9 rows; `width` pads the rows,
    `offset` moves the base by that many elements."""
    width = width or d
    def one(h):
        if model_view:     # the transpose(1, 2) view the model passes
            t = torch.zeros(2 * 9 * h * width + offset, dtype=dtype)
            t = t[offset:].view(2, 9, h, width).transpose(1, 2)
        else:
            t = torch.zeros(2 * h * 9 * width + offset, dtype=dtype)
            t = t[offset:].view(2, h, 9, width)
        return t[..., :d]
    return one(4), one(2), one(2)


@pytest.mark.parametrize("kw,route", [
    (dict(), "wgmma"),                                  # bf16, D 128
    (dict(d=64), "wgmma"),
    (dict(dtype=torch.float16), "wgmma"),
    (dict(model_view=False), "wgmma"),                  # contiguous
    (dict(dtype=torch.float32), "ffma"),
    (dict(d=96), "ffma"),                               # D not 64 or 128
    (dict(d=64, width=68), "ffma"),                     # rows of 136 bytes
    (dict(d=64, width=72), "wgmma"),                    # rows of 144 bytes
    (dict(offset=4), "ffma"),                           # base off 16 bytes
    (dict(offset=8), "wgmma"),
])
def test_mha_route_follows_tma_conditions(kw, route):
    assert t_attn.mha_route(*_route_operands(**kw)) == route


def test_tma_strides_pack_dimensions_of_size_one():
    q = torch.zeros(1, 7, 1, 128, dtype=torch.bfloat16).transpose(1, 2)
    assert q.shape == (1, 1, 7, 128)
    assert t_attn.tma_strides(q) == (7 * 128, 7 * 128, 128)
    q = torch.zeros(2, 5, 3, 64).transpose(1, 2)
    assert t_attn.tma_strides(q) == q.stride()[:3]


def test_reset_counts_clears_the_route_counts():
    tops.mha.route_launches["wgmma"] += 3
    tops.decode_attention.route_launches["mma"] += 2
    common.reset_counts(tops.mha, tops.decode_attention)
    assert tops.mha.route_launches == {"wgmma": 0, "ffma": 0}
    assert tops.decode_attention.route_launches == {"mma": 0, "simt": 0}
