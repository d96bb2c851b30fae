"""Decode attention (one query token per sequence over a KV cache) for
Hopper, in CUDA C++ (`csrc/decode_attention.cu`).

Replaces `repro/kernels/decode_attention.py::decode_attention` (its
`pallas_call` at decode_attention.py:85). The same function: q (B, Hq,
D) against caches (B, Hkv, Smax, D), all G = Hq / Hkv query heads of a
KV head together, `cache_len` (a scalar or one per row, the new token's
K/V already written) masking the tail and, with a window, keys before
len - window; float32 softmax, the output in q's dtype, and 0 for a row
with no valid key.

Bound on an H100 SXM at Llama-3-8B's decode (B 8, 8 KV heads of 128,
~1800 cached tokens, bfloat16): the bytes of the valid K and V rows,
about 18 µs per layer at 3.35 TB/s. The kernel reads only the valid
range, split across blocks (`decode_plan`) whose partials the last block
of each (b, head group) folds in a fixed order, through a TMA-filled ring
that keeps K and V in the cache's type; see csrc/decode_attention.cu.
One launch per call: `finish_launches` stays 0. `decode_route` picks one
of two kernels: tensor cores (mma.sync, P split into two 16-bit parts)
for bfloat16 and float16 at any even D up to 128, in a tile of 64 or 128
columns that TMA zero-fills past D (`attention.padded_width`, as `mha`
pads), float32 SIMT for the rest (float32, odd D, D over 128, views TMA
refuses).

With `return_lse=True` the call also returns each row's log-sum-exp of
its scaled scores, (B, Hq) float32 (-inf for a row with no valid key),
written by the same launch where it writes the output: what the combine
of partial attentions over the blocks of a cache split over a mesh reads
(`models.attention.combine_partials`). The output is bitwise the same
with it or without it (`lse_launches` counts these launches).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import common, cuda
from .attention import MAX_HEAD_DIM, padded_width, tma_strides

BLOCKS_PER_SM = 2           # the mma route's 97 KB blocks: two per SM
ROUTES = ("mma", "simt")
TILE_KEYS = {"mma": 64, "simt": 32}        # keys of each route's tile
HEADS_PER_BLOCK = {"mma": 16, "simt": 4}   # query heads a block serves


def decode_plan(b: int, hkv: int, smax: int, tile: int, sms: int) -> int:
    """Splits of the valid range: as many as keep B Hkv splits blocks
    resident at once on `sms` SMs (two per SM, one wave), and no split
    shorter than a `tile` of the cache's capacity. The lengths stay on
    the device, so the capacity decides."""
    return max(1, min(BLOCKS_PER_SM * sms // (b * hkv), smax // tile))


def decode_route(q, k_cache, v_cache) -> str:
    """The kernel that `decode_attention` launches: "mma" (tensor cores,
    TMA) for bfloat16 and float16 at an even D up to 128 (the kernel's
    tile `padded_width(D)`, 64 or 128 columns) whose bases and cache
    strides over (B, H, S) are multiples of 16 bytes, "simt" for
    everything else. Shapes, dtypes and addresses only: it also answers
    for CPU tensors."""
    d = q.shape[-1]
    if (q.dtype not in (torch.bfloat16, torch.float16)
            or d % 2 or d > padded_width(d)
            or q.data_ptr() % 16):
        return "simt"
    for t in (k_cache, v_cache):
        if t.data_ptr() % 16 or any(st % 8 for st in tma_strides(t)):
            return "simt"
    return "mma"


def check_operands(q, k_cache, v_cache, window):
    """Validate decode attention's operands; returns (b, hq, hkv, smax,
    d)."""
    if not torch.is_tensor(q) or q.ndim != 3:
        raise ValueError(f"decode attention takes q (B, Hq, D), got "
                         f"{getattr(q, 'shape', type(q).__name__)}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if not torch.is_tensor(t) or t.ndim != 4:
            raise ValueError(f"{name} must be (B, Hkv, Smax, D), got "
                             f"{getattr(t, 'shape', type(t).__name__)}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} needs unit stride over D; strides "
                             f"{t.stride()}")
    b, hq, d = q.shape
    _, hkv, smax, _ = k_cache.shape
    if (k_cache.shape[0] != b or k_cache.shape[3] != d
            or v_cache.shape != k_cache.shape):
        raise ValueError(f"decode attention needs q (B, Hq, D) and caches "
                         f"(B, Hkv, Smax, D); got q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    if not q.dtype == k_cache.dtype == v_cache.dtype:
        raise ValueError(f"operand dtypes disagree: q {q.dtype}, caches "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    if min(b, hq, hkv, smax, d) < 1 or hq % hkv:
        raise ValueError(f"decode attention needs non-empty operands and "
                         f"Hq a multiple of Hkv; got q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}")
    if d > MAX_HEAD_DIM or max(b, hkv) > 65535:
        raise ValueError(f"decode attention takes D <= {MAX_HEAD_DIM}; got "
                         f"q {tuple(q.shape)}")
    if window is not None and (not isinstance(window, int) or window < 1):
        raise ValueError(f"window must be None or a positive int, got "
                         f"{window!r}")
    return b, hq, hkv, smax, d


def lengths(cache_len, b: int, device: torch.device) -> torch.Tensor:
    """`cache_len` (an int, a 0-d or a (B,) tensor) as a contiguous (B,)
    int32 tensor on `device`. An int becomes a fill on the device, not an
    upload."""
    if isinstance(cache_len, int):
        return torch.full((b,), cache_len, dtype=torch.int32, device=device)
    if not torch.is_tensor(cache_len) or cache_len.ndim > 1 or (
            cache_len.ndim == 1 and cache_len.shape[0] not in (1, b)):
        raise ValueError(f"cache_len must be an int or a () or (B,) tensor, "
                         f"got {getattr(cache_len, 'shape', cache_len)!r}")
    if cache_len.device != device:
        raise ValueError(f"cache_len lies on {cache_len.device}, the "
                         f"operands on {device}")
    return cache_len.to(torch.int32).reshape(-1).expand(b).contiguous()


# ---------------------------------------------------------------------------
# Plain version (float32 math; a row with no valid key gives 0)
# ---------------------------------------------------------------------------


def decode_attention_plain(q, k_cache, v_cache, cache_len, *,
                           window: Optional[int] = None,
                           return_lse: bool = False):
    b, hq, d = q.shape
    _, hkv, smax, _ = k_cache.shape
    scale = d ** -0.5
    qf = q.float().reshape(b, hkv, hq // hkv, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qf, k_cache.float()) * scale
    lens = lengths(cache_len, b, q.device).reshape(b, 1)
    kpos = torch.arange(smax, device=q.device)[None]
    valid = kpos < lens
    if window is not None:
        valid &= kpos >= lens - window
    s.masked_fill_(~valid[:, None, None], -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = s.sub_(m).exp_()
    l = p.sum(dim=-1, keepdim=True)
    lse = torch.where(l == 0, -torch.inf, m + torch.log(l))
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float()) / l
    out = out.reshape(b, hq, d).to(q.dtype)
    return (out, lse.reshape(b, hq)) if return_lse else out


def valid_keys(cache_len, smax: int, window: Optional[int]) -> int:
    """The keys a row reads: below the length (up to the capacity) and,
    with a window, at or above length - window. From a host int; a tensor
    of lengths is not read (it may lie on the card), and counts the whole
    capacity."""
    if not isinstance(cache_len, int):
        return smax
    hi = min(max(cache_len, 0), smax)
    lo = min(max(cache_len - window, 0), hi) if window else 0
    return hi - lo


def decode_attention_cost(q, k_cache, v_cache, cache_len, *,
                          window: Optional[int] = None,
                          return_lse: bool = False):
    """(flops, bytes) of one call, from the shapes and the host lengths:
    4 D a query head and valid key; q, the valid K and V rows, the output
    (and the lse) each moved once (PERF.md's bound of the kernel)."""
    b, hq, d = q.shape
    _, hkv, smax, _ = k_cache.shape
    keys = valid_keys(cache_len, smax, window)
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * b * hkv * keys * d * k_cache.element_size()
              + (4 * b * hq if return_lse else 0))
    return 4.0 * b * hq * keys * d, float(nbytes)


# ---------------------------------------------------------------------------
# Wrapper: the kernel on CUDA tensors, the plain version on CPU ones
# ---------------------------------------------------------------------------


@common.counted(cost=decode_attention_cost)
def decode_attention(q, k_cache, v_cache, cache_len, *,
                     window: Optional[int] = None, return_lse: bool = False):
    """q: (B, Hq, D) contiguous; caches: (B, Hkv, Smax, D), any strides
    over (B, H, S) and unit stride over D; cache_len: an int, or a () or
    (B,) int32 tensor on the operands' device -> (B, Hq, D), or with
    `return_lse` (that, the rows' (B, Hq) float32 log-sum-exp). On `meta`
    tensors (the cost counter's stand-ins) the results' shapes alone."""
    b, hq, hkv, smax, d = check_operands(q, k_cache, v_cache, window)
    if common.on_meta(q, k_cache, v_cache):
        out = torch.empty((b, hq, d), dtype=q.dtype, device="meta")
        return ((out, torch.empty((b, hq), device="meta")) if return_lse
                else out)
    if not common.on_card(q, k_cache, v_cache):
        decode_attention.plain_calls += 1
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      window=window, return_lse=return_lse)
    if not q.is_contiguous():
        raise ValueError("decode attention takes a contiguous q")
    lens = lengths(cache_len, b, q.device)
    route = decode_route(q, k_cache, v_cache)
    splits = decode_plan(b, hkv, smax, TILE_KEYS[route],
                         common.sm_count(q.device))
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    wm = wl = wacc = counters = 0
    if splits > 1:    # one scratch: m, l (splits, B, Hq), acc, tickets
        rows = splits * b * hq
        groups = b * hkv * common.cdiv(hq // hkv, HEADS_PER_BLOCK[route])
        work = torch.empty(rows * (d + 2) + groups, dtype=torch.float32,
                           device=q.device)
        wm = work.data_ptr()
        wl, wacc = wm + 4 * rows, wm + 8 * rows
        counters = wacc + 4 * rows * d
    cuda.launch("decode_attention", f"repro_decode_attention_{route}", q,
                cuda.ptr(q), cuda.ptr(k_cache), cuda.ptr(v_cache),
                cuda.ptr(lens), cuda.ptr(out),
                cuda.ptr(lse), wm, wl, wacc, counters,
                b, hq,
                hkv, smax, d, *tma_strides(k_cache), *tma_strides(v_cache),
                window or 0, d ** -0.5, splits)
    decode_attention.launches += 1
    decode_attention.route_launches[route] += 1
    if return_lse:
        decode_attention.lse_launches += 1
        return out, lse
    return out


decode_attention.route_launches = dict.fromkeys(ROUTES, 0)
decode_attention.lse_launches = 0
