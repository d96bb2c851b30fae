"""Model-stack attention, the port of `repro/models/attention.py`.

The reference computes the model's attention in plain jnp: prefill
through `chunked_attention`, "the XLA-differentiable twin of the Pallas
flash kernel", and decode through `decode_attention_full` or, under a
sliding window, `decode_attention_ring`, or for MLA through
`decode_attention_mla`. The first three compute the same function as
one of the Pallas kernels, so here they are those kernels' ports:

* `chunked_attention(q, k, v, causal=, window=)` is `mha(q, k, v,
  causal=, window=)` (`kernels/attention.py`, CUDA C++ on the card),
  with v at a width of its own where MLA gives it one. The reference
  takes one of two branches, its banded sliding-window walk
  (`_banded_swa_attention`, when window < Skv // 2) or its masked chunks;
  both are this one function, and the kernel skips the key tiles that
  the window leaves out;
* `decode_attention_full(q, K, V, pos)` is `decode_attention(q, K', V',
  pos + 1)` with K' the (B, Hkv, S, D) view of the (B, S, Hkv, D) cache
  (`kernels/decode_attention.py`);
* `decode_attention_ring(q, K, V, pos)` over a (B, W, Hkv, D) ring is
  `decode_attention(q, K', V', min(pos + 1, W))`: slot j holds position
  pos - ((pos - j) mod W), valid iff that is >= 0, so the valid slots
  are [0, pos] before the ring wraps and all W after; the keys carry
  their RoPE already, and a softmax does not depend on the slots'
  order.

On CPU tensors these run the kernels' plain versions.
`decode_attention_mla`, the absorbed MLA decode in the latent space, is
plain einsum in the reference with no Pallas kernel behind it, and is
torch ops here.

On a mesh the decode caches' sequence dimension is split over "model"
(`sharding.cache_specs`, the reference's context parallelism). Given the
`offset` of this rank's block (its first position, or ring slot), each of
the three decode functions attends over the block alone and returns
(out, lse): the partial output and its rows' log-sum-exp of the scaled
scores (-inf, with out 0, where the block holds no valid key).
`combine_partials` then folds every "model" rank's partial into the
whole attention, the same bits on every rank.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.distributed import live, partials
from ..kernels.attention import mha
from ..kernels.decode_attention import decode_attention

def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None):
    """q: (B, Hq, Sq, d); k: (B, Hkv, Skv, d); v: (B, Hkv, Skv, dv) ->
    (B, Hq, Sq, dv) (MLA has dv != d; the scale is d ** -0.5).

    GQA without repeating heads; positions aligned at the sequence end
    (query i is at absolute position Skv - Sq + i)."""
    return mha(q, k, v, causal=causal, window=window)


def _block_len(length, offset: int):
    """A block's valid length from the whole cache's: the length less the
    block's offset, clamped at 0 (the kernel reads no further than the
    block holds)."""
    if isinstance(length, int):
        return max(length - offset, 0)
    return (length - offset).clamp(min=0)


def decode_attention_full(q, k_cache, v_cache, pos: int, *,
                          cache_len: Optional[torch.Tensor] = None,
                          offset: Optional[int] = None):
    """One-token decode over a preallocated full cache.

    q: (B, Hq, D); k_cache/v_cache: (B, S, Hkv, D); pos: the host int
    position of this token, entries [0, pos] valid (its K/V already
    written at index pos). `cache_len`, when given, is a (B,) int32
    tensor on q's device holding pos + 1, which the caller advances in
    place from step to step; without it the lengths are filled on the
    device from pos.

    With `offset`, the cache is the block of positions [offset, offset +
    S) of a longer one: returns (out, lse) over the block (see the
    module's docstring)."""
    k = k_cache.permute(0, 2, 1, 3)       # strided (B, Hkv, S, D) views
    v = v_cache.permute(0, 2, 1, 3)
    length = pos + 1 if cache_len is None else cache_len
    if offset is None:
        return decode_attention(q, k, v, length)
    return decode_attention(q, k, v, _block_len(length, offset),
                            return_lse=True)


def decode_attention_ring(q, k_ring, v_ring, pos: int, *,
                          window: Optional[int],
                          ring_len: Optional[torch.Tensor] = None,
                          offset: Optional[int] = None,
                          slots: Optional[int] = None):
    """One-token decode over a ring-buffer sliding-window cache.

    q: (B, Hq, D); k_ring/v_ring: (B, W, Hkv, D) with W <= window, the
    new token's K/V already written at slot pos % W; pos: the host int
    position of this token. `ring_len`, when given, is a (B,) int32
    tensor on q's device holding min(pos + 1, W) (the caller clamps its
    device lengths once per step); without it the count is filled on
    the device from pos. With no window, a ring of W > pos slots is the
    full cache and this is `decode_attention_full`.

    With `offset`, the ring is the block of slots [offset, offset + W) of
    a ring of `slots` slots: the valid slots of the whole are the prefix
    [0, min(pos + 1, slots)); returns (out, lse) over the block."""
    w = k_ring.shape[1] if slots is None else slots
    if window is not None and w > window:
        raise ValueError(f"a ring of {w} slots is longer than the window "
                         f"{window}: it would keep keys outside it")
    k = k_ring.permute(0, 2, 1, 3)        # strided (B, Hkv, W, D) views
    v = v_ring.permute(0, 2, 1, 3)
    length = min(pos + 1, w) if ring_len is None else ring_len
    if offset is None:
        return decode_attention(q, k, v, length)
    return decode_attention(q, k, v, _block_len(length, offset),
                            return_lse=True)


def decode_attention_mla(q_lat, q_rope, ckv_cache, krope_cache, pos: int,
                         *, scale: float, offset: Optional[int] = None):
    """Absorbed-MLA decode: attention in the latent space.

    q_lat: (B, H, R), q_nope absorbed through W_uk (float32); q_rope:
    (B, H, Dr), the query's rotary part; ckv_cache: (B, S, R) and
    krope_cache: (B, S, Dr), shared across heads; pos: the host int
    position of this token, entries [0, pos] valid (its own already
    written at pos). Returns the latent context (B, H, R) in float32
    (W_uv expands it outside).

    The reference's steps: both query parts rounded to the caches'
    dtype, scores and softmax in float32, the probabilities rounded to
    the cache's dtype for the product with it, which sums in float32.
    Its mask of the entries past pos is a slice here: they weigh exactly
    0 there.

    With `offset`, the caches are the block of positions [offset, offset
    + S) of longer ones: returns (the block's latent context, lse), the
    probabilities normalised over the block and rounded as above."""
    n = pos + 1 if offset is None else min(max(pos + 1 - offset, 0),
                                           ckv_cache.shape[1])
    ckv = ckv_cache[:, :n].float()
    krope = krope_cache[:, :n].float()
    s = (torch.einsum("bhr,bsr->bhs",
                      q_lat.to(ckv_cache.dtype).float(), ckv)
         + torch.einsum("bhd,bsd->bhs",
                        q_rope.to(krope_cache.dtype).float(), krope)) * scale
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", p.to(ckv_cache.dtype).float(), ckv)
    if offset is None:
        return ctx
    return ctx, torch.logsumexp(s, dim=-1)


def combine_partials(mesh, out, lse):
    """The whole attention from every rank's partial over its block of
    the cache: out (B, H, D) and lse (B, H) float32 of each rank over
    "model", gathered (one all-gather) and folded in rank order in
    float32, each weighted by exp(lse_r - max_r lse_r), so every rank
    gets the same bits. Over one rank, its partial itself."""
    if not live(mesh, "model"):
        return out
    parts = partials(mesh, torch.cat([out.float(), lse[..., None]], dim=-1),
                     "model", "all-gather")
    lses = parts[..., -1]
    top = lses.amax(dim=0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    num = den = None
    for r in range(parts.shape[0]):
        w = torch.exp(lses[r] - top)
        term = parts[r, ..., :-1] * w[..., None]
        num = term if num is None else num + term
        den = w if den is None else den + w
    den = torch.where(den == 0, torch.ones_like(den), den)
    return (num / den[..., None]).to(out.dtype)
