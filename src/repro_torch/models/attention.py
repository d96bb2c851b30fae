"""Model-stack attention, the port of `repro/models/attention.py`.

The reference computes the model's attention in plain jnp: prefill
through `chunked_attention`, "the XLA-differentiable twin of the Pallas
flash kernel", and decode through `decode_attention_full` or, under a
sliding window, `decode_attention_ring`. For a GQA model each computes
the same function as one of the Pallas kernels, so here they are those
kernels' ports:

* `chunked_attention(q, k, v, causal=, window=)` is `mha(q, k, v,
  causal=, window=)` (`kernels/attention.py`, CUDA C++ on the card). The
  reference takes one of two branches, its banded sliding-window walk
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

On CPU tensors these run the kernels' plain versions. MLA (and with it
a value width other than the query's) raises NotImplementedError naming
its ROADMAP item.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.attention import mha
from ..kernels.decode_attention import decode_attention

MLA_ITEM = "ROADMAP Queue 1, item 14.3 (MLA)"


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D).

    GQA without repeating heads; positions aligned at the sequence end
    (query i is at absolute position Skv - Sq + i)."""
    if v.shape[-1] != q.shape[-1]:
        raise NotImplementedError(
            f"attention with a value width other than the query's (dv "
            f"{v.shape[-1]} != d {q.shape[-1]}) is {MLA_ITEM}")
    return mha(q, k, v, causal=causal, window=window)


def decode_attention_full(q, k_cache, v_cache, pos: int, *,
                          cache_len: Optional[torch.Tensor] = None):
    """One-token decode over a preallocated full cache.

    q: (B, Hq, D); k_cache/v_cache: (B, S, Hkv, D); pos: the host int
    position of this token, entries [0, pos] valid (its K/V already
    written at index pos). `cache_len`, when given, is a (B,) int32
    tensor on q's device holding pos + 1, which the caller advances in
    place from step to step; without it the lengths are filled on the
    device from pos."""
    k = k_cache.permute(0, 2, 1, 3)       # strided (B, Hkv, S, D) views
    v = v_cache.permute(0, 2, 1, 3)
    return decode_attention(q, k, v, pos + 1 if cache_len is None
                            else cache_len)


def decode_attention_ring(q, k_ring, v_ring, pos: int, *,
                          window: Optional[int],
                          ring_len: Optional[torch.Tensor] = None):
    """One-token decode over a ring-buffer sliding-window cache.

    q: (B, Hq, D); k_ring/v_ring: (B, W, Hkv, D) with W <= window, the
    new token's K/V already written at slot pos % W; pos: the host int
    position of this token. `ring_len`, when given, is a (B,) int32
    tensor on q's device holding min(pos + 1, W) (the caller clamps its
    device lengths once per step); without it the count is filled on
    the device from pos. With no window, a ring of W > pos slots is the
    full cache and this is `decode_attention_full`."""
    w = k_ring.shape[1]
    if window is not None and w > window:
        raise ValueError(f"a ring of {w} slots is longer than the window "
                         f"{window}: it would keep keys outside it")
    k = k_ring.permute(0, 2, 1, 3)        # strided (B, Hkv, W, D) views
    v = v_ring.permute(0, 2, 1, 3)
    return decode_attention(q, k, v, min(pos + 1, w) if ring_len is None
                            else ring_len)


def decode_attention_mla(q_lat, q_rope, ckv_cache, krope_cache, pos, *,
                         scale):
    """Absorbed-MLA decode in the latent space: not ported yet."""
    raise NotImplementedError(f"absorbed-MLA decode attention is {MLA_ITEM}")
