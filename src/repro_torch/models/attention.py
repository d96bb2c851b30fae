"""Model-stack attention, the port of `repro/models/attention.py`.

The reference computes the model's attention in plain jnp: prefill
through `chunked_attention`, "the XLA-differentiable twin of the Pallas
flash kernel", and decode through `decode_attention_full`. For a GQA,
causal, unwindowed model each computes the same function as one of the
Pallas kernels, so here they are those kernels' ports:

* `chunked_attention(q, k, v, causal=True)` is `mha(q, k, v,
  causal=True)` (`kernels/attention.py`, CUDA C++ on the card);
* `decode_attention_full(q, K, V, pos)` is `decode_attention(q, K', V',
  pos + 1)` with K' the (B, Hkv, S, D) view of the (B, S, Hkv, D) cache
  (`kernels/decode_attention.py`).

On CPU tensors both run their kernels' plain versions. The paths this
slice does not port raise NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.attention import mha
from ..kernels.decode_attention import decode_attention

SWA_ITEM = ("ROADMAP Queue 1, item 14.1 (SWA: ring-buffer decode and "
            "banded prefill)")
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
    if window is not None:
        raise NotImplementedError(
            f"windowed (SWA) prefill attention is {SWA_ITEM}")
    return mha(q, k, v, causal=causal)


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


def decode_attention_ring(q, k_ring, v_ring, pos, *, window, scale=None):
    """One-token decode over a ring-buffer SWA cache: not ported yet."""
    raise NotImplementedError(f"ring-buffer (SWA) decode attention is "
                              f"{SWA_ITEM}")


def decode_attention_mla(q_lat, q_rope, ckv_cache, krope_cache, pos, *,
                         scale):
    """Absorbed-MLA decode in the latent space: not ported yet."""
    raise NotImplementedError(f"absorbed-MLA decode attention is {MLA_ITEM}")
