"""The decoder model of the serve path, the port of `repro/models/model.py`.

Ported: the `attn` and `attn_moe` segments with GQA attention, full or
over a sliding window, a dense GLU FFN or the MoE FFN of `models/moe.py`
(routed experts, shared experts), token inputs, a tied or separate LM
head. That covers llama3-8b, starcoder2-3b, mixtral-8x22b,
deepseek-moe-16b and h2o-danube-3-4b. MLA, the SSM, xLSTM and hybrid
blocks and embedding inputs raise NotImplementedError naming their
ROADMAP item (`check_ported`).

The reference's parameter pytree (layers stacked per segment, scanned
with `jax.lax.scan`) becomes a `Model` module with one `AttnBlock` per
layer in an `nn.ModuleList`, walked by a Python loop; its device and
dtype are explicit. Each block keeps the reference's parameter names in
an `nn.ParameterDict` (`block.p["wq"]`, ...), the router in float32
whatever the model's dtype. The decode cache keeps the reference's
layout, one dict per segment of stacked (count, B, W, Hkv, D) rings,
and is written in place: position p lives in slot p % W, W =
min(max_len, window) under a sliding window and max_len without one
(then slot p is p, the reference's full cache).

Entry points (the reference's, with `params` the `Model`):
  init_params(cfg, seed, device=, dtype=)        Model
  forward_logits(params, cfg, inputs)            (B, S, V) logits
  init_cache(cfg, batch, max_len, device=)       decode cache
  prefill(params, cfg, inputs, max_len)          logits, cache, pos
  decode_step(params, cfg, inp_t, cache, pos)    logits, cache
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels import common
from .attention import MLA_ITEM, chunked_attention, decode_attention_ring
from .layers import (dense, embed_lookup, glu_ffn, init_dense, rmsnorm,
                     rope_angles, rotate)
from .moe import moe_ffn

SSM_ITEM = "ROADMAP Queue 1, item 14.4 (hybrid, SSM and xLSTM blocks)"
EMBED_ITEM = "ROADMAP Queue 1, item 14.5 (embedding inputs)"


def check_ported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for a config
    this slice does not run."""
    for kind, _count in cfg.segments:
        if kind in ("mlstm", "slstm", "hybrid"):
            raise NotImplementedError(f"{cfg.name}: {kind} blocks are "
                                      f"{SSM_ITEM}")
        if kind not in ("attn", "attn_moe"):
            raise ValueError(kind)
        if kind == "attn_moe" and cfg.moe is None:
            raise ValueError(f"{cfg.name}: attn_moe blocks need cfg.moe")
    if cfg.attn_kind == "mla":
        raise NotImplementedError(f"{cfg.name}: MLA attention is {MLA_ITEM}")
    if cfg.input_mode != "tokens":
        raise NotImplementedError(f"{cfg.name}: embedding inputs are "
                                  f"{EMBED_ITEM}")


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def block_shapes(cfg: ArchConfig, kind: str = "attn"):
    """Parameter names and shapes of one block of a segment of `kind`
    ("attn": a dense FFN; "attn_moe": routed and, where the config has
    them, shared experts), in the reference's order
    (`_init_attn_block`)."""
    d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    shapes = {"attn_norm": (d,), "mlp_norm": (d,),
              "wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    if kind == "attn_moe":
        mo = cfg.moe
        e, de = mo.n_experts, mo.d_expert
        shapes.update(router=(d, e), we_gate=(e, d, de), we_up=(e, d, de),
                      we_down=(e, de, d))
        if mo.n_shared_experts:
            ds = mo.d_shared
            shapes.update(ws_gate=(d, ds), ws_up=(d, ds), ws_down=(ds, d))
    else:
        shapes.update(w_gate=(d, f), w_up=(d, f), w_down=(f, d))
    return shapes


def _param(shape, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class AttnBlock(nn.Module):
    """One `attn` or `attn_moe` block: pre-norm GQA attention and a dense
    GLU FFN or the MoE FFN."""

    def __init__(self, cfg: ArchConfig, kind: str, *, device, dtype):
        super().__init__()
        # the router stays in float32 whatever the model's dtype, as in
        # the reference
        self.p = nn.ParameterDict({
            name: _param(shape, device,
                         torch.float32 if name == "router" else dtype)
            for name, shape in block_shapes(cfg, kind).items()})


class Model(nn.Module):
    """The decoder's parameters (uninitialised: see `init_params` and
    `convert.params_from_numpy`)."""

    def __init__(self, cfg: ArchConfig, *, device, dtype=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        dtype = dtype or torch_dtype(cfg.dtype)
        d = cfg.d_model
        self.embed = _param((cfg.vocab_size, d), device, dtype)
        self.blocks = nn.ModuleList(
            AttnBlock(cfg, kind, device=device, dtype=dtype)
            for kind, count in cfg.segments for _ in range(count))
        self.final_norm = _param((d,), device, dtype)
        self.lm_head = (None if cfg.tie_embeddings
                        else _param((d, cfg.vocab_size), device, dtype))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def segment_blocks(self):
        """(kind, blocks of that segment) in order."""
        i = 0
        for kind, count in self.cfg.segments:
            yield kind, list(self.blocks[i:i + count])
            i += count


@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0, *, device=None,
                dtype=None) -> Model:
    """Random parameters from a seeded generator on the device: norms 1,
    projections normal * fan_in**-0.5 (the experts' too: d**-0.5 for
    their inputs, d_expert**-0.5 for `we_down`), the embedding normal *
    0.02. (The draws are torch's, not jax.random's: tests that compare
    the two packages hand both the same numpy weights.)"""
    dev = common.resolve_device(device)
    model = Model(cfg, device=dev, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model.embed.copy_(init_dense(gen, model.embed.shape, scale=0.02))
    for block in model.blocks:
        for name, t in block.p.items():
            if name.endswith("_norm"):
                t.fill_(1.0)
            else:
                t.copy_(init_dense(gen, t.shape))
    model.final_norm.fill_(1.0)
    if model.lm_head is not None:
        model.lm_head.copy_(init_dense(gen, model.lm_head.shape))
    return model


# ---------------------------------------------------------------------------
# Sequence forward
# ---------------------------------------------------------------------------


def _gqa_qkv(p, h, cfg: ArchConfig, cos, sin):
    b, s, _ = h.shape
    hd = cfg.head_dim
    q = dense(h, p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = dense(h, p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = dense(h, p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    q = rotate(q.transpose(1, 2), cos, sin)
    k = rotate(k.transpose(1, 2), cos, sin)
    return q, k, v.transpose(1, 2)


def _ffn(p, h2, cfg: ArchConfig, kind: str, decode: bool = False):
    """The block's FFN on (..., d): dense, or the MoE FFN over the
    flattened tokens, whose capacity factor a decode step raises to at
    least 4 (as the reference does)."""
    if kind != "attn_moe":
        return glu_ffn(p, h2, act=cfg.act)
    mo, d = cfg.moe, h2.shape[-1]
    cf = max(4.0, mo.capacity_factor) if decode else mo.capacity_factor
    return moe_ffn(p, h2.reshape(-1, d), n_experts=mo.n_experts,
                   top_k=mo.top_k, capacity_factor=cf,
                   act=cfg.act).reshape(h2.shape)


def _ring_from_full(ring, full) -> None:
    """Write the last W positions of full (B, S, ...) into ring (B, W,
    ...) at slots p % W: positions [S - W, S - r) go to slots [r, W) and
    [S - r, S) to [0, r), r = S % W. With S < W, positions [0, S) go to
    slots [0, S) and the rest stays as it is (zeros from `init_cache`)."""
    s, w = full.shape[1], ring.shape[1]
    if s < w:
        ring[:, :s] = full
        return
    r = s % w
    ring[:, r:] = full[:, s - w:s - r]
    ring[:, :r] = full[:, s - r:]


def _attn_block_fwd(p, x, cfg: ArchConfig, cos, sin, kind: str,
                    cache=None):
    """x: (B, S, d). With `cache` (this layer's (B, W, Hkv, D) K and V
    rings, see `init_cache`), the rotated keys and the values go to the
    ring's slots."""
    b, s, _ = x.shape
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = _gqa_qkv(p, h, cfg, cos, sin)
    attn = chunked_attention(q, k, v, causal=True, window=cfg.window)
    attn = attn.transpose(1, 2).reshape(b, s, -1)
    if cache is not None:
        for dst, src in zip(cache, (k, v)):
            _ring_from_full(dst, src.transpose(1, 2))
    x = x + dense(attn, p["wo"])
    h2 = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + _ffn(p, h2, cfg, kind)


def _embed_inputs(params: Model, cfg: ArchConfig, inputs):
    return embed_lookup(params.embed, inputs)


def _unembed(params: Model, cfg: ArchConfig, h):
    if params.lm_head is not None:
        return dense(h, params.lm_head)
    return dense(h, params.embed.t())


@torch.no_grad()
def forward_hidden(params: Model, cfg: ArchConfig, inputs, *,
                   want_cache: bool = False,
                   max_len: Optional[int] = None):
    """inputs: (B, S) token ids -> final-normed hidden states (B, S, d);
    with `want_cache`, also the decode cache of `max_len` (default S)
    positions holding the prompt's K and V."""
    b, s = inputs.shape
    x = _embed_inputs(params, cfg, inputs)
    cos, sin = rope_angles(torch.arange(s, device=x.device), cfg.head_dim,
                           cfg.rope_theta)
    caches = (init_cache(cfg, b, max_len or s, dtype=x.dtype,
                         device=x.device) if want_cache else None)
    for si, (kind, blocks) in enumerate(params.segment_blocks()):
        for li, block in enumerate(blocks):
            layer_cache = ((caches[si]["k"][li], caches[si]["v"][li])
                           if want_cache else None)
            x = _attn_block_fwd(block.p, x, cfg, cos, sin, kind,
                                layer_cache)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    return (x, caches) if want_cache else x


def forward_logits(params: Model, cfg: ArchConfig, inputs):
    return _unembed(params, cfg, forward_hidden(params, cfg, inputs))


# ---------------------------------------------------------------------------
# Decode (serve) path
# ---------------------------------------------------------------------------


def _swa_cache_len(cfg: ArchConfig, max_len: int) -> int:
    """The ring's W: the positions the attention cache holds. Without a
    window W = max_len, and the ring is the full cache (slot p % W is p)."""
    return min(max_len, cfg.window) if cfg.window else max_len


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, dtype=None,
               device=None) -> List[dict]:
    """Preallocated decode cache (zeros): per segment {"k", "v"} rings of
    shape (count, B, W, Hkv, D), W = `_swa_cache_len(cfg, max_len)`."""
    check_ported(cfg)
    dev = common.resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    shape = (batch, _swa_cache_len(cfg, max_len), cfg.n_kv_heads,
             cfg.head_dim)
    return [{"k": torch.zeros((count, *shape), dtype=dtype, device=dev),
             "v": torch.zeros((count, *shape), dtype=dtype, device=dev)}
            for _kind, count in cfg.segments]


def _write_at(cache_arr, val, idx: int) -> None:
    """cache_arr: (B, S, ...); val: (B, ...) -> written at [:, idx], in
    place (the reference returns an updated copy)."""
    cache_arr[:, idx] = val


def _attn_block_step(p, x, k_cache, v_cache, pos: int, cfg: ArchConfig,
                     cos, sin, kind: str, cache_len=None):
    """One token's block: the caches are rings written at slot pos % W,
    and `cache_len`, when given, holds min(pos + 1, W)."""
    b, _ = x.shape
    hd = cfg.head_dim
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    q = dense(h, p["wq"]).reshape(b, cfg.n_heads, hd)
    k_t = dense(h, p["wk"]).reshape(b, cfg.n_kv_heads, hd)
    v_t = dense(h, p["wv"]).reshape(b, cfg.n_kv_heads, hd)
    q = rotate(q, cos, sin)
    k_t = rotate(k_t, cos, sin)
    slot = pos % k_cache.shape[1]
    _write_at(k_cache, k_t, slot)
    _write_at(v_cache, v_t, slot)
    attn = decode_attention_ring(q, k_cache, v_cache, pos,
                                 window=cfg.window, ring_len=cache_len)
    x = x + dense(attn.reshape(b, cfg.n_heads * hd), p["wo"])
    h2 = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + _ffn(p, h2, cfg, kind, decode=True)


@torch.no_grad()
def decode_step(params: Model, cfg: ArchConfig, inputs_t, caches, pos: int,
                *, cache_len: Optional[torch.Tensor] = None):
    """One decoding step.

    inputs_t: (B,) token ids; caches: from init_cache/prefill, written in
    place at slot pos % W of each ring; pos: the host int position of
    this token. `cache_len`, optional, is a (B,) int32 tensor on the
    device equal to pos + 1; once pos + 1 passes W it is clamped to W on
    the device, once per step. Returns (logits (B, V), caches)."""
    x = embed_lookup(params.embed, inputs_t)
    position = torch.full((1,), pos, dtype=torch.float32, device=x.device)
    cos, sin = rope_angles(position, cfg.head_dim, cfg.rope_theta)
    w = caches[0]["k"].shape[2]
    if pos >= w and not cfg.window:
        raise ValueError(f"position {pos} is past the cache of {w}")
    if cache_len is not None and pos >= w:
        cache_len = cache_len.clamp(max=w)
    for si, (kind, blocks) in enumerate(params.segment_blocks()):
        for li, block in enumerate(blocks):
            x = _attn_block_step(block.p, x, caches[si]["k"][li],
                                 caches[si]["v"][li], pos, cfg, cos, sin,
                                 kind, cache_len)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    return _unembed(params, cfg, x), caches


@torch.no_grad()
def prefill(params: Model, cfg: ArchConfig, inputs, max_len: int):
    """Process a full prompt; return (last-token logits (B, V), decode
    caches of W = `_swa_cache_len(cfg, max_len)` ring slots, pos = S as
    a host int). inputs: (B, S) token ids."""
    s = inputs.shape[1]
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    h, caches = forward_hidden(params, cfg, inputs, want_cache=True,
                               max_len=max_len)
    return _unembed(params, cfg, h[:, -1]), caches, s
