"""The decoder model of the serve path, the port of `repro/models/model.py`.

Ported: the `attn` segment with GQA attention (no window) and a dense
GLU FFN, token inputs, a tied or separate LM head. That covers
llama3-8b and starcoder2-3b. Every other segment kind, MLA, MoE, a
sliding window and embedding inputs raise NotImplementedError naming
their ROADMAP item (`check_ported`).

The reference's parameter pytree (layers stacked per segment, scanned
with `jax.lax.scan`) becomes a `Model` module with one `AttnBlock` per
layer in an `nn.ModuleList`, walked by a Python loop; its device and
dtype are explicit. Each block keeps the reference's parameter names in
an `nn.ParameterDict` (`block.p["wq"]`, ...). The decode cache keeps the
reference's layout, one dict per segment of stacked (count, B, S, Hkv,
D) tensors, and is written in place.

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
from .attention import (MLA_ITEM, SWA_ITEM, chunked_attention,
                        decode_attention_full)
from .layers import (dense, embed_lookup, glu_ffn, init_dense, rmsnorm,
                     rope_angles, rotate)

MOE_ITEM = "ROADMAP Queue 1, item 14.2 (MoE)"
SSM_ITEM = "ROADMAP Queue 1, item 14.4 (hybrid, SSM and xLSTM blocks)"
EMBED_ITEM = "ROADMAP Queue 1, item 14.5 (embedding inputs)"


def check_ported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for a config
    this slice does not run."""
    for kind, _count in cfg.segments:
        if kind == "attn_moe" or cfg.moe is not None:
            raise NotImplementedError(f"{cfg.name}: MoE blocks are "
                                      f"{MOE_ITEM}")
        if kind in ("mlstm", "slstm", "hybrid"):
            raise NotImplementedError(f"{cfg.name}: {kind} blocks are "
                                      f"{SSM_ITEM}")
        if kind != "attn":
            raise ValueError(kind)
    if cfg.attn_kind == "mla":
        raise NotImplementedError(f"{cfg.name}: MLA attention is {MLA_ITEM}")
    if cfg.window:
        raise NotImplementedError(f"{cfg.name}: sliding-window attention is "
                                  f"{SWA_ITEM}")
    if cfg.input_mode != "tokens":
        raise NotImplementedError(f"{cfg.name}: embedding inputs are "
                                  f"{EMBED_ITEM}")


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def block_shapes(cfg: ArchConfig):
    """Parameter names and shapes of one `attn` block, in the
    reference's order (`_init_attn_block`)."""
    d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    return {"attn_norm": (d,), "mlp_norm": (d,),
            "wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
            "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d),
            "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def _param(shape, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class AttnBlock(nn.Module):
    """One `attn` block: pre-norm GQA attention and a dense GLU FFN."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        super().__init__()
        self.p = nn.ParameterDict({
            name: _param(shape, device, dtype)
            for name, shape in block_shapes(cfg).items()})


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
            AttnBlock(cfg, device=device, dtype=dtype)
            for _ in range(cfg.n_layers))
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
    projections normal * fan_in**-0.5, the embedding normal * 0.02. (The
    draws are torch's, not jax.random's: tests that compare the two
    packages hand both the same numpy weights.)"""
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


def _attn_block_fwd(p, x, cfg: ArchConfig, cos, sin, cache=None):
    """x: (B, S, d). With `cache` ((B, S_max, Hkv, D) K and V of this
    layer), the rotated keys and the values go to its first S rows."""
    b, s, _ = x.shape
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = _gqa_qkv(p, h, cfg, cos, sin)
    attn = chunked_attention(q, k, v, causal=True, window=cfg.window)
    attn = attn.transpose(1, 2).reshape(b, s, -1)
    if cache is not None:
        cache[0][:, :s] = k.transpose(1, 2)
        cache[1][:, :s] = v.transpose(1, 2)
    x = x + dense(attn, p["wo"])
    h2 = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + glu_ffn(p, h2, act=cfg.act)


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
    for si, (_kind, blocks) in enumerate(params.segment_blocks()):
        for li, block in enumerate(blocks):
            layer_cache = ((caches[si]["k"][li], caches[si]["v"][li])
                           if want_cache else None)
            x = _attn_block_fwd(block.p, x, cfg, cos, sin, layer_cache)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    return (x, caches) if want_cache else x


def forward_logits(params: Model, cfg: ArchConfig, inputs):
    return _unembed(params, cfg, forward_hidden(params, cfg, inputs))


# ---------------------------------------------------------------------------
# Decode (serve) path
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, dtype=None,
               device=None) -> List[dict]:
    """Preallocated decode cache (zeros): per segment {"k", "v"} of shape
    (count, B, max_len, Hkv, D)."""
    check_ported(cfg)
    dev = common.resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros((count, *shape), dtype=dtype, device=dev),
             "v": torch.zeros((count, *shape), dtype=dtype, device=dev)}
            for _kind, count in cfg.segments]


def _write_at(cache_arr, val, idx: int) -> None:
    """cache_arr: (B, S, ...); val: (B, ...) -> written at [:, idx], in
    place (the reference returns an updated copy)."""
    cache_arr[:, idx] = val


def _attn_block_step(p, x, k_cache, v_cache, pos: int, cfg: ArchConfig,
                     cos, sin, cache_len=None):
    b, _ = x.shape
    hd = cfg.head_dim
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    q = dense(h, p["wq"]).reshape(b, cfg.n_heads, hd)
    k_t = dense(h, p["wk"]).reshape(b, cfg.n_kv_heads, hd)
    v_t = dense(h, p["wv"]).reshape(b, cfg.n_kv_heads, hd)
    q = rotate(q, cos, sin)
    k_t = rotate(k_t, cos, sin)
    _write_at(k_cache, k_t, pos)
    _write_at(v_cache, v_t, pos)
    attn = decode_attention_full(q, k_cache, v_cache, pos,
                                 cache_len=cache_len)
    x = x + dense(attn.reshape(b, cfg.n_heads * hd), p["wo"])
    h2 = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + glu_ffn(p, h2, act=cfg.act)


@torch.no_grad()
def decode_step(params: Model, cfg: ArchConfig, inputs_t, caches, pos: int,
                *, cache_len: Optional[torch.Tensor] = None):
    """One decoding step.

    inputs_t: (B,) token ids; caches: from init_cache/prefill, written in
    place at `pos`; pos: the host int position of this token.
    `cache_len`, optional, is a (B,) int32 tensor on the device equal to
    pos + 1 (see `decode_attention_full`). Returns (logits (B, V),
    caches)."""
    x = embed_lookup(params.embed, inputs_t)
    position = torch.full((1,), pos, dtype=torch.float32, device=x.device)
    cos, sin = rope_angles(position, cfg.head_dim, cfg.rope_theta)
    for si, (_kind, blocks) in enumerate(params.segment_blocks()):
        for li, block in enumerate(blocks):
            x = _attn_block_step(block.p, x, caches[si]["k"][li],
                                 caches[si]["v"][li], pos, cfg, cos, sin,
                                 cache_len)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    return _unembed(params, cfg, x), caches


@torch.no_grad()
def prefill(params: Model, cfg: ArchConfig, inputs, max_len: int):
    """Process a full prompt; return (last-token logits (B, V), decode
    caches of max_len positions, pos = S as a host int). inputs: (B, S)
    token ids."""
    s = inputs.shape[1]
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    h, caches = forward_hidden(params, cfg, inputs, want_cache=True,
                               max_len=max_len)
    return _unembed(params, cfg, h[:, -1]), caches, s
