"""The decoder model of the serve path, the port of `repro/models/model.py`.

Ported: the `attn` and `attn_moe` segments with GQA attention, full or
over a sliding window, or MLA (multi-head latent attention: low-rank
query and key-value projections, a latent decode cache, the absorbed
decode in the latent space), a dense GLU FFN or the MoE FFN of
`models/moe.py` (routed experts, shared experts), token inputs or
precomputed (B, S, d) embeddings, a tied or separate LM head. That
covers llama3-8b, starcoder2-3b, mixtral-8x22b, deepseek-moe-16b,
h2o-danube-3-4b, minicpm3-4b, musicgen-medium and llava-next-34b. The
SSM, xLSTM and hybrid blocks raise NotImplementedError naming their
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
(then slot p is p, the reference's full cache). MLA keeps instead the
reference's latent cache, per segment {"ckv": (count, B, max_len, R),
"krope": (count, B, max_len, Dr)}, R the kv_lora rank and Dr the rotary
width, shared across heads.

Entry points (the reference's, with `params` the `Model`):
  init_params(cfg, seed, device=, dtype=)        Model
  forward_logits(params, cfg, inputs)            (B, S, V) logits
  init_cache(cfg, batch, max_len, device=)       decode cache
  prefill(params, cfg, inputs, max_len)          logits, cache, pos
  decode_step(params, cfg, inp_t, cache, pos)    logits, cache
`inputs` are (B, S) token ids, or (B, S, d) embeddings for a config
whose `input_mode` is "embeddings" (`inp_t` (B,) or (B, d)).
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels import common
from .attention import (chunked_attention, decode_attention_mla,
                        decode_attention_ring)
from .layers import (dense, embed_lookup, glu_ffn, init_dense, rmsnorm,
                     rope_angles, rotate)
from .moe import moe_ffn

SSM_ITEM = "ROADMAP Queue 1, item 14.4 (hybrid, SSM and xLSTM blocks)"


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


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def block_shapes(cfg: ArchConfig, kind: str = "attn"):
    """Parameter names and shapes of one block of a segment of `kind`
    ("attn": a dense FFN; "attn_moe": routed and, where the config has
    them, shared experts), GQA or MLA attention, in the reference's order
    (`_init_attn_block`)."""
    d, hd, f, nh = cfg.d_model, cfg.head_dim, cfg.d_ff, cfg.n_heads
    shapes = {"attn_norm": (d,), "mlp_norm": (d,)}
    if cfg.attn_kind == "mla":
        m = cfg.mla
        shapes.update(
            wq_a=(d, m.q_lora_rank), q_norm=(m.q_lora_rank,),
            wq_b=(m.q_lora_rank, nh * m.qk_head_dim),
            wkv_a=(d, m.kv_lora_rank + m.qk_rope_dim),
            kv_norm=(m.kv_lora_rank,),
            wkv_b=(m.kv_lora_rank, nh * (m.qk_nope_dim + m.v_head_dim)),
            wo=(nh * m.v_head_dim, d))
    else:
        shapes.update(wq=(d, nh * hd), wk=(d, cfg.n_kv_heads * hd),
                      wv=(d, cfg.n_kv_heads * hd), wo=(nh * hd, d))
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
    `convert.params_from_numpy`). As in the reference, a model of
    embedding inputs has no `embed` table and always an `lm_head`."""

    def __init__(self, cfg: ArchConfig, *, device, dtype=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        dtype = dtype or torch_dtype(cfg.dtype)
        d = cfg.d_model
        tokens = cfg.input_mode == "tokens"
        self.embed = (_param((cfg.vocab_size, d), device, dtype) if tokens
                      else None)
        self.blocks = nn.ModuleList(
            AttnBlock(cfg, kind, device=device, dtype=dtype)
            for kind, count in cfg.segments for _ in range(count))
        self.final_norm = _param((d,), device, dtype)
        self.lm_head = (None if cfg.tie_embeddings and tokens
                        else _param((d, cfg.vocab_size), device, dtype))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

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
    if model.embed is not None:
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


def _mla_qkv(p, h, cfg: ArchConfig, cos, sin):
    """MLA's prefill operands (the reference's `_attn_block_fwd`): q and
    k (B, H, S, nope + rope) with the rotary part last, k's shared across
    the heads; v (B, H, S, dv); and the latent cache entries ckv (B, S,
    R) and the rotated k_rope (B, S, Dr). cos and sin are at the rotary
    width Dr."""
    b, s, _ = h.shape
    m, nh = cfg.mla, cfg.n_heads
    qa = rmsnorm(dense(h, p["wq_a"]), p["q_norm"], cfg.norm_eps)
    q = dense(qa, p["wq_b"]).reshape(b, s, nh, m.qk_head_dim)
    kv_a = dense(h, p["wkv_a"])
    ckv = rmsnorm(kv_a[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    kv = dense(ckv, p["wkv_b"]).reshape(b, s, nh,
                                        m.qk_nope_dim + m.v_head_dim)
    q_rope = rotate(q[..., m.qk_nope_dim:].transpose(1, 2), cos, sin)
    k_rope = rotate(kv_a[:, None, :, m.kv_lora_rank:], cos, sin)  # (B,1,S,Dr)
    q = torch.cat([q[..., :m.qk_nope_dim].transpose(1, 2), q_rope], dim=-1)
    k = torch.cat([kv[..., :m.qk_nope_dim].transpose(1, 2),
                   k_rope.expand(b, nh, s, m.qk_rope_dim)], dim=-1)
    return q, k, kv[..., m.qk_nope_dim:].transpose(1, 2), ckv, k_rope[:, 0]


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
    ring's slots; under MLA (this layer's (B, max_len, R) ckv and (B,
    max_len, Dr) krope) the latent entries go to positions [0, S)."""
    b, s, _ = x.shape
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        q, k, v, *latent = _mla_qkv(p, h, cfg, cos, sin)
        if cache is not None:
            for dst, src in zip(cache, latent):
                dst[:, :s] = src
    else:
        q, k, v = _gqa_qkv(p, h, cfg, cos, sin)
        if cache is not None:
            for dst, src in zip(cache, (k, v)):
                _ring_from_full(dst, src.transpose(1, 2))
    attn = chunked_attention(q, k, v, causal=True, window=cfg.window)
    attn = attn.transpose(1, 2).reshape(b, s, -1)
    x = x + dense(attn, p["wo"])
    h2 = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + _ffn(p, h2, cfg, kind)


def _embed_inputs(params: Model, cfg: ArchConfig, inputs):
    """Token ids (B, S) or (B,) through the table; precomputed modality
    embeddings (B, S, d) or (B, d) as they are."""
    if cfg.input_mode == "tokens":
        return embed_lookup(params.embed, inputs)
    return inputs


def _unembed(params: Model, cfg: ArchConfig, h):
    if params.lm_head is not None:
        return dense(h, params.lm_head)
    return dense(h, params.embed.t())


def _rope_width(cfg: ArchConfig) -> int:
    """The width RoPE rotates: the head, or MLA's rotary part alone."""
    return cfg.mla.qk_rope_dim if cfg.attn_kind == "mla" else cfg.head_dim


def _cache_names(cfg: ArchConfig):
    return ("ckv", "krope") if cfg.attn_kind == "mla" else ("k", "v")


@torch.no_grad()
def forward_hidden(params: Model, cfg: ArchConfig, inputs, *,
                   want_cache: bool = False,
                   max_len: Optional[int] = None):
    """inputs: (B, S) token ids or (B, S, d) embeddings -> final-normed
    hidden states (B, S, d); with `want_cache`, also the decode cache of
    `max_len` (default S) positions holding the prompt's K and V (under
    MLA its latent entries)."""
    b, s = inputs.shape[:2]
    x = _embed_inputs(params, cfg, inputs)
    cos, sin = rope_angles(torch.arange(s, device=x.device),
                           _rope_width(cfg), cfg.rope_theta)
    caches = (init_cache(cfg, b, max_len or s, dtype=x.dtype,
                         device=x.device) if want_cache else None)
    names = _cache_names(cfg)
    for si, (kind, blocks) in enumerate(params.segment_blocks()):
        for li, block in enumerate(blocks):
            layer_cache = (tuple(caches[si][n][li] for n in names)
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
    shape (count, B, W, Hkv, D), W = `_swa_cache_len(cfg, max_len)`; under
    MLA {"ckv": (count, B, max_len, R), "krope": (count, B, max_len,
    Dr)}."""
    check_ported(cfg)
    dev = common.resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    if cfg.attn_kind == "mla":
        m = cfg.mla
        shapes = ((batch, max_len, m.kv_lora_rank),
                  (batch, max_len, m.qk_rope_dim))
    else:
        shapes = ((batch, _swa_cache_len(cfg, max_len), cfg.n_kv_heads,
                   cfg.head_dim),) * 2
    return [{name: torch.zeros((count, *shape), dtype=dtype, device=dev)
             for name, shape in zip(_cache_names(cfg), shapes)}
            for _kind, count in cfg.segments]


def _write_at(cache_arr, val, idx: int) -> None:
    """cache_arr: (B, S, ...); val: (B, ...) -> written at [:, idx], in
    place (the reference returns an updated copy)."""
    cache_arr[:, idx] = val


def _mla_step(p, h, ckv_cache, krope_cache, pos: int, cfg: ArchConfig,
              cos, sin):
    """MLA's attention for one token (the reference's `_attn_block_step`):
    the latent entries written at pos, q_nope absorbed through W_uk in
    float32, the latent context expanded through W_uv in float32, then
    rounded to h's dtype. Returns (B, H dv)."""
    b, _ = h.shape
    m, nh = cfg.mla, cfg.n_heads
    qa = rmsnorm(dense(h, p["wq_a"]), p["q_norm"], cfg.norm_eps)
    q = dense(qa, p["wq_b"]).reshape(b, nh, m.qk_head_dim)
    q_rope = rotate(q[..., m.qk_nope_dim:], cos, sin)
    kv_a = dense(h, p["wkv_a"])
    _write_at(ckv_cache, rmsnorm(kv_a[..., :m.kv_lora_rank], p["kv_norm"],
                                 cfg.norm_eps), pos)
    _write_at(krope_cache, rotate(kv_a[..., m.kv_lora_rank:], cos, sin),
              pos)
    w_uk = p["wkv_b"].reshape(m.kv_lora_rank, nh,
                              m.qk_nope_dim + m.v_head_dim).float()
    q_lat = torch.einsum("bhn,rhn->bhr", q[..., :m.qk_nope_dim].float(),
                         w_uk[..., :m.qk_nope_dim])
    ctx = decode_attention_mla(q_lat, q_rope, ckv_cache, krope_cache, pos,
                               scale=m.qk_head_dim ** -0.5)
    attn = torch.einsum("bhr,rhv->bhv", ctx, w_uk[..., m.qk_nope_dim:])
    return attn.to(h.dtype).reshape(b, nh * m.v_head_dim)


def _attn_block_step(p, x, k_cache, v_cache, pos: int, cfg: ArchConfig,
                     cos, sin, kind: str, cache_len=None):
    """One token's block: the caches are rings written at slot pos % W,
    and `cache_len`, when given, holds min(pos + 1, W). Under MLA they
    are the latent ckv and krope caches, written at pos."""
    b, _ = x.shape
    hd = cfg.head_dim
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        attn = _mla_step(p, h, k_cache, v_cache, pos, cfg, cos, sin)
    else:
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
        attn = attn.reshape(b, cfg.n_heads * hd)
    x = x + dense(attn, p["wo"])
    h2 = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + _ffn(p, h2, cfg, kind, decode=True)


@torch.no_grad()
def decode_step(params: Model, cfg: ArchConfig, inputs_t, caches, pos: int,
                *, cache_len: Optional[torch.Tensor] = None):
    """One decoding step.

    inputs_t: (B,) token ids or (B, d) embeddings; caches: from
    init_cache/prefill, written in place at slot pos % W of each ring (at
    pos of MLA's latent caches); pos: the host int position of this
    token. `cache_len`, optional, is a (B,) int32 tensor on the device
    equal to pos + 1; once pos + 1 passes W it is clamped to W on the
    device, once per step (MLA's decode reads pos alone). Returns
    (logits (B, V), caches)."""
    x = _embed_inputs(params, cfg, inputs_t)
    position = torch.full((1,), pos, dtype=torch.float32, device=x.device)
    cos, sin = rope_angles(position, _rope_width(cfg), cfg.rope_theta)
    names = _cache_names(cfg)
    w = caches[0][names[0]].shape[2]
    if pos >= w and not cfg.window:
        raise ValueError(f"position {pos} is past the cache of {w}")
    if cache_len is not None and pos >= w:
        cache_len = cache_len.clamp(max=w)
    for si, (kind, blocks) in enumerate(params.segment_blocks()):
        for li, block in enumerate(blocks):
            x = _attn_block_step(block.p, x, caches[si][names[0]][li],
                                 caches[si][names[1]][li], pos, cfg, cos,
                                 sin, kind, cache_len)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    return _unembed(params, cfg, x), caches


@torch.no_grad()
def prefill(params: Model, cfg: ArchConfig, inputs, max_len: int):
    """Process a full prompt; return (last-token logits (B, V), decode
    caches of W = `_swa_cache_len(cfg, max_len)` ring slots, or MLA's
    latent caches of max_len, pos = S as a host int). inputs: (B, S)
    token ids or (B, S, d) embeddings."""
    s = inputs.shape[1]
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    h, caches = forward_hidden(params, cfg, inputs, want_cache=True,
                               max_len=max_len)
    return _unembed(params, cfg, h[:, -1]), caches, s
