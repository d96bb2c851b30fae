"""The decoder model of the serve path, the port of `repro/models/model.py`.

Every segment kind of the reference runs: `attn` and `attn_moe` with GQA
attention, full or over a sliding window, or MLA (multi-head latent
attention: low-rank query and key-value projections, a latent decode
cache, the absorbed decode in the latent space), a dense GLU FFN or the
MoE FFN of `models/moe.py` (routed experts, shared experts); xLSTM's
`mlstm` and `slstm` blocks; and the `hybrid` block, windowed GQA
attention and Mamba-2 SSD heads in parallel on the same input, their
outputs averaged, then a GLU FFN (the scans in `models/ssm.py`). Inputs
are token ids or precomputed (B, S, d) embeddings, with a tied or
separate LM head. That covers all ten configs.

The reference's parameter pytree (layers stacked per segment, scanned
with `jax.lax.scan`) becomes a `Model` module with one `Block` per layer
in an `nn.ModuleList`, walked by a Python loop; its device and dtype are
explicit. Each block keeps the reference's parameter names in an
`nn.ParameterDict` (`block.p["wq"]`, ...); the names in `FLOAT32` stay
float32 whatever the model's dtype, as in the reference. The decode
cache keeps the reference's layout, one dict per segment of tensors
stacked over the segment's layers, and is written in place:

* attention: K and V rings (count, B, W, Hkv, D), position p in slot
  p % W, W = min(max_len, window) under a sliding window and max_len
  without one (then slot p is p, the reference's full cache); under MLA
  the latent cache {"ckv": (count, B, max_len, R), "krope": (count, B,
  max_len, Dr)}, R the kv_lora rank and Dr the rotary width;
* mlstm: C (count, B, H, D, D), n (count, B, H, D), m (count, B, H);
  slstm: h, c, n, m (count, B, d), m starting at -1e30; hybrid: the K
  and V rings and ssm_state (count, B, H, N, P). These states are
  float32 whatever the cache's dtype;
* every mlstm, slstm and hybrid layer also keeps "conv" (count, B,
  d_conv - 1, C), the last inputs of its causal conv. A prompt shorter
  than d_conv - 1 leaves its leading rows zero, the left padding the
  conv assumes (the reference slices a shorter cache, which its decode
  step cannot take).

Entry points (the reference's, with `params` the `Model`):
  init_params(cfg, seed, device=, dtype=)        Model
  forward_logits(params, cfg, inputs)            (B, S, V) logits
  train_loss(params, cfg, batch, remat=)         scalar loss, with grad
  init_cache(cfg, batch, max_len, device=)       decode cache
  prefill(params, cfg, inputs, max_len)          logits, cache, pos
  decode_step(params, cfg, inp_t, cache, pos)    logits, cache
`inputs` are (B, S) token ids, or (B, S, d) embeddings for a config
whose `input_mode` is "embeddings" (`inp_t` (B,) or (B, d)).

The serve entry points run under `torch.no_grad()`, and a `Model`'s
parameters do not require grad: the train state turns that on
(`train.make_train_state`). `train_loss` follows the caller's grad mode;
with `remat` each block runs under `torch.utils.checkpoint` (the
reference's `jax.checkpoint` on each scanned layer), so its activations
are recomputed in the backward pass.

A model the train state placed on a mesh (`model.layout`, a
`partition.Layout`) holds only this rank's block of each parameter, and
`train_loss` takes this rank's block of the batch. Each block's weights
are gathered whole inside its checkpointed function, so they are freed
after the layer and gathered again in the recompute (ZeRO-3); their
gradients are summed over the ranks that hold distinct batch blocks and
cut back to the block (`core.distributed.gather_param`). The loss is the
reference's mean over the GLOBAL batch: each rank's sum over its tokens
divided by the global count, summed over the batch blocks.

Such a model also serves (`shard_model` places one without a train
state). `prefill` and `decode_step` then take this rank's block of the
inputs under `sharding.batch_specs` / `decode_input_specs` (the whole
batch where it does not divide over the DP dimensions), gather each
block's weights as the forward above does (no grad, no remat), and keep
the caches in their `sharding.cache_specs` blocks (`CacheBlocks`): the
batch rows this rank serves and, for the attention caches, its block of
the sequence dimension over "model". Prefill builds the rank's rows'
whole cache, then cuts it to the block. A decode step writes the new
token's K and V (or latent entries) on the rank whose block holds its
position or ring slot, attends over each rank's block and combines the
partials over "model" (`attention.combine_partials`); the recurrent
states are DP-only. Over one rank of each dimension this is bitwise the
whole model's serve path.
"""
from __future__ import annotations

import types
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.distributed import coordinate, live, psum, shard, sum_over
from ..kernels import common
from . import ssm
from .attention import (chunked_attention, combine_partials,
                        decode_attention_mla, decode_attention_ring)
from .layers import (dense, embed_lookup, glu_ffn, init_dense, rmsnorm,
                     rope_angles, rotate)
from . import partition, sharding
from .moe import moe_ffn, shard_map_variant

ATTN_KINDS = ("attn", "attn_moe")
SSM_KINDS = ("mlstm", "slstm", "hybrid")
# parameters kept in float32 whatever the model's dtype, as in the reference
FLOAT32 = frozenset({"router", "w_i", "w_f", "b_f", "r_gates", "w_dt",
                     "a_log", "d_skip"})
# an attn_moe block's MoE weights: on a "2d" mesh the TP/EP variants
# take them split over "model" (`make_layout`)
MOE_NAMES = frozenset({"router", "we_gate", "we_up", "we_down", "ws_gate",
                       "ws_up", "ws_down"})


def check_ported(cfg: ArchConfig) -> None:
    """Raise ValueError for a segment kind the model does not know, or
    one whose config part is missing."""
    for kind, _count in cfg.segments:
        if kind not in ATTN_KINDS + SSM_KINDS:
            raise ValueError(kind)
        if kind == "attn_moe" and cfg.moe is None:
            raise ValueError(f"{cfg.name}: attn_moe blocks need cfg.moe")
        if kind in SSM_KINDS and cfg.ssm is None:
            raise ValueError(f"{cfg.name}: {kind} blocks need cfg.ssm")


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _ffd_slstm(d: int) -> int:
    return -(-(4 * d // 3) // 64) * 64


def _ssm_heads(cfg: ArchConfig, kind: str) -> int:
    """The SSM or xLSTM head count: the config's, else the reference's
    default (4 for xLSTM, 8 for the hybrid's SSD heads)."""
    return cfg.ssm.n_ssm_heads or (8 if kind == "hybrid" else 4)


def _attn_shapes(cfg: ArchConfig):
    d, hd, nh = cfg.d_model, cfg.head_dim, cfg.n_heads
    if cfg.attn_kind == "mla":
        m = cfg.mla
        return dict(
            wq_a=(d, m.q_lora_rank), q_norm=(m.q_lora_rank,),
            wq_b=(m.q_lora_rank, nh * m.qk_head_dim),
            wkv_a=(d, m.kv_lora_rank + m.qk_rope_dim),
            kv_norm=(m.kv_lora_rank,),
            wkv_b=(m.kv_lora_rank, nh * (m.qk_nope_dim + m.v_head_dim)),
            wo=(nh * m.v_head_dim, d))
    return dict(wq=(d, nh * hd), wk=(d, cfg.n_kv_heads * hd),
                wv=(d, cfg.n_kv_heads * hd), wo=(nh * hd, d))


def block_shapes(cfg: ArchConfig, kind: str = "attn"):
    """Parameter names and shapes of one block of a segment of `kind`, in
    the reference's order: "attn" (a dense FFN) and "attn_moe" (routed
    and, where the config has them, shared experts) with GQA or MLA
    attention (`_init_attn_block`); "mlstm", "slstm" and "hybrid"
    (`_init_mlstm_block`, `_init_slstm_block`, `_init_hybrid_block`)."""
    d, f = cfg.d_model, cfg.d_ff
    if kind == "mlstm":
        dm, nh = 2 * d, _ssm_heads(cfg, kind)
        return dict(norm=(d,), w_up=(d, 2 * dm),
                    conv_w=(cfg.ssm.d_conv, dm), wq=(dm, dm), wk=(dm, dm),
                    wv=(dm, dm), w_i=(dm, nh), w_f=(dm, nh), b_f=(nh,),
                    gnorm=(dm,), w_down=(dm, d))
    if kind == "slstm":
        nh = _ssm_heads(cfg, kind)
        hd, ffd = d // nh, _ffd_slstm(d)
        return dict(norm=(d,), conv_w=(cfg.ssm.d_conv, d), w_i=(d, d),
                    w_f=(d, d), w_z=(d, d), w_o=(d, d),
                    r_gates=(4, nh, hd, hd), gnorm=(d,),
                    w_up=(d, 2 * ffd), w_down=(ffd, d))
    if kind == "hybrid":
        s, nh, hq = cfg.ssm, _ssm_heads(cfg, kind), cfg.n_heads * cfg.head_dim
        dss = s.expand * d
        shapes = dict(norm=(d,), mlp_norm=(d,), **_attn_shapes(cfg))
        shapes["attn_out_norm"] = (hq,)
        shapes["wo_attn"] = shapes.pop("wo")
        shapes.update(w_ssm_in=(d, 2 * dss), conv_w=(s.d_conv, dss),
                      w_bc=(dss, 2 * s.d_state), w_dt=(dss, nh),
                      a_log=(nh,), d_skip=(nh,), ssm_out_norm=(dss,),
                      wo_ssm=(dss, d), w_gate=(d, f), w_up=(d, f),
                      w_down=(f, d))
        return shapes
    shapes = dict(attn_norm=(d,), mlp_norm=(d,), **_attn_shapes(cfg))
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


def param_shapes(cfg: ArchConfig) -> dict:
    """{name: shape} of a `Model`'s parameters, in `named_parameters`
    order, with nothing allocated (the sharding rules read it for the
    full-size configs)."""
    check_ported(cfg)
    d, tokens = cfg.d_model, cfg.input_mode == "tokens"
    out = {"embed": (cfg.vocab_size, d)} if tokens else {}
    i = 0
    for kind, count in cfg.segments:
        for _ in range(count):
            out.update({f"blocks.{i}.p.{n}": tuple(shape)
                        for n, shape in block_shapes(cfg, kind).items()})
            i += 1
    out["final_norm"] = (d,)
    if not (cfg.tie_embeddings and tokens):
        out["lm_head"] = (d, cfg.vocab_size)
    return out


def make_layout(cfg: ArchConfig, mesh, style: str, params=None):
    """The `partition.Layout` of the config's parameters on `mesh` (a
    DeviceMesh, or a `sharding.MeshShape` for the reckoning alone) in
    `style`: their `sharding.param_specs` (from `params`, a Model, or
    else `param_shapes`) and, on a "2d" mesh, the split over "model"
    that the MoE variant of each attn_moe block takes
    (`moe.shard_map_variant`)."""
    specs = sharding.param_specs(cfg, mesh, params if params is not None
                                 else param_shapes(cfg), style=style)
    layout = partition.Layout(mesh, style, specs)
    if cfg.moe is None or not layout.moe_sharded():
        return layout
    msize = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))["model"]
    _, split = shard_map_variant(cfg.moe.n_experts, msize)
    kinds = [kind for kind, count in cfg.segments for _ in range(count)]
    moe = {f"blocks.{i}.p.{n}": split.get(n)
           for i, kind in enumerate(kinds) if kind == "attn_moe"
           for n in MOE_NAMES if f"blocks.{i}.p.{n}" in specs}
    return partition.Layout(mesh, style, specs, moe)


@torch.no_grad()
def shard_model(cfg: ArchConfig, params: "Model", mesh,
                style: str = "2d") -> "Model":
    """Place `params` on `mesh`: each parameter cut in place to this
    rank's block under `sharding.param_specs` in `style` (a block over one
    rank is the tensor itself), the placement recorded as
    `params.layout`. Returns `params`."""
    layout = make_layout(cfg, mesh, style, params)
    for name, p in params.named_parameters():
        p.data = shard(mesh, p.data, layout.specs[name])
    params.layout = layout
    return params


def _param(shape, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class Block(nn.Module):
    """One block of any segment kind: its parameters under the
    reference's names, those in `FLOAT32` in float32."""

    def __init__(self, cfg: ArchConfig, kind: str, *, device, dtype):
        super().__init__()
        self.p = nn.ParameterDict({
            name: _param(shape, device,
                         torch.float32 if name in FLOAT32 else dtype)
            for name, shape in block_shapes(cfg, kind).items()})


class Model(nn.Module):
    """The decoder's parameters (uninitialised: see `init_params` and
    `convert.params_from_numpy`). As in the reference, a model of
    embedding inputs has no `embed` table and always an `lm_head`."""

    def __init__(self, cfg: ArchConfig, *, device, dtype=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.layout = None          # a partition.Layout once sharded
        dtype = dtype or torch_dtype(cfg.dtype)
        d = cfg.d_model
        tokens = cfg.input_mode == "tokens"
        self.embed = (_param((cfg.vocab_size, d), device, dtype) if tokens
                      else None)
        self.blocks = nn.ModuleList(
            Block(cfg, kind, device=device, dtype=dtype)
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


# the parameters the reference sets to a constant, by name (besides the
# `*_norm` scales, which are 1)
_FILLS = {"norm": 1.0, "gnorm": 1.0, "b_f": 3.0, "a_log": 0.0,
          "d_skip": 1.0}


@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0, *, device=None,
                dtype=None) -> Model:
    """Random parameters from a seeded generator on the device: norms 1
    (every `*_norm`, `norm` and `gnorm`), the reference's constants
    (`b_f` 3, `a_log` 0, `d_skip` 1), projections normal * fan_in**-0.5
    (the experts' too: d**-0.5 for their inputs, d_expert**-0.5 for
    `we_down`; `r_gates` hd**-0.5), the conv weights normal * 0.3, the
    embedding normal * 0.02. (The draws are torch's, not jax.random's:
    tests that compare the two packages hand both the same numpy
    weights.)"""
    dev = common.resolve_device(device)
    model = Model(cfg, device=dev, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if model.embed is not None:
        model.embed.copy_(init_dense(gen, model.embed.shape, scale=0.02))
    for block in model.blocks:
        for name, t in block.p.items():
            if name.endswith("_norm") or name in _FILLS:
                t.fill_(_FILLS.get(name, 1.0))
            else:
                t.copy_(init_dense(gen, t.shape,
                                   scale=0.3 if name == "conv_w" else None))
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


def _ffn(p, h2, cfg: ArchConfig, kind: str, decode: bool = False,
         layout=None):
    """The block's FFN on (..., d): dense, or the MoE FFN over the
    flattened tokens, whose capacity factor a decode step raises to at
    least 4 (as the reference does). On a sharded model's (B / dp, S, d)
    block, as the reference on a mesh: in "2d" style the EP variant where
    "model" divides the experts, else the TP one; in "fsdp" style the
    dispatch over this rank's tokens, the reference's group of
    `groups=dp_total`."""
    if kind != "attn_moe":
        return glu_ffn(p, h2, act=cfg.act)
    mo, d = cfg.moe, h2.shape[-1]
    cf = max(4.0, mo.capacity_factor) if decode else mo.capacity_factor
    kw = dict(n_experts=mo.n_experts, top_k=mo.top_k, capacity_factor=cf,
              act=cfg.act)
    if layout is not None and layout.moe_sharded():
        mesh = layout.mesh
        msize = mesh.shape[mesh.mesh_dim_names.index("model")]
        fn, _ = shard_map_variant(mo.n_experts, msize)
        if h2.ndim == 2:             # a decode step's (B, d)
            return fn(p, h2[:, None], mesh=mesh, **kw)[:, 0]
        return fn(p, h2, mesh=mesh, **kw)
    if layout is not None and layout.dp_total > 1 and \
            h2.numel() // d < mo.top_k:
        raise ValueError(f"{h2.numel() // d} tokens a rank, fewer than "
                         f"top_k {mo.top_k}: the reference dispatches them "
                         f"over every rank at once")
    return moe_ffn(p, h2.reshape(-1, d), **kw).reshape(h2.shape)


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


def _conv_tail(conv, x) -> None:
    """Write the last K - 1 inputs x (B, S, C) of a causal conv into its
    cache conv (B, K - 1, C); with S < K - 1 they go to the last S rows
    and the leading rows stay zero (from `init_cache`)."""
    n = min(x.shape[1], conv.shape[1])
    conv[:, conv.shape[1] - n:] = x[:, x.shape[1] - n:]


def _gqa_attention(p, h, cfg: ArchConfig, cos, sin, cache):
    """Causal GQA attention of h (B, S, d) over the config's window, the
    rotated keys and the values written into the cache's K and V rings:
    (B, S, H D)."""
    b, s, _ = h.shape
    q, k, v = _gqa_qkv(p, h, cfg, cos, sin)
    if cache is not None:
        _ring_from_full(cache["k"], k.transpose(1, 2))
        _ring_from_full(cache["v"], v.transpose(1, 2))
    attn = chunked_attention(q, k, v, causal=True, window=cfg.window)
    return attn.transpose(1, 2).reshape(b, s, -1)


def _attn_block_fwd(p, x, cfg: ArchConfig, cos, sin, kind: str,
                    cache=None, layout=None):
    """x: (B, S, d). With `cache` (this layer's {"k", "v"} (B, W, Hkv, D)
    rings, see `init_cache`), the rotated keys and the values go to the
    ring's slots; under MLA (this layer's (B, max_len, R) ckv and (B,
    max_len, Dr) krope) the latent entries go to positions [0, S)."""
    b, s, _ = x.shape
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        q, k, v, ckv, krope = _mla_qkv(p, h, cfg, cos, sin)
        if cache is not None:
            cache["ckv"][:, :s] = ckv
            cache["krope"][:, :s] = krope
        attn = chunked_attention(q, k, v, causal=True, window=cfg.window)
        attn = attn.transpose(1, 2).reshape(b, s, -1)
    else:
        attn = _gqa_attention(p, h, cfg, cos, sin, cache)
    x = x + dense(attn, p["wo"])
    h2 = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + _ffn(p, h2, cfg, kind, layout=layout)


def _mlstm_qkv_gates(p, xm, xc, nh: int):
    """The mLSTM's q, k (from the conv's output xc), v (from its input
    xm), (..., H, D) each, and its input and forget gate preactivations
    (..., H); the forget gate's bias is float32, so the gate is too."""
    lead, dm = xm.shape[:-1], xm.shape[-1]
    q, k, v = (dense(t, p[n]).reshape(*lead, nh, dm // nh)
               for t, n in ((xc, "wq"), (xc, "wk"), (xm, "wv")))
    return q, k, v, dense(xc, p["w_i"]), dense(xc, p["w_f"]) + p["b_f"]


def _mlstm_block_fwd(p, x, cfg: ArchConfig, cache=None):
    """xLSTM's mLSTM block on x (B, S, d); with `cache`, the chunked
    scan's final (C, n, m) and the conv's last inputs go to it."""
    b, s, d = x.shape
    dm = 2 * d
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    up = dense(h, p["w_up"])
    xm, z = up[..., :dm], up[..., dm:]
    xc = F.silu(ssm.causal_conv1d(xm, p["conv_w"]))
    q, k, v, ig, fg = _mlstm_qkv_gates(p, xm, xc, _ssm_heads(cfg, "mlstm"))
    y, state = ssm.mlstm_chunked(q, k, v, ig, fg)
    y = rmsnorm(y.reshape(b, s, dm), p["gnorm"], cfg.norm_eps) * F.silu(z)
    if cache is not None:
        for name, t in zip(("C", "n", "m"), state):
            cache[name].copy_(t)
        _conv_tail(cache["conv"], xm)
    return x + dense(y, p["w_down"])


def _slstm_gates(p, h, xc, dim: int):
    """sLSTM's (i, f, z, o) input preactivations stacked on `dim`: i and f
    from the conv's output xc, z and o from its input h."""
    return torch.stack([dense(xc, p["w_i"]), dense(xc, p["w_f"]),
                        dense(h, p["w_z"]), dense(h, p["w_o"])], dim=dim)


def _slstm_out(p, x, hseq, cfg: ArchConfig):
    """The sLSTM block's group norm, GLU up-projection and residuals."""
    y = rmsnorm(hseq.to(x.dtype), p["gnorm"], cfg.norm_eps)
    up = dense(y, p["w_up"])
    ffd = up.shape[-1] // 2
    y2 = F.silu(up[..., :ffd]) * up[..., ffd:]
    return x + dense(y2, p["w_down"]) + y


def _slstm_block_fwd(p, x, cfg: ArchConfig, cache=None):
    """xLSTM's sLSTM block on x (B, S, d); with `cache`, the scan's final
    (h, c, n, m) and the conv's last inputs (the normed h) go to it."""
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    xc = F.silu(ssm.causal_conv1d(h, p["conv_w"]))
    hseq, state = ssm.slstm_scan(_slstm_gates(p, h, xc, 2), p["r_gates"])
    if cache is not None:
        for name, t in zip(("h", "c", "n", "m"), state):
            cache[name].copy_(t)
        _conv_tail(cache["conv"], h)
    return _slstm_out(p, x, hseq, cfg)


def _ssd_operands(p, xcv, cfg: ArchConfig):
    """The hybrid's SSD operands from the conv's output xcv (..., dss):
    x split into heads (..., H, P), dt (..., H), B and C (..., N)."""
    n, nh = cfg.ssm.d_state, _ssm_heads(cfg, "hybrid")
    bc = dense(xcv, p["w_bc"])
    xh = xcv.reshape(*xcv.shape[:-1], nh, xcv.shape[-1] // nh)
    return xh, dense(xcv, p["w_dt"]), bc[..., :n], bc[..., n:]


def _hybrid_mix(p, x, attn, y, z, cfg: ArchConfig):
    """The hybrid block's tail: each branch normed and projected, their
    mean added to x, then the GLU FFN."""
    ao = dense(rmsnorm(attn, p["attn_out_norm"], cfg.norm_eps),
               p["wo_attn"])
    y = rmsnorm(y, p["ssm_out_norm"], cfg.norm_eps) * F.silu(z)
    x = x + 0.5 * (ao + dense(y, p["wo_ssm"]))
    h2 = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + glu_ffn(p, h2, act=cfg.act)


def _hybrid_block_fwd(p, x, cfg: ArchConfig, cos, sin, cache=None):
    """Hymba's block on x (B, S, d): windowed GQA attention and SSD heads
    in parallel on the normed input. With `cache`, K and V go to its
    rings, the SSD's final state and the conv's last inputs (xs) to
    their entries."""
    b, s, d = x.shape
    dss = cfg.ssm.expand * d
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    attn = _gqa_attention(p, h, cfg, cos, sin, cache)
    inp = dense(h, p["w_ssm_in"])
    xs, z = inp[..., :dss], inp[..., dss:]
    xcv = F.silu(ssm.causal_conv1d(xs, p["conv_w"]))
    xh, dt, bmat, cmat = _ssd_operands(p, xcv, cfg)
    y, state = ssm.ssd_chunked(xh, dt, p["a_log"], bmat, cmat, p["d_skip"])
    if cache is not None:
        cache["ssm_state"].copy_(state)
        _conv_tail(cache["conv"], xs)
    return _hybrid_mix(p, x, attn, y.reshape(b, s, dss), z, cfg)


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


def _rope(cfg: ArchConfig, positions):
    """cos and sin at the width RoPE rotates (the head, or MLA's rotary
    part alone); None where no segment attends (xLSTM)."""
    if not any(kind in ATTN_KINDS + ("hybrid",) for kind, _ in cfg.segments):
        return None, None
    width = cfg.mla.qk_rope_dim if cfg.attn_kind == "mla" else cfg.head_dim
    return rope_angles(positions, width, cfg.rope_theta)


def _block_fwd(kind: str, p, x, cfg: ArchConfig, cos, sin, cache,
               layout=None):
    if kind in ATTN_KINDS:
        return _attn_block_fwd(p, x, cfg, cos, sin, kind, cache, layout)
    if kind == "mlstm":
        return _mlstm_block_fwd(p, x, cfg, cache)
    if kind == "slstm":
        return _slstm_block_fwd(p, x, cfg, cache)
    return _hybrid_block_fwd(p, x, cfg, cos, sin, cache)


def _layer_cache(seg_cache, li: int):
    """Layer li's entries of a segment's stacked cache, as views."""
    return {name: t[li] for name, t in seg_cache.items()}


def _whole_top(params: Model, layout):
    """The model's embed, final_norm and lm_head whole: the parameters
    themselves, or on a sharded model gathered from this rank's blocks
    (once a step: a tied embedding's two uses share one gather)."""
    if layout is None:
        return params
    return types.SimpleNamespace(**{
        n: (None if getattr(params, n) is None
            else layout.gather(n, getattr(params, n)))
        for n in ("embed", "final_norm", "lm_head")})


def _gathered(layout, i: int, local):
    """Block i's weights for compute from this rank's blocks `local`
    (`Layout.gather`: whole, or the MoE variants' "model" part)."""
    return {name: layout.gather(f"blocks.{i}.p.{name}", t)
            for name, t in local.items()}


def _sharded_block_fwd(kind: str, i: int, local, x, cfg: ArchConfig, cos,
                       sin, layout, cache=None):
    """Block i of a sharded model: its weights gathered from this rank's
    blocks `local` (inside remat's checkpoint: freed after the layer,
    gathered again in the recompute), then the block's forward (with
    `cache`, prefill's, writing this rank's rows' whole cache)."""
    return _block_fwd(kind, _gathered(layout, i, local), x, cfg, cos, sin,
                      cache, layout)


def _hidden(params: Model, cfg: ArchConfig, inputs, *, remat: bool = False,
            want_cache: bool = False, max_len: Optional[int] = None,
            top=None):
    """The sequence forward of `forward_hidden` in the caller's grad
    mode; with `remat`, each block under `checkpoint` (no cache). `top`
    holds the whole embed and final_norm (`_whole_top`)."""
    b, s = inputs.shape[:2]
    layout = params.layout
    if top is None:
        top = _whole_top(params, layout)
    x = _embed_inputs(top, cfg, inputs)
    cos, sin = _rope(cfg, torch.arange(s, device=x.device))
    caches = (init_cache(cfg, b, max_len or s, dtype=x.dtype,
                         device=x.device) if want_cache else None)
    i = 0
    for si, (kind, blocks) in enumerate(params.segment_blocks()):
        for li, block in enumerate(blocks):
            if layout is not None and want_cache:
                x = _sharded_block_fwd(kind, i, block.p, x, cfg, cos, sin,
                                       layout, _layer_cache(caches[si], li))
            elif layout is not None:
                args = (kind, i, block.p, x, cfg, cos, sin, layout)
                x = (checkpoint(_sharded_block_fwd, *args,
                                use_reentrant=False) if remat
                     else _sharded_block_fwd(*args))
            elif remat:
                x = checkpoint(_block_fwd, kind, block.p, x, cfg, cos, sin,
                               None, use_reentrant=False)
            else:
                cache = _layer_cache(caches[si], li) if want_cache else None
                x = _block_fwd(kind, block.p, x, cfg, cos, sin, cache)
            i += 1
    x = rmsnorm(x, top.final_norm, cfg.norm_eps)
    if want_cache and layout is not None:
        caches = cut_caches(cfg, layout.mesh, caches)
    return (x, caches) if want_cache else x


@torch.no_grad()
def forward_hidden(params: Model, cfg: ArchConfig, inputs, *,
                   want_cache: bool = False,
                   max_len: Optional[int] = None, top=None):
    """inputs: (B, S) token ids or (B, S, d) embeddings -> final-normed
    hidden states (B, S, d); with `want_cache`, also the decode cache of
    `max_len` (default S) positions holding the prompt's K and V (under
    MLA its latent entries) and each recurrent block's state after it
    (on a sharded model, this rank's blocks of it, `CacheBlocks`)."""
    return _hidden(params, cfg, inputs, want_cache=want_cache,
                   max_len=max_len, top=top)


@torch.no_grad()
def forward_logits(params: Model, cfg: ArchConfig, inputs):
    top = _whole_top(params, params.layout)
    return _unembed(top, cfg, forward_hidden(params, cfg, inputs, top=top))


def train_loss(params: Model, cfg: ArchConfig, batch, *, remat: bool = True):
    """Causal-LM cross entropy, the reference's `train_loss`: float32
    logits, logsumexp minus the gold logit, the mean over tokens (over
    the tokens where batch["mask"] is set, when it is given): their sum
    divided by their count. batch: {"inputs": (B, S) token ids or (B, S,
    d) embeddings, "labels": (B, S) ids, "mask": optional (B, S)}. In the
    caller's grad mode.

    On a sharded model the batch is this rank's block (`sharding.
    batch_specs`) and the loss is still the global batch's: this rank's
    sum over the global count (the batch blocks' mask counts summed),
    summed over the blocks in rank order; each rank's gradient is that of
    its own term, and the weights' gathers sum them onto the shards."""
    layout = params.layout
    top = _whole_top(params, layout)
    h = _hidden(params, cfg, batch["inputs"], remat=remat, top=top)
    lf = _unembed(top, cfg, h).float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, batch["labels"].long()[..., None])[..., 0]
    nll = logz - gold
    mask = batch.get("mask")
    if mask is None:
        count = nll.numel() * (layout.dp_total if layout else 1)
        total = nll.sum() / count
    else:
        mask = mask.float()
        count = mask.sum()
        blocks = live(layout.mesh, layout.dp) if layout else ()
        if blocks:
            count = psum(layout.mesh, count, blocks)
        total = (nll * mask).sum() / count.clamp(min=1.0)
    return total if layout is None else sum_over(layout.mesh, total,
                                                 layout.dp)


# ---------------------------------------------------------------------------
# Decode (serve) path
# ---------------------------------------------------------------------------


def _swa_cache_len(cfg: ArchConfig, max_len: int) -> int:
    """The ring's W: the positions the attention cache holds. Without a
    window W = max_len, and the ring is the full cache (slot p % W is p)."""
    return min(max_len, cfg.window) if cfg.window else max_len


def _segment_cache(cfg: ArchConfig, kind: str, count: int, batch: int,
                   max_len: int, dtype, dev):
    """One segment's zero cache, the reference's layout
    (`repro/models/model.py::init_cache`)."""
    f32 = torch.float32

    def zeros(*shape, dt=dtype):
        return torch.zeros((count, batch, *shape), dtype=dt, device=dev)

    if kind in ATTN_KINDS and cfg.attn_kind == "mla":
        m = cfg.mla
        return {"ckv": zeros(max_len, m.kv_lora_rank),
                "krope": zeros(max_len, m.qk_rope_dim)}
    ring = (_swa_cache_len(cfg, max_len), cfg.n_kv_heads, cfg.head_dim)
    if kind in ATTN_KINDS:
        return {"k": zeros(*ring), "v": zeros(*ring)}
    d, kc = cfg.d_model, cfg.ssm.d_conv - 1
    nh = _ssm_heads(cfg, kind)
    if kind == "mlstm":
        hd = 2 * d // nh
        return {"C": zeros(nh, hd, hd, dt=f32), "n": zeros(nh, hd, dt=f32),
                "m": zeros(nh, dt=f32), "conv": zeros(kc, 2 * d)}
    if kind == "slstm":
        return {"h": zeros(d, dt=f32), "c": zeros(d, dt=f32),
                "n": zeros(d, dt=f32),
                "m": torch.full((count, batch, d), -1e30, dtype=f32,
                                device=dev),
                "conv": zeros(kc, d)}
    dss = cfg.ssm.expand * d
    return {"k": zeros(*ring), "v": zeros(*ring),
            "ssm_state": zeros(nh, cfg.ssm.d_state, dss // nh, dt=f32),
            "conv": zeros(kc, dss)}


class CacheBlocks(list):
    """A sharded model's decode cache: the list of `init_cache`'s layout
    holding this rank's block of each tensor, with `specs`, the specs
    that cut this rank's rows' whole cache to them (the attention caches'
    sequence dimension over "model" where it divides, as
    `sharding.cache_specs` splits it; the batch rows are this rank's
    already)."""

    def __init__(self, blocks, specs):
        super().__init__(blocks)
        self.specs = specs


def cut_caches(cfg: ArchConfig, mesh, caches) -> CacheBlocks:
    """This rank's blocks (`CacheBlocks`) of the whole cache of its batch
    rows: `sharding.cache_specs` with the batch entry dropped."""
    specs = [{n: (sp[0], None, *sp[2:]) for n, sp in seg.items()}
             for seg in sharding.cache_specs(cfg, mesh, caches, batch=1)]
    return CacheBlocks([{n: shard(mesh, t, sp[n]) for n, t in seg.items()}
                        for seg, sp in zip(caches, specs)], specs)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, dtype=None,
               device=None, layout=None) -> List[dict]:
    """Preallocated decode cache (zeros, sLSTM's m -1e30), one dict per
    segment in the reference's layout (see the module's docstring): K
    and V rings of W = `_swa_cache_len(cfg, max_len)` slots or MLA's
    latent cache of max_len positions, and the recurrent states. The
    states are float32; the rest is in `dtype` (the config's by
    default). With the `layout` of a sharded model, this rank's blocks of
    a cache of `batch` rows (`CacheBlocks`). `device` may be "meta" (the
    cost counter's stand-ins)."""
    check_ported(cfg)
    dev = (torch.device("meta") if str(device) == "meta"
           else common.resolve_device(device))
    dtype = dtype or torch_dtype(cfg.dtype)
    caches = [_segment_cache(cfg, kind, count, batch, max_len, dtype, dev)
              for kind, count in cfg.segments]
    return caches if layout is None else cut_caches(cfg, layout.mesh,
                                                    caches)


def _write_at(cache_arr, val, idx: int) -> None:
    """cache_arr: (B, S, ...); val: (B, ...) -> written at [:, idx], in
    place (the reference returns an updated copy)."""
    cache_arr[:, idx] = val


def _write_block(cache_arr, val, at: int, split) -> None:
    """Write val at position (or slot) `at` of a cache of which cache_arr
    is this rank's block under `split` (None: the whole of it): on the
    rank whose block holds `at` alone."""
    if split is None:
        _write_at(cache_arr, val, at)
        return
    _mesh, index = split
    blk = cache_arr.shape[1]
    if at // blk == index:
        _write_at(cache_arr, val, at - index * blk)


def _mla_step(p, h, ckv_cache, krope_cache, pos: int, cfg: ArchConfig,
              cos, sin, split=None):
    """MLA's attention for one token (the reference's `_attn_block_step`):
    the latent entries written at pos, q_nope absorbed through W_uk in
    float32, the latent context expanded through W_uv in float32, then
    rounded to h's dtype. Returns (B, H dv). With `split`, (mesh, this
    rank's index) of caches whose positions are split over "model": the
    context of each rank's block, combined."""
    b, _ = h.shape
    m, nh = cfg.mla, cfg.n_heads
    qa = rmsnorm(dense(h, p["wq_a"]), p["q_norm"], cfg.norm_eps)
    q = dense(qa, p["wq_b"]).reshape(b, nh, m.qk_head_dim)
    q_rope = rotate(q[..., m.qk_nope_dim:], cos, sin)
    kv_a = dense(h, p["wkv_a"])
    _write_block(ckv_cache, rmsnorm(kv_a[..., :m.kv_lora_rank],
                                    p["kv_norm"], cfg.norm_eps), pos, split)
    _write_block(krope_cache, rotate(kv_a[..., m.kv_lora_rank:], cos, sin),
                 pos, split)
    w_uk = p["wkv_b"].reshape(m.kv_lora_rank, nh,
                              m.qk_nope_dim + m.v_head_dim).float()
    q_lat = torch.einsum("bhn,rhn->bhr", q[..., :m.qk_nope_dim].float(),
                         w_uk[..., :m.qk_nope_dim])
    scale = m.qk_head_dim ** -0.5
    if split is None:
        ctx = decode_attention_mla(q_lat, q_rope, ckv_cache, krope_cache,
                                   pos, scale=scale)
    else:
        mesh, index = split
        ctx = combine_partials(mesh, *decode_attention_mla(
            q_lat, q_rope, ckv_cache, krope_cache, pos, scale=scale,
            offset=index * ckv_cache.shape[1]))
    attn = torch.einsum("bhr,rhv->bhv", ctx, w_uk[..., m.qk_nope_dim:])
    return attn.to(h.dtype).reshape(b, nh * m.v_head_dim)


def _gqa_step(p, h, cache, pos: int, cfg: ArchConfig, cos, sin,
              cache_len=None, split=None):
    """One token's GQA attention: its rotated key and value written at
    slot pos % W of the cache's rings, then decode over the ring's view.
    Returns (B, H D). With `split`, (mesh, this rank's index) of rings
    whose slots are split over "model": the write on the rank that holds
    the slot, each rank's block attended, the partials combined."""
    b, _ = h.shape
    hd = cfg.head_dim
    q = rotate(dense(h, p["wq"]).reshape(b, cfg.n_heads, hd), cos, sin)
    k_t = rotate(dense(h, p["wk"]).reshape(b, cfg.n_kv_heads, hd), cos, sin)
    v_t = dense(h, p["wv"]).reshape(b, cfg.n_kv_heads, hd)
    blk = cache["k"].shape[1]
    if split is None:
        slot = pos % blk
        _write_at(cache["k"], k_t, slot)
        _write_at(cache["v"], v_t, slot)
        attn = decode_attention_ring(q, cache["k"], cache["v"], pos,
                                     window=cfg.window, ring_len=cache_len)
    else:
        mesh, index = split
        slots = blk * mesh.shape[mesh.mesh_dim_names.index("model")]
        _write_block(cache["k"], k_t, pos % slots, split)
        _write_block(cache["v"], v_t, pos % slots, split)
        attn = combine_partials(mesh, *decode_attention_ring(
            q, cache["k"], cache["v"], pos, window=cfg.window,
            offset=index * blk, slots=slots))
    return attn.reshape(b, cfg.n_heads * hd)


def _attn_block_step(p, x, cache, pos: int, cfg: ArchConfig, cos, sin,
                     kind: str, cache_len=None, split=None, layout=None):
    """One token's block: the caches are rings written at slot pos % W,
    and `cache_len`, when given, holds min(pos + 1, W). Under MLA they
    are the latent ckv and krope caches, written at pos. `split`: see
    `_gqa_step`; `layout`, a sharded model's (its MoE variants)."""
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        attn = _mla_step(p, h, cache["ckv"], cache["krope"], pos, cfg, cos,
                         sin, split)
    else:
        attn = _gqa_step(p, h, cache, pos, cfg, cos, sin, cache_len, split)
    x = x + dense(attn, p["wo"])
    h2 = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + _ffn(p, h2, cfg, kind, decode=True, layout=layout)


def _conv_step(p, x_t, cache):
    """The causal conv on one token, its window shifted in place."""
    y, window = ssm.causal_conv1d_step(x_t, cache["conv"], p["conv_w"])
    cache["conv"].copy_(window)
    return y


def _mlstm_block_step(p, x, cache, cfg: ArchConfig):
    b, d = x.shape
    dm = 2 * d
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    up = dense(h, p["w_up"])
    xm, z = up[..., :dm], up[..., dm:]
    xc = F.silu(_conv_step(p, xm, cache))
    q, k, v, ig, fg = _mlstm_qkv_gates(p, xm, xc, _ssm_heads(cfg, "mlstm"))
    y, state = ssm.mlstm_step(q, k, v, ig, fg,
                              (cache["C"], cache["n"], cache["m"]))
    for name, t in zip(("C", "n", "m"), state):
        cache[name].copy_(t)
    y = rmsnorm(y.reshape(b, dm), p["gnorm"], cfg.norm_eps) * F.silu(z)
    return x + dense(y, p["w_down"])


def _slstm_block_step(p, x, cache, cfg: ArchConfig):
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    xc = F.silu(_conv_step(p, h, cache))
    names = ("h", "c", "n", "m")
    hy, state = ssm.slstm_step(_slstm_gates(p, h, xc, 1), p["r_gates"],
                               tuple(cache[n] for n in names))
    for name, t in zip(names, state):
        cache[name].copy_(t)
    return _slstm_out(p, x, hy, cfg)


def _hybrid_block_step(p, x, cache, pos: int, cfg: ArchConfig, cos, sin,
                       cache_len=None, split=None):
    dss = cfg.ssm.expand * x.shape[-1]
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    attn = _gqa_step(p, h, cache, pos, cfg, cos, sin, cache_len, split)
    inp = dense(h, p["w_ssm_in"])
    xs, z = inp[..., :dss], inp[..., dss:]
    xcv = F.silu(_conv_step(p, xs, cache))
    xh, dt, bvec, cvec = _ssd_operands(p, xcv, cfg)
    y, state = ssm.ssd_step(xh, dt, p["a_log"], bvec, cvec, p["d_skip"],
                            cache["ssm_state"])
    cache["ssm_state"].copy_(state)
    return _hybrid_mix(p, x, attn, y.reshape(x.shape[0], dss), z, cfg)


def _block_step(kind: str, p, x, cache, pos: int, cfg: ArchConfig, cos,
                sin, cache_len, split=None, layout=None):
    if kind in ATTN_KINDS:
        return _attn_block_step(p, x, cache, pos, cfg, cos, sin, kind,
                                cache_len, split, layout)
    if kind == "mlstm":
        return _mlstm_block_step(p, x, cache, cfg)
    if kind == "slstm":
        return _slstm_block_step(p, x, cache, cfg)
    return _hybrid_block_step(p, x, cache, pos, cfg, cos, sin, cache_len,
                              split)


def _split(caches, si: int) -> bool:
    """Whether segment si's attention caches are split over "model" (their
    spec in `CacheBlocks.specs` names it)."""
    specs = getattr(caches, "specs", None)
    return specs is not None and any(
        name in specs[si] and specs[si][name][2] is not None
        for name in ("k", "ckv"))


def _attention_slots(caches, msize: int = 1) -> Optional[int]:
    """The positions the attention caches hold (the ring's W, or MLA's
    max_len, over the `msize` blocks where "model" splits them); None
    where no segment keeps one (xLSTM)."""
    for si, seg in enumerate(caches):
        for name in ("k", "ckv"):
            if name in seg:
                return seg[name].shape[2] * (msize if _split(caches, si)
                                             else 1)
    return None


@torch.no_grad()
def decode_step(params: Model, cfg: ArchConfig, inputs_t, caches, pos: int,
                *, cache_len: Optional[torch.Tensor] = None):
    """One decoding step.

    inputs_t: (B,) token ids or (B, d) embeddings; caches: from
    init_cache/prefill, written in place: at slot pos % W of each ring
    (at pos of MLA's latent caches), and each recurrent state replaced
    by the next; pos: the host int position of this token. `cache_len`,
    optional, is a (B,) int32 tensor on the device equal to pos + 1;
    once pos + 1 passes W it is clamped to W on the device, once per step
    (MLA's decode reads pos alone, and a model without attention reads
    neither: it has no position limit). Returns (logits (B, V),
    caches).

    On a sharded model (`model.layout`), inputs_t is this rank's block
    (`sharding.decode_input_specs`) and caches its `CacheBlocks` (from
    `prefill` or `init_cache(layout=)`); `cache_len` is the single-card
    engine's and is refused there."""
    layout = params.layout
    msize = 1
    if layout is not None:
        if not isinstance(caches, CacheBlocks):
            raise ValueError("a sharded model decodes over its cache blocks "
                             "(CacheBlocks, from prefill or init_cache("
                             "layout=))")
        if cache_len is not None:
            raise ValueError("cache_len is the single-card engine's; a "
                             "sharded model counts from pos")
        mesh = layout.mesh
        msize = mesh.shape[mesh.mesh_dim_names.index("model")]
    top = _whole_top(params, layout)
    x = _embed_inputs(top, cfg, inputs_t)
    cos, sin = _rope(cfg, torch.full((1,), pos, dtype=torch.float32,
                                     device=x.device))
    w = _attention_slots(caches, msize)
    if w is not None and pos >= w:
        if not cfg.window:
            raise ValueError(f"position {pos} is past the cache of {w}")
        if cache_len is not None:
            cache_len = cache_len.clamp(max=w)
    i = 0
    for si, (kind, blocks) in enumerate(params.segment_blocks()):
        split = ((layout.mesh, coordinate(layout.mesh, "model"))
                 if layout is not None and _split(caches, si) else None)
        for li, block in enumerate(blocks):
            p = block.p if layout is None else _gathered(layout, i, block.p)
            x = _block_step(kind, p, x, _layer_cache(caches[si], li), pos,
                            cfg, cos, sin, cache_len, split, layout)
            i += 1
    x = rmsnorm(x, top.final_norm, cfg.norm_eps)
    return _unembed(top, cfg, x), caches


@torch.no_grad()
def prefill(params: Model, cfg: ArchConfig, inputs, max_len: int):
    """Process a full prompt; return (last-token logits (B, V), decode
    caches (W = `_swa_cache_len(cfg, max_len)` ring slots, MLA's latent
    caches of max_len, each recurrent block's state after the prompt and
    its conv's last inputs), pos = S as a host int). inputs: (B, S) token
    ids or (B, S, d) embeddings; on a sharded model this rank's block of
    them, and the caches its `CacheBlocks`."""
    s = inputs.shape[1]
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    top = _whole_top(params, params.layout)
    h, caches = forward_hidden(params, cfg, inputs, want_cache=True,
                               max_len=max_len, top=top)
    return _unembed(top, cfg, h[:, -1]), caches, s
