"""Flash-attention forward (mha) for Hopper, in CUDA C++
(`csrc/attention.cu`).

Replaces `repro/kernels/attention.py::mha` (its `pallas_call` at
attention.py:92). The same function: q (B, Hq, Sq, d) against k (B, Hkv,
Skv, d) and v (B, Hkv, Skv, dv), the value width dv free of d as the
reference's `chunked_attention` takes it for MLA (scale d ** -0.5), query
head h reading KV head h // (Hq / Hkv), queries
aligned at the end of the keys (query i sits at Skv - Sq + i), causal
and sliding-window masks, an online softmax in float32 and the output in
q's dtype. As in the Pallas kernel, a row that sees no key gives 0, not
NaN: `mha_plain` follows the kernel there, not `ref.mha`, whose softmax
over a row of -inf is NaN.

Bound on an H100 SXM at Llama-3-8B's prefill (B 8, 32 on 8 heads, S
1781, D 128, bfloat16, causal): the operations, 4 D per visible (query,
key) pair, 0.21 ms per layer at 989 TFLOP/s; in general 2 (d + dv) per
pair. `mha_route` picks one of two kernels: bfloat16 and float16 with d
and dv up to 128 in one of the padded pairs (64, 64), (128, 128) and
(128, 64), dv even, and every base and stride a multiple of 16 bytes run
on `wgmma` fed by TMA, everything else on float32 FFMA; both designs are
described in csrc/attention.cu.

Training: the reference has no Pallas backward; it trains through its
plain-jnp `chunked_attention`, which JAX differentiates. Here `mha` goes
through `MhaFunction` whenever grad is enabled and an operand requires
it: the forward is the kernel (its plain version on CPU tensors), and
the backward is `mha_backward_plain`, the gradient of the same function
in float32 torch ops over query chunks of 512 rows. `attention_reference`
is an out-of-place float32 softmax attention that autograd
differentiates directly: the yardstick the tests and `chip_smoke.py`
hold the gradient to; no path of the port calls it.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import common, cuda

MAX_HEAD_DIM = 256
ROUTES = ("wgmma", "ffma")


def check_operands(q, k, v, window):
    """Validate mha's operands; returns (b, hq, hkv, sq, skv, d, dv)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not torch.is_tensor(t) or t.ndim != 4:
            raise ValueError(f"mha takes 4-D (B, H, S, D) tensors; {name} "
                             f"is {getattr(t, 'shape', type(t).__name__)}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"mha needs unit stride over D; {name} has "
                             f"strides {t.stride()}")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    dv = v.shape[3]
    if (k.shape[0] != b or k.shape[3] != d or v.shape[:3] != k.shape[:3]):
        raise ValueError(f"mha needs q (B, Hq, Sq, d), k (B, Hkv, Skv, d) "
                         f"and v (B, Hkv, Skv, dv); got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"operand dtypes disagree: q {q.dtype}, k "
                         f"{k.dtype}, v {v.dtype}")
    if min(b, hq, hkv, sq, skv, d, dv) < 1 or hq % hkv:
        raise ValueError(f"mha needs non-empty operands and Hq a multiple "
                         f"of Hkv; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if max(d, dv) > MAX_HEAD_DIM or max(b, hq) > 65535:
        raise ValueError(f"mha takes d, dv <= {MAX_HEAD_DIM} and B, Hq <= "
                         f"65535; got q {tuple(q.shape)}, v "
                         f"{tuple(v.shape)}")
    if window is not None and (not isinstance(window, int) or window < 1):
        raise ValueError(f"window must be None or a positive int, got "
                         f"{window!r}")
    return b, hq, hkv, sq, skv, d, dv


def tma_strides(t) -> tuple:
    """t's strides over (B, H, S) in elements, where a dimension of size
    1 (whose stride no index ever multiplies) takes its packed stride:
    PyTorch may report any stride there, and TMA checks every one."""
    _, h, s, d = t.shape
    packed = (h * s * d, s * d, d)
    return tuple(st if n > 1 else p for st, n, p in
                 zip(t.stride()[:3], t.shape[:3], packed))


def padded_width(n: int) -> int:
    """The wgmma kernel's padded head width for n columns: 64 or 128."""
    return 64 if n <= 64 else 128


def mha_route(q, k, v) -> str:
    """The kernel that `mha` launches for these operands: "wgmma" for
    bfloat16 and float16 with d and dv up to 128, dv even, v's padded
    width no wider than q's (the kernel's instantiations (64, 64),
    (128, 128) and (128, 64)), and bases and strides over (B, H, S) that
    are multiples of 16 bytes (TMA's conditions); "ffma" for everything
    else. Shapes, dtypes and addresses only: it also answers for CPU
    tensors."""
    d, dv = q.shape[-1], v.shape[-1]
    if (q.dtype not in (torch.bfloat16, torch.float16) or max(d, dv) > 128
            or dv % 2 or padded_width(dv) > padded_width(d)):
        return "ffma"
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(st % 8 for st in tma_strides(t)):
            return "ffma"
    return "wgmma"


# ---------------------------------------------------------------------------
# Plain version (float32 math; a row that sees no key gives 0)
# ---------------------------------------------------------------------------


def _acc(t) -> torch.dtype:
    """The plain versions' arithmetic: float32, or float64 for float64
    operands (the gradient's finite-difference check runs in float64)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _mask(q0: int, q1: int, k0: int, k1: int, off: int, causal: bool,
          window: Optional[int], device):
    """Visibility of keys [k0, k1) to queries [q0, q1), the queries at
    absolute positions off + i."""
    qpos = torch.arange(q0, q1, device=device)[:, None] + off
    kpos = torch.arange(k0, k1, device=device)[None, :]
    mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask


def mha_plain(q, k, v, *, causal: bool = True,
              window: Optional[int] = None):
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    dv = v.shape[-1]
    scale = d ** -0.5
    acc = _acc(q)
    qf = q.to(acc).reshape(b, hkv, hq // hkv, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.to(acc)) * scale
    mask = _mask(0, sq, 0, skv, skv - sq, causal, window, q.device)
    s.masked_fill_(~mask, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = s.sub_(m).exp_()
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(acc)) / l
    return out.reshape(b, hq, sq, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# Gradient (float32 torch ops; the reference differentiates plain jnp)
# ---------------------------------------------------------------------------

BLOCK_Q = 512      # the reference's `chunked_attention` block_q


def mha_backward_plain(q, k, v, out, dout, *, causal: bool = True,
                       window: Optional[int] = None):
    """The gradient of `mha` at (q, k, v): (dq, dk, dv) in the operands'
    dtypes, given its output `out` and the output's gradient `dout`.

    Float32 (float64 for float64 operands) torch ops over query chunks of
    BLOCK_Q rows, each against the keys in its reach only (under a
    window, its band): the scores and the row logsumexp recomputed,
    P = softmax, delta = rowsum(dout . out), dS = P (dP - delta) with
    dP = dout V^T; dq = scale dS K, dk = scale dS^T Q and dv = P^T dout
    summed over each KV head's query group (GQA), dv at v's own width. A
    row that sees no key has P = 0 and gives zero gradients, as `mha`
    gives it a zero output."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    dv_w = v.shape[-1]
    g = hq // hkv
    scale = d ** -0.5
    off = skv - sq
    acc = _acc(q)
    qf = q.to(acc).reshape(b, hkv, g, sq, d)
    kf, vf = k.to(acc), v.to(acc)
    of = out.to(acc).reshape(b, hkv, g, sq, dv_w)
    gf = dout.to(acc).reshape(b, hkv, g, sq, dv_w)
    delta = (gf * of).sum(dim=-1)                      # (b, hkv, g, sq)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for q0 in range(0, sq, BLOCK_Q):
        q1 = min(q0 + BLOCK_Q, sq)
        k1 = min(skv, q1 + off) if causal else skv
        k0 = max(0, q0 + off - window + 1) if window is not None else 0
        if k1 <= k0:
            continue                                   # no key in reach
        qc, gc = qf[:, :, :, q0:q1], gf[:, :, :, q0:q1]
        kc, vc = kf[:, :, k0:k1], vf[:, :, k0:k1]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc) * scale
        s = torch.where(_mask(q0, q1, k0, k1, off, causal, window,
                              q.device), s, -torch.inf)
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        p = p / torch.where(l == 0, torch.ones_like(l), l)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", gc, vc)
        ds = p * (dp - delta[:, :, :, q0:q1, None])
        dq[:, :, :, q0:q1] = torch.einsum("bhgqk,bhkd->bhgqd", ds,
                                          kc) * scale
        dk[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", ds,
                                        qc) * scale
        dv[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", p, gc)
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def attention_reference(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None):
    """Out-of-place float32 (float64 for float64 operands) softmax
    attention, the same function as `mha` (a row with no visible key
    gives 0), for autograd to differentiate: the yardstick of
    `MhaFunction`'s gradient in the tests and on the card. Not on any
    path of the port."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    acc = _acc(q)
    qf = q.to(acc).reshape(b, hkv, hq // hkv, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.to(acc)) * d ** -0.5
    mask = _mask(0, sq, 0, skv, skv - sq, causal, window, q.device)
    s = torch.where(mask, s, -torch.inf)
    m = s.amax(dim=-1, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(acc))
    return out.reshape(b, hq, sq, v.shape[-1])


class MhaFunction(torch.autograd.Function):
    """`mha` with a gradient: the forward is the kernel (the plain
    version on CPU tensors), counted as `mha` counts it; the backward is
    `mha_backward_plain` on the saved q, k, v and output."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out = _mha_forward(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = mha_backward_plain(q, k, v, out, dout,
                                        causal=ctx.causal,
                                        window=ctx.window)
        return dq, dk, dv, None, None


# ---------------------------------------------------------------------------
# Wrapper: the kernel on CUDA tensors, the plain version on CPU ones
# ---------------------------------------------------------------------------


def _mha_forward(q, k, v, causal, window):
    b, hq, hkv, sq, skv, d, dv = check_operands(q, k, v, window)
    if common.on_meta(q, k, v):
        return torch.empty((b, hq, sq, dv), dtype=q.dtype, device="meta")
    if not common.on_card(q, k, v):
        mha.plain_calls += 1
        return mha_plain(q, k, v, causal=causal, window=window)
    route = mha_route(q, k, v)
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=q.device)
    cuda.launch("attention", f"repro_mha_{route}", q, cuda.ptr(q),
                cuda.ptr(k), cuda.ptr(v), cuda.ptr(out), b, hq, hkv, sq, skv,
                d, dv, *tma_strides(q), *tma_strides(k), *tma_strides(v),
                int(bool(causal)), window or 0, d ** -0.5)
    mha.launches += 1
    mha.route_launches[route] += 1
    return out


def _triangle(n: int, w: int) -> int:
    """sum over x in [1, n] of min(x, w), 0 for n <= 0."""
    if n <= 0:
        return 0
    if n <= w:
        return n * (n + 1) // 2
    return w * (w + 1) // 2 + (n - w) * w


def visible_pairs(sq: int, skv: int, causal: bool,
                  window: Optional[int]) -> int:
    """The (query, key) pairs of one head that the masks leave visible,
    the queries at absolute positions skv - sq + i."""
    off = skv - sq
    if causal:       # query i sees min(off + i + 1, window) keys, >= 0
        w = window or skv
        return _triangle(off + sq, w) - _triangle(off, w)
    if window is None:
        return sq * skv
    return sum(max(0, skv - max(0, off + i - window + 1))
               for i in range(sq))


def mha_cost(q, k, v, *, causal: bool = True,
             window: Optional[int] = None):
    """(flops, bytes) of one forward, from the shapes: 2 (d + dv) a
    visible pair and head; q, k, v and the output each moved once
    (PERF.md's bound of the kernel)."""
    b, hq, sq, d = q.shape
    skv, dv = k.shape[2], v.shape[-1]
    pairs = visible_pairs(sq, skv, causal, window)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v))
    nbytes += b * hq * sq * dv * q.element_size()
    return 2.0 * (d + dv) * b * hq * pairs, float(nbytes)


@common.counted(cost=mha_cost)
def mha(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    """q: (B, Hq, Sq, d); k: (B, Hkv, Skv, d); v: (B, Hkv, Skv, dv) ->
    (B, Hq, Sq, dv) in q's dtype. Any strides over (B, H, S); unit stride
    over the last dimension. With grad enabled and an operand that
    requires it, through `MhaFunction`: the output is never cut off from
    q, k and v. On `meta` tensors (the cost counter's stand-ins) the
    output's shape alone."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in (q, k, v)):
        return MhaFunction.apply(q, k, v, causal, window)
    return _mha_forward(q, k, v, causal, window)


mha.route_launches = dict.fromkeys(ROUTES, 0)   # launches per kernel
