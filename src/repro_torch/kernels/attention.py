"""Flash-attention forward (mha) for Hopper, in CUDA C++
(`csrc/attention.cu`).

Replaces `repro/kernels/attention.py::mha` (its `pallas_call` at
attention.py:92). The same function: q (B, Hq, Sq, D) against k and v
(B, Hkv, Skv, D), query head h reading KV head h // (Hq / Hkv), queries
aligned at the end of the keys (query i sits at Skv - Sq + i), causal
and sliding-window masks, an online softmax in float32 and the output in
q's dtype. As in the Pallas kernel, a row that sees no key gives 0, not
NaN: `mha_plain` follows the kernel there, not `ref.mha`, whose softmax
over a row of -inf is NaN.

Bound on an H100 SXM at Llama-3-8B's prefill (B 8, 32 on 8 heads, S
1781, D 128, bfloat16, causal): the operations, 4 D per visible (query,
key) pair, 0.21 ms per layer at 989 TFLOP/s. `mha_route` picks one of
two kernels: bfloat16 and float16 at D 64 and 128 with every base and
stride a multiple of 16 bytes run on `wgmma` fed by TMA, everything else
on float32 FFMA; both designs are described in csrc/attention.cu.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import common, cuda

MAX_HEAD_DIM = 256
ROUTES = ("wgmma", "ffma")


def check_operands(q, k, v, window):
    """Validate mha's operands; returns (b, hq, hkv, sq, skv, d)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not torch.is_tensor(t) or t.ndim != 4:
            raise ValueError(f"mha takes 4-D (B, H, S, D) tensors; {name} "
                             f"is {getattr(t, 'shape', type(t).__name__)}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"mha needs unit stride over D; {name} has "
                             f"strides {t.stride()}")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if (k.shape[0] != b or k.shape[3] != d or v.shape != k.shape):
        raise ValueError(f"mha needs q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, "
                         f"D); got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"operand dtypes disagree: q {q.dtype}, k "
                         f"{k.dtype}, v {v.dtype}")
    if min(b, hq, hkv, sq, skv, d) < 1 or hq % hkv:
        raise ValueError(f"mha needs non-empty operands and Hq a multiple "
                         f"of Hkv; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if d > MAX_HEAD_DIM or max(b, hq) > 65535:
        raise ValueError(f"mha takes D <= {MAX_HEAD_DIM} and B, Hq <= 65535;"
                         f" got q {tuple(q.shape)}")
    if window is not None and (not isinstance(window, int) or window < 1):
        raise ValueError(f"window must be None or a positive int, got "
                         f"{window!r}")
    return b, hq, hkv, sq, skv, d


def tma_strides(t) -> tuple:
    """t's strides over (B, H, S) in elements, where a dimension of size
    1 (whose stride no index ever multiplies) takes its packed stride:
    PyTorch may report any stride there, and TMA checks every one."""
    _, h, s, d = t.shape
    packed = (h * s * d, s * d, d)
    return tuple(st if n > 1 else p for st, n, p in
                 zip(t.stride()[:3], t.shape[:3], packed))


def mha_route(q, k, v) -> str:
    """The kernel that `mha` launches for these operands: "wgmma" for
    bfloat16 and float16 at D 64 and 128 whose bases and strides over
    (B, H, S) are multiples of 16 bytes (TMA's conditions), "ffma" for
    everything else. Shapes, dtypes and addresses only: it also answers
    for CPU tensors."""
    if (q.dtype not in (torch.bfloat16, torch.float16)
            or q.shape[-1] not in (64, 128)):
        return "ffma"
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(st % 8 for st in tma_strides(t)):
            return "ffma"
    return "wgmma"


# ---------------------------------------------------------------------------
# Plain version (float32 math; a row that sees no key gives 0)
# ---------------------------------------------------------------------------


def mha_plain(q, k, v, *, causal: bool = True,
              window: Optional[int] = None):
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    scale = d ** -0.5
    qf = q.float().reshape(b, hkv, hq // hkv, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s.masked_fill_(~mask, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = s.sub_(m).exp_()
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / l
    return out.reshape(b, hq, sq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Wrapper: the kernel on CUDA tensors, the plain version on CPU ones
# ---------------------------------------------------------------------------


@common.counted
def mha(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q's
    dtype. Any strides over (B, H, S); unit stride over D."""
    b, hq, hkv, sq, skv, d = check_operands(q, k, v, window)
    if not common.on_card(q, k, v):
        mha.plain_calls += 1
        return mha_plain(q, k, v, causal=causal, window=window)
    route = mha_route(q, k, v)
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    cuda.launch("attention", f"repro_mha_{route}", q, cuda.ptr(q),
                cuda.ptr(k), cuda.ptr(v), cuda.ptr(out), b, hq, hkv, sq, skv,
                d, *tma_strides(q), *tma_strides(k), *tma_strides(v),
                int(bool(causal)), window or 0, d ** -0.5)
    mha.launches += 1
    mha.route_launches[route] += 1
    return out


mha.route_launches = dict.fromkeys(ROUTES, 0)   # launches per kernel
