"""Plain-torch oracles with the semantics of `repro/kernels/ref.py`.

Each function is the ground truth for one kernel of the reference
package, and the `reference` execution mode runs them for every spec,
including the level-2/3 and attention routines whose Hopper kernels are
not ported yet. Float32 products run in full float32 (the card's
default: `torch.backends.cuda.matmul.allow_tf32` is False).
"""
from __future__ import annotations

import torch

f32 = torch.float32

# ---------------------------------------------------------------------------
# BLAS level 1
# ---------------------------------------------------------------------------


def axpy(alpha, x, y):
    """y' = alpha * x + y  (BLAS saxpy/daxpy)."""
    return alpha * x + y


def scal(alpha, x):
    """x' = alpha * x."""
    return alpha * x


def dot(x, y):
    """xᵀ y with f32 accumulation."""
    return torch.sum(x.to(f32) * y.to(f32))


def asum(x):
    """Σ|x_i| with f32 accumulation."""
    return torch.sum(torch.abs(x.to(f32)))


def nrm2(x):
    """‖x‖₂ with f32 accumulation."""
    return torch.sqrt(torch.sum(torch.square(x.to(f32))))


def waxpby(alpha, x, beta, y):
    """w = alpha*x + beta*y (updated-BLAS composite)."""
    return alpha * x + beta * y


def copy(x):
    """y = x (BLAS scopy): a new tensor, so that a loop's in-place stack
    store never reaches a value copied from it."""
    return x.clone()


def vmul(x, y):
    """out = x ⊙ y (Hadamard product)."""
    return x * y


def rot(c, s, x, y):
    """Givens plane rotation: (c x + s y, c y - s x)."""
    return c * x + s * y, c * y - s * x


def iamax(x):
    """Index of the first element with maximal |x_i| (BLAS isamax)."""
    return torch.argmax(torch.abs(x.to(f32))).to(torch.int32)


# ---------------------------------------------------------------------------
# BLAS level 2
# ---------------------------------------------------------------------------


def gemv(alpha, a, x, beta, y):
    """y' = alpha * A @ x + beta * y."""
    acc = a.to(f32) @ x.to(f32)
    return (alpha * acc + beta * y.to(f32)).to(a.dtype)


def gemvt(alpha, a, x, beta, y):
    """y' = alpha * Aᵀ @ x + beta * y (transposed matvec: the
    Gram-Schmidt correction w − Vᵀh in GMRES)."""
    acc = a.to(f32).T @ x.to(f32)
    return (alpha * acc + beta * y.to(f32)).to(a.dtype)


def transpose(a):
    """out = Aᵀ, as a new row-major tensor (not a view of A)."""
    return a.T.clone(memory_format=torch.contiguous_format)


def ger(alpha, x, y, a):
    """A' = alpha * x yᵀ + A (rank-1 update)."""
    return (alpha * torch.outer(x, y) + a).to(a.dtype)


def symv(alpha, a, x, beta, y):
    """y' = alpha * S @ x + beta * y with S the symmetric matrix stored
    in A's lower triangle (the upper triangle is never referenced)."""
    af = a.to(f32)
    s = torch.tril(af) + torch.tril(af, -1).T
    acc = s @ x.to(f32)
    return (alpha * acc + beta * y.to(f32)).to(a.dtype)


# ---------------------------------------------------------------------------
# BLAS level 3
# ---------------------------------------------------------------------------


def gemm(alpha, a, b, beta, c):
    """C' = alpha * A @ B + beta * C with f32 accumulation."""
    acc = a.to(f32) @ b.to(f32)
    return (alpha * acc + beta * c.to(f32)).to(c.dtype)


def matmul(a, b):
    """Plain C = A @ B, f32 accumulation, output in a.dtype."""
    return (a.to(f32) @ b.to(f32)).to(a.dtype)


# ---------------------------------------------------------------------------
# Composed routines (the paper's dataflow compositions)
# ---------------------------------------------------------------------------


def axpydot(alpha, w, v, u):
    """Paper Fig. 1: z = w - alpha*v ; beta = zᵀ u."""
    z = w - alpha * v
    return torch.sum(z.to(f32) * u.to(f32))


def gesummv(alpha, a, beta, b, x):
    """y = alpha*A@x + beta*B@x (updated-BLAS composite)."""
    af = a.to(f32) @ x.to(f32)
    bf = b.to(f32) @ x.to(f32)
    return (alpha * af + beta * bf).to(a.dtype)


def atax(a, x):
    """y = Aᵀ (A x) (updated-BLAS composite)."""
    ax = a.to(f32) @ x.to(f32)
    return (a.to(f32).T @ ax).to(a.dtype)


def bicgk(a, p, r):
    """q = A p ; s = Aᵀ r (BiCG kernel, updated-BLAS composite)."""
    q = a.to(f32) @ p.to(f32)
    s = a.to(f32).T @ r.to(f32)
    return q.to(a.dtype), s.to(a.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def mha(q, k, v, *, causal=True, window=None, scale=None):
    """Multi-head attention oracle.

    q: (B, Hq, Sq, D), k/v: (B, Hkv, Skv, D). GQA when Hq > Hkv.
    window: sliding-window size (None = full). Positions are aligned at
    the end: query i attends keys j with (Skv - Sq + i) >= j when causal.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    scale = (d ** -0.5) if scale is None else scale
    group = hq // hkv
    qf = q.to(f32).reshape(b, hkv, group, sq, d)
    kf, vf = k.to(f32), v.to(f32)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    logits = torch.where(mask[None, None, None], logits,
                         torch.tensor(-torch.inf, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, vf)
    return out.reshape(b, hq, sq, d).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None,
                     scale=None):
    """Single-new-token attention over a KV cache.

    q: (B, Hq, D); caches: (B, Hkv, Smax, D); cache_len: () or (B,)
    number of valid cache entries (the new token's K/V already written).
    """
    b, hq, d = q.shape
    _, hkv, smax, _ = k_cache.shape
    scale = (d ** -0.5) if scale is None else scale
    group = hq // hkv
    qf = q.to(f32).reshape(b, hkv, group, d)
    logits = torch.einsum("bhgd,bhkd->bhgk", qf, k_cache.to(f32)) * scale
    kpos = torch.arange(smax, device=q.device)[None]
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = kpos < lens
    if window is not None:
        valid &= kpos >= (lens - window)
    logits = torch.where(valid[:, None, None], logits,
                         torch.tensor(-torch.inf, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", probs, v_cache.to(f32))
    return out.reshape(b, hq, d).to(q.dtype)
