"""Shared model layers, the port of `repro/models/layers.py`.

Every dense projection goes through `dense()`. By default it is
`torch.matmul`: a plain large product, which the reference leaves to
XLA's einsum with float32 accumulation. Inside `use_gemm_kernel()` it
runs the port's gemm kernel (`kernels/gemm.matmul`), as the reference's
`use_pallas()` routes it through its Pallas gemm. That kernel has no
backward (the reference trains through `jnp.einsum`), so under grad
`dense` refuses it rather than return a product cut off from its
operands.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from ..kernels import gemm as k_gemm

_state = threading.local()


def use_gemm_kernel_now() -> bool:
    return getattr(_state, "gemm", False)


@contextlib.contextmanager
def use_gemm_kernel(on: bool = True):
    """Route dense() through the port's gemm kernel (inference only)."""
    prev = use_gemm_kernel_now()
    _state.gemm = on
    try:
        yield
    finally:
        _state.gemm = prev


def dense(x, w):
    """x @ w for x (..., K) and w (K, N); the output in x's dtype."""
    if use_gemm_kernel_now():
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            raise RuntimeError("dense: the gemm kernel has no backward; "
                               "leave use_gemm_kernel() off under grad "
                               "(training runs torch.matmul)")
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        out = k_gemm.matmul(x2, w.to(x.dtype).contiguous())
        return out.reshape(*lead, w.shape[-1])
    return torch.matmul(x, w.to(x.dtype))


def rmsnorm(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def _act(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":   # jax.nn.gelu's default is the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def glu_ffn(params: Mapping[str, torch.Tensor], x, act: str = "silu"):
    """Gated FFN (SwiGLU/GeGLU): down( act(gate(x)) * up(x) )."""
    g = dense(x, params["w_gate"])
    u = dense(x, params["w_up"])
    return dense(_act(g, act) * u, params["w_down"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device=None):
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def rope_angles(positions, dim: int, theta: float):
    """cos and sin of the rotation angles: positions (...) -> (..., D/2)
    each, in float32."""
    ang = positions[..., None].float() * rope_freqs(dim, theta,
                                                    positions.device)
    return torch.cos(ang), torch.sin(ang)


def rotate(x, cos, sin):
    """Rotate the pairs (x[2i], x[2i+1]) by the angles of `rope_angles`
    (the interleaved convention of the reference, not the half-split)."""
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, D) or (..., D) with matching positions (..., S)/(...)."""
    return rotate(x, *rope_angles(positions, x.shape[-1], theta))


def embed_lookup(table, ids):
    """Token embedding: a gather of rows (ids: (...) int32 or int64)."""
    flat = table.index_select(0, ids.reshape(-1))
    return flat.reshape(*ids.shape, table.shape[-1])


def init_dense(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32):
    """normal * fan_in**-0.5 (or `scale`), drawn in float32 on the
    generator's device, then cast."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    scale = scale if scale is not None else fan_in ** -0.5
    out = torch.randn(shape, generator=gen, device=gen.device,
                      dtype=torch.float32)
    return out.mul_(scale).to(dtype)
