"""Gradient compression, the port of `repro/optim/compress.py`: int8
quantization with a per-tensor scale and stochastic rounding, unbiased
(E[deq(q(x))] = x), for the cross-host all-reduce.

The reference draws its uniforms from a jax key, split once per leaf.
Here an explicit `torch.Generator` takes the key's place, and the
uniforms come from one helper, `uniforms`, drawn leaf after leaf in the
tree's order (dict keys sorted, as jax flattens them); a test may feed
it another source's draws, and the quantized values then match that
source's bitwise.
"""
from __future__ import annotations

from typing import Optional

import torch


def uniforms(shape, generator: Optional[torch.Generator], device):
    """U[0, 1) float32 draws of `shape` on `device`."""
    gen_dev = generator.device if generator is not None else torch.device(
        "cpu")
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=gen_dev).to(device)


def quantize_int8(x, generator: Optional[torch.Generator] = None):
    """x -> (q int8, scale float32 0-d): x / scale rounded down or up at
    random, up with probability its fraction, clipped to [-127, 127]."""
    xf = x.float()
    scale = xf.abs().max().clamp(min=1e-12) / 127.0
    y = xf / scale
    lo = torch.floor(y)
    rnd = uniforms(x.shape, generator, x.device)
    q = lo + (rnd < y - lo).float()
    return q.clamp(-127.0, 127.0).to(torch.int8), scale


def dequantize_int8(q, scale):
    return q.float() * scale


def _leaves(tree):
    """The leaves of a tree of dicts, lists and tuples, dict keys sorted
    (jax's order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, leaves) for t in tree)
    return next(leaves)


def compress_tree(grads, generator: Optional[torch.Generator] = None):
    """Quantize every leaf; returns (quantized tree, scales tree)."""
    pairs = [quantize_int8(leaf, generator) for leaf in _leaves(grads)]
    return (_rebuild(grads, iter(q for q, _ in pairs)),
            _rebuild(grads, iter(s for _, s in pairs)))


def decompress_tree(qs, scales):
    return _rebuild(qs, iter(dequantize_int8(q, s) for q, s in
                             zip(_leaves(qs), _leaves(scales))))
