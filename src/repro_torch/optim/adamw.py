"""AdamW, the port of `repro/optim/adamw.py`: the same update on a flat
{name: tensor} mapping of parameters, with float32 moments.

The reference's update is functional and returns new trees. Here it
writes the parameters and the moments in place (a full-width model's
weights, gradients and moments fill most of one card; new copies would
not fit beside them) and returns them. The arithmetic is the
reference's: the gradients widened to float32, a global-norm clip
scaling them by min(1, clip / max(norm, 1e-9)), the moments
m = b1 m + (1 - b1) g and v = b2 v + (1 - b2) g², bias corrections with
t = step + 1, the decoupled weight decay on every parameter, and the
result cast back to the parameter's dtype. Plain torch ops per tensor;
the clip's scale stays on the device (no read-back per step). The
learning-rate schedule and the bias corrections are host floats,
computed in float32 as the reference computes them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Mapping, Optional, Union

import numpy as np
import torch

F32 = np.float32


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[int], float], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0

    def init(self, params: Mapping[str, torch.Tensor]):
        """Zero float32 moments {"m": {name: ...}, "v": {name: ...}} on
        each parameter's device."""
        def zeros():
            return {name: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
                    for name, p in params.items()}
        return {"m": zeros(), "v": zeros()}

    def _lr(self, step: int) -> float:
        if callable(self.lr):
            return self.lr(step)
        return float(F32(self.lr))

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor], opt_state, step: int, *,
               gnorm: Optional[torch.Tensor] = None):
        """One step at `step` (an int, from 0): params and opt_state
        written in place; returns (params, opt_state). `gnorm`, when
        given, is the gradients' global norm for the clip (a sharded
        state's, over every rank's blocks); else it is computed here."""
        scale = None
        if self.grad_clip is not None:
            if gnorm is None:
                gnorm = global_norm(grads.values())
            scale = (self.grad_clip / gnorm.clamp(min=1e-9)).clamp(max=1.0)
        t = F32(step) + F32(1.0)
        lr = self._lr(step)
        b1, b2 = self.b1, self.b2
        mhat = float(F32(1.0) / (F32(1.0) - np.power(F32(b1), t)))
        vhat = float(F32(1.0) / (F32(1.0) - np.power(F32(b2), t)))
        m_all, v_all = opt_state["m"], opt_state["v"]
        for name, p in params.items():
            # one tensor's float32 temporaries at a time
            g, m, v = grads[name].float(), m_all[name], v_all[name]
            if scale is not None:
                g = g * scale
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g * (1 - b2) * g)
            u = (m * mhat).div_((v * vhat).sqrt_().add_(self.eps))
            pf = p.float()
            u.add_(pf * self.weight_decay)
            p.copy_(pf - u.mul_(lr))
        return params, opt_state


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32, as a
    0-d tensor on the tensors' device."""
    return torch.sqrt(sum(x.float().square().sum() for x in tensors))


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable[[int], float]:
    """step -> lr: linear warm-up to peak_lr over `warmup` steps, then a
    cosine decay to floor * peak_lr at `total`; float32 arithmetic in
    the reference's order."""
    def lr(step: int) -> float:
        s = F32(step)
        warm = F32(peak_lr) * np.minimum(
            F32(1.0), (s + F32(1.0)) / F32(max(warmup, 1)))
        frac = np.clip((s - F32(warmup)) / F32(max(total - warmup, 1)),
                       F32(0.0), F32(1.0))
        cos = F32(floor) + F32((1 - floor) * 0.5) * (
            F32(1.0) + np.cos(F32(math.pi) * frac))
        return float(warm if s < F32(warmup) else F32(peak_lr) * cos)
    return lr
