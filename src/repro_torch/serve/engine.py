"""Serving engine, the port of `repro/serve/engine.py`: batched prefill,
then greedy or temperature decode over a preallocated KV cache written
in place.

The engine runs on the card unless it is given `device="cpu"`, and
raises with no card and no device. Per decode step it issues the model's
kernels and reads nothing back: the position stays a host int, and the
decode kernel's per-row cache lengths are one (B,) int32 tensor on the
device, advanced in place. Only a `stop_token` makes it read one flag
per step, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..configs.base import ArchConfig
from ..kernels import common
from ..models import Model, decode_step, prefill


@dataclasses.dataclass
class GenerationResult:
    """Generated ids for the REAL requests of one batch: filler rows
    (a short final batch is padded to size by repeating its last
    request) are dropped before results leave the engine, so callers
    never mistake a filler's tokens for a served response."""
    tokens: List[List[int]]     # per-sequence generated ids
    steps: int


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params: Model, *, max_len: int,
                 batch_size: int, temperature: float = 0.0, seed: int = 0,
                 device=None):
        if cfg.input_mode != "tokens":
            # generate() feeds token ids back as the next inputs
            raise ValueError(f"{cfg.name} takes {cfg.input_mode} inputs; "
                             f"the engine serves token archs (drive "
                             f"prefill and decode_step with embeddings)")
        self.device = common.resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"the parameters lie on {params.device}, the "
                             f"engine runs on {self.device}")
        self.device = params.device
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.batch_size = batch_size
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def _next(self, logits):
        if self.temperature > 0.0:
            # Gumbel-max: a categorical draw from softmax(logits / T)
            # with no host sync (not jax.random.categorical's draws)
            noise = torch.empty(logits.shape, dtype=torch.float32,
                                device=logits.device)
            noise.exponential_(generator=self.gen)
            scores = logits.float() / self.temperature - noise.log()
            return torch.argmax(scores, dim=-1).to(torch.int32)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def generate(self, prompts, *, max_new_tokens: int,
                 stop_token: Optional[int] = None,
                 valid: Optional[int] = None) -> GenerationResult:
        """prompts: (B, S) int (right-aligned, same length — the batcher
        pads upstream). `valid` is the per-batch real-request count from
        `pad_and_batch`: rows past it are fillers and are dropped from
        the result (they still decode — the batch shape is fixed — but
        their tokens never surface)."""
        prompts = torch.as_tensor(prompts, dtype=torch.int32,
                                  device=self.device)
        b, s = prompts.shape
        if b != self.batch_size:
            raise ValueError(f"batch of {b} rows, the engine takes "
                             f"{self.batch_size}")
        if s + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {s} + {max_new_tokens} new tokens "
                             f"exceed max_len {self.max_len}")
        if valid is None:
            valid = b
        if not 0 < valid <= b:
            raise ValueError(
                f"valid={valid} must be in 1..batch_size={b}")

        logits, caches, pos = prefill(self.params, self.cfg, prompts,
                                      self.max_len)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        outs = [tok]
        done = torch.zeros((b,), dtype=torch.bool, device=self.device)
        cache_len = torch.full((b,), pos + 1, dtype=torch.int32,
                               device=self.device)
        for _ in range(max_new_tokens - 1):
            logits, caches = decode_step(self.params, self.cfg, tok, caches,
                                         pos, cache_len=cache_len)
            tok = self._next(logits)
            pos += 1
            cache_len.add_(1)
            if stop_token is not None:
                done |= tok == stop_token
                if bool(done.all()):
                    outs.append(tok)
                    break
            outs.append(tok)
        toks = torch.stack(outs, dim=1).cpu()
        return GenerationResult(tokens=toks[:valid].tolist(),
                                steps=toks.shape[1])


def pad_and_batch(prompts: List[List[int]], batch_size: int,
                  pad_id: int = 0):
    """Left-pad a ragged request list into fixed (B, S) batches.

    Returns (batch, valid) pairs: `valid` is how many leading rows are
    real requests. A short final chunk is filled to `batch_size` by
    repeating its last request, so without the count a caller reading
    the batch array alone cannot tell a filler row from a genuinely
    duplicated request — pass `valid` through to
    `ServeEngine.generate` and the fillers never reach a result. The
    batches are int32 CPU tensors; the engine moves them to its
    device."""
    batches = []
    for i in range(0, len(prompts), batch_size):
        chunk = prompts[i:i + batch_size]
        valid = len(chunk)
        while len(chunk) < batch_size:
            chunk = chunk + [chunk[-1]]      # repeat to fill the batch
        s = max(len(p) for p in chunk)
        rows = [[pad_id] * (s - len(p)) + list(p) for p in chunk]
        batches.append((torch.tensor(rows, dtype=torch.int32), valid))
    return batches
