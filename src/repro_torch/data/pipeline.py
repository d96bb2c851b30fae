"""Data pipeline, the port of `repro/data/pipeline.py`: deterministic
synthetic LM streams and binary token files, batched by global step so
that a restart resumes the same stream.

`SyntheticLM` (an order-2 Markov chain over the vocab, so that a run has
real signal) and `TokenFileDataset` (np.memmap windows) draw with numpy
exactly as the reference does: their batches equal its batches bitwise,
as int32 tensors on the device the caller names (the host by default).
`EmbeddingStream` (the modality-frontend stub of musicgen and llava)
draws from a torch generator seeded by (seed, step) on the host: the
same shapes and dtypes as the reference's, deterministic and
restart-safe, its values its own (the reference's come from jax.random).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch


def _tensors(rows: np.ndarray, device) -> dict:
    """{"inputs", "labels"} of (B, S + 1) token rows, next-token shifted."""
    return {"inputs": torch.from_numpy(rows[:, :-1].copy()).to(device),
            "labels": torch.from_numpy(rows[:, 1:].copy()).to(device)}


@dataclasses.dataclass
class SyntheticLM:
    """Order-2 Markov chain token stream."""
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    branching: int = 4   # successors per state; lower is easier
    device: str = "cpu"

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # successor table: state (a, b) hashed -> `branching` candidates
        self._succ = rng.integers(0, self.vocab_size,
                                  size=(4096, self.branching),
                                  dtype=np.int32)

    def _hash(self, a, b):
        return (a * 1000003 + b * 10007) % 4096

    def batches(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a global step (restart-safe)."""
        rng = np.random.default_rng((self.seed, step))
        b, s, v = self.batch_size, self.seq_len, self.vocab_size
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, size=b)
        toks[:, 1] = rng.integers(0, v, size=b)
        choice = rng.integers(0, self.branching, size=(b, s + 1))
        for t in range(2, s + 1):
            h = self._hash(toks[:, t - 2], toks[:, t - 1])
            toks[:, t] = self._succ[h, choice[:, t]]
        return _tensors(toks, self.device)


@dataclasses.dataclass
class EmbeddingStream:
    """Synthetic modality-frontend stub stream (musicgen, llava):
    precomputed frame or patch embeddings (B, S, d) float32 and
    next-token labels (B, S) int32."""
    d_model: int
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    device: str = "cpu"

    def batch_at(self, step: int) -> dict:
        key = np.random.SeedSequence((self.seed, step)).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator().manual_seed(int(key) & (2 ** 63 - 1))
        emb = torch.randn((self.batch_size, self.seq_len, self.d_model),
                          generator=gen, dtype=torch.float32)
        labels = torch.randint(0, self.vocab_size,
                               (self.batch_size, self.seq_len),
                               generator=gen, dtype=torch.int32)
        return {"inputs": emb.to(self.device),
                "labels": labels.to(self.device)}


class TokenFileDataset:
    """np.memmap-backed binary token file (uint16/uint32), packed into
    (batch, seq + 1) windows; a deterministic order by global step."""

    def __init__(self, path, seq_len, batch_size, dtype=np.uint16, seed=0,
                 device="cpu"):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.seed = seed
        self.device = device
        self.n_windows = (len(self.tokens) - 1) // seq_len

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        idx = rng.integers(0, self.n_windows, size=self.batch_size)
        s = self.seq_len
        rows = np.stack([np.asarray(self.tokens[i * s:i * s + s + 1])
                         for i in idx]).astype(np.int32)
        return _tensors(rows, self.device)


def make_stream(cfg, *, seq_len: int, batch_size: int, seed: int = 0,
                device="cpu"):
    """The stream for an ArchConfig: tokens or embeddings."""
    if cfg.input_mode == "tokens":
        return SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq_len,
                           batch_size=batch_size, seed=seed, device=device)
    return EmbeddingStream(d_model=cfg.d_model, vocab_size=cfg.vocab_size,
                           seq_len=seq_len, batch_size=batch_size, seed=seed,
                           device=device)
