"""Train and serve step factories, the port of `repro/train/step.py`.

The train state is {"params": the `Model` (its parameters requiring
grad), "opt": {"m", "v"} float32 moments under the Model's parameter
names, "step": an int}. The reference's step is functional; here
`train_step(state, batch)` writes the state in place (the optimizer
updates the weights and moments where they lie) and returns it with the
metrics. `state_tree` and `load_state_tree` give the state as a tree of
tensors for the checkpoint manager and back.

Sharded training is not ported yet: the reference's `grad_specs` pins
gradients to GSPMD shardings, which have no counterpart in a
one-process program (ROADMAP item 14.6b), so a non-None `grad_specs` is
refused rather than ignored.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models import model as M
from ..optim import AdamW

SHARDED = ("sharded training (grad_specs, a mesh of more than one rank) "
           "is not ported yet: ROADMAP item 14.6b")


def make_train_state(cfg: ArchConfig, params: M.Model, optim: AdamW):
    """The train state of a Model: its parameters made to require grad,
    zero moments, step 0."""
    for p in params.parameters():
        p.requires_grad_(True)
    return {"params": params,
            "opt": optim.init(dict(params.named_parameters())), "step": 0}


def state_tree(state):
    """The state as a tree of tensors (the step a 0-d int64 tensor): what
    the checkpoint manager saves, and the `like` it restores into."""
    return {"params": {n: p.detach() for n, p in
                       state["params"].named_parameters()},
            "opt": state["opt"],
            "step": torch.tensor(state["step"], dtype=torch.int64)}


@torch.no_grad()
def load_state_tree(state, tree):
    """Write a tree of `state_tree`'s layout into the state, in place."""
    for n, p in state["params"].named_parameters():
        p.copy_(tree["params"][n])
    for key in ("m", "v"):
        for n, t in state["opt"][key].items():
            t.copy_(tree["opt"][key][n])
    state["step"] = int(tree["step"])
    return state


def make_train_step(cfg: ArchConfig, optim: AdamW, *, remat: bool = True,
                    grad_specs=None):
    """state, batch -> state (updated in place), {"loss": 0-d tensor}."""
    if grad_specs is not None:
        raise ValueError(f"make_train_step: {SHARDED}")

    def train_step(state, batch):
        model = state["params"]
        named = dict(model.named_parameters())
        with torch.enable_grad():
            loss = M.train_loss(model, cfg, batch, remat=remat)
            grads = torch.autograd.grad(loss, list(named.values()))
        optim.update(named, dict(zip(named, grads)), state["opt"],
                     state["step"])
        del grads
        state["step"] += 1
        return state, {"loss": loss.detach()}

    return train_step


def make_serve_step(cfg: ArchConfig):
    """One greedy decode step: (params, caches, token or embedding, pos)
    -> (logits, caches)."""
    def serve_step(params, caches, inputs_t, pos):
        return M.decode_step(params, cfg, inputs_t, caches, pos)

    return serve_step


def make_prefill_step(cfg: ArchConfig, max_len: int):
    def prefill_step(params, inputs):
        return M.prefill(params, cfg, inputs, max_len)

    return prefill_step
