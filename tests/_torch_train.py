"""Shared by the port's train tests: the reference's loss and gradient
of one reduced float32 config on seeded numpy inputs, and the port's on
the same parameters (through `params_from_numpy`)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.models import convert, params_from_numpy, train_loss

B = 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread for the test (restored after): the
    reduced models' ops are tiny, and extra threads only contend for the
    cores the suite's workers share (import it into a test file to make
    it autouse there)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

_value_and_grad = jax.jit(jax.value_and_grad(jmodel.train_loss),
                          static_argnums=(1,), static_argnames=("remat",))


def cfgs(arch):
    return (dataclasses.replace(jconfigs.get_config(arch).reduced(),
                                dtype="float32"),
            dataclasses.replace(tconfigs.get_config(arch).reduced(),
                                dtype="float32"))


def batch_np(cfg, s, seed=1, masked=False):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        inputs = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    else:
        inputs = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    batch = {"inputs": inputs,
             "labels": rng.integers(0, cfg.vocab_size, (B, s)).astype(
                 np.int32)}
    if masked:
        batch["mask"] = (rng.random((B, s)) < 0.6).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def reference(arch, s, masked=False):
    """(params tree, batch, loss, gradient tree) of the reference, all
    numpy: `jax.value_and_grad(train_loss)` with remat, jitted, as it
    trains."""
    jcfg, _ = cfgs(arch)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    batch = batch_np(jcfg, s, masked=masked)
    loss, grads = _value_and_grad(
        params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        remat=True)
    return (jax.tree.map(np.asarray, params), batch, float(loss),
            jax.tree.map(np.asarray, grads))


def check_loss_and_grads(arch, s, remat, rel, masked=False):
    """The port's loss (within 1e-5 relative) and every parameter's
    gradient (|got - want| <= rel max|want|, per parameter) against the
    reference's."""
    tree, batch, want_loss, want_grads = reference(arch, s, masked)
    _, tcfg = cfgs(arch)
    model = params_from_numpy(tcfg, tree, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    loss = train_loss(model, tcfg, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, remat=remat)
    grads = torch.autograd.grad(loss, params)
    assert abs(loss.item() - want_loss) <= 1e-5 * abs(want_loss), (
        loss.item(), want_loss)
    want = convert.tree_to_named(model, want_grads)
    assert set(want) == set(names)
    for name, got in zip(names, grads):
        w = want[name]
        assert got.shape == w.shape, name
        assert bool(torch.isfinite(got).all()), name
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=rel * float(np.abs(w).max()),
                                   err_msg=f"{arch} d{name}")
