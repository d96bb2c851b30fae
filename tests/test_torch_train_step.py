"""The port's train step against the reference's: 3 steps of llama3-8b
and deepseek-moe-16b, reduced, float32, from the same train state on
both sides (the reference's, after two of its own steps so that the
moments are not zero, carried across by `train_state_from_numpy`),
against the reference's jitted `train_step`.

Tolerance: each step's loss within 1e-5 relative, and the final
parameters and moments within 1e-5 of their largest element (+1e-6 of
the peak learning rate for the parameters). Each step's gradient agrees
to ~1e-6 (tests/test_torch_train_loss.py), which AdamW's normalised
update carries into the weights at most lr times over.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jmodel
from repro.optim import AdamW as JAdamW, cosine_schedule as jcosine
from repro.train import make_train_state as jmake_state, \
    make_train_step as jmake_step
from repro_torch.models import convert, train_state_from_numpy, \
    train_state_to_numpy
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.train import make_train_step

from _torch_train import batch_np, cfgs
from _torch_train import one_torch_thread  # noqa: F401 (autouse)

PEAK = 3e-3


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-moe-16b"])
def test_train_step_matches_reference(arch):
    jcfg, tcfg = cfgs(arch)
    jopt = JAdamW(lr=jcosine(PEAK, warmup=2, total=10))
    jstep = jax.jit(jmake_step(jcfg, jopt, remat=True))
    state = jmake_state(jcfg, jmodel.init_params(jcfg, jax.random.PRNGKey(0)),
                        jopt)
    batches = [batch_np(jcfg, 16, seed=s) for s in range(5)]
    for b in batches[:2]:
        state, _ = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
    tstate = train_state_from_numpy(tcfg, jax.tree.map(np.asarray, state),
                                    device="cpu")
    assert tstate["step"] == 2
    tstep = make_train_step(tcfg, AdamW(lr=cosine_schedule(PEAK, warmup=2,
                                                           total=10)))
    for b in batches[2:]:
        state, jm = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        want = float(jm["loss"])
        assert abs(float(tm["loss"]) - want) <= 1e-5 * abs(want)
    assert tstate["step"] == int(state["step"]) == 5
    got = train_state_to_numpy(tstate)
    want = jax.tree.map(np.asarray, state)
    model = tstate["params"]
    for part, slack in (("params", 1e-6 * PEAK), ("m", 0.0), ("v", 0.0)):
        g_tree = got["params"] if part == "params" else got["opt"][part]
        w_tree = want["params"] if part == "params" else want["opt"][part]
        g_named = convert.tree_to_named(model, g_tree)
        for name, w in convert.tree_to_named(model, w_tree).items():
            np.testing.assert_allclose(
                g_named[name], w, rtol=0,
                atol=1e-5 * float(np.abs(w).max()) + slack,
                err_msg=f"{arch} {part} {name}")
