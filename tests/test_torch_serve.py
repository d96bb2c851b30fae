"""Port parity for the serving engine and its launcher: the same numpy
weights and prompts go through the reference's `repro.serve.ServeEngine`
and the port's on the CPU. Greedy decoding is an argmax, which takes the
first maximum in both frameworks, and the two models' logits agree to
about 1e-6 of their scale (tests/test_torch_model.py), far inside the
top-1/top-2 margins of these seeded runs: the generated ids must be
identical. Temperature sampling draws from a torch.Generator, not from
jax.random, so it is checked for its own seeding only.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_params as jinit
from repro.serve import ServeEngine as JEngine, pad_and_batch as jpad
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import init_params, params_from_numpy
from repro_torch.serve import ServeEngine, pad_and_batch


# two layers of each segment kind of the reduced config: mixtral's MoE
# blocks under a window of 16, deepseek's dense first layer and MoE block
# with a shared expert, danube's windowed dense blocks
SEGMENTS = {"mixtral-8x22b": (("attn_moe", 2),),
            "deepseek-moe-16b": (("attn", 1), ("attn_moe", 1))}
SWA_MOE = ["mixtral-8x22b", "deepseek-moe-16b", "h2o-danube-3-4b"]


def _pair(arch="llama3-8b", seed=0):
    kw = dict(n_layers=2, segments=SEGMENTS.get(arch, (("attn", 2),)),
              dtype="float32")
    jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(), **kw)
    tcfg = dataclasses.replace(tconfigs.get_config(arch).reduced(), **kw)
    jparams = jinit(jcfg, jax.random.PRNGKey(seed))
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, model


def _prompts(cfg, seed, b=2, s=12):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ["llama3-8b", "starcoder2-3b", *SWA_MOE])
def test_greedy_tokens_equal_reference(arch):
    jcfg, tcfg, jparams, model = _pair(arch)
    prompts = _prompts(jcfg, 5)
    want = JEngine(jcfg, jparams, max_len=24, batch_size=2).generate(
        prompts, max_new_tokens=10)
    got = ServeEngine(tcfg, model, max_len=24, batch_size=2,
                      device="cpu").generate(prompts, max_new_tokens=10)
    assert got.tokens == want.tokens
    assert got.steps == want.steps == 10


@pytest.mark.parametrize("prompt,new", [(12, 10), (40, 6)])
@pytest.mark.parametrize("arch", SWA_MOE)
def test_greedy_tokens_across_a_ring_wrap(arch, prompt, new):
    """A 16-slot ring: prompt 12 and 10 tokens wrap it while decoding,
    prompt 40 wraps it in prefill. Left-padded ragged requests."""
    jcfg, tcfg, jparams, model = _pair(arch, seed=4)
    reqs = [list(r) for r in _prompts(jcfg, 11, b=2, s=prompt)]
    reqs[1] = reqs[1][prompt // 3:]
    ((tb, valid),) = pad_and_batch(reqs, batch_size=2)
    ((jb, _),) = jpad(reqs, batch_size=2)
    max_len = prompt + new
    want = JEngine(jcfg, jparams, max_len=max_len, batch_size=2).generate(
        jb, max_new_tokens=new, valid=valid)
    got = ServeEngine(tcfg, model, max_len=max_len, batch_size=2,
                      device="cpu").generate(tb, max_new_tokens=new,
                                             valid=valid)
    assert got.tokens == want.tokens and got.steps == want.steps == new


def test_pad_and_batch_matches_reference():
    reqs = [[5, 6], [7, 8, 9], [10], [11, 12, 13, 14], [15]]
    want = jpad(reqs, batch_size=2, pad_id=3)
    got = pad_and_batch(reqs, batch_size=2, pad_id=3)
    assert [v for _, v in got] == [v for _, v in want] == [2, 2, 1]
    for (g, _), (w, _) in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_filler_rows_never_reach_the_result():
    jcfg, tcfg, jparams, model = _pair(seed=1)
    reqs = [list(r) for r in _prompts(jcfg, 6, b=3, s=7)]
    reqs[2] = reqs[2][:4]                      # ragged: left-padded
    batches = pad_and_batch(reqs, batch_size=2)
    jbatches = jpad(reqs, batch_size=2)
    jeng = JEngine(jcfg, jparams, max_len=16, batch_size=2)
    teng = ServeEngine(tcfg, model, max_len=16, batch_size=2, device="cpu")
    for (tb, valid), (jb, _) in zip(batches, jbatches):
        want = jeng.generate(jb, max_new_tokens=5, valid=valid)
        got = teng.generate(tb, max_new_tokens=5, valid=valid)
        assert len(got.tokens) == valid
        assert got.tokens == want.tokens
    with pytest.raises(ValueError, match="valid"):
        teng.generate(batches[0][0], max_new_tokens=2, valid=3)


def test_stop_token_ends_as_the_reference_does():
    jcfg, tcfg, jparams, model = _pair(seed=2)
    prompts = _prompts(jcfg, 7, b=1)
    free = ServeEngine(tcfg, model, max_len=32, batch_size=1,
                       device="cpu").generate(prompts, max_new_tokens=12)
    stop = free.tokens[0][4]                   # met at the 4th decode step
    want = JEngine(jcfg, jparams, max_len=32, batch_size=1).generate(
        prompts, max_new_tokens=12, stop_token=stop)
    got = ServeEngine(tcfg, model, max_len=32, batch_size=1,
                      device="cpu").generate(prompts, max_new_tokens=12,
                                             stop_token=stop)
    assert got.tokens == want.tokens
    assert got.steps == want.steps <= 5
    assert got.tokens[0][-1] == stop


def test_temperature_sampling_is_seeded():
    _, tcfg, _, model = _pair(seed=3)
    prompts = _prompts(tcfg, 8)

    def run(seed):
        return ServeEngine(tcfg, model, max_len=24, batch_size=2,
                           temperature=1.5, seed=seed,
                           device="cpu").generate(prompts,
                                                  max_new_tokens=10).tokens

    a, b, c = run(0), run(0), run(1)
    assert a == b and a != c
    assert all(0 <= t < tcfg.vocab_size for row in a for t in row)


def test_engine_checks_its_inputs():
    _, tcfg, _, model = _pair()
    eng = ServeEngine(tcfg, model, max_len=10, batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="batch"):
        eng.generate(_prompts(tcfg, 1, b=3, s=4), max_new_tokens=2)
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(_prompts(tcfg, 1, s=8), max_new_tokens=3)


def test_no_device_and_no_card_raises(monkeypatch):
    _, tcfg, _, model = _pair()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(tcfg, model, max_len=16, batch_size=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "llama3-8b", "--reduced"])


def test_params_and_engine_on_one_device():
    _, tcfg, _, model = _pair()
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="lie on"):
            ServeEngine(tcfg, model, max_len=16, batch_size=2,
                        device="cuda")
    eng = ServeEngine(tcfg, model, max_len=16, batch_size=2, device="cpu")
    assert eng.device.type == "cpu"


@pytest.mark.parametrize("arch", ["llama3-8b", "starcoder2-3b", *SWA_MOE])
def test_launch_cli_runs_on_the_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "6",
                       "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "generated 4 tokens x 2 seqs" in out and "on cpu" in out
    assert out.count("seq") == 3


def test_launch_cli_refuses_embedding_archs():
    with pytest.raises(SystemExit, match="embedding inputs"):
        launch_serve.main(["--arch", "musicgen-medium", "--reduced",
                           "--device", "cpu"])


@pytest.mark.parametrize("arch,item", [("hymba-1.5b", "item 14.4"),
                                       ("minicpm3-4b", "item 14.3")])
def test_launch_cli_names_the_item_of_an_unported_arch(arch, item):
    with pytest.raises(NotImplementedError, match=item):
        launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu"])


def test_init_params_builds_the_served_model_on_the_cpu():
    cfg = dataclasses.replace(tconfigs.get_config("llama3-8b").reduced(),
                              dtype="float32")
    model = init_params(cfg, 0, device="cpu")
    res = ServeEngine(cfg, model, max_len=12, batch_size=1,
                      device="cpu").generate(_prompts(cfg, 9, b=1, s=4),
                                             max_new_tokens=3)
    assert res.steps == 3 and len(res.tokens[0]) == 3
