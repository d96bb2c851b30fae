"""The port's cost counter (`repro_torch.launch.cost`), the counterpart
of `repro.launch.hlo_cost`.

* the cases of tests/test_hlo_cost.py on the port: a matmul's 2·M·N·K, a
  7-layer loop counted 7 times (and 5 x 3 nested), weight reads counted
  per layer, stash writes counted per slice, no collective bytes
  without a mesh;
* `mha` and `decode_attention` counted at their wrappers, from the
  shapes (the visible pairs, the valid keys), the plain versions' ops
  not counted again;
* the same counts on `meta` stand-ins and on CPU tensors, for reduced
  configs' train step, prefill and decode step;
* a rank's train step on meta stand-ins of a (2, 2) mesh: the
  collectives' bytes equal `train.step_traffic`'s, with and without the
  optimizer's clip;
* llama3-8b at full width, 2 layers, prefill of B 1 x S 512 on `meta`,
  within 5% of `repro.launch.hlo_cost.analyze_text` on the reference's
  same prefill, lowered from ShapeDtypeStructs on one device. The ratio
  found is 0.985: the port's `mha` counts the causal half of the pairs,
  2 (d + dv) a pair (2 layers x 32 heads x 131,328 pairs x 512 = 4.3e9
  flops), where the reference's `chunked_attention` computes the masked
  full score matrix (8.6e9); the rest of the difference is element-wise
  flops, which the reference's walker drops inside fusions and the port
  counts at every op.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.kernels import attention as katt
from repro_torch.kernels import decode_attention as kdec
from repro_torch.launch import specs as SP
from repro_torch.launch.cost import Cost, count
from repro_torch.models import model as tmodel
from repro_torch.models import sharding as TS
from repro_torch.optim import AdamW
from repro_torch.train import make_train_state, make_train_step, step_traffic

from _torch_caches import fresh_lowering_caches  # noqa: F401

META = torch.device("meta")


def test_plain_matmul_flops():
    a, b = torch.zeros(64, 128), torch.zeros(128, 32)
    _, c = count(torch.matmul, a, b)
    assert c.cost.flops == 2 * 64 * 128 * 32
    # A and B read once, C written once, float32
    assert c.cost.hbm_bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32)


def _layers(w, x):
    for wl in w:
        x = torch.tanh(x @ wl)
    return x


def test_loop_counted_per_iteration():
    w, x = torch.zeros(7, 32, 32), torch.zeros(8, 32)
    _, c = count(_layers, w, x)
    # 7 products and 7 tanh (one flop an element)
    assert c.cost.flops == 7 * (2 * 8 * 32 * 32 + 8 * 32)
    assert c.cost.flops == pytest.approx(7 * 2 * 8 * 32 * 32, rel=0.05)


def test_nested_loops_multiply():
    w, x = torch.zeros(3, 16, 16), torch.zeros(4, 16)

    def f(w, x):
        for _ in range(5):
            x = _layers(w, x)
        return x

    _, c = count(f, w, x)
    assert c.cost.flops == pytest.approx(5 * 3 * 2 * 4 * 16 * 16, rel=0.05)


def test_weight_reads_counted_per_layer():
    """A loop reading one (128, 128) layer of a stacked (L, 128, 128)
    weight a step counts about L layers' bytes, not L stacks."""
    layers = 10
    w, x = torch.zeros(layers, 128, 128), torch.zeros(4, 128)
    _, c = count(_layers, w, x)
    layer_bytes = 128 * 128 * 4
    assert c.cost.hbm_bytes < 3 * layers * layer_bytes + 1e6
    assert c.cost.hbm_bytes >= layers * layer_bytes


def test_stash_writes_counted_per_slice():
    """Writing each step's (256, 256) into its slice of a stacked stash
    counts the slice, not the whole stash, each step."""
    steps = 16
    x = torch.zeros(256, 256)

    def f(x):
        ys = torch.empty(steps, 256, 256)
        for i in range(steps):
            x = x * 1.5
            ys[i] = x
        return ys

    _, c = count(f, x)
    full = steps * 256 * 256 * 4
    assert 2 * full <= c.cost.hbm_bytes < 8 * full


def test_no_collective_without_a_mesh():
    _, c = count(lambda a: a * 2, torch.zeros(8, 8))
    assert c.cost.coll_bytes == 0 and c.cost.coll_detail == {}


@pytest.mark.parametrize("sq,skv,window", [(33, 70, None), (64, 64, 16),
                                           (1, 40, None), (40, 40, None)])
def test_mha_counted_at_its_wrapper(sq, skv, window):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, sq, 16, generator=g)
    k = torch.randn(2, 2, skv, 16, generator=g)
    v = torch.randn(2, 2, skv, 8, generator=g)
    _, c = count(katt.mha, q, k, v, causal=True, window=window)
    mask = katt._mask(0, sq, 0, skv, skv - sq, True, window, "cpu")
    pairs = int(mask.sum())
    assert c.kernels == {"mha": 1}
    assert c.cost.flops == 2 * (16 + 8) * 2 * 4 * pairs
    assert c.cost.hbm_bytes == 4 * (q.numel() + k.numel() + v.numel()
                                    + 2 * 4 * sq * 8)
    _, m = count(katt.mha, q.to(META), k.to(META), v.to(META), causal=True,
                 window=window)
    assert m.cost == c.cost


@pytest.mark.parametrize("length,window,lse", [(30, None, False),
                                               (30, 8, True), (0, None, True),
                                               (99, None, False)])
def test_decode_attention_counted_at_its_wrapper(length, window, lse):
    g = torch.Generator().manual_seed(1)
    q = torch.randn(3, 8, 16, generator=g)
    k = torch.randn(3, 2, 40, 16, generator=g)
    _, c = count(kdec.decode_attention, q, k, k, length, window=window,
                 return_lse=lse)
    keys = min(length, 40) - (max(length - window, 0) if window else 0)
    assert c.kernels == {"decode_attention": 1}
    assert c.cost.flops == 4 * 16 * 3 * 8 * keys
    assert c.cost.hbm_bytes == 4 * (2 * q.numel() + 2 * 3 * 2 * keys * 16
                                    + (3 * 8 if lse else 0))
    _, m = count(kdec.decode_attention, q.to(META), k.to(META), k.to(META),
                 length, window=window, return_lse=lse)
    assert m.cost == c.cost


ARCHS = ("llama3-8b", "deepseek-moe-16b", "minicpm3-4b", "hymba-1.5b",
         "xlstm-125m", "musicgen-medium")


def _cfg(arch):
    return dataclasses.replace(tconfigs.get_config(arch).reduced(),
                               dtype="float32")


def _inputs(cfg, device, b=2, s=12):
    if cfg.input_mode == "tokens":
        return torch.zeros((b, s), dtype=torch.int64, device=device)
    return torch.zeros((b, s, cfg.d_model), device=device)


def _model(cfg, device):
    if device == META:
        return tmodel.Model(cfg, device=META)
    return tmodel.init_params(cfg, 0, device="cpu")


def _same(cpu, meta):
    assert meta.cost == cpu.cost
    assert meta.kernels == cpu.kernels


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_count_the_same_on_meta_and_cpu(arch):
    cfg = _cfg(arch)
    got = {}
    for dev in (torch.device("cpu"), META):
        model = _model(cfg, dev)
        (_, caches, pos), pre = count(tmodel.prefill, model, cfg,
                                      _inputs(cfg, dev), 16)
        _, dec = count(tmodel.decode_step, model, cfg,
                       _inputs(cfg, dev)[:, 0], caches, pos)
        got[dev.type] = (pre, dec)
    for cpu, meta in zip(got["cpu"], got["meta"]):
        _same(cpu, meta)
    assert got["cpu"][0].cost.flops > 0 and got["cpu"][1].cost.flops > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_counts_the_same_on_meta_and_cpu(arch):
    cfg = _cfg(arch)
    got = {}
    for dev in (torch.device("cpu"), META):
        optim = AdamW()
        state = make_train_state(cfg, _model(cfg, dev), optim)
        step = make_train_step(cfg, optim)
        batch = {"inputs": _inputs(cfg, dev),
                 "labels": torch.zeros((2, 12), dtype=torch.int64,
                                       device=dev)}
        got[dev.type] = count(step, state, batch)[1]
    _same(got["cpu"], got["meta"])
    # remat: each attention layer's forward twice
    attn = sum(c for k, c in cfg.segments
               if k in ("attn", "attn_moe", "hybrid"))
    assert got["cpu"].kernels.get("mha", 0) == 2 * attn


@pytest.mark.parametrize("grad_clip", [1.0, None])
@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-moe-16b"])
def test_train_collectives_equal_step_traffic_with_and_without_clip(
        arch, grad_clip):
    """A rank's train step on meta stand-ins of a (2, 2) mesh: the
    collectives' bytes equal `train.step_traffic`'s, the clip norm's sum
    counted only where the optimizer clips."""
    cfg = _cfg(arch)
    mesh = TS.MeshShape({"data": 2, "model": 2})
    optim = AdamW(grad_clip=grad_clip)
    state, sspecs = SP.train_state_struct(cfg, mesh, optim)
    batch, _ = SP.train_batch_struct(cfg, mesh, tconfigs.InputShape(
        "train", 12, 4, "train"))
    step = make_train_step(cfg, optim, grad_specs=sspecs["params"])
    _, c = count(step, state, batch)
    want = step_traffic(cfg, mesh, batch=(4, 12),
                        clip=grad_clip is not None)
    assert c.cost.coll_bytes == sum(want.values())
    clipped = step_traffic(cfg, mesh, batch=(4, 12))
    assert want["gather"] == clipped["gather"]
    assert want["grad_sum"] == clipped["grad_sum"]
    assert (want["other"] < clipped["other"]) == (grad_clip is None)


def test_cost_adds_and_scales():
    a = Cost(1.0, 2.0, 3.0, {"all-gather": 3.0})
    a += Cost(1.0, 1.0, 1.0, {"all-reduce": 1.0})
    assert a == Cost(2.0, 3.0, 4.0, {"all-gather": 3.0, "all-reduce": 1.0})
    assert a.scaled(2) == Cost(4.0, 6.0, 8.0, {"all-gather": 6.0,
                                               "all-reduce": 2.0})


def test_full_width_prefill_within_5pct_of_the_reference():
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.launch.hlo_cost import analyze_text
    from repro.models import model as jmodel
    from repro.train import make_prefill_step

    def two_layers(pkg):
        return dataclasses.replace(pkg.get_config("llama3-8b"), n_layers=2,
                                   segments=(("attn", 2),))

    jcfg = two_layers(jconfigs)
    params = jax.eval_shape(
        lambda: jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    inp = jax.ShapeDtypeStruct((1, 512), jnp.int32)
    text = jax.jit(make_prefill_step(jcfg, max_len=512)).lower(
        params, inp).compile().as_text()
    want = analyze_text(text).flops

    tcfg = two_layers(tconfigs)
    _, got = count(tmodel.prefill, tmodel.Model(tcfg, device=META), tcfg,
                   torch.empty((1, 512), dtype=torch.int32, device=META), 512)
    ratio = got.cost.flops / want
    assert got.kernels == {"mha": 2}
    assert abs(ratio - 1) <= 0.05, ratio
    # the causal half of the pairs: the kernel counts 2 (d + dv) a
    # visible pair, the reference's masked scores every pair
    half = 2 * 32 * (512 * 513 // 2) * 2 * (128 + 128)
    assert want - got.cost.flops < 2 * half
    np.testing.assert_allclose(ratio, 0.985, atol=0.01)
