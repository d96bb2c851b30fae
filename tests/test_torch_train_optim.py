"""The port's optimizer, gradient compression, data streams and
checkpoint manager against the reference's (`repro.optim`,
`repro.data`, `repro.checkpoint`), on the CPU.

Tolerances:
* AdamW, 5 steps on the same gradients from the same state: moments and
  parameters within 1e-6 relative to their largest element (+1e-7 of the
  learning rate for the parameters). Each side rounds the same float32
  operations; torch may fuse a multiply-add that XLA rounds twice
  (measured ~1e-7).
* `cosine_schedule`: float32 arithmetic in the reference's order on
  both sides, within 2 float32 units (XLA's cos against numpy's).
* compression: bitwise, with jax's uniforms fed to the port's helper.
* streams and checkpoints: bitwise.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager as JManager
from repro.data import SyntheticLM as JSyntheticLM, \
    TokenFileDataset as JTokenFile, make_stream as jmake_stream
from repro.optim import AdamW as JAdamW, cosine_schedule as jcosine
from repro.optim import compress as jcompress
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import EmbeddingStream, SyntheticLM, \
    TokenFileDataset, make_stream
from repro_torch.optim import AdamW, compress, cosine_schedule, global_norm

SHAPES = {"a": (7, 5), "b": (33,), "c": (3, 4, 6)}


def _np_tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


# ---------------------------------------------------------------------------
# AdamW and the schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip,gscale", [(1.0, 3.0), (None, 1.0),
                                         (1e3, 0.1)])
def test_adamw_matches_reference_over_five_steps(clip, gscale):
    rng = np.random.default_rng(5)
    params = _np_tree(rng)
    grads = [_np_tree(rng, gscale) for _ in range(5)]
    lr = cosine_schedule(1e-2, warmup=2, total=5)
    jopt = JAdamW(lr=jcosine(1e-2, warmup=2, total=5), grad_clip=clip)
    topt = AdamW(lr=lr, grad_clip=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = topt.init(tp)
    for step, g in enumerate(grads):
        jp, js = jopt.update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                             js, jnp.asarray(step, jnp.int32))
        tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
        out, ts = topt.update(tp, tg, ts, step)
        assert out is tp
        for k, v in g.items():          # the gradients are left as given
            assert np.array_equal(tg[k].numpy(), v)
        for k in SHAPES:
            for got, want in ((ts["m"][k], js["m"][k]),
                              (ts["v"][k], js["v"][k])):
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=0,
                    atol=1e-6 * float(np.abs(want).max()))
            want = np.asarray(jp[k])
            np.testing.assert_allclose(
                tp[k].numpy(), want, rtol=0,
                atol=1e-6 * float(np.abs(want).max()) + 1e-7 * lr(step))


def test_adamw_keeps_bfloat16_parameters_and_float32_moments():
    p = {"w": torch.randn(4, 3).to(torch.bfloat16)}
    opt = AdamW(lr=0.1)
    st = opt.init(p)
    assert st["m"]["w"].dtype == torch.float32
    g = {"w": torch.randn(4, 3).to(torch.bfloat16)}
    want = JAdamW(lr=0.1).update(
        {"w": jnp.asarray(p["w"].float().numpy(), jnp.bfloat16)},
        {"w": jnp.asarray(g["w"].float().numpy(), jnp.bfloat16)},
        JAdamW(lr=0.1).init({"w": jnp.zeros((4, 3), jnp.bfloat16)}),
        jnp.asarray(0, jnp.int32))[0]["w"]
    opt.update(p, g, st, 0)
    assert p["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(p["w"].float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=2 ** -7)


def test_adamw_minimizes_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0, grad_clip=None)
    p = {"x": torch.tensor([5.0, -3.0])}
    st = opt.init(p)
    target = torch.tensor([1.0, 2.0])
    for step in range(200):
        opt.update(p, {"x": 2 * (p["x"] - target)}, st, step)
    torch.testing.assert_close(p["x"], target, rtol=0, atol=1e-2)


def test_grad_clip_bounds_update_norm():
    opt = AdamW(lr=1.0, grad_clip=1e-3, weight_decay=0.0)
    p = {"x": torch.zeros(4)}
    opt.update(p, {"x": torch.full((4,), 1e9)}, opt.init(p), 0)
    assert bool(torch.isfinite(p["x"]).all())


@pytest.mark.parametrize("peak,warmup,total", [(1e-3, 10, 100),
                                               (3e-3, 7, 60), (3e-4, 1, 1)])
def test_cosine_schedule_matches_reference_at_every_step(peak, warmup,
                                                         total):
    got = cosine_schedule(peak, warmup, total)
    want = jcosine(peak, warmup, total)
    for step in range(total + 3):
        w = float(want(jnp.asarray(step, jnp.int32)))
        assert abs(got(step) - w) <= 2 * np.spacing(np.float32(w)), step


def test_global_norm_matches_reference():
    from repro.optim import global_norm as jglobal_norm
    tree = _np_tree(np.random.default_rng(2))
    want = float(jglobal_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    got = float(global_norm(torch.from_numpy(v) for v in tree.values()))
    assert abs(got - want) <= 1e-6 * want


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------


def _feed_jax_uniforms(monkeypatch, keys):
    """The port's uniforms replaced by jax's draws from `keys`, in turn."""
    it = iter(keys)

    def draws(shape, generator, device):
        return torch.from_numpy(np.array(
            jax.random.uniform(next(it), tuple(shape))))

    monkeypatch.setattr(compress, "uniforms", draws)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_quantize_matches_reference_bitwise(monkeypatch, seed):
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (300,))) * 3
    key = jax.random.PRNGKey(seed + 1)
    jq, js = jcompress.quantize_int8(jnp.asarray(x), key)
    _feed_jax_uniforms(monkeypatch, [key])
    tq, ts = compress.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.float32(ts) == np.float32(js)
    assert np.array_equal(compress.dequantize_int8(tq, ts).numpy(),
                          np.asarray(jcompress.dequantize_int8(jq, js)))


def test_compress_tree_matches_reference_bitwise(monkeypatch):
    rng = np.random.default_rng(4)
    tree = {"w": rng.standard_normal((5, 6)).astype(np.float32),
            "b": {"c": rng.standard_normal(9).astype(np.float32),
                  "a": np.linspace(-1, 1, 33).astype(np.float32)}}
    key = jax.random.PRNGKey(9)
    jqs, jss = jcompress.compress_tree(jax.tree.map(jnp.asarray, tree), key)
    _feed_jax_uniforms(monkeypatch, jax.random.split(key, 3))
    tqs, tss = compress.compress_tree(jax.tree.map(torch.from_numpy, tree))
    for jl, tl in zip(jax.tree.leaves(jqs), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), tqs))):
        assert np.array_equal(np.asarray(jl), tl)
    deq = compress.decompress_tree(tqs, tss)
    for a, b in zip(jax.tree.leaves(jcompress.decompress_tree(jqs, jss)),
                    jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), deq))):
        assert np.array_equal(np.asarray(a), b)


@pytest.mark.parametrize("seed", [0, 1, 7, 42])
def test_quantization_unbiased_and_bounded(seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(256, generator=gen) * 3.0
    q, s = compress.quantize_int8(x, gen)
    assert float((compress.dequantize_int8(q, s) - x).abs().max()) <= \
        float(s) + 1e-6
    mean = torch.stack([compress.dequantize_int8(
        *compress.quantize_int8(x, gen)) for _ in range(64)]).mean(0)
    torch.testing.assert_close(mean, x, rtol=0, atol=float(s) / 4)


def test_compress_tree_roundtrip():
    tree = {"a": torch.arange(16, dtype=torch.float32),
            "b": {"c": torch.linspace(-1, 1, 33)}}
    qs, scales = compress.compress_tree(tree, torch.Generator().manual_seed(0))
    deq = compress.decompress_tree(qs, scales)
    for a, b in ((tree["a"], deq["a"]), (tree["b"]["c"], deq["b"]["c"])):
        assert float((a - b).abs().max()) <= float(a.abs().max()) / 127 + 1e-6


# ---------------------------------------------------------------------------
# Data streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("branching", [2, 4])
def test_synthetic_lm_batches_equal_reference(branching):
    kw = dict(vocab_size=300, seq_len=40, batch_size=3, seed=2,
              branching=branching)
    ref, port = JSyntheticLM(**kw), SyntheticLM(**kw)
    assert np.array_equal(ref._succ, port._succ)
    for step in (0, 1, 17, 123):
        want, got = ref.batch_at(step), port.batch_at(step)
        for k in ("inputs", "labels"):
            assert got[k].dtype == torch.int32
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


def test_synthetic_lm_restart_safe_and_shifted():
    ds1 = SyntheticLM(vocab_size=256, seq_len=32, batch_size=4, seed=1)
    ds2 = SyntheticLM(vocab_size=256, seq_len=32, batch_size=4, seed=1)
    b5 = ds1.batch_at(5)
    assert torch.equal(b5["inputs"], ds2.batch_at(5)["inputs"])
    assert not torch.equal(b5["inputs"], ds1.batch_at(6)["inputs"])
    assert torch.equal(b5["inputs"][:, 1:], b5["labels"][:, :-1])
    it = ds1.batches(start_step=5)
    assert torch.equal(next(it)["labels"], b5["labels"])
    assert torch.equal(next(it)["labels"], ds2.batch_at(6)["labels"])


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_token_file_batches_equal_reference(tmp_path, dtype):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(3).integers(0, 60000, 5000).astype(dtype).tofile(
        path)
    ref = JTokenFile(path, seq_len=64, batch_size=4, dtype=dtype, seed=8)
    port = TokenFileDataset(path, seq_len=64, batch_size=4, dtype=dtype,
                            seed=8)
    assert port.n_windows == ref.n_windows
    for step in (0, 9, 40):
        want, got = ref.batch_at(step), port.batch_at(step)
        for k in ("inputs", "labels"):
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("arch", ["musicgen-medium", "llava-next-34b"])
def test_make_stream_embedding_mode(arch):
    tcfg = tconfigs.get_config(arch).reduced()
    want = jmake_stream(jconfigs.get_config(arch).reduced(), seq_len=16,
                        batch_size=2).batch_at(3)
    s = make_stream(tcfg, seq_len=16, batch_size=2)
    assert isinstance(s, EmbeddingStream)
    b = s.batch_at(3)
    for k in ("inputs", "labels"):
        assert tuple(b[k].shape) == tuple(want[k].shape)
        assert str(b[k].dtype).split(".")[-1] == str(want[k].dtype)
    assert b["inputs"].shape == (2, 16, tcfg.d_model)
    assert bool(((b["labels"] >= 0) & (b["labels"] < tcfg.vocab_size)).all())
    again = make_stream(tcfg, seq_len=16, batch_size=2).batch_at(3)
    assert all(torch.equal(b[k], again[k]) for k in b)    # restart-safe
    assert not torch.equal(b["inputs"], s.batch_at(4)["inputs"])


def test_make_stream_token_mode():
    cfg = tconfigs.get_config("llama3-8b").reduced()
    s = make_stream(cfg, seq_len=8, batch_size=2, seed=3)
    assert isinstance(s, SyntheticLM) and s.vocab_size == cfg.vocab_size


# ---------------------------------------------------------------------------
# Checkpoints: each case of tests/test_checkpoint_ft.py, plus bfloat16
# ---------------------------------------------------------------------------


def _tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 8, generator=gen),
                       "b": torch.zeros(8)},
            "opt": {"m": {"w": torch.randn(8, 8, generator=gen),
                          "b": torch.ones(8)}},
            "step": torch.tensor(7, dtype=torch.int32)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    mgr.save(10, tree, blocking=True)
    assert mgr.latest_valid_step() == 10
    step, restored = mgr.restore_latest(tree)
    assert step == 10
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_format_readable_by_reference_and_back(tmp_path):
    """The same on-disk format: the reference restores the port's step
    and the port the reference's."""
    tree = _tree()
    CheckpointManager(tmp_path / "p").save(3, tree, blocking=True)
    like = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
    _, got = JManager(tmp_path / "p").restore_latest(like)
    for a, b in zip(_leaves(tree), jax.tree.leaves(got)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    JManager(tmp_path / "j").save(4, like, blocking=True)
    _, back = CheckpointManager(tmp_path / "j").restore_latest(tree)
    for a, b in zip(_leaves(tree), _leaves(back)):
        # the reference stores a 0-d array (the step) as shape (1,)
        assert torch.equal(a, b.reshape(a.shape))


def test_corrupted_checkpoint_skipped(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    mgr.save(1, tree, blocking=True)
    mgr.save(2, tree, blocking=True)
    target = sorted((tmp_path / "step_0000000002").glob("arr_*.npy"))[0]
    raw = bytearray(target.read_bytes())
    raw[-8] ^= 0xFF
    target.write_bytes(bytes(raw))
    assert mgr.latest_valid_step() == 1
    assert mgr.restore_latest(tree)[0] == 1


def test_torn_write_never_published(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree(), blocking=True)
    tmp = tmp_path / "step_0000000005.tmp"
    tmp.mkdir()
    (tmp / "arr_00000.npy").write_bytes(b"garbage")
    assert mgr.all_steps() == [1]
    assert mgr.latest_valid_step() == 1


def test_keep_last_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(), blocking=True)
    assert mgr.all_steps() == [3, 4]


def test_restore_onto_a_named_device(tmp_path):
    """The reference's elastic restore onto explicit shardings is
    `device=` here: every leaf lands there, whatever `like` holds."""
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    mgr.save(3, tree, blocking=True)
    like = {"params": {"w": None, "b": None}, "opt": {"m": {"w": 0, "b": 0}},
            "step": 0}
    step, restored = mgr.restore_latest(like, device="cpu")
    assert step == 3
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert b.device.type == "cpu" and torch.equal(a, b)


def test_missing_array_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"a": torch.ones(3)}, blocking=True)
    with pytest.raises(ValueError, match="missing"):
        mgr.restore(1, {"a": torch.ones(3), "b": torch.ones(3)})


def test_bfloat16_restored_bitwise(tmp_path):
    gen = torch.Generator().manual_seed(1)
    w = torch.randn(5, 7, generator=gen).to(torch.bfloat16)
    w[0, 0] = float("nan")
    w[0, 1] = -0.0
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, {"w": w, "f": torch.ones(2)}, blocking=True)
    manifest = json.loads((tmp_path / "step_0000000002" /
                           "manifest.json").read_text())
    assert manifest["arrays"]["w"]["dtype"] == "bfloat16"
    got = mgr.restore(2, {"w": w, "f": torch.ones(2)})["w"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), w.view(torch.int16))


def test_async_save_snapshots_and_reraises(tmp_path):
    """The snapshot is taken at save(): a tensor written in place after it
    does not reach the step; an error of the write comes back at the
    next save."""
    mgr = CheckpointManager(tmp_path)
    t = torch.zeros(4)
    mgr.save(1, {"t": t})
    t.add_(1.0)
    mgr.wait()
    assert torch.equal(mgr.restore(1, {"t": t})["t"], torch.zeros(4))

    def boom(step, host):
        raise OSError("disk full")

    mgr._write = boom
    mgr.save(2, {"t": t})
    with pytest.raises(OSError, match="disk full"):
        mgr.save(3, {"t": t})
