"""Prefill and decode on a sharded model (`models.model.shard_model`,
`prefill` and `decode_step` over `CacheBlocks`), against the reference's
sharded serve and against the same model served whole.

One 8-rank gloo world (tests/_torch_shard_serve_check.py `rank`, a
process per rank, a file store) runs every case of its CASES: reduced
float32 llama3-8b, mixtral-8x22b (window-16 ring, MoE), minicpm3-4b
(MLA), hymba-1.5b (ring and SSD states), xlstm-125m (recurrent states
only), musicgen-medium (embedding inputs) and deepseek-moe-16b, each
segment of 2 layers, on ("data" 2, "model" 4) and ("pod" 2, "data" 2,
"model" 2) meshes; a batch of 3 that does not divide over DP; and a
max_len of 30 that does not divide over "model" (the cache stays whole
on every rank). Each rank serves its block of a batch of 4 (a prompt of
14, then 4 teacher-forced decode steps that wrap the rings) and gathers
its logits and cache blocks. Beside the world, JAX_PARTS subprocesses
(`... jax DIR PART`, 8 forced host devices) run the reference's jitted
`make_prefill_step` and `make_serve_step` on the same weights and
inputs, on a mesh of the same shape, the parameters under
`param_specs`, the prompt under `batch_specs`, the caches under
`cache_specs` and the decode inputs under `decode_input_specs` before
each step, as `repro/launch/dryrun.py` lowers them (but for one
parameter of hymba-1.5b on the 2 x 2 x 2 mesh, placed whole: under its
spec XLA's partitioner gets two rows of the reference's step wrong, a
fault of the reference's sharded step that its own unsharded step shows;
see REFERENCE_WHOLE in the helper). Every rank's
gathered logits and caches must agree with the reference's, each tensor
within REF_REL (2e-5, tests/test_torch_hybrid.py's bound between the two
packages) of its largest magnitude (seen: <= 7.0e-6, xlstm-125m's sLSTM
state on the 2 x 2 x 2 mesh after 3 steps), and with the whole model's
served in the rank's own process within REL (seen: <= 1.7e-6,
xlstm-125m on the 2 x 2 x 2 mesh, the sums over other batch blocks'
products). The MoE
configs' reduced capacity drops no pair, per block or whole, so their
dispatch agrees too.

A world of one (`one`) on (1, 1) and (1, 1, 1) meshes is bitwise the
whole model's serve path, logits and caches. And in process:
`decode_attention_plain`'s lse against a float64 log-sum-exp, and the
three partial decode attentions over a cache cut into blocks, folded as
`combine_partials` folds them, against the whole. About 45 s, the
reference's compiles the long pole.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as kdec
from repro_torch.models import attention as tattn

HERE = pathlib.Path(__file__).resolve().parent
CHECK = HERE / "_torch_shard_serve_check.py"
SRC = str(HERE.parent / "src")
WORLD, TIMEOUT = 8, 300
REL, REF_REL = 1e-5, 2e-5

sys.path.insert(0, str(HERE))
import _torch_shard_serve_check as C  # noqa: E402

CASES = [c[0] for c in C.CASES]
STAGES = range(1 + C.STEPS)


def _env(tmp):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    logs = ([tmp / f"rank_{r}.log" for r in range(WORLD)] + [tmp / "one.log"]
            + [tmp / f"jax_{i}.log" for i in range(C.JAX_PARTS)])
    args = [["rank", str(tmp), str(r), str(WORLD)] for r in range(WORLD)]
    args.append(["one", str(tmp)])
    args += [["jax", str(tmp), str(i)] for i in range(C.JAX_PARTS)]
    procs = []
    for a, log in zip(args, logs):
        with open(log, "w") as out:
            procs.append(subprocess.Popen([sys.executable, str(CHECK), *a],
                                          env=_env(tmp), stdout=out,
                                          stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text()[-4000:]
    ranks = [dict(np.load(tmp / f"serve_{r}.npz")) for r in range(WORLD)]
    jax = {}
    for i in range(C.JAX_PARTS):
        jax.update(np.load(tmp / f"jax_{i}.npz"))
    return ranks, dict(np.load(tmp / "serve_one.npz")), jax


@pytest.mark.parametrize("what", ["logits", "cache"])
@pytest.mark.parametrize("case", CASES)
def test_sharded_serve_matches_reference(worlds, case, what):
    ranks, _, jax = worlds
    for i in STAGES:
        want = {k: v for k, v in jax.items()
                if k == f"{case}/{what}/{i}"
                or k.startswith(f"{case}/{what}/{i}/")}
        assert want, (case, what, i)
        for rank, got in enumerate(ranks):
            for key, w in want.items():
                g = got[f"{case}/got/{key[len(case) + 1:]}"]
                assert g.shape == w.shape, (rank, key, g.shape, w.shape)
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=REF_REL * float(np.abs(w).max()),
                    err_msg=f"rank {rank} {key}")


@pytest.mark.parametrize("what", ["logits", "cache"])
@pytest.mark.parametrize("case", CASES)
def test_sharded_serve_matches_whole(worlds, case, what):
    ranks, _, _ = worlds
    for rank, got in enumerate(ranks):
        for i in STAGES:
            err, top = got[f"{case}/{what}/{i}"]
            assert err <= REL * top, (rank, i, err, top)


@pytest.mark.parametrize("tag", [f"{a}-{'x'.join(map(str, m.values()))}"
                                 for a in C.ONE_ARCHS for m in C.ONE_MESHES])
def test_world_of_one_is_bitwise_the_whole_model(worlds, tag):
    _, one, _ = worlds
    assert bool(one[f"{tag}/logits"]) and bool(one[f"{tag}/cache"])


@pytest.mark.parametrize("length,window", [(37, None), (1, None), (0, None),
                                           (60, 16), (64, None), (90, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_lse_against_float64(length, window, dtype):
    g = torch.Generator().manual_seed(length)
    q = torch.randn(3, 8, 32, generator=g).to(dtype)
    k = torch.randn(3, 2, 64, 32, generator=g).to(dtype)
    v = torch.randn(3, 2, 64, 32, generator=g).to(dtype)
    out, lse = kdec.decode_attention_plain(q, k, v, length, window=window,
                                           return_lse=True)
    assert torch.equal(out, kdec.decode_attention_plain(q, k, v, length,
                                                        window=window))
    assert lse.shape == (3, 8) and lse.dtype == torch.float32
    s = torch.einsum("bhgd,bhkd->bhgk", q.double().reshape(3, 2, 4, 32),
                     k.double()) * 32 ** -0.5
    kpos = torch.arange(64)
    valid = (kpos < length) & ((kpos >= length - window) if window else True)
    if not valid.any():
        assert torch.all(lse == -torch.inf)
        assert torch.all(out == 0)
        return
    want = torch.logsumexp(s[..., valid], dim=-1).reshape(3, 8)
    np.testing.assert_allclose(lse.double(), want, rtol=0, atol=1e-5)


def _fold(parts):
    """`combine_partials`' fold of [(out, lse)] in order, without a
    mesh."""
    lses = torch.stack([lse for _, lse in parts])
    top = lses.amax(dim=0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    num = den = 0
    for out, lse in parts:
        w = torch.exp(lse - top)
        num = num + out.float() * w[..., None]
        den = den + w
    return num / torch.where(den == 0, torch.ones_like(den), den)[..., None]


@pytest.mark.parametrize("pos", [0, 9, 23, 40])
def test_partial_decode_attentions_fold_into_the_whole(pos):
    g = torch.Generator().manual_seed(pos)
    q = torch.randn(2, 4, 16, generator=g)
    k, v = (torch.randn(2, 24, 2, 16, generator=g) for _ in range(2))
    blocks = 4
    blk = 24 // blocks
    if pos < 24:          # the full cache, positions [0, pos] valid
        whole = tattn.decode_attention_full(q, k, v, pos)
        parts = [tattn.decode_attention_full(
            q, k[:, i * blk:(i + 1) * blk], v[:, i * blk:(i + 1) * blk],
            pos, offset=i * blk) for i in range(blocks)]
        torch.testing.assert_close(_fold(parts), whole, rtol=0, atol=1e-6)
    # the ring of 24 slots (a window of 24), wrapped past pos 23
    whole = tattn.decode_attention_ring(q, k, v, pos, window=24)
    parts = [tattn.decode_attention_ring(
        q, k[:, i * blk:(i + 1) * blk], v[:, i * blk:(i + 1) * blk], pos,
        window=24, offset=i * blk, slots=24) for i in range(blocks)]
    torch.testing.assert_close(_fold(parts), whole, rtol=0, atol=1e-6)
    if pos < 24:          # MLA's latent caches
        q_lat, q_rope = torch.randn(2, 4, 8, generator=g), torch.randn(
            2, 4, 4, generator=g)
        ckv, kr = torch.randn(2, 24, 8, generator=g), torch.randn(
            2, 24, 4, generator=g)
        whole = tattn.decode_attention_mla(q_lat, q_rope, ckv, kr, pos,
                                           scale=0.3)
        parts = [tattn.decode_attention_mla(
            q_lat, q_rope, ckv[:, i * blk:(i + 1) * blk],
            kr[:, i * blk:(i + 1) * blk], pos, scale=0.3, offset=i * blk)
            for i in range(blocks)]
        torch.testing.assert_close(_fold(parts), whole, rtol=0, atol=1e-6)
