"""Subprocess bodies for tests/test_torch_shard_train.py (and the loop
world of tests/test_torch_train_loop.py, the world of one of
tests/test_torch_shard_one.py): the port's
sharded train step (`repro_torch.models.sharding`, `partition`,
`train.make_train_step(grad_specs=)`) in an 8-rank gloo world, and the
reference's `repro.train.make_train_step`, jitted under `jax.set_mesh`
on 8 forced host devices with its state `device_put` onto
`param_specs` (as `repro/launch/train.py` places it), over the same
weights and batches.

    python _torch_shard_check.py jax DIR PART           # DIR/jax_PART.npz
    python _torch_shard_check.py rank DIR RANK WORLD    # DIR/rank_RANK.npz
    python _torch_shard_check.py loop DIR RANK 4        # DIR/loop_RANK.npz
    python _torch_shard_check.py one DIR                # DIR/one.npz

Every case of CASES trains two steps, each segment given 2 layers so
that the per-layer gathers run more than once, from the same state on
both sides (`start_state`; the port places it on the mesh through
`load_state_tree`, the elastic restore). Each rank runs every case twice
(RUNS) and writes, per case and run, the losses and its stored blocks of
the parameters and both moments, and the bytes its collectives moved in
run "a"'s last step; rank 0 also the whole state (`state_tree`) and, for
the dense configs, the one-process port step on the whole batch. The reference's 8 host devices must be set before jax
initialises, and a gloo world needs a process per rank, so neither runs
inside the pytest process.
"""
import contextlib
import dataclasses
import os
import pathlib
import sys

import numpy as np

# (case, arch, mesh {name: size}, style, n_experts in place of the
# reduced config's, or None)
CASES = (
    ("hymba-1.5b-2d", "hymba-1.5b", {"data": 4, "model": 2}, "2d", None),
    # 6 experts on 4 "model" ranks: the TP variant
    ("deepseek-moe-16b-tp", "deepseek-moe-16b", {"data": 2, "model": 4},
     "2d", 6),
    ("minicpm3-4b-2d", "minicpm3-4b", {"data": 4, "model": 2}, "2d", None),
    ("deepseek-moe-16b-2d", "deepseek-moe-16b", {"data": 4, "model": 2},
     "2d", None),
    ("llama3-8b-2d", "llama3-8b", {"data": 4, "model": 2}, "2d", None),
    ("mixtral-8x22b-2d", "mixtral-8x22b", {"data": 4, "model": 2}, "2d",
     None),
    ("llama3-8b-fsdp", "llama3-8b", {"data": 4, "model": 2}, "fsdp", None),
    ("mixtral-8x22b-fsdp", "mixtral-8x22b", {"data": 4, "model": 2},
     "fsdp", None),
    ("llama3-8b-pod", "llama3-8b", {"pod": 2, "data": 2, "model": 2}, "2d",
     None),
)
# the MoE configs' sharded dispatch is per batch block, as the
# reference's; the dense ones also match the one-process step
DENSE = ("llama3-8b", "minicpm3-4b", "hymba-1.5b")
B, S, STEPS, SEED = 8, 16, 2, 0
PEAK, WARMUP, TOTAL = 3e-3, 1, 10
RUNS = ("a", "b")
JAX_PARTS = 2          # the reference's cases split over two processes


def config(pkg, arch, n_experts):
    """The reduced float32 config of `pkg` (either package's `configs`),
    each segment 2 layers, the MoE's expert count replaced if given."""
    cfg = dataclasses.replace(pkg.get_config(arch).reduced(),
                              dtype="float32")
    segs = tuple((kind, 2) for kind, _ in cfg.segments)
    cfg = dataclasses.replace(cfg, segments=segs, n_layers=2 * len(segs))
    if n_experts is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, n_experts=n_experts))
    return cfg


def batches(cfg):
    rng = np.random.default_rng(1)
    return [{"inputs": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32)} for _ in range(STEPS)]


def start_state(arch, n_experts):
    """The case's train state in the reference's tree: the port's seeded
    `init_params` (through `params_to_numpy`), moments drawn from a seed
    and step 2. Nonzero moments keep AdamW's update well conditioned: from
    zero moments the first update is lr * g / (|g| + eps), which turns a
    float32 difference in a gradient element of ~1e-8 into one of order lr
    (tests/test_torch_train_step.py starts from moments for the same
    reason)."""
    from repro_torch import configs as tconfigs
    from repro_torch.models import init_params, params_to_numpy

    params = params_to_numpy(init_params(config(tconfigs, arch, n_experts),
                                         SEED, device="cpu"))
    rng = np.random.default_rng(2)

    def draw(tree, f):
        if isinstance(tree, dict):
            return {k: draw(v, f) for k, v in tree.items()}
        if isinstance(tree, list):
            return [draw(v, f) for v in tree]
        return f(tree.shape).astype(np.float32)

    m = draw(params, lambda shape: 1e-3 * rng.standard_normal(shape))
    v = draw(params, lambda shape: (1e-2 * rng.standard_normal(shape)) ** 2
             + 1e-6)
    return {"params": params, "opt": {"m": m, "v": v},
            "step": np.asarray(2, np.int32)}


def run_jax(outdir, part):
    # 8 host devices; LLVM's optimisation off, which halves the compile
    # time of the 9 jitted steps (the numbers stay within the tests'
    # bounds by the same margin)
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_backend_optimization_level=0 "
                               + os.environ.get("XLA_FLAGS", ""))
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec

    from repro import configs as jconfigs
    from repro.models import partition as jpartition
    from repro.models import sharding as JS
    from repro.optim import AdamW, cosine_schedule
    from repro.train import make_train_state, make_train_step
    from repro_torch import configs as tconfigs
    from repro_torch.models import Model, convert

    assert jax.device_count() == 8, jax.devices()
    out = {}
    for case, arch, shape, style, n_experts in CASES[part::JAX_PARTS]:
        jcfg = config(jconfigs, arch, n_experts)
        mesh = jax.make_mesh(tuple(shape.values()), tuple(shape),
                             axis_types=(AxisType.Auto,) * len(shape))
        optim = AdamW(lr=cosine_schedule(PEAK, warmup=WARMUP, total=TOTAL))
        with jax.set_mesh(mesh), jpartition.parallelism_style(style):
            state = jax.tree.map(jnp.asarray, start_state(arch, n_experts))
            pspec = JS.param_specs(jcfg, mesh, state["params"], style=style)
            specs = {"params": pspec, "opt": {"m": pspec, "v": pspec},
                     "step": PartitionSpec()}
            shard = jax.tree.map(
                lambda s: NamedSharding(mesh, s), specs,
                is_leaf=lambda x: isinstance(x, PartitionSpec))
            state = jax.tree.map(jax.device_put, state, shard)
            bspec = JS.batch_specs(jcfg, mesh, style=style)
            step = jax.jit(make_train_step(jcfg, optim, remat=True))
            losses = []
            for b in batches(jcfg):
                b = {k: jax.device_put(v, NamedSharding(mesh, bspec[k]))
                     for k, v in b.items()}
                state, metrics = step(state, b)
                losses.append(float(metrics["loss"]))
        model = Model(config(tconfigs, arch, n_experts), device="meta")
        tree = jax.tree.map(np.asarray, state)
        out[f"{case}/loss"] = np.asarray(losses, np.float32)
        for name_of, t in (("params", tree["params"]),
                           ("m", tree["opt"]["m"]),
                           ("v", tree["opt"]["v"])):
            for name, v in convert.tree_to_named(model, t).items():
                out[f"{case}/{name_of}/{name}"] = v
    np.savez(outdir / f"jax_{part}.npz", **out)


def run_rank(outdir, rank, world):
    import torch
    import torch.distributed as dist

    from repro_torch import configs as tconfigs
    from repro_torch.core.distributed import shard
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import convert, params_from_numpy, partition
    from repro_torch.models import sharding as TS
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train import (load_state_tree, make_train_state,
                                   make_train_step, state_tree)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{outdir}/store",
                            rank=rank, world_size=world)
    meshes = {}
    out = {}

    def put(prefix, params, opt):
        for part, named in (("params", params), ("m", opt["m"]),
                            ("v", opt["v"])):
            for name, t in named.items():
                out[f"{prefix}/{part}/{name}"] = t.detach().numpy().copy()

    def train(cfg, start, data, mesh=None, style="2d", moved=None):
        """Two steps from the start state, placed on `mesh` (by the
        elastic restore's `load_state_tree`) or on this process alone;
        the bytes the last step's collectives moved into `moved`."""
        optim = AdamW(lr=cosine_schedule(PEAK, warmup=WARMUP, total=TOTAL))
        model = params_from_numpy(cfg, start["params"], device="cpu")
        with partition.use_mesh(mesh), partition.parallelism_style(style):
            state = make_train_state(cfg, model, optim)

        def named(tree):
            return {n: torch.from_numpy(v) for n, v in
                    convert.tree_to_named(model, tree).items()}

        load_state_tree(state, {
            "params": named(start["params"]),
            "opt": {k: named(start["opt"][k]) for k in ("m", "v")},
            "step": torch.tensor(int(start["step"]))})
        specs = model.layout.specs if mesh is not None else None
        step = make_train_step(cfg, optim, remat=True, grad_specs=specs)
        bspec = (TS.batch_specs(cfg, mesh, style=style) if mesh is not None
                 else None)
        losses = []
        for i, b in enumerate(data):
            b = {k: torch.from_numpy(v) for k, v in b.items()}
            if mesh is not None:
                b = {k: shard(mesh, v, bspec[k]) for k, v in b.items()}
            last = moved is not None and i == len(data) - 1
            with _traffic() if last else contextlib.nullcontext() as got:
                losses.append(float(step(state, b)[1]["loss"]))
            if last:
                moved.update(got)
        return state, np.asarray(losses, np.float32)

    try:
        for case, arch, shape, style, n_experts in CASES:
            key = tuple(shape.items())
            if key not in meshes:
                meshes[key] = make_host_mesh(
                    pod=shape.get("pod"), data=shape["data"],
                    model=shape["model"], device="cpu")
            mesh = meshes[key]
            cfg = config(tconfigs, arch, n_experts)
            tree, data = start_state(arch, n_experts), batches(cfg)
            out[f"{case}/coordinate"] = np.asarray(mesh.get_coordinate())
            moved = {}
            for tag in RUNS:
                state, losses = train(cfg, tree, data, mesh, style,
                                      moved if tag == "a" else None)
                out[f"{case}/{tag}/loss"] = losses
                put(f"{case}/{tag}/block",
                    dict(state["params"].named_parameters()), state["opt"])
                whole = state_tree(state)          # every rank gathers
                if rank == 0:
                    put(f"{case}/{tag}/whole", whole["params"], whole["opt"])
            out[f"{case}/moved"] = np.asarray([moved["gather"],
                                              moved["grad_sum"]])
            if rank == 0 and arch in DENSE:
                state, losses = train(cfg, tree, data)
                out[f"{case}/one/loss"] = losses
                put(f"{case}/one", state_tree(state)["params"], state["opt"])
        np.savez(outdir / f"rank_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# the loop world: reduced llama3-8b on a (2, 2) mesh, LOOP_STEPS steps of
# train_loop with a checkpoint every LOOP_CKPT
LOOP_MESH, LOOP_STEPS, LOOP_CKPT, LOOP_BATCH, LOOP_SEQ = (2, 2), 8, 4, 8, 16
# the world of one: (arch, mesh {name: size}, style)
ONE_CASES = tuple((arch, shape, style)
                  for arch in ("llama3-8b", "deepseek-moe-16b")
                  for shape in ({"data": 1, "model": 1},
                                {"pod": 1, "data": 1, "model": 1})
                  for style in ("2d", "fsdp"))


def loop_config():
    from repro_torch import configs as tconfigs
    return config(tconfigs, "llama3-8b", None)


def loop_stream(cfg):
    from repro_torch.data import SyntheticLM
    return SyntheticLM(vocab_size=cfg.vocab_size, seq_len=LOOP_SEQ,
                       batch_size=LOOP_BATCH, seed=0, branching=2)


@contextlib.contextmanager
def _traffic():
    """{"gather", "grad_sum"}: the bytes this rank receives in the
    parameters' gathers and the gradients' sums while inside (an
    all_gather over s ranks receives s - 1 copies of its tensor, an
    all_to_all (s - 1) / s of it), counted in the collectives that
    `core.distributed`'s differentiable gather runs."""
    import torch.distributed as dist

    from repro_torch.core import distributed as D

    moved = {"gather": 0, "grad_sum": 0}
    where = []
    saved = (dist.all_gather, dist.all_to_all_single,
             D._GatherParam.forward, D._GatherParam.backward)

    def all_gather(parts, t, group=None):
        if where:
            moved[where[-1]] += (len(parts) - 1) * t.numel() * t.itemsize
        return saved[0](parts, t, group=group)

    def all_to_all_single(out, t, group=None):
        if where:
            n = dist.get_world_size(group)
            moved[where[-1]] += (n - 1) * t.numel() * t.itemsize // n
        return saved[1](out, t, group=group)

    def inside(fn, what):
        def run(*args):
            where.append(what)
            try:
                return fn(*args)
            finally:
                where.pop()
        return staticmethod(run)

    dist.all_gather, dist.all_to_all_single = all_gather, all_to_all_single
    D._GatherParam.forward = inside(saved[2], "gather")
    D._GatherParam.backward = inside(saved[3], "grad_sum")
    try:
        yield moved
    finally:
        (dist.all_gather, dist.all_to_all_single) = saved[:2]
        D._GatherParam.forward = staticmethod(saved[2])
        D._GatherParam.backward = staticmethod(saved[3])


def run_loop(outdir, rank, world):
    """A 4-rank world: `make_train_step(grad_specs=)` on the (2, 2) mesh
    (its losses, whole state and the bytes its collectives moved in the
    last step to DIR/loop_RANK.npz), then `train_loop`
    on that mesh for LOOP_STEPS steps with checkpoints in DIR/ckpt."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import shard
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.models import init_params, partition
    from repro_torch.models import sharding as TS
    from repro_torch.optim import AdamW
    from repro_torch.train import make_train_state, make_train_step, \
        state_tree

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{outdir}/store",
                            rank=rank, world_size=world)
    try:
        cfg = loop_config()
        data, model = LOOP_MESH
        mesh = make_host_mesh(data=data, model=model, device="cpu")
        optim = AdamW(lr=1e-3)
        with partition.use_mesh(mesh):
            state = make_train_state(cfg, init_params(cfg, 0, device="cpu"),
                                     optim)
        step = make_train_step(cfg, optim,
                               grad_specs=state["params"].layout.specs)
        bspec = TS.batch_specs(cfg, mesh)
        stream = loop_stream(cfg)
        losses = []
        for i in range(2):
            b = {k: shard(mesh, v, bspec[k])
                 for k, v in stream.batch_at(i).items()}
            with _traffic() as moved:
                losses.append(float(step(state, b)[1]["loss"]))
        out = {"losses": np.asarray(losses, np.float32),
               "moved": np.asarray([moved["gather"], moved["grad_sum"]])}
        whole = state_tree(state)
        out.update({f"params/{n}": t.numpy()
                    for n, t in whole["params"].items()})
        res = train_loop(cfg, mesh=mesh, steps=LOOP_STEPS,
                         batch_size=LOOP_BATCH, seq_len=LOOP_SEQ,
                         ckpt_dir=outdir / "ckpt", ckpt_every=LOOP_CKPT,
                         lr=3e-3, log_every=1, stream=loop_stream(cfg),
                         device="cpu")
        out["loop_losses"] = np.asarray([l for _, l in res.losses],
                                        np.float32)
        np.savez(outdir / f"loop_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def run_one(outdir):
    """A world of one: each ONE_CASES case's sharded step against the
    unsharded one from the same seed (DIR/one.npz)."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs as tconfigs
    from repro_torch.core.distributed import shard
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params, partition
    from repro_torch.models import sharding as TS
    from repro_torch.optim import AdamW
    from repro_torch.train import make_train_state, make_train_step, \
        state_tree

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{outdir}/store1",
                            rank=0, world_size=1)
    out = {}

    def run(cfg, mesh=None, style="2d"):
        optim = AdamW(lr=3e-3)
        model = init_params(cfg, 0, device="cpu")
        ptrs = {n: p.data_ptr() for n, p in model.named_parameters()}
        with partition.use_mesh(mesh), partition.parallelism_style(style):
            state = make_train_state(cfg, model, optim)
        # a block over one rank is the tensor itself, and so is its gather:
        # the world holds no second copy of the weights
        out["aliased"] = all(
            p.data_ptr() == ptrs[n] and (model.layout is None or
                                         model.layout.gather(n, p) is p)
            for n, p in model.named_parameters())
        step = make_train_step(cfg, optim, grad_specs=(
            state["params"].layout.specs if mesh is not None else None))
        losses = []
        for b in batches(cfg):
            b = {k: torch.from_numpy(v) for k, v in b.items()}
            if mesh is not None:
                spec = TS.batch_specs(cfg, mesh, style=style)
                b = {k: shard(mesh, v, spec[k]) for k, v in b.items()}
            losses.append(float(step(state, b)[1]["loss"]))
        return losses, state, state_tree(state)

    try:
        for i, (arch, shape, style) in enumerate(ONE_CASES):
            cfg = config(tconfigs, arch, None)
            mesh = make_host_mesh(pod=shape.get("pod"), data=1, model=1,
                                  device="cpu")
            got, _, tree = run(cfg, mesh, style)
            out[f"{i}/aliased"] = np.asarray(out.pop("aliased"))
            want, _, plain = run(cfg)
            out.pop("aliased")
            out[f"{i}/loss"] = np.asarray([got, want], np.float32)
            for part in ("params", "m", "v"):
                g = tree["params"] if part == "params" else tree["opt"][part]
                w = plain["params"] if part == "params" else \
                    plain["opt"][part]
                out[f"{i}/{part}/same"] = np.asarray(
                    all(torch.equal(g[n], w[n]) for n in w))
        np.savez(outdir / "one.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    what, outdir = sys.argv[1], pathlib.Path(sys.argv[2])
    if what == "jax":
        run_jax(outdir, int(sys.argv[3]))
    elif what == "loop":
        run_loop(outdir, int(sys.argv[3]), int(sys.argv[4]))
    elif what == "one":
        run_one(outdir)
    else:
        run_rank(outdir, int(sys.argv[3]), int(sys.argv[4]))
