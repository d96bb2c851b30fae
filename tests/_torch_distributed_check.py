"""Subprocess bodies for tests/test_torch_distributed.py: the distributed
layer of the port (`repro_torch.core.distributed`, `core.placement`,
`launch.mesh` and the sharded MoE variants) in an 8-rank gloo world on a
(4, 2) ("data", "model") mesh, and the reference's `repro.core.
distributed` and `repro.models.moe` on 8 forced host devices, over the
same npz inputs at the sizes of tests/_distributed_check.py.

    python _torch_distributed_check.py inputs DIR   # write DIR/inputs.npz
    python _torch_distributed_check.py jax DIR      # DIR/jax.npz
    python _torch_distributed_check.py rank DIR RANK WORLD TAG
                                                    # DIR/TAG_RANK.npz

Each rank writes every result as the global tensor (`gather` of its
block) and its own blocks of the placed inputs. The reference needs its
8 host devices before jax initialises, and a gloo world needs a process
per rank, so neither can run inside the pytest process.
"""
import os
import pathlib
import sys

import numpy as np

N = 4 * 2048
ALPHA, NEG_ALPHA = 1.5, -0.7
GEMV = (256, 192, 1.1, 0.3)          # m, n, alpha, beta
GEMM = (128, 256, 128)               # m, k, n
MOE = dict(d=32, b=4, s=8, de=16, top_k=2, capacity_factor=4.0, act="silu")
E_TP, E_EP = 3, 4                    # 3 % 2 != 0 -> TP; 4 % 2 == 0 -> EP


def _dense(rng, shape):
    return (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(
        np.float32)


def make_inputs():
    rng = np.random.default_rng(0)
    out = {k: rng.standard_normal(N).astype(np.float32)
           for k in ("w", "v", "u", "x", "y")}
    m, n, _, _ = GEMV
    out.update(gemv_a=rng.standard_normal((m, n)).astype(np.float32),
               gemv_x=rng.standard_normal(n).astype(np.float32),
               gemv_y=rng.standard_normal(m).astype(np.float32))
    m, k, n = GEMM
    out.update(gemm_a=rng.standard_normal((m, k)).astype(np.float32),
               gemm_b=rng.standard_normal((k, n)).astype(np.float32))
    d, de = MOE["d"], MOE["de"]
    for tag, e in (("tp", E_TP), ("ep", E_EP)):
        out.update({f"{tag}_router": _dense(rng, (d, e)),
                    f"{tag}_we_gate": _dense(rng, (e, d, de)),
                    f"{tag}_we_up": _dense(rng, (e, d, de)),
                    f"{tag}_we_down": _dense(rng, (e, de, d)),
                    f"{tag}_x": rng.standard_normal(
                        (MOE["b"], MOE["s"], d)).astype(np.float32)})
    out.update(ep_ws_gate=_dense(rng, (d, de)), ep_ws_up=_dense(rng, (d, de)),
               ep_ws_down=_dense(rng, (de, d)))
    out.update(col_x=rng.standard_normal((256, 8)).astype(np.float32),
               col_y=rng.standard_normal((256, 8)).astype(np.float32),
               col_a=rng.standard_normal(8).astype(np.float32))
    # the reference fault's case: nrm2 of 8192 draws of default_rng(0)
    out["nrm2_x"] = np.random.default_rng(0).standard_normal(N).astype(
        np.float32)
    return out


def moe_params(ins, tag):
    return {k[len(tag) + 1:]: v for k, v in ins.items()
            if k.startswith(tag + "_") and k != tag + "_x"}


def run_jax(outdir):
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))
    import jax
    import jax.numpy as jnp

    from repro.core import Program, axpydot_program, distributed as D
    from repro.models import moe
    from repro.solvers import specs

    assert jax.device_count() == 8, jax.devices()
    mesh = jax.make_mesh((4, 2), ("data", "model"))
    ins = {k: jnp.asarray(v)
           for k, v in np.load(outdir / "inputs.npz").items()}
    _, _, alpha, beta = GEMV
    out = {
        "paxpy": D.paxpy(mesh, ALPHA, ins["x"], ins["y"]),
        "pdot": D.pdot(mesh, ins["x"], ins["y"]),
        "paxpydot": D.paxpydot(mesh, 0.7, ins["w"], ins["v"], ins["u"]),
        "pgemv": D.pgemv(mesh, alpha, ins["gemv_a"], ins["gemv_x"], beta,
                         ins["gemv_y"]),
        "pgemm_row_col": D.pgemm(mesh, ins["gemm_a"], ins["gemm_b"],
                                 strategy="row_col", block=128),
        "pgemm_contract": D.pgemm(mesh, ins["gemm_a"], ins["gemm_b"],
                                  strategy="contract", block=128),
        "program_axpydot": D.distribute_program(axpydot_program(), mesh)(
            neg_alpha=jnp.float32(NEG_ALPHA), w=ins["w"], v=ins["v"],
            u=ins["u"])["beta"],
        "program_nrm2": D.distribute_program(
            Program.from_spec(specs.NRM2), mesh)(x=ins["nrm2_x"])["norm"],
    }
    kw = {k: MOE[k] for k in ("top_k", "capacity_factor", "act")}
    with jax.set_mesh(mesh):
        out["moe_tp"] = moe.moe_ffn_tp_shard_map(
            moe_params(ins, "tp"), ins["tp_x"], n_experts=E_TP, mesh=mesh,
            **kw)
        out["moe_ep"] = moe.moe_ffn_ep_shard_map(
            moe_params(ins, "ep"), ins["ep_x"], n_experts=E_EP, mesh=mesh,
            **kw)
    np.savez(outdir / "jax.npz", **{k: np.asarray(v) for k, v in out.items()})


# coldot's per-column sums (combined over the shards) beside colaxpy's
# per-column a (whole on every shard)
COLUMN_SPEC = {
    "name": "columns",
    "routines": [
        {"blas": "coldot", "name": "cd", "inputs": {"x": "X", "y": "Y"},
         "outputs": {"out": "rz"}},
        {"blas": "colaxpy", "name": "ca",
         "inputs": {"a": "a", "x": "X", "y": "Y"},
         "outputs": {"out": "Z"}},
    ],
}


# a spec whose hints name both mesh dimensions and one that is not there
PLACED_SPEC = {
    "name": "placed",
    "routines": [
        {"blas": "axpy", "name": "a0", "scalars": {"alpha": 2.0},
         "inputs": {"x": "px", "y": "py"}, "outputs": {"out": "pz"},
         "placement": {"x": ["data"], "y": ["pod"]}},
        {"blas": "gemv", "name": "g0", "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "pa", "x": "pv", "y": "pw"},
         "outputs": {"out": "po"},
         "placement": {"A": ["data", "model"]}},
    ],
}


def run_rank(outdir, rank, world, tag):
    import torch
    import torch.distributed as dist

    from repro_torch.core import Program, axpydot_program
    from repro_torch.core import distributed as D
    from repro_torch.core import placement
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.solvers import specs

    dist.init_process_group("gloo", init_method=f"file://{outdir}/store_"
                            f"{tag}", rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(data=4, model=2, device="cpu")
        ins = {k: torch.from_numpy(v)
               for k, v in np.load(outdir / "inputs.npz").items()}
        _, _, alpha, beta = GEMV
        data, both = ("data",), ("data", "model")
        out = {
            "paxpy": D.gather(mesh, D.paxpy(mesh, ALPHA, ins["x"],
                                            ins["y"]), data),
            "pdot": D.pdot(mesh, ins["x"], ins["y"]),
            "paxpydot": D.paxpydot(mesh, 0.7, ins["w"], ins["v"], ins["u"]),
            "pgemv": D.gather(mesh, D.pgemv(
                mesh, alpha, ins["gemv_a"], ins["gemv_x"], beta,
                ins["gemv_y"]), data),
            "pgemm_row_col": D.gather(mesh, D.pgemm(
                mesh, ins["gemm_a"], ins["gemm_b"], strategy="row_col",
                block=128), both),
            "pgemm_contract": D.gather(mesh, D.pgemm(
                mesh, ins["gemm_a"], ins["gemm_b"], strategy="contract",
                block=128), (data, None)),
            "program_axpydot": D.distribute_program(
                axpydot_program(device="cpu"), mesh)(
                    neg_alpha=NEG_ALPHA, w=ins["w"], v=ins["v"],
                    u=ins["u"])["beta"],
            "program_nrm2": D.distribute_program(
                Program.from_spec(specs.NRM2, device="cpu"), mesh)(
                    x=ins["nrm2_x"])["norm"],
        }
        cols = D.distribute_program(
            Program.from_spec(COLUMN_SPEC, device="cpu"), mesh)(
                X=ins["col_x"], Y=ins["col_y"], a=ins["col_a"])
        out["program_coldot"] = cols["rz"]
        out["program_colaxpy"] = D.gather(mesh, cols["Z"], (data, None))
        kw = {k: MOE[k] for k in ("top_k", "capacity_factor", "act")}
        tokens = (data, None, None)       # each rank passes its own block

        def model_part(tag, split):
            """This rank's part of each weight under the variant's split
            over "model" (whole over "data")."""
            return {n: D.shard(mesh, w, split[n]) if n in split else w
                    for n, w in moe_params(ins, tag).items()}

        out["moe_tp"] = D.gather(mesh, moe.moe_ffn_tp_shard_map(
            model_part("tp", {**moe.TP_SPECS, **moe.SHARED_SPECS}),
            D.shard(mesh, ins["tp_x"], tokens), n_experts=E_TP, mesh=mesh,
            **kw), tokens)
        out["moe_ep"] = D.gather(mesh, moe.moe_ffn_ep_shard_map(
            model_part("ep", {**moe.EP_SPECS, **moe.SHARED_SPECS}),
            D.shard(mesh, ins["ep_x"], tokens), n_experts=E_EP, mesh=mesh,
            **kw), tokens)
        # the placed inputs' blocks on this rank, and its coordinate
        prog = Program.from_spec(PLACED_SPEC, device="cpu")
        placed = placement.apply_placement(
            prog, mesh, {"px": ins["x"], "py": ins["y"], "pv": ins["gemv_x"],
                         "pa": ins["gemv_a"]})
        out.update({f"placed_{k}": v for k, v in placed.items()})
        out["coordinate"] = torch.tensor(mesh.get_coordinate())
        out["fallback_shape"] = torch.tensor(
            make_host_mesh(data=4, model=4, device="cpu").shape)
        out["world_mesh_shape"] = torch.tensor(mesh.shape)
        np.savez(outdir / f"{tag}_{rank}.npz",
                 **{k: v.numpy() for k, v in out.items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    what, outdir = sys.argv[1], pathlib.Path(sys.argv[2])
    if what == "inputs":
        np.savez(outdir / "inputs.npz", **make_inputs())
    elif what == "jax":
        run_jax(outdir)
    else:
        run_rank(outdir, int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
