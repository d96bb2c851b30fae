"""Port parity for slice 3's level 3: gemm (row 10 of the TPU kernel
table) and the gemm-anchored tiled generator (row 11), which carry
block-CG. The same seeded numpy inputs go through the reference package
(its Pallas kernels in interpret mode, its `Program`) and through
repro_torch on the CPU, where gemm runs its plain version and every
tiled group its plain splice. The generated Triton and the CUDA source
run only on the card (chip_smoke.py and the `cuda` test below).

Tolerances:
* gemm elements: |got - want| <= 1e-5 * sum_k |alpha A_ik B_kj|
  + 1e-6 * |beta C_ij| + 1e-5 * |want|, the sums in float64 (another
  summation order in float32); bfloat16: both sides accumulate the same
  bfloat16 inputs in float32 and round once, so that bound plus half a
  bfloat16 unit of each side, 2**-8 * (|got| + |want|);
* program outputs: rtol 1e-5 with atol 1e-5 * sqrt(k) * max|want|,
  which stands in for 1e-5 * sum|terms| (k terms of mixed sign sum to
  about |result| * sqrt(k)).
"""
import importlib.util
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Program as JProgram, codegen as jcodegen
from repro.core.lowering import lower as jlower
from repro.kernels import gemm as jgemm, ref as jref
from repro_torch.core import Program, codegen, lowering
from repro_torch.core.fusion import FusionGroup
from repro_torch.core.runtime import inputs_from_numpy, results_to_numpy
from repro_torch.kernels import common, cuda, gemm as t_gemm, ops as tops, \
    tiled
from repro_torch.solvers import specs as tsolver_specs

from _torch_caches import fresh_lowering_caches  # noqa: F401 (autouse)

MODES = ["dataflow", "nodataflow", "reference"]
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rng(seed):
    return np.random.default_rng(seed)


def _mat(rng, m, n):
    return rng.standard_normal((m, n)).astype(np.float32)


def _both(arrays, dtype):
    """The same values for both packages: jax arrays and CPU tensors."""
    jx = [jnp.asarray(a, dtype=_JNP[dtype]) for a in arrays]
    tx = inputs_from_numpy({str(i): np.asarray(a) for i, a in enumerate(jx)},
                           device="cpu")
    return jx, [tx[str(i)] for i in range(len(jx))]


def _f64(v):
    if torch.is_tensor(v):
        return v.double().numpy()
    return np.asarray(v, np.float32).astype(np.float64)


# ---------------------------------------------------------------------------
# Row 10: gemm and matmul
# ---------------------------------------------------------------------------

SHAPES = [(37, 45, 11), (130, 70, 33), (8, 300, 5)]   # (m, k, n)


def _check_elements(got, want, a, b, alpha, beta, c, dtype):
    got, want = _f64(got), _f64(want)
    tol = 1e-5 * abs(alpha) * (np.abs(a) @ np.abs(b)) \
        + 1e-6 * abs(beta) * np.abs(c) + 1e-5 * np.abs(want)
    if dtype == "bfloat16":
        tol = tol + 2.0 ** -8 * (np.abs(got) + np.abs(want))
    assert np.all(np.isfinite(got))
    err = np.abs(got - want)
    assert np.all(err <= tol), float(np.max(err - tol))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_gemm_matches_reference(shape, dtype):
    m, k, n = shape
    rng = _rng(m + k + n)
    arrays = [_mat(rng, m, k), _mat(rng, k, n), _mat(rng, m, n)]
    (ja, jb, jc), (ta, tb, tc) = _both(arrays, dtype)
    alpha, beta = 1.3, -0.7
    got = tops.gemm(alpha, ta, tb, beta, tc)
    assert got.dtype == _TORCH[dtype] and got.shape == (m, n)
    args = (_f64(ta), _f64(tb), alpha, beta, _f64(tc), dtype)
    _check_elements(got, jgemm.gemm(alpha, ja, jb, beta, jc), *args)
    _check_elements(got, jref.gemm(alpha, ja, jb, beta, jc), *args)


@pytest.mark.parametrize("shape", SHAPES)
def test_matmul_matches_reference(shape):
    m, k, n = shape
    rng = _rng(m * k + n)
    (ja, jb), (ta, tb) = _both([_mat(rng, m, k), _mat(rng, k, n)],
                               "float32")
    got = tops.matmul(ta, tb)
    _check_elements(got, jgemm.matmul(ja, jb), _f64(ta), _f64(tb), 1.0,
                    0.0, np.zeros((m, n)), "float32")


def test_gemm_nan_times_zero_beta_is_nan():
    """beta * C is computed even at beta = 0, as in the reference: a NaN
    in C reaches the output."""
    a, b = torch.ones(3, 4), torch.ones(4, 2)
    c = torch.zeros(3, 2)
    c[1, 1] = float("nan")
    got = tops.gemm(1.0, a, b, 0.0, c)
    want = np.asarray(jgemm.gemm(1.0, jnp.ones((3, 4)), jnp.ones((4, 2)),
                                 0.0, jnp.asarray(c.numpy())))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert torch.isnan(got[1, 1]) and torch.isfinite(got[0]).all()


def test_gemm_counts_plain_calls_on_cpu():
    common.reset_counts(tops.gemm)
    tops.gemm(1.0, torch.ones(2, 3), torch.ones(3, 4), 0.0,
              torch.zeros(2, 4))
    tops.matmul(torch.ones(2, 3), torch.ones(3, 4))
    assert tops.KERNELS["gemm"] is tops.gemm
    assert (tops.gemm.plain_calls, tops.gemm.launches) == (2, 0)


@pytest.mark.parametrize("bad", [
    lambda: tops.gemm(1.0, torch.zeros(4, 3), torch.zeros(4, 2), 0.0,
                      torch.zeros(4, 2)),                   # inner dims
    lambda: tops.gemm(1.0, torch.zeros(4, 3), torch.zeros(3, 2), 0.0,
                      torch.zeros(2, 4)),                   # C shape
    lambda: tops.gemm(1.0, torch.zeros(3, 4).T, torch.zeros(3, 2), 0.0,
                      torch.zeros(4, 2)),                   # not contiguous
    lambda: tops.gemm(1.0, torch.zeros(4), torch.zeros(4, 2), 0.0,
                      torch.zeros(1, 2)),                   # not 2-D
    lambda: tops.gemm(1.0, torch.zeros(4, 3), torch.zeros(3, 2), 0.0,
                      torch.zeros(4, 2, dtype=torch.bfloat16)),   # dtypes
])
def test_gemm_rejects_bad_operands(bad):
    with pytest.raises(ValueError):
        bad()


@pytest.mark.parametrize("n,bn", [(1, 32), (16, 32), (29, 32), (32, 32),
                                  (33, 64), (64, 64), (65, 128),
                                  (4096, 128)])
def test_gemm_block_n_follows_n(n, bn):
    assert t_gemm.block_n(n) == bn


SMS = 132    # an H100 SXM


@pytest.mark.parametrize("shape,itemsize,splits", [
    ((16384, 32, 16384), 4, 1),     # block-CG: 128 tiles, no split
    ((16381, 29, 16379), 4, 1),     # the ragged block-CG shape
    ((4096, 4096, 4096), 4, 1),     # the square product fills the card
    ((14248, 4096, 4096), 2, 1),    # a bf16 prefill projection
    ((100, 5, 100), 4, 1),          # too little K to split
    ((8, 4096, 4096), 2, 4),        # a decode projection: 32 tiles
    ((16, 32, 16384), 4, 32),       # one tile, long K
    ((300, 64, 1 << 20), 4, 44),    # 3 tiles: one wave of splits
])
def test_gemm_plan(shape, itemsize, splits):
    m, n, k = shape
    plan = t_gemm.gemm_plan(m, n, k, itemsize, SMS)
    tiles = common.cdiv(m, t_gemm.BM) * common.cdiv(n, plan.bn)
    assert plan.bn == t_gemm.block_n(n)
    assert plan.splits == splits
    # whole stages of K per chunk, and the chunks cover K once
    assert plan.chunk % t_gemm.block_k(itemsize) == 0
    assert (plan.splits - 1) * plan.chunk < k <= plan.splits * plan.chunk
    # a split only where the tiles leave most SMs idle, and never more
    # blocks than one wave holds
    assert plan.splits == 1 or 2 * tiles < SMS
    assert plan.splits * tiles <= max(SMS, tiles)
    assert plan.splits == 1 or plan.chunk >= t_gemm.MIN_K_PER_SPLIT


def _operands(dtype, k, n, a_offset=0, b_offset=0):
    """CPU A (4, k) and B (k, n), each a view `offset` elements into a
    fresh buffer (torch aligns a fresh buffer to 64 bytes)."""
    a = torch.zeros(4 * k + a_offset, dtype=dtype)[a_offset:].view(4, k)
    b = torch.zeros(k * n + b_offset, dtype=dtype)[b_offset:].view(k, n)
    return a, b


@pytest.mark.parametrize("dtype,k,n,a_offset,b_offset,route", [
    (torch.float32, 16384, 32, 0, 0, "tma"),     # block-CG
    (torch.float32, 16379, 29, 0, 0, "ldg"),     # the ragged case
    (torch.float32, 16384, 29, 0, 0, "ldg"),     # B's rows of 116 bytes
    (torch.float32, 16379, 32, 0, 0, "ldg"),     # A's rows of 65516 bytes
    (torch.bfloat16, 16384, 32, 0, 0, "wgmma"),  # 16-bit: tensor cores
    (torch.bfloat16, 16380, 32, 0, 0, "ldg"),    # rows of 32760 bytes
    (torch.float16, 64, 8, 0, 0, "wgmma"),       # rows of 128, 16 bytes
    (torch.float16, 64, 12, 0, 0, "ldg"),        # B's rows of 24 bytes
    (torch.bfloat16, 64, 32, 1, 0, "ldg"),       # A's base 2 bytes off
    (torch.float16, 64, 32, 0, 8, "wgmma"),      # 16 bytes off: aligned
    (torch.float32, 64, 32, 1, 0, "ldg"),        # A's base 4 bytes off
    (torch.float32, 64, 32, 0, 2, "ldg"),        # B's base 8 bytes off
    (torch.float32, 64, 32, 4, 4, "tma"),        # 16 bytes off: aligned
])
def test_gemm_route_follows_dtype_shape_and_alignment(dtype, k, n, a_offset,
                                                      b_offset, route):
    a, b = _operands(dtype, k, n, a_offset, b_offset)
    assert t_gemm.gemm_route(a, b) == route


@pytest.mark.parametrize("shape,route", [((512, 96, 32), "tma"),
                                         ((515, 101, 29), "ldg")])
def test_gemm_launch_takes_the_plan_and_route(monkeypatch, shape, route):
    """A tensor taken for the card's reaches `repro_gemm` with the plan
    and route code, and is counted on its route (no card: the C call is
    recorded, not made)."""
    m, k, n = shape
    calls = []
    monkeypatch.setattr(common, "on_card", lambda *t: True)
    monkeypatch.setattr(common, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(cuda, "launch", lambda *args: calls.append(args))
    common.reset_counts(tops.gemm)
    tops.gemm(1.0, torch.ones(m, k), torch.ones(k, n), 0.0,
              torch.zeros(m, n))
    (stem, entry, _, *args), = calls
    plan = t_gemm.gemm_plan(m, n, k, 4, SMS)
    assert (stem, entry) == ("gemm", "repro_gemm")
    assert args[6:] == [m, n, k, plan.bn, plan.chunk, plan.splits,
                        t_gemm.ROUTES.index(route)]
    assert tops.gemm.route_launches == {r: int(r == route)
                                        for r in t_gemm.ROUTES}
    assert (tops.gemm.launches, tops.gemm.finish_launches,
            tops.gemm.plain_calls) == (1, 0, 0)


# ---------------------------------------------------------------------------
# No fallback: a CUDA tensor goes to the kernel or raises
# ---------------------------------------------------------------------------


def test_gemm_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("REPRO_TORCH_BUILD", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda.build(["gemm"])
    # a tensor the wrapper takes for the card's never reaches the plain
    # version: the build is attempted and its failure raised (the plan
    # asks the card for its SM count: an H100's)
    monkeypatch.setattr(common, "on_card", lambda *t: True)
    monkeypatch.setattr(common, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(cuda, "_LIBS", {})
    common.reset_counts(tops.gemm)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tops.gemm(1.0, torch.ones(2, 3), torch.ones(3, 4), 0.0,
                  torch.zeros(2, 4))
    assert tops.gemm.plain_calls == 0


PTXAS_SAMPLE = """\
ptxas info    : Compiling entry function '_Z4gemmv' for 'sm_90a'
ptxas info    : Function properties for _Z4gemmv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 2 barriers
ptxas info    : Compiling entry function '_Z4foldv' for 'sm_90a'
ptxas info    : Function properties for _Z4foldv
    16 bytes stack frame, 12 bytes spill stores, 36 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 16 bytes cumulative stack
"""


def test_ptxas_report_reads_registers_and_spills():
    """The build keeps nvcc's `-Xptxas -v` report; chip_smoke.py reads
    it to show that no gemm kernel spills."""
    assert ("-Xptxas", "-v") == cuda.NVCC_FLAGS[-2:]
    assert cuda.parse_ptxas(PTXAS_SAMPLE) == {
        "_Z4gemmv": {"spill_stores": 0, "spill_loads": 0, "registers": 128},
        "_Z4foldv": {"spill_stores": 12, "spill_loads": 36,
                     "registers": 32}}


# ---------------------------------------------------------------------------
# Programs: every spec of tests/test_fusion_l3.py and the block-CG stage
# programs, in all three modes
# ---------------------------------------------------------------------------

# copies of tests/test_fusion_l3.py's specs
GEMM_COLAXPY_COLDOT = {
    "name": "gemm_colaxpy_coldot",
    "routines": [
        {"blas": "gemm", "name": "mm",
         "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "A", "B": "B", "C": "C0"},
         "connections": {"out": "up.x"}, "outputs": {"out": "Q"}},
        {"blas": "colaxpy", "name": "up",
         "inputs": {"a": "alphas", "y": "Y0"},
         "connections": {"out": ["cd.x", "cd.y"]},
         "outputs": {"out": "R"}},
        {"blas": "coldot", "name": "cd", "outputs": {"out": "rz"}},
    ],
}
GEMVT_SCAL_NRM2 = {
    "name": "gemvt_scal_nrm2",
    "routines": [
        {"blas": "gemvt", "name": "mv",
         "scalars": {"alpha": 1.0, "beta": 1.0},
         "inputs": {"A": "A", "x": "x", "y": "y0"},
         "connections": {"out": "sc.x"}, "outputs": {"out": "q"}},
        {"blas": "scal", "name": "sc", "scalars": {"alpha": -0.5},
         "connections": {"out": "nn.x"}, "outputs": {"out": "w"}},
        {"blas": "nrm2", "name": "nn", "outputs": {"out": "wnorm"}},
    ],
}
BLOCK_STAGES = ["BLOCK_NRM2", "BLOCK_RESIDUAL", "BLOCK_CG_MATVEC",
                "BLOCK_CG_UPDATE", "BLOCK_CG_PUPDATE"]
PROGRAMS = {"GEMM_COLAXPY_COLDOT": GEMM_COLAXPY_COLDOT,
            "GEMVT_SCAL_NRM2": GEMVT_SCAL_NRM2,
            **{name: getattr(tsolver_specs, name) for name in BLOCK_STAGES}}


def _program_inputs(name, shape, seed):
    """Seeded inputs of one program at `shape` = (m, k, s): matrices
    are (m, k) for A, (k, s) for B, (m, s) otherwise (a square A for the
    block-CG stages); the per-column Gram diagonals that block-CG
    divides by are positive, as they are in a solve."""
    m, k, s = shape
    rng = _rng(seed)
    ir = lowering.lower(PROGRAMS[name], upto="infer")
    out = {}
    for pub, kind in sorted(ir.io.input_kinds.items()):
        if name == "GEMVT_SCAL_NRM2":
            dims = {"A": (m, k), "x": (m,), "y0": (k,)}[pub]
        elif kind == "matrix":
            dims = {"A": (m, k), "B": (k, s)}.get(pub, (m, s)) \
                if name == "GEMM_COLAXPY_COLDOT" else \
                ((m, m) if pub == "A" else (m, s))
        else:
            dims = (s,)
        v = rng.standard_normal(dims).astype(np.float32)
        if pub in ("rz", "pq", "rz_next"):
            v = np.abs(v) + 1.0
        out[pub] = v
    return out


CASES = [(name, shape) for name in PROGRAMS
         for shape in ([(64, 64, 4), (257, 96, 3), (513, 300, 8)]
                       if name == "GEMM_COLAXPY_COLDOT"
                       else [(170, 170, 5)])]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,shape", CASES,
                         ids=[f"{n}-{'x'.join(map(str, s))}"
                              for n, s in CASES])
def test_program_matches_reference(name, shape, mode):
    raw = PROGRAMS[name]
    inputs = _program_inputs(name, shape, seed=sum(shape))
    want = JProgram.from_spec(raw, mode=mode)(**inputs)
    prog = Program.from_spec(raw, mode=mode, device="cpu")
    got = results_to_numpy(prog(**inputs_from_numpy(inputs, device="cpu")))
    assert set(got) == set(want)
    depth = max(shape[:2])
    for key, w in want.items():
        w = np.asarray(w, np.float64)
        assert got[key].shape == w.shape, key
        assert got[key].dtype == np.float32, key
        np.testing.assert_allclose(
            got[key], w, rtol=1e-5,
            atol=1e-5 * np.sqrt(depth) * max(1.0, float(np.abs(w).max())),
            err_msg=f"{name} {mode} output {key}")


@pytest.mark.parametrize("mode", ["dataflow", "nodataflow"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_plans_match_reference(name, mode):
    """Tiled groups plan as in the reference: members, anchor, fusion
    and the kind of generator (tiled for a gemm anchor)."""
    raw = PROGRAMS[name]
    want = jlower(raw, mode=mode, upto="fuse")
    got = lowering.lower(raw, mode=mode, upto="fuse")
    assert [(g.nodes, g.anchor, g.fused) for g in got.groups] == \
        [(g.nodes, g.anchor, g.fused) for g in want.groups]
    for g in got.groups:
        if g.anchor is not None:
            blas = got.graph.nodes[g.anchor].blas
            assert (blas == "gemm") == (name != "GEMVT_SCAL_NRM2")


def _tiled_groups():
    for name, raw in sorted(PROGRAMS.items()):
        ir = lowering.lower(raw, upto="fuse")
        for g in ir.groups:
            if g.anchor is not None and \
                    ir.graph.nodes[g.anchor].blas == "gemm":
                yield name, ir, g


def test_block_cg_stage_programs_plan_one_tiled_group():
    found = {name: g.nodes for name, _, g in _tiled_groups()}
    assert found == {"GEMM_COLAXPY_COLDOT": ["mm", "up", "cd"],
                     "BLOCK_RESIDUAL": ["resid", "rz"],
                     "BLOCK_CG_MATVEC": ["mv", "pq"]}


@pytest.mark.parametrize("name", ["GEMM_COLAXPY_COLDOT", "BLOCK_RESIDUAL",
                                  "BLOCK_CG_MATVEC"])
def test_tiled_sources_compile_with_an_ieee_product(name):
    (_, ir, group), = [t for t in _tiled_groups() if t[0] == name]
    sig = codegen._tiled_signature(ir.graph, group)
    jsig = jcodegen._tiled_signature(
        jlower(PROGRAMS[name], upto="fuse").graph, group)
    for field in ("scalar_keys", "vec_in_keys", "mat_in_keys",
                  "col_in_keys", "elt_out_keys", "colred_out_keys",
                  "red_out_keys", "post"):
        assert getattr(sig, field) == getattr(jsig, field), field
    body = codegen.tiled_body(ir.graph, group, sig)
    src = tiled.source(body)
    compile(src, f"<{name}>", "exec")
    # the product is gemm's CUDA mainloop (true float32 FFMA); the
    # generated module only finishes its float32 partials
    assert "tl.dot(" not in src and "tf32" not in src.lower()
    assert "acc_ptr" in src and "for split in range(1, S)" in src
    assert len(body.stores) == len(sig.elt_out_keys)
    assert len(body.colsums) == len(sig.colred_out_keys) >= 1
    assert src.count("@triton.jit") == 2        # the epilogue, its fold


def test_tiled_source_with_scalar_sums_compiles():
    body = tiled.TiledBody(n_scalars=2, n_mats=1, n_cols=1, alpha="s0",
                           beta="s1", post=("t0 = v0 * yo + m0",),
                           stores=("t0",), colsums=(("t0 * t0", None),),
                           sums=(("t0 * m0", None), ("t0 * t0", "tl.sqrt")))
    src = tiled.source(body)
    compile(src, "<sums>", "exec")
    assert "tl.dot(" not in src
    assert src.count("@triton.jit") == 3        # epilogue, colsum, finish
    assert "tl.sqrt(tl.sum(acc1, axis=0))" in src


def test_block_n_rounds_up_to_a_power_of_two():
    assert [tiled.block_n(n) for n in (1, 5, 16, 29, 32, 33, 64, 4096)] \
        == [16, 16, 16, 32, 32, 64, 64, 64]


def _iamax_tile_group(package):
    """A gemm anchor with an iamax grouped under it by hand: the planner
    never builds this, and both generators refuse it."""
    raw = {"routines": [
        {"blas": "gemm", "name": "mm", "scalars": {"alpha": 1.0,
                                                   "beta": 0.0},
         "inputs": {"A": "A", "B": "B", "C": "C"},
         "outputs": {"out": "Q"}},
        {"blas": "iamax", "name": "im", "inputs": {"x": "v"},
         "outputs": {"out": "idx"}}]}
    lower = jlower if package == "reference" else lowering.lower
    ir = lower(raw, upto="infer")
    group = (jcodegen.FusionGroup if package == "reference"
             else FusionGroup)(nodes=["mm", "im"], fused=True, anchor="mm")
    return ir, group


def test_index_reduction_in_a_tiled_group_raises():
    ir, group = _iamax_tile_group("reference")
    run = jcodegen.make_tiled_callable(ir.graph, group, jnp.float32)
    rng = _rng(3)
    ins = {("mm", "A"): _mat(rng, 8, 8), ("mm", "B"): _mat(rng, 8, 4),
           ("mm", "C"): _mat(rng, 8, 4), ("im", "x"): rng.standard_normal(
               4).astype(np.float32)}
    with pytest.raises(NotImplementedError, match="index reductions"):
        run({("mm", "alpha"): 1.0, ("mm", "beta"): 0.0},
            {k: jnp.asarray(v) for k, v in ins.items()})
    ir, group = _iamax_tile_group("port")
    with pytest.raises(NotImplementedError, match="index reductions"):
        codegen.make_tiled_callable(ir.graph, group, torch.float32)


def test_tiled_group_rejects_mismatched_panels():
    prog = Program.from_spec(GEMM_COLAXPY_COLDOT, device="cpu")
    rng = _rng(4)
    inputs = {"A": _mat(rng, 20, 10), "B": _mat(rng, 10, 3),
              "C0": _mat(rng, 20, 3), "Y0": _mat(rng, 20, 4),
              "alphas": rng.standard_normal(3).astype(np.float32)}
    with pytest.raises(ValueError, match="panels disagree"):
        prog(**inputs_from_numpy(inputs, device="cpu"))
    inputs["Y0"] = _mat(rng, 20, 3)
    inputs["alphas"] = rng.standard_normal(4).astype(np.float32)
    with pytest.raises(ValueError, match="column vectors disagree"):
        prog(**inputs_from_numpy(inputs, device="cpu"))


def test_tiled_group_without_triton_raises(monkeypatch, tmp_path):
    """On a tensor the wrapper takes for the card, the tiled group
    builds and imports its Triton module or raises; it never runs the
    plain splice."""
    monkeypatch.setenv("REPRO_TORCH_BUILD", str(tmp_path))
    monkeypatch.setattr(common, "on_card", lambda *t: True)
    monkeypatch.setattr(tiled, "_MODULES", {})
    prog = Program.from_spec(tsolver_specs.BLOCK_CG_MATVEC, device="cpu")
    rng = _rng(5)
    common.reset_counts(codegen.tiled_kernel)
    with pytest.raises(ImportError):
        prog(A=torch.from_numpy(_mat(rng, 40, 40)),
             P=torch.from_numpy(_mat(rng, 40, 3)))
    assert codegen.tiled_kernel.plain_calls == 0
    assert list((tmp_path / "kernels").glob("tiled_gemm_*.py"))


def test_tiled_product_is_counted_under_the_tiled_group(monkeypatch):
    """On tensors taken for the card's, a tiled group launches gemm's
    mainloop through `repro_gemm_acc` (counted per route under
    `codegen.tiled_kernel`, never under `gemm`), then its generated
    epilogue over the float32 partials and the column fold (no card:
    the launches are recorded, not made)."""
    calls = []

    class Kernel:
        def __init__(self, name):
            self.name = name

        def __getitem__(self, grid):
            return lambda *args, **meta: calls.append((self.name, grid))

    monkeypatch.setattr(common, "on_card", lambda *t: True)
    monkeypatch.setattr(common, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(tiled, "load", lambda body: types.SimpleNamespace(
        tiled_kernel=Kernel("tiled_kernel"),
        colsum_kernel=Kernel("colsum_kernel")))
    monkeypatch.setattr(cuda, "launch", lambda stem, entry, like, *args:
                        calls.append((entry, args[-3:])))
    common.reset_counts(codegen.tiled_kernel, tops.gemm)
    rng = _rng(6)
    a, p = (torch.from_numpy(_mat(rng, *s)).clone()
            for s in ((40, 40), (40, 4)))
    route = t_gemm.gemm_route(a, p)
    Program.from_spec(tsolver_specs.BLOCK_CG_MATVEC, device="cpu")(A=a, P=p)
    chunk = t_gemm.gemm_plan(40, 4, 40, 4, SMS).chunk
    assert calls == [("repro_gemm_acc", (chunk, 1, t_gemm.ROUTES.index(
        route))), ("tiled_kernel", (1, 1)), ("colsum_kernel", (1,))]
    assert codegen.tiled_kernel.route_launches == {
        r: int(r == route) for r in t_gemm.ROUTES}
    assert (codegen.tiled_kernel.launches,
            codegen.tiled_kernel.finish_launches,
            codegen.tiled_kernel.plain_calls) == (1, 1, 0)
    assert (tops.gemm.launches, tops.gemm.plain_calls) == (0, 0)


def test_chip_smoke_tiled_spec_equals_the_test_copy():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.GEMM_COLAXPY_COLDOT == GEMM_COLAXPY_COLDOT


# ---------------------------------------------------------------------------
# On the card: gemm and one tiled group against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(515, 1029, 29), (1024, 2048, 32)])
def test_level3_kernels_match_plain_on_card(cuda_device, shape, dtype):
    m, k, n = shape
    rng = _rng(m + n)
    a, b, c = (torch.from_numpy(_mat(rng, *s)).to(cuda_device)
               .to(_TORCH[dtype]) for s in ((m, k), (k, n), (m, n)))
    got = tops.gemm(1.3, a, b, -0.7, c)
    want = t_gemm.gemm_plain(1.3, a, b, -0.7, c)
    _check_elements(got.cpu(), want.cpu(), _f64(a.cpu()), _f64(b.cpu()),
                    1.3, -0.7, _f64(c.cpu()), dtype)
    if dtype == "float32":   # the tiled group of BLOCK_CG_MATVEC
        sq, p = (torch.from_numpy(_mat(rng, *s)).to(cuda_device)
                 for s in ((k, k), (k, n)))
        got, want = (Program.from_spec(tsolver_specs.BLOCK_CG_MATVEC,
                                       mode=mode, device=cuda_device)(
            A=sq, P=p) for mode in ("dataflow", "reference"))
        for key in ("q", "pq"):
            np.testing.assert_allclose(
                _f64(got[key].cpu()), _f64(want[key].cpu()), rtol=1e-5,
                atol=1e-5 * np.sqrt(k) * float(want[key].abs().max()))
