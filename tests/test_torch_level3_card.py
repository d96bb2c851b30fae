"""gemm's CUDA mainloops (csrc/gemm.cu) on the card: `gemm` against its
plain version and float64 on every route (FFMA by TMA or ordinary
loads; wgmma for aligned 16-bit operands, also replayed from a CUDA
graph), and the tiled generator (the route's raw float32 product, then
the generated Triton epilogue) through each tiled group kind and a
16-bit group on wgmma. This file imports torch and numpy only, so that it
runs on a card host:

    python -m pytest -q -m cuda tests/test_torch_level3_card.py

Every test skips on a host without a card. The CPU parity with the
reference's Pallas gemm and tiled groups is tests/test_torch_level3.py.

Tolerances (as chip_smoke.py states them):
* float32 elements: |got - x| <= 1e-5 * sum_k |alpha A_ik B_kj|
  + 1e-6 * |beta C_ij|, x the plain version or the float64 result (the
  sums in another order); a 16-bit output also half a unit of its dtype
  for each rounded side (bfloat16 2**-8, float16 2**-11 of |got| and
  |want|);
* tiled groups: each tile output against float64 under that bound
  (colaxpy's a x + y adds |a| times it and 1e-6 of its terms), and
  against reference mode within twice it; each column reduction against
  the float64 sum of the tile outputs the same run returned, within
  1e-5 * sum|terms|.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core import Program, codegen
from repro_torch.kernels import common, gemm as t_gemm, ops as tops
from repro_torch.solvers import specs as tspecs

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
_HALF_UNIT = {"float32": 0.0, "bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}


def _smoke_spec(name):
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, name)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _matrix(rng, shape, device, dtype, offset=0):
    """A seeded contiguous matrix; `offset` elements into its buffer,
    so that its base is not 16-byte aligned."""
    m, n = shape
    buf = torch.from_numpy(rng.standard_normal(m * n + offset).astype(
        np.float32)).to(device, _TORCH[dtype])
    return buf[offset:].view(m, n)


def _deltas(before):
    return {r: tops.gemm.route_launches[r] - c for r, c in before.items()}


# (m, k, n, offset of A): aligned (tma), ragged (ldg), one wide tile
# column, split plans on both routes, an unaligned base, several tile
# columns at BN 128
SHAPES = [(1024, 2048, 32, 0), (515, 1029, 29, 0), (300, 4096, 100, 0),
          (8, 4096, 256, 0), (8, 4095, 200, 0), (256, 1024, 64, 1),
          (200, 640, 384, 0)]
# aligned shapes that 16-bit operands take on the wgmma route: M of 1, 8
# (64-row tiles, TMA's zero fill), 63, 65 and 300 (128-row tiles); n not
# a multiple of the tile; k a multiple of 8 but not of a 64-deep stage;
# split K (one tile over a long K); a square B that is not symmetric, so
# that a transposed read of it would show; 17 row tiles, past one group
# of the tile walk
WG_SHAPES = [(1, 4096, 512, 0), (8, 4096, 1000, 0), (63, 1000, 520, 0),
             (65, 2048, 192, 0), (300, 1536, 264, 0), (8, 8192, 64, 0),
             (256, 512, 512, 0), (2100, 256, 384, 0)]
SHAPES += WG_SHAPES


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=["x".join(map(str, s)) for s in SHAPES])
def test_gemm_matches_plain_and_float64_on_card(cuda_device, shape, dtype):
    m, k, n, offset = shape
    rng = np.random.default_rng(m + k + n)
    a = _matrix(rng, (m, k), cuda_device, dtype, offset)
    b, c = (_matrix(rng, s, cuda_device, dtype) for s in ((k, n), (m, n)))
    alpha, beta = 1.3, -0.7
    route = t_gemm.gemm_route(a, b)
    plan = t_gemm.plan_for(a, b)
    before = dict(tops.gemm.route_launches)
    finishes = tops.gemm.finish_launches
    got = tops.gemm(alpha, a, b, beta, c)
    again = tops.gemm(alpha, a, b, beta, c)
    torch.cuda.synchronize()
    assert _deltas(before) == {r: 2 * (r == route) for r in before}
    assert tops.gemm.finish_launches - finishes == 2 * (plan.splits > 1)
    assert torch.equal(got, again)            # bitwise repeatable
    assert got.dtype == c.dtype and got.shape == (m, n)
    want = t_gemm.gemm_plain(alpha, a, b, beta, c).double()
    a64, b64, c64 = a.double(), b.double(), c.double()
    exact = alpha * (a64 @ b64) + beta * c64
    tol = 1e-5 * abs(alpha) * (a64.abs() @ b64.abs()) \
        + 1e-6 * abs(beta) * c64.abs()
    g = got.double()
    assert bool(torch.isfinite(g).all())
    unit = _HALF_UNIT[dtype]
    assert bool(((g - want).abs() <= tol + unit * (g.abs() + want.abs()))
                .all())
    assert bool(((g - exact).abs() <= tol + unit * g.abs()).all())


def _elements_close(got, a, b, c, alpha, beta, dtype):
    """Each element within the file's bound of the plain version and of
    the float64 result."""
    want = t_gemm.gemm_plain(alpha, a, b, beta, c).double()
    a64, b64, c64 = a.double(), b.double(), c.double()
    exact = alpha * (a64 @ b64) + beta * c64
    tol = 1e-5 * abs(alpha) * (a64.abs() @ b64.abs()) \
        + 1e-6 * abs(beta) * c64.abs()
    g = got.double()
    unit = _HALF_UNIT[dtype]
    return (bool(torch.isfinite(g).all())
            and bool(((g - want).abs() <= tol + unit * (g.abs()
                                                      + want.abs())).all())
            and bool(((g - exact).abs() <= tol + unit * g.abs()).all()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("shape", WG_SHAPES,
                         ids=["x".join(map(str, s)) for s in WG_SHAPES])
def test_gemm_wgmma_route_eager_and_graph_on_card(cuda_device, shape,
                                                  dtype):
    """16-bit operands that TMA takes run on the wgmma route, under its
    own plan (a split of K where the tiles leave SMs idle), and a
    CUDA-graph replay gives the eager result bitwise."""
    m, k, n, offset = shape
    rng = np.random.default_rng(7 * m + k + n)
    a = _matrix(rng, (m, k), cuda_device, dtype, offset)
    b, c = (_matrix(rng, s, cuda_device, dtype) for s in ((k, n), (m, n)))
    alpha, beta = 0.8, 1.25
    assert t_gemm.gemm_route(a, b) == "wgmma"
    assert t_gemm.plan_for(a, b) == t_gemm.wgmma_plan(
        m, n, k, common.sm_count(a.device))
    before = dict(tops.gemm.route_launches)
    eager = tops.gemm(alpha, a, b, beta, c)
    torch.cuda.synchronize()
    assert _deltas(before) == {r: int(r == "wgmma") for r in before}
    assert _elements_close(eager, a, b, c, alpha, beta, dtype)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tops.gemm(alpha, a, b, beta, c)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_tiled_group_product_takes_the_wgmma_route_on_card(cuda_device,
                                                           dtype):
    """A 16-bit BLOCK_CG_MATVEC group: its raw product runs on the wgmma
    route (the one route choice of gemm), counted under the group, and
    q = A P is within the file's bound of the plain version and float64;
    pq = diag(Pᵀ q), summed from q before its rounding, within 1e-5 plus
    half a unit of the dtype of the terms' magnitudes."""
    m, s = 1024, 32
    rng = np.random.default_rng(11)
    a, p = (_matrix(rng, sh, cuda_device, dtype) for sh in ((m, m),
                                                            (m, s)))
    raw = dict(tspecs.BLOCK_CG_MATVEC, dtype=dtype)
    prog = Program.from_spec(raw, mode="dataflow", device=cuda_device)
    common.reset_counts(codegen.tiled_kernel, tops.gemm)
    got = prog(A=a, P=p)
    again = prog(A=a, P=p)
    torch.cuda.synchronize()
    assert codegen.tiled_kernel.route_launches == {
        r: 2 * (r == "wgmma") for r in t_gemm.ROUTES}
    assert (tops.gemm.launches, codegen.tiled_kernel.plain_calls) == (0, 0)
    assert all(torch.equal(got[key], again[key]) for key in got)
    assert got["q"].dtype == _TORCH[dtype]
    assert _elements_close(got["q"], a, p, torch.zeros_like(got["q"]), 1.0,
                           0.0, dtype)
    terms = p.double() * got["q"].double()
    err = (got["pq"].double() - terms.sum(0)).abs()
    assert bool((err <= (1e-5 + _HALF_UNIT[dtype])
                 * terms.abs().sum(0)).all())


def _tiled_case(name, shape, rng, device):
    """(spec, inputs, the key of the product's B, float64 tile outputs
    with their bounds, column reductions as (output, x key, y key)) of
    one tiled group kind at shape (m, k, s): A (m, k), panels (k, s) or
    (m, s)."""
    m, k, s = shape

    def mat(*dims):
        return _matrix(rng, dims, device, "float32")

    if name == "BLOCK_CG_MATVEC":     # q = A P; pq = diag(Pᵀq)
        ins = dict(A=mat(m, m), P=mat(m, s))
        prod = ins["A"].double() @ ins["P"].double()
        mag = ins["A"].double().abs() @ ins["P"].double().abs()
        return (tspecs.BLOCK_CG_MATVEC, ins, "P",
                {"q": (prod, 1e-5 * mag)}, [("pq", "P", "q")])
    if name == "BLOCK_RESIDUAL":      # r0 = B - A X; rz0 = diag(r0ᵀr0)
        ins = dict(A=mat(m, m), X=mat(m, s), B=mat(m, s))
        a64, x64, b64 = (ins[key].double() for key in "AXB")
        tol = 1e-5 * (a64.abs() @ x64.abs()) + 1e-6 * b64.abs()
        return (tspecs.BLOCK_RESIDUAL, ins, "X",
                {"r0": (b64 - a64 @ x64, tol)},
                [("rz0", "r0", "r0")])
    # Q = A B; R = a Q + Y0; rz = diag(RᵀR)
    ins = dict(A=mat(m, k), B=mat(k, s), C0=mat(m, s), Y0=mat(m, s),
               alphas=torch.from_numpy(rng.standard_normal(s).astype(
                   np.float32)).to(device))
    a64, b64 = ins["A"].double(), ins["B"].double()
    al64, y64 = ins["alphas"].double(), ins["Y0"].double()
    prod = a64 @ b64
    t_q = 1e-5 * (a64.abs() @ b64.abs()) + 1e-6 * ins["C0"].double().abs()
    t_r = al64.abs() * t_q + 1e-6 * ((al64 * prod).abs() + y64.abs())
    return (_smoke_spec("GEMM_COLAXPY_COLDOT"), ins, "B",
            {"Q": (prod, t_q), "R": (al64 * prod + y64, t_r)},
            [("rz", "R", "R")])


# (m, k, s): aligned (tma), ragged (ldg), and one row tile over a long K,
# whose product is split and summed by the epilogue
TILED = [("BLOCK_CG_MATVEC", (1024, 1024, 32)),
         ("BLOCK_CG_MATVEC", (1021, 1021, 29)),
         ("BLOCK_RESIDUAL", (1024, 1024, 32)),
         ("BLOCK_RESIDUAL", (1021, 1021, 29)),
         ("GEMM_COLAXPY_COLDOT", (1024, 1024, 32)),
         ("GEMM_COLAXPY_COLDOT", (515, 1029, 29)),
         ("GEMM_COLAXPY_COLDOT", (64, 8192, 16))]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", TILED, ids=[
    f"{n}-{'x'.join(map(str, s))}" for n, s in TILED])
def test_tiled_groups_match_plain_and_float64_on_card(cuda_device, name,
                                                      shape):
    rng = np.random.default_rng(sum(shape))
    raw, ins, bkey, tiles, cols = _tiled_case(name, shape, rng,
                                              cuda_device)
    prog = Program.from_spec(raw, mode="dataflow", device=cuda_device)
    route = t_gemm.gemm_route(ins["A"], ins[bkey])
    common.reset_counts(codegen.tiled_kernel, tops.gemm)
    got = prog(**ins)
    again = prog(**ins)
    torch.cuda.synchronize()
    # one product per call, on its route, never counted under gemm
    assert codegen.tiled_kernel.route_launches == {
        r: 2 * (r == route) for r in t_gemm.ROUTES}
    assert codegen.tiled_kernel.launches == 2
    assert (tops.gemm.launches, codegen.tiled_kernel.plain_calls) == (0, 0)
    assert all(torch.equal(got[key], again[key]) for key in got)
    want = Program.from_spec(raw, mode="reference", device=cuda_device)(
        **ins)
    for key, (exact, tol) in tiles.items():
        g = got[key].double()
        assert bool(torch.isfinite(g).all()), key
        assert bool(((g - exact).abs() <= tol).all()), key
        assert bool(((g - want[key].double()).abs() <= 2 * tol).all()), key
    for key, xk, yk in cols:
        x = (got[xk] if xk in got else ins[xk]).double()
        terms = x * got[yk].double()
        err = (got[key].double() - terms.sum(0)).abs()
        assert bool((err <= 1e-5 * terms.abs().sum(0)).all()), key
