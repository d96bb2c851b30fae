"""The level-2 CUDA kernels on the card: symv (csrc/symv.cu), gemvt and
gemv (csrc/gemv.cu) and the anchored generator's products, against their
plain versions and float64, at tile, cluster and band edges, at the
ragged 16381 and 16379, in float32, bfloat16 and float16, on every
route (TMA, masked loads, and gemv's one warp per row), with NaN in
symv's upper triangle, bitwise from call to call, with their launches
counted per route; gemv also with alpha and beta as tensors, replayed
from a CUDA graph, with its first call on a stream inside a capture,
and in two graphs of one capture stream replayed at once, under its
default plan and under tuned plans (`tune.TileConfig`). This file
imports torch and numpy only, so that it runs on a card host:

    python -m pytest -q -m cuda tests/test_torch_level2_card.py

Every test skips on a host without a card. The CPU parity with the
reference's Pallas kernels, of symv's partial layout and fold, of
gemvt's and gemv's plans and of the anchored epilogues, is
tests/test_torch_level2.py.

Tolerance (as chip_smoke.py states it): each element |got - x| <= 1e-5
* |alpha| * sum_j |A_ij x_j| + 1e-6 * |beta y_i|, x the plain version or
the float64 result (the sums run in another order); a 16-bit output
also half a unit of its dtype for each rounded side (bfloat16 2**-8,
float16 2**-11 of |got| and |want|). A reduction of an anchored group:
1e-5 of the sum of its terms' magnitudes, plus what its inputs' bounds
carry into it.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Program, codegen
from repro_torch.kernels import (anchored, gemv as t_gemv, ops as tops,
                                 symv as t_symv)
from repro_torch.solvers import specs as t_specs
from repro_torch.tune.config import TileConfig

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
_HALF_UNIT = {"float32": 0.0, "bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
ALPHA, BETA = 1.3, -0.7


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _operands(n, dtype, device, offset=0):
    """A seeded symmetric (n, n) A, `offset` elements into its buffer
    (an odd offset makes its base unaligned), and x, y."""
    rng = np.random.default_rng(n + offset)
    g = rng.standard_normal((n, n)).astype(np.float32)
    buf = torch.empty(n * n + offset, dtype=_TORCH[dtype], device=device)
    a = buf[offset:].view(n, n)
    a.copy_(torch.from_numpy((g + g.T) / 2))
    x, y = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            .to(device, _TORCH[dtype]) for _ in range(2))
    return a, x, y


def _deltas(before):
    return {r: tops.symv.route_launches[r] - c for r, c in before.items()}


def _check(got, a, x, y, dtype):
    want = t_symv.symv_plain(ALPHA, a, x, BETA, y).double()
    s64 = t_symv.symmetric_from_lower(a).double()
    x64, y64 = x.double(), y.double()
    exact = ALPHA * (s64 @ x64) + BETA * y64
    tol = 1e-5 * abs(ALPHA) * (s64.abs() @ x64.abs()) \
        + 1e-6 * abs(BETA) * y64.abs()
    g = got.double()
    unit = _HALF_UNIT[dtype]
    assert got.dtype == a.dtype and got.shape == y.shape
    assert bool(torch.isfinite(g).all())
    assert bool(((g - want).abs() <= tol + unit * (g.abs() + want.abs()))
                .all())
    assert bool(((g - exact).abs() <= tol + unit * g.abs()).all())


# around the 64-row tiles, several chunks per column, and the ragged
# order the chip run uses
SIZES = [1, 63, 64, 65, 127, 128, 129, 515, 4099, 16381]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("n", SIZES)
def test_symv_matches_plain_and_float64_on_card(cuda_device, n, dtype):
    a, x, y = _operands(n, dtype, cuda_device)
    route = t_symv.symv_route(a)
    before = dict(tops.symv.route_launches)
    finishes = tops.symv.finish_launches
    got = tops.symv(ALPHA, a, x, BETA, y)
    again = tops.symv(ALPHA, a, x, BETA, y)
    torch.cuda.synchronize()
    assert _deltas(before) == {r: 2 * (r == route) for r in before}
    assert tops.symv.finish_launches - finishes == 2   # one fold a call
    assert torch.equal(got, again)                     # bitwise repeatable
    _check(got, a, x, y, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("n,offset", [(128, 0), (128, 1), (4096, 0),
                                      (4096, 3), (4099, 0)])
def test_symv_ignores_a_nan_upper_triangle_on_card(cuda_device, n, offset,
                                                   dtype):
    a, x, y = _operands(n, dtype, cuda_device, offset)
    clean = tops.symv(ALPHA, a, x, BETA, y)
    upper = torch.ones(n, n, dtype=torch.bool, device=cuda_device).triu_(1)
    a.masked_fill_(upper, float("nan"))
    got = tops.symv(ALPHA, a, x, BETA, y)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.double()).all())
    assert torch.equal(got, clean)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("n", [64, 515, 4096])
def test_symv_routes_on_card(cuda_device, n, dtype):
    """An aligned A whose rows are whole 16-byte units goes by TMA; the
    same values at an odd offset into their buffer go by the ldg route,
    and the two agree within the tolerance."""
    a, x, y = _operands(n, dtype, cuda_device)
    b = torch.empty(n * n + 1, dtype=a.dtype,
                    device=cuda_device)[1:].view(n, n)
    b.copy_(a)
    row_bytes_whole = n * a.element_size() % 16 == 0
    assert t_symv.symv_route(a) == ("tma" if row_bytes_whole else "ldg")
    assert t_symv.symv_route(b) == "ldg"
    before = dict(tops.symv.route_launches)
    got_a = tops.symv(ALPHA, a, x, BETA, y)
    got_b = tops.symv(ALPHA, b, x, BETA, y)
    torch.cuda.synchronize()
    want = {r: 0 for r in before}
    want[t_symv.symv_route(a)] += 1
    want["ldg"] += 1
    assert _deltas(before) == want
    _check(got_a, a, x, y, dtype)
    _check(got_b, b, x, y, dtype)


# ---------------------------------------------------------------------------
# gemvt: one launch, row splits folded in a cluster
# ---------------------------------------------------------------------------

# around the 512-byte column tiles and the 32-row stages; row splits in
# clusters of 2, 4 and 8 (130, 520, 2049 rows; 16384 x 64); the ragged
# main-path shape; short-wide bases of 512 and 1025 column tiles
GEMVT_SHAPES = [(1, 1), (1, 130), (31, 127), (32, 128), (33, 129),
                (64, 256), (65, 257), (130, 300), (520, 300), (2049, 1000),
                (16384, 64), (16381, 16379), (31, 65536), (7, 131073)]


def _gemvt_operands(m, n, dtype, device, offset=0):
    """A seeded (m, n) A, `offset` elements into its buffer, x (m,) and
    y (n,)."""
    rng = np.random.default_rng(m * 7 + n + offset)
    buf = torch.empty(m * n + offset, dtype=_TORCH[dtype], device=device)
    a = buf[offset:].view(m, n)
    a.copy_(torch.from_numpy(rng.standard_normal((m, n), np.float32)))
    x = torch.from_numpy(rng.standard_normal(m, np.float32)).to(
        device, _TORCH[dtype])
    y = torch.from_numpy(rng.standard_normal(n, np.float32)).to(
        device, _TORCH[dtype])
    return a, x, y


def _check_gemvt(got, a, x, y, dtype):
    want = t_gemv.gemvt_plain(ALPHA, a, x, BETA, y).double()
    a64, x64, y64 = a.double(), x.double(), y.double()
    exact = ALPHA * (a64.T @ x64) + BETA * y64
    tol = 1e-5 * abs(ALPHA) * (a64.abs().T @ x64.abs()) \
        + 1e-6 * abs(BETA) * y64.abs()
    g = got.double()
    unit = _HALF_UNIT[dtype]
    assert got.dtype == a.dtype and got.shape == y.shape
    assert bool(torch.isfinite(g).all())
    assert bool(((g - want).abs() <= tol + unit * (g.abs() + want.abs()))
                .all())
    assert bool(((g - exact).abs() <= tol + unit * g.abs()).all())


def _gemvt_deltas(before):
    return {r: tops.gemvt.route_launches[r] - c for r, c in before.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("m,n", GEMVT_SHAPES)
def test_gemvt_matches_plain_and_float64_on_card(cuda_device, m, n, dtype):
    a, x, y = _gemvt_operands(m, n, dtype, cuda_device)
    route = t_gemv.gemvt_route(a)
    before = dict(tops.gemvt.route_launches)
    counts = (tops.gemvt.launches, tops.gemvt.finish_launches)
    got = tops.gemvt(ALPHA, a, x, BETA, y)
    again = tops.gemvt(ALPHA, a, x, BETA, y)
    torch.cuda.synchronize()
    assert _gemvt_deltas(before) == {r: 2 * (r == route) for r in before}
    # one launch a call, no combine
    assert (tops.gemvt.launches, tops.gemvt.finish_launches) == (
        counts[0] + 2, counts[1])
    assert torch.equal(got, again)                 # bitwise repeatable
    _check_gemvt(got, a, x, y, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("m,n", [(130, 300), (2049, 1000), (31, 65536),
                                 (7, 131073), (4096, 4096)])
def test_gemvt_routes_on_card(cuda_device, m, n, dtype):
    """An aligned A whose rows are whole 16-byte units goes by TMA; the
    same values at an odd offset into their buffer go by the ldg route,
    and both agree with the plain version and float64."""
    a, x, y = _gemvt_operands(m, n, dtype, cuda_device)
    b = torch.empty(m * n + 1, dtype=a.dtype,
                    device=cuda_device)[1:].view(m, n)
    b.copy_(a)
    row_bytes_whole = n * a.element_size() % 16 == 0
    assert t_gemv.gemvt_route(a) == ("tma" if row_bytes_whole else "ldg")
    assert t_gemv.gemvt_route(b) == "ldg"
    before = dict(tops.gemvt.route_launches)
    got_a = tops.gemvt(ALPHA, a, x, BETA, y)
    got_b = tops.gemvt(ALPHA, b, x, BETA, y)
    torch.cuda.synchronize()
    want = {r: 0 for r in before}
    want[t_gemv.gemvt_route(a)] += 1
    want["ldg"] += 1
    assert _gemvt_deltas(before) == want
    _check_gemvt(got_a, a, x, y, dtype)
    _check_gemvt(got_b, b, x, y, dtype)


# ---------------------------------------------------------------------------
# gemv: one warp per row where the rows fill the card, else bands of rows
# over column chunks folded by the band's last block
# ---------------------------------------------------------------------------

# 16384^2 and the ragged 16381 x 16379 one warp per row; short, wide
# bases folded over 128-264 chunks ((31, 65536), GMRES's (21, 16384), one
# row of 2**20, 16379 + 114688 columns of 7 rows); and bands with no
# fold or a fold of 2
GEMV_SHAPES = [(16384, 16384), (16381, 16379), (31, 65536), (21, 16384),
               (1, 2 ** 20), (7, 131073), (130, 300), (2049, 1000)]


def _gemv_operands(m, n, dtype, device, offset=0):
    """A seeded (m, n) A, `offset` elements into its buffer, x (n,) and
    y (m,)."""
    a, y, x = _gemvt_operands(m, n, dtype, device, offset)
    return a, x, y


def _check_gemv(got, a, x, y, dtype):
    want = t_gemv.gemv_plain(ALPHA, a, x, BETA, y).double()
    a64, x64, y64 = a.double(), x.double(), y.double()
    exact = ALPHA * (a64 @ x64) + BETA * y64
    tol = 1e-5 * abs(ALPHA) * (a64.abs() @ x64.abs()) \
        + 1e-6 * abs(BETA) * y64.abs()
    g = got.double()
    unit = _HALF_UNIT[dtype]
    assert got.dtype == a.dtype and got.shape == y.shape
    assert bool(torch.isfinite(g).all())
    assert bool(((g - want).abs() <= tol + unit * (g.abs() + want.abs()))
                .all())
    assert bool(((g - exact).abs() <= tol + unit * g.abs()).all())


def _gemv_deltas(before):
    return {r: tops.gemv.route_launches[r] - c for r, c in before.items()}


def _offset_copy(t):
    """The values of `t` one element into a larger buffer: an odd base."""
    b = torch.empty(t.numel() + 1, dtype=t.dtype,
                    device=t.device)[1:].view(t.shape)
    return b.copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("m,n", GEMV_SHAPES)
def test_gemv_matches_plain_and_float64_on_card(cuda_device, m, n, dtype):
    a, x, y = _gemv_operands(m, n, dtype, cuda_device)
    plan = t_gemv.gemv_plan_for(a)
    route = t_gemv.gemv_route(a, x, plan)
    assert (route == "rows") == (m >= 16381)
    before = dict(tops.gemv.route_launches)
    counts = (tops.gemv.launches, tops.gemv.finish_launches)
    got = tops.gemv(ALPHA, a, x, BETA, y)
    again = tops.gemv(ALPHA, a, x, BETA, y)
    torch.cuda.synchronize()
    assert _gemv_deltas(before) == {r: 2 * (r == route) for r in before}
    # one launch a call, no combine
    assert (tops.gemv.launches, tops.gemv.finish_launches) == (
        counts[0] + 2, counts[1])
    assert torch.equal(got, again)                 # bitwise repeatable
    _check_gemv(got, a, x, y, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("m,n", [(130, 300), (2049, 1000), (31, 65536),
                                 (21, 16384), (7, 131073)])
def test_gemv_routes_on_card(cuda_device, m, n, dtype):
    """The band kernel takes an aligned A and x whose rows are whole
    16-byte units by TMA; the same values with A, or x, at an odd offset
    into its buffer go by the ldg route, and all agree with the plain
    version and float64."""
    a, x, y = _gemv_operands(m, n, dtype, cuda_device)
    b, x_off = _offset_copy(a), _offset_copy(x)
    plan = t_gemv.gemv_plan_for(a)
    assert plan.band
    row_bytes_whole = n * a.element_size() % 16 == 0
    assert t_gemv.gemv_route(a, x, plan) == ("tma" if row_bytes_whole
                                             else "ldg")
    assert t_gemv.gemv_route(b, x, plan) == "ldg"
    assert t_gemv.gemv_route(a, x_off, plan) == "ldg"
    before = dict(tops.gemv.route_launches)
    got = [tops.gemv(ALPHA, a, x, BETA, y), tops.gemv(ALPHA, b, x, BETA, y),
           tops.gemv(ALPHA, a, x_off, BETA, y)]
    torch.cuda.synchronize()
    want = {r: 0 for r in before}
    want[t_gemv.gemv_route(a, x, plan)] += 1
    want["ldg"] += 2
    assert _gemv_deltas(before) == want
    for out in got:
        _check_gemv(out, a, x, y, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(16384, 64), (31, 65536), (130, 300),
                                 (2049, 1000)])
def test_gemv_takes_tensor_scalars_on_card(cuda_device, m, n):
    """alpha and beta as tensors on the card are read from a float32
    block: the same bits as the same numbers passed by value."""
    a, x, y = _gemv_operands(m, n, "float32", cuda_device)
    alpha = torch.tensor(ALPHA, device=cuda_device)
    beta = torch.tensor(BETA, dtype=torch.float64, device=cuda_device)
    by_value = tops.gemv(ALPHA, a, x, BETA, y)
    got = tops.gemv(alpha, a, x, beta, y)
    torch.cuda.synchronize()
    assert torch.equal(got, by_value)
    _check_gemv(got, a, x, y, "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n", [(21, 16384), (31, 65536), (2049, 1000),
                                 (16384, 64)])
def test_gemv_graph_replay_equals_eager_on_card(cuda_device, m, n, dtype):
    """A gemv captured in a CUDA graph (its fold's tickets and scratch
    included) replays to the eager result, bitwise, again and again."""
    a, x, y = _gemv_operands(m, n, dtype, cuda_device)
    eager = tops.gemv(ALPHA, a, x, BETA, y)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tops.gemv(ALPHA, a, x, BETA, y)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = tops.gemv(ALPHA, a, x, BETA, y)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["own", "reused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n", [(21, 16384), (31, 65536)])
def test_gemv_first_call_on_stream_captured_on_card(cuda_device, m, n,
                                                     dtype, pool):
    """The first band gemv on a fresh stream is inside a capture. The
    stream's eager gemv after it, the replay and an eager gemv after the
    replay all give the eager result, bitwise. The capture draws its
    memory from a pool of its own, or ("reused") from the pool of an
    earlier graph whose replay left -1 in every int32 of a block it has
    since freed."""
    _first_call_captured(cuda_device, m, n, dtype, pool, None)


# tuned plans (tune.TileConfig, family gemv) that keep a fold: bands of
# at most 16 rows over chunks of 512 columns, and of 8 over 1024
TUNED = [TileConfig(block_m=16, block_n=512),
         TileConfig(block_m=8, block_n=1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", TUNED, ids=lambda c: c.key())
@pytest.mark.parametrize("pool", ["own", "reused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n", [(21, 16384), (31, 65536)])
def test_gemv_first_call_on_stream_captured_under_a_tuned_plan_on_card(
        cuda_device, m, n, dtype, pool, tiles):
    """The same under tuned plans, whose bands and chunks differ from
    the default plan's and whose folds take the same tickets."""
    _first_call_captured(cuda_device, m, n, dtype, pool, tiles)


def _first_call_captured(cuda_device, m, n, dtype, pool, tiles):
    a, x, y = _gemv_operands(m, n, dtype, cuda_device)
    assert t_gemv.gemv_plan_for(a, tiles).chunks > 1
    eager = tops.gemv(ALPHA, a, x, BETA, y, tiles=tiles)
    torch.cuda.synchronize()
    fresh = torch.cuda.Stream()
    kw = {}
    if pool == "reused":
        dirty = torch.cuda.CUDAGraph()
        with torch.cuda.graph(dirty):
            junk = torch.full((1 << 16,), -1, dtype=torch.int32,
                              device=cuda_device)
        dirty.replay()
        torch.cuda.synchronize()
        del junk
        kw["pool"] = dirty.pool()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=fresh, **kw):
        got = tops.gemv(ALPHA, a, x, BETA, y, tiles=tiles)
    with torch.cuda.stream(fresh):
        before = tops.gemv(ALPHA, a, x, BETA, y, tiles=tiles)
        graph.replay()
    fresh.synchronize()
    assert torch.equal(before, eager)
    assert torch.equal(got, eager)
    with torch.cuda.stream(fresh):
        after = tops.gemv(ALPHA, a, x, BETA, y, tiles=tiles)
    fresh.synchronize()
    assert torch.equal(after, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemv_graphs_of_one_capture_stream_replay_at_once_on_card(
        cuda_device, dtype):
    """Two graphs captured on the default capture stream (no `stream=`),
    each of four band gemvs, replayed at once on two side streams, 50
    replays each: every replayed gemv gives its eager result, bitwise
    (each graph counts its mismatching elements on the card)."""
    _graphs_replay_at_once(cuda_device, dtype, None)


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", TUNED, ids=lambda c: c.key())
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemv_graphs_replay_at_once_under_a_tuned_plan_on_card(
        cuda_device, dtype, tiles):
    """The same under tuned plans."""
    _graphs_replay_at_once(cuda_device, dtype, tiles)


def _graphs_replay_at_once(cuda_device, dtype, tiles):
    shapes = [(21, 16384), (31, 65536)]
    ops_ = [_gemv_operands(m, n, dtype, cuda_device) for m, n in shapes]
    eager = [tops.gemv(ALPHA, a, x, BETA, y, tiles=tiles)
             for a, x, y in ops_]
    wrong = [torch.zeros((), dtype=torch.int64, device=cuda_device)
             for _ in ops_]
    torch.cuda.synchronize()
    graphs, got = [], []
    for (a, x, y), want, bad in zip(ops_, eager, wrong):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(4):
                out = tops.gemv(ALPHA, a, x, BETA, y, tiles=tiles)
                bad.add_((out != want).sum())
        graphs.append(graph)
        got.append(out)
    sides = [torch.cuda.Stream() for _ in graphs]
    for side in sides:
        side.wait_stream(torch.cuda.current_stream())
    for _ in range(50):
        for graph, side in zip(graphs, sides):
            with torch.cuda.stream(side):
                graph.replay()
    torch.cuda.synchronize()
    assert [int(b) for b in wrong] == [0, 0]
    for out, want in zip(got, eager):
        assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# The anchored generator: each anchor kind, its products per route
# ---------------------------------------------------------------------------

# SYMV_DOT (tests/test_fusion_l2.py's symv -> dot) returning s = S x too
SYMV_DOT_S = {"name": "symv_dot_s", "routines": [
    {"blas": "symv", "name": "mv", "scalars": {"alpha": 1.0, "beta": 0.0},
     "inputs": {"A": "A", "x": "x", "y": "x"},
     "connections": {"out": "d.x"}, "outputs": {"out": "s"}},
    {"blas": "dot", "name": "d", "inputs": {"y": "x"},
     "outputs": {"out": "q"}}]}


def _exact(program, inputs):
    """Float64 results of the three anchored programs and the bound of
    each: {output: (value, tolerance)}."""
    d = {k: v.double() for k, v in inputs.items()}
    if program == "SYMV_DOT_S":
        s64 = t_symv.symmetric_from_lower(inputs["A"]).double()
        s = s64 @ d["x"]
        tol = 1e-5 * (s64.abs() @ d["x"].abs())
        return {"s": (s, tol),
                "q": (float(d["x"] @ s), float(1e-5 * (d["x"] * s).abs()
                                               .sum() + d["x"].abs() @ tol))}
    if program == "GMRES_ORTH":
        w2 = d["w"] - d["V"].T @ d["h"]
        tol = 1e-5 * (d["V"].abs().T @ d["h"].abs()) + 1e-6 * d["w"].abs()
        return {"w2": (w2, tol),
                "hnorm": (float(w2.norm()),
                          float(tol.norm() + 1e-5 * w2.norm()))}
    q = d["A"] @ d["p"]
    tol = 1e-5 * (d["A"].abs() @ d["p"].abs())
    return {"q": (q, tol),
            "pq": (float(d["p"] @ q), float(1e-5 * (d["p"] * q).abs().sum()
                                            + d["p"].abs() @ tol))}


def _anchored_group(program, inputs):
    """The dataflow program's one anchored group: (run, scalars,
    vectors), bound as emit_program binds them."""
    raw = SYMV_DOT_S if program == "SYMV_DOT_S" else getattr(t_specs,
                                                             program)
    prog = Program.from_spec(raw, mode="dataflow", device="cuda")
    assert len(prog.groups) == 1 and prog.groups[0].anchor is not None
    run = codegen.make_anchored_callable(prog.graph, prog.groups[0],
                                         torch.float32)
    bind = {(pi.routine, pi.port): inputs[pi.name]
            for pi in prog.graph.inputs}
    scal = {k: prog.graph.nodes[k[0]].scalars[k[1]].value
            for k in run.signature.scalar_keys}
    outs = {(o.routine, o.port): o.name for o in prog.graph.outputs}
    return run, scal, {k: bind[k] for k in run.signature.vec_in_keys}, outs


def _anchored_inputs(program, shape, device, offset=0):
    rng = np.random.default_rng(sum(shape) + offset)
    m, n = shape

    def vec(k):
        return torch.from_numpy(rng.standard_normal(k, np.float32)).to(
            device)

    g = rng.standard_normal((m, n), np.float32)
    if program == "SYMV_DOT_S":
        g = (g + g.T) / 2
    buf = torch.empty(m * n + offset, device=device)
    a = buf[offset:].view(m, n)
    a.copy_(torch.from_numpy(g))
    if program == "SYMV_DOT_S":
        return {"A": a, "x": vec(n)}
    if program == "GMRES_ORTH":
        return {"V": a, "h": vec(m), "w": vec(n)}
    return {"A": a, "p": vec(n)}


# (program, anchor, matrix shape, offset, the product's route)
ANCHORED_CASES = [
    ("SYMV_DOT_S", "symv", (4096, 4096), 0, "symv/tma"),
    ("SYMV_DOT_S", "symv", (4099, 4099), 0, "symv/ldg"),
    ("SYMV_DOT_S", "symv", (4096, 4096), 1, "symv/ldg"),
    ("SYMV_DOT_S", "symv", (65, 65), 0, "symv/ldg"),
    ("GMRES_ORTH", "gemvt", (31, 65536), 0, "gemvt/tma"),
    ("GMRES_ORTH", "gemvt", (21, 16379), 0, "gemvt/ldg"),
    ("GMRES_ORTH", "gemvt", (31, 65536), 3, "gemvt/ldg"),
    ("GMRES_ORTH", "gemvt", (7, 131073), 0, "gemvt/ldg"),
    ("GMRES_ORTH", "gemvt", (2049, 1024), 0, "gemvt/tma"),
    ("CG_MATVEC", "gemv", (4096, 4096), 0, None),
    ("CG_MATVEC", "gemv", (203, 203), 0, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("program,anchor,shape,offset,route",
                         ANCHORED_CASES)
def test_anchored_group_matches_plain_and_float64_on_card(
        cuda_device, program, anchor, shape, offset, route):
    """Each anchor kind against its plain splice and float64, bitwise
    from call to call, one group launch a call and its product counted
    under its anchor and route (never under symv or gemvt), a product's
    epilogue folding its partials in its last program."""
    inputs = _anchored_inputs(program, shape, cuda_device, offset)
    run, scal, vecs, outs = _anchored_group(program, inputs)
    assert run.body.anchor == anchor
    a = vecs[run.signature.mat_key]
    assert anchored.product_route(anchor, a) == route
    kernel = codegen.anchored_kernel
    before = dict(kernel.route_launches)
    counts = (kernel.launches, kernel.finish_launches, tops.symv.launches,
              tops.gemvt.launches, kernel.folded)
    got = run(scal, vecs)
    again = run(scal, vecs)
    torch.cuda.synchronize()
    # symv's fold of its slots; the gemv anchor's finish launch (a
    # product's epilogue folds its partials in its last program)
    folds = (anchor == "symv") + (anchor == "gemv")
    assert (kernel.launches, kernel.finish_launches, tops.symv.launches,
            tops.gemvt.launches) == (counts[0] + 2, counts[1] + 2 * folds,
                                     counts[2], counts[3])
    assert kernel.folded - counts[4] == 2 * (anchor != "gemv")
    assert {r: kernel.route_launches[r] - c for r, c in before.items()} \
        == {r: 2 * (r == route) for r in before}
    assert all(torch.equal(got[k], again[k]) for k in got)
    want = run.plain(scal, vecs)
    for key, name in outs.items():
        value, tol = _exact(program, inputs)[name]
        g, w = got[key].double(), want[key].double()
        assert bool(torch.isfinite(g).all()), name
        assert bool(((g - w).abs() <= tol).all()), name
        assert bool(((g - value).abs() <= tol).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset,route", [(4096, 0, "symv/tma"),
                                            (4099, 0, "symv/ldg"),
                                            (4096, 1, "symv/ldg")])
def test_symv_anchor_ignores_a_nan_upper_triangle_on_card(cuda_device, n,
                                                          offset, route):
    inputs = _anchored_inputs("SYMV_DOT_S", (n, n), cuda_device, offset)
    run, scal, vecs, _ = _anchored_group("SYMV_DOT_S", inputs)
    a = vecs[run.signature.mat_key]
    assert anchored.product_route("symv", a) == route
    clean = run(scal, vecs)
    upper = torch.ones(n, n, dtype=torch.bool, device=cuda_device).triu_(1)
    a.masked_fill_(upper, float("nan"))
    got = run(scal, vecs)
    torch.cuda.synchronize()
    for k in clean:
        assert bool(torch.isfinite(got[k].double()).all())
        assert torch.equal(got[k], clean[k])
