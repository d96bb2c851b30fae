"""The loop driver's CUDA graph on the card: each guarded iteration of
CG, PCG, Jacobi and block-CG replayed from one capture, against the
same solve on the eager loop (forced for the test), bitwise on `x`,
`history`, `iterations` and `status`: a replay launches the kernels
the eager iteration launches, in the same order, on the same buffers'
values. Also: a solve ending at each of CONVERGED, MAX_ITERS and
STAGNATED; a second solve over the same A replays with no capture; an
A at another address captures again; batched lanes share one capture;
and a replay after the host has reused its pinned blocks. This file
imports torch only, so that it runs on a card host:

    python -m pytest -q -m cuda tests/test_torch_loop_graph_card.py

Every test skips on a host without a card.
"""
import copy

import pytest
import torch

from repro_torch import blas, obs
from repro_torch.solvers import LoopProgram, driver, pcg, plain_gp, specs

N = 4096


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _stagnating_cg():
    """CG whose stall test wants the residual to fall by 99% an
    iteration, for 2 iterations: it stops STAGNATED after a few."""
    spec = copy.deepcopy(specs.CG_LOOP)
    spec["name"] = "cg_stagnating"
    spec["iterate"]["guards"]["stagnation"] = {"window": 2,
                                               "min_drop": 0.99}
    return spec


def _spec(name):
    return {"cg": specs.CG_LOOP, "pcg": pcg.PCG_LOOP,
            "jacobi": specs.JACOBI_LOOP, "block_cg": specs.BLOCK_CG_LOOP,
            "stagnating": _stagnating_cg()}[name]


def _system(name, dev, seed=2 ** 31 + 5):
    """A system of loop `name` on the card: its matrix and the operands
    made from the matrix alone."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if name == "pcg":
        X = torch.randn(N, 8, dtype=torch.float64, generator=gen,
                        device=dev)
        K = plain_gp.kernel_matrix(X, 4.0, 1.0, 0.05)
        return K, blas.pivoted_cholesky(K, 15, 0.05).operands()
    m = torch.randn(N, N, generator=gen, device=dev) / N ** 0.5
    A = m @ m.T + torch.eye(N, device=dev)
    if name == "jacobi":
        A = A + torch.diag(A.abs().sum(dim=1))
        return A, {"dinv": 1.0 / A.diagonal(),
                   "omega": torch.tensor(0.9, device=dev)}
    return A, {}


def _operands(name, system, seed):
    A, fixed = system
    gen = torch.Generator(device=A.device).manual_seed(seed)
    if name == "block_cg":
        B = torch.randn(N, 8, generator=gen, device=A.device)
        return {"A": A, "B": B, "x0": torch.zeros_like(B)}
    b = torch.randn(N, generator=gen, device=A.device)
    x0 = 0.01 * torch.randn(N, generator=gen, device=A.device)
    return {"A": A, "b": b, "x0": x0, **fixed}


def _eager(name, ops, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(driver, "graph_engages", lambda *a: False)
        return LoopProgram(_spec(name), **kw).solve(**ops)


def _same(got, want):
    assert torch.equal(got.x, want.x)
    assert torch.equal(got.history.isnan(), want.history.isnan())
    assert torch.equal(got.history.nan_to_num(), want.history.nan_to_num())
    assert torch.equal(got.iterations, want.iterations)
    assert torch.equal(got.status, want.status)


def _solve(lp, ops):
    with obs.capture(wait=False) as reg:
        res = lp.solve(**ops)
    return res, reg.counters


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cg", "pcg", "jacobi", "block_cg"])
def test_replays_are_bitwise_the_eager_loop_on_card(cuda_device, name):
    """The first solve captures at its second iteration; a second
    solve with another b and x0 over the same A replays from its first
    iteration and captures nothing."""
    system = _system(name, cuda_device)
    lp = LoopProgram(_spec(name))
    for seed in (1, 2):
        ops = _operands(name, system, seed)
        got, counters = _solve(lp, ops)
        _same(got, _eager(name, ops))
        k = int(got.iterations)
        assert got.status_names() == "CONVERGED" and k > 2
        assert counters.get("loop.graph_captures", 0) == (seed == 1)
        assert counters["loop.graph_replays"] == k - (seed == 1)
    assert len(lp._graphs) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("end", ["MAX_ITERS", "STAGNATED"])
def test_replays_stop_where_the_eager_loop_stops_on_card(cuda_device,
                                                         end):
    name = "cg" if end == "MAX_ITERS" else "stagnating"
    kw = {"max_iters": 6} if end == "MAX_ITERS" else {}
    system = _system("cg", cuda_device)
    lp = LoopProgram(_spec(name), **kw)
    for seed in (1, 2):
        ops = _operands("cg", system, seed)
        got, counters = _solve(lp, ops)
        _same(got, _eager(name, ops, **kw))
        assert got.status_names() == end
        assert counters["loop.graph_replays"] == \
            int(got.iterations) - (seed == 1) > 0
    if end == "MAX_ITERS":
        assert int(got.iterations) == 6


@pytest.mark.cuda
def test_a_matrix_at_another_address_captures_again_on_card(cuda_device):
    first = _system("cg", cuda_device)
    other = (first[0].clone(), {})
    lp = LoopProgram(specs.CG_LOOP)
    captures = []
    for system in (first, other, first):
        ops = _operands("cg", system, 3)
        got, counters = _solve(lp, ops)
        _same(got, _eager("cg", ops))
        captures.append(counters.get("loop.graph_captures", 0))
    assert captures == [1, 1, 0]


@pytest.mark.cuda
def test_batched_lanes_share_one_capture_on_card(cuda_device):
    A, _ = _system("cg", cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    B = torch.randn(6, N, generator=gen, device=cuda_device)
    lp = LoopProgram(specs.CG_LOOP)
    with obs.capture(wait=False) as reg:
        got = lp.batched(A=A, b=B, x0=torch.zeros_like(B))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(driver, "graph_engages", lambda *a: False)
        want = LoopProgram(specs.CG_LOOP).batched(A=A, b=B,
                                                  x0=torch.zeros_like(B))
    _same(got, want)
    assert reg.counters["loop.graph_captures"] == 1
    assert reg.counters["loop.graph_replays"] == \
        int(got.iterations.sum()) - 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cg", "pcg"])
def test_a_replay_after_the_pinned_blocks_are_reused_on_card(cuda_device,
                                                             name):
    """The anchored gemv's scalars (α 1, β 0 of the K̂ matvec; PCG's
    shifts over W) come from a block built on the device inside the
    capture, never from the pinned host block of an eager launch: after
    the host has taken, filled and freed pinned blocks of every small
    size many times over, a replay still equals the eager loop."""
    system = _system(name, cuda_device)
    lp = LoopProgram(_spec(name))
    lp.solve(**_operands(name, system, 1))              # captures
    for _ in range(64):
        held = [torch.full((size,), 3.0e7).pin_memory()
                for size in (1, 2, 3, 4, 8, 16)]
        held = [t.to(cuda_device, non_blocking=True) for t in held]
    torch.cuda.synchronize()
    ops = _operands(name, system, 2)
    got, counters = _solve(lp, ops)
    assert "loop.graph_captures" not in counters
    assert counters["loop.graph_replays"] == int(got.iterations)
    _same(got, _eager(name, ops))


@pytest.mark.cuda
def test_blas_solve_replays_its_first_rung_on_card(cuda_device):
    """`blas.solve` keeps its executables, so the graph outlives a call:
    the ladder's first rung replays on every later call."""
    A, _ = _system("cg", cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    ys = torch.randn(3, N, generator=gen, device=cuda_device)
    counts = []
    for y in ys:
        with obs.capture(wait=False) as reg:
            res = blas.solve(A, y, tol=1e-5, device=cuda_device)
        first, = res.attempts
        assert first.status_name == "CONVERGED"
        counts.append((reg.counters.get("loop.graph_captures", 0),
                       reg.counters["loop.graph_replays"],
                       first.iterations))
    assert [c for c, _, _ in counts] == [1, 0, 0]
    assert all(r == k for _, r, k in counts[1:])
