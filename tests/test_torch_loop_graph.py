"""The loop driver's CUDA-graph path on the CPU: which loops take it
(`solvers.driver.graph_engages`), and its bookkeeping, run with a
stand-in for the CUDA graph that runs the captured step again at each
replay. The stand-in keeps everything but the capture: the static
buffers, their loads, the device's iteration count, the copies of the
next carry back into the buffers and of the results out of them, the
cache of graphs and its keys, and the counters. Each solve is compared
bitwise with the eager loop's on `x`, `history`, `iterations` and
`status`: the same plain versions run in the same order. The card
tests (`test_torch_loop_graph_card.py`) capture real graphs.
"""
import copy
import types

import pytest
import torch

from repro_torch import blas, obs
from repro_torch.guard import chaos
from repro_torch.solvers import LoopProgram, driver, pcg, specs

from _torch_caches import fresh_lowering_caches  # noqa: F401 (autouse)
from _torch_obs import isolated_obs_registries  # noqa: F401 (autouse)

CPU = torch.device("cpu")
CUDA = torch.device("cuda")
GRAPHED = ("cg", "pcg", "jacobi", "block_cg")


def _spd(n, seed):
    gen = torch.Generator().manual_seed(seed)
    m = torch.randn(n, n, generator=gen)
    return m @ m.T / n + torch.eye(n)


def _rhs(n, seed, cols=None):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n,) if cols is None else (n, cols), generator=gen)


def _stagnating_cg():
    """CG whose stall test wants the residual to fall by 99% an
    iteration, for 2 iterations: it stops STAGNATED after a few."""
    spec = copy.deepcopy(specs.CG_LOOP)
    spec["name"] = "cg_stagnating"
    spec["iterate"]["guards"]["stagnation"] = {"window": 2,
                                               "min_drop": 0.99}
    return spec


def _program(name, **kw):
    spec = {"cg": specs.CG_LOOP, "pcg": pcg.PCG_LOOP,
            "jacobi": specs.JACOBI_LOOP, "block_cg": specs.BLOCK_CG_LOOP,
            "stagnating": _stagnating_cg()}[name]
    return LoopProgram(spec, device=CPU, **kw)


def _matrix(name, seed=3):
    """A system of loop `name`: its matrix and the operands made from
    the matrix alone (Jacobi's D⁻¹ and ω, PCG's preconditioner)."""
    A = _spd(48, seed)
    if name == "jacobi":      # diagonally dominant: Jacobi converges
        A = A + torch.diag(A.abs().sum(dim=1))
        return A, {"dinv": 1.0 / A.diagonal(), "omega": torch.tensor(0.9)}
    if name == "pcg":         # a kernel matrix with its noise
        A = A + 0.05 * torch.eye(48)
        return A, blas.pivoted_cholesky(A, 4, 0.05).operands()
    return A, {}


def _operands(name, system, seed):
    """One solve's operands of loop `name` over `system`, its
    right-hand side from `seed`."""
    A, fixed = system
    n = A.shape[0]
    if name == "block_cg":
        B = _rhs(n, seed, cols=3)
        return {"A": A, "B": B, "x0": torch.zeros_like(B)}
    b = _rhs(n, seed)
    return {"A": A, "b": b, "x0": torch.zeros_like(b), **fixed}


@pytest.fixture
def stand_in(monkeypatch):
    """The graph path on the CPU: the rule asked as for a card, and a
    capture that records the step to run it again at each replay."""
    rule = driver.graph_engages
    monkeypatch.setattr(driver, "graph_engages",
                        lambda lir, device, waiting: rule(lir, CUDA,
                                                          waiting))

    def capture(self, iterate):
        self.graph = types.SimpleNamespace(
            replay=lambda: self.step(iterate))
    monkeypatch.setattr(driver._LoopGraph, "capture", capture)


def _eager(name, ops, **kw):
    """The solve on the eager loop, whatever the rule says."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(driver, "graph_engages", lambda *a: False)
        return _program(name, **kw).solve(**ops)


def _same(got, want):
    assert torch.equal(got.x, want.x)
    assert torch.equal(got.history.isnan(), want.history.isnan())
    assert torch.equal(got.history.nan_to_num(), want.history.nan_to_num())
    assert torch.equal(got.iterations, want.iterations)
    assert torch.equal(got.status, want.status)


# -- the engagement rule --------------------------------------------------


@pytest.mark.parametrize("name, engages", [
    ("cg", True), ("pcg", True), ("jacobi", True), ("block_cg", True),
    ("bicgstab", False), ("gmres", False)])
def test_which_bodies_take_the_graph(name, engages):
    """CG, PCG, Jacobi and block-CG take the graph on a card; BiCGStab
    (a `cond` stage) and GMRES (nested loops) do not."""
    spec = {"bicgstab": specs.BICGSTAB_LOOP,
            "gmres": specs.gmres_loop(4)}.get(name)
    lp = _program(name) if spec is None else LoopProgram(spec, device=CPU)
    assert driver.graph_engages(lp.lir, CUDA, waiting=False) is engages
    assert not driver.graph_engages(lp.lir, CPU, waiting=False)
    assert not driver.graph_engages(lp.lir, CUDA, waiting=True)


def test_a_faulted_lowering_stays_eager():
    plan = chaos.FaultPlan(program="cg", kind="nan", iteration=3)
    lp = LoopProgram(specs.CG_LOOP, device=CPU, fault=plan)
    assert not driver.graph_engages(lp.lir, CUDA, waiting=False)
    assert driver.graph_engages(_program("cg").lir, CUDA, waiting=False)


@pytest.mark.parametrize("wait", [True, False])
def test_a_waiting_registry_stays_eager(stand_in, wait):
    """Under `obs.capture(wait=True)` no graph is captured or replayed;
    under `wait=False` the solve replays."""
    A = _matrix("cg")
    lp = _program("cg")
    with obs.capture(wait=wait) as reg:
        res = lp.solve(**_operands("cg", A, 1))
    if wait:
        assert not lp._graphs
        assert "loop.graph_captures" not in reg.counters
        assert "loop.graph_replays" not in reg.counters
    else:
        assert reg.counters["loop.graph_captures"] == 1
        assert reg.counters["loop.graph_replays"] == \
            int(res.iterations) - 1


@pytest.mark.parametrize("name", GRAPHED)
def test_the_cpu_takes_no_graph_and_keeps_the_bits(name):
    ops = _operands(name, _matrix(name), 1)
    off = _program(name).solve(**ops)
    lp = _program(name)
    with obs.capture(wait=False) as reg:
        on = lp.solve(**ops)
    _same(on, off)
    assert not lp._graphs
    assert reg.counters["loop.iterations"] == int(on.iterations) > 1
    assert not any(n.startswith("loop.graph") for n in reg.counters)


# -- the graph path's bookkeeping, with the stand-in ----------------------


@pytest.mark.parametrize("name", GRAPHED)
def test_replays_equal_the_eager_loop(stand_in, name):
    """The first solve runs one iteration eagerly and captures at the
    second; a second solve with another right-hand side and start over
    the same A replays from its first iteration, with no capture."""
    system = _matrix(name)
    lp = _program(name)
    for seed in (1, 2):
        ops = _operands(name, system, seed)
        if seed == 2:
            ops["x0"] = 0.01 * _rhs(48, 9, cols=(
                3 if name == "block_cg" else None))
        with obs.capture(wait=False) as reg:
            got = lp.solve(**ops)
        _same(got, _eager(name, ops))
        k = int(got.iterations)
        assert got.status_names() == "CONVERGED" and k > 2
        assert len(lp._graphs) == 1
        assert reg.counters.get("loop.graph_captures", 0) == \
            (1 if seed == 1 else 0)
        assert reg.counters["loop.graph_replays"] == \
            (k - 1 if seed == 1 else k)
        assert reg.counters["loop.iterations"] == k


@pytest.mark.parametrize("end", ["MAX_ITERS", "STAGNATED"])
def test_replays_stop_where_the_eager_loop_stops(stand_in, end):
    """MAX_ITERS from the device's count, STAGNATED from the stall count
    and best metric carried through the buffers."""
    A = _matrix("cg")
    kw = {"max_iters": 5} if end == "MAX_ITERS" else {}
    name = "cg" if end == "MAX_ITERS" else "stagnating"
    lp = _program(name, **kw)
    for seed in (1, 2):
        ops = _operands("cg", A, seed)
        with obs.capture(wait=False) as reg:
            got = lp.solve(**ops)
        _same(got, _eager(name, ops, **kw))
        assert got.status_names() == end
        assert reg.counters["loop.graph_replays"] == \
            int(got.iterations) - (seed == 1)
    if end == "MAX_ITERS":
        assert int(got.iterations) == 5


def test_a_new_matrix_captures_again(stand_in):
    """The key holds A's address: a solve over another A captures its
    own graph, and the old one still replays for the first A."""
    lp = _program("cg")
    A1, A2 = _matrix("cg", 3), _matrix("cg", 4)     # systems
    captures = []
    for A in (A1, A2, A1):
        with obs.capture(wait=False) as reg:
            got = lp.solve(**_operands("cg", A, 1))
        _same(got, _eager("cg", _operands("cg", A, 1)))
        captures.append(reg.counters.get("loop.graph_captures", 0))
    assert captures == [1, 1, 0]
    assert len(lp._graphs) == 2


def test_the_program_keeps_a_few_graphs(stand_in):
    lp = _program("cg")
    mats = [_matrix("cg", s) for s in range(driver.GRAPHS + 1)]
    for A in mats:
        lp.solve(**_operands("cg", A, 1))
    assert len(lp._graphs) == driver.GRAPHS
    with obs.capture(wait=False) as reg:       # the oldest went first
        lp.solve(**_operands("cg", mats[0], 1))
    assert reg.counters["loop.graph_captures"] == 1


def test_batched_lanes_share_one_capture(stand_in):
    A, _ = _matrix("cg")
    B = _rhs(48, 5, cols=4).T.contiguous()
    lp = _program("cg")
    with obs.capture(wait=False) as reg:
        got = lp.batched(A=A, b=B, x0=torch.zeros_like(B))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(driver, "graph_engages", lambda *a: False)
        want = _program("cg").batched(A=A, b=B, x0=torch.zeros_like(B))
    _same(got, want)
    assert reg.counters["loop.graph_captures"] == 1
    assert reg.counters["loop.graph_replays"] == \
        int(got.iterations.sum()) - 1


def test_returned_results_are_not_written_by_later_replays(stand_in):
    A = _matrix("cg")
    lp = _program("cg")
    first = lp.solve(**_operands("cg", A, 1))
    kept = (first.x.clone(), first.history.clone(), first.status.clone())
    lp.solve(**_operands("cg", A, 2))
    assert torch.equal(first.x, kept[0])
    assert torch.equal(first.history.nan_to_num(), kept[1].nan_to_num())
    assert torch.equal(first.status, kept[2])


def test_a_one_iteration_solve_captures_nothing(stand_in):
    A = _matrix("cg")
    lp = _program("cg", max_iters=1)
    with obs.capture(wait=False) as reg:
        res = lp.solve(**_operands("cg", A, 1))
    assert int(res.iterations) == 1 and not lp._graphs
    assert reg.counters["loop.graph_replays"] == 0
    assert "loop.graph_captures" not in reg.counters


def test_the_body_reads_only_what_the_graph_holds():
    """PCG's body reads K̂, L and W where they lie and copies its three
    setup values; b, x0 and the shift are read in the setup only."""
    lp = _program("pcg")
    assert lp._reads == ["A", "L", "W", "inv_shift", "neg_inv_shift", "t0"]
    assert lp._in_place == {"A", "L", "W"}
    assert _program("jacobi")._reads == ["A", "b", "dinv", "omega"]
    assert _program("jacobi")._in_place == {"A"}
