"""The window walk (kernels/window.py) on the card: every body of the
standalone level-1 kernels (axpy, scal, waxpby, copy, vmul, rot; dot,
asum, nrm2; iamax; axpydot) and one generated group against their plain
versions, at the walk's edges (n = 1, one step BLOCK +- 1, one wave of
programs times BLOCK +- 1), iamax's first-index rule on ties across
programs, across one program's steps and across lanes, and bitwise
repeats of the reductions; the combine folded into the walk's last
program (bitwise over 50 launches, its ticket back at 0, on two streams
at once, from a CUDA graph), and a device α read where it lives at
every alignment. This file imports torch and numpy only, so
that it runs on a card host:

    python -m pytest -q -m cuda tests/test_torch_level1_card.py

Every test skips on a host without a card. The CPU parity with the
reference's Pallas kernels is tests/test_torch_kernels.py.

Tolerances (as chip_smoke.py states them):
* element-wise: |got - plain| <= u * (1 + sum |scalars|) * max |inputs|,
  u = 1e-6 in float32 (the kernel may contract a*x + y into one fused
  multiply-add) and 2**-8 in bfloat16 (one rounding each side);
* reductions: |got - x| <= 1e-5 * sum |terms|, x the plain version or
  the float64 sum (another summation order);
* the group's iamax: the element it names reaches the reference's max
  |s| within 1e-6 of it (s is rounded by each side).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import AXPYDOT_SPEC, Program, codegen
from repro_torch.kernels import (axpy as t_axpy, axpydot as t_axpydot,
                                 common, cuda, dot as t_dot, ops as tops,
                                 window)

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DTYPES = sorted(_TORCH)
# walk edges: one element, one step +- 1, one wave of programs +- 1
EDGES = ["1", "block-1", "block+1", "wave-1", "wave+1"]
ELTWISE = {"axpy": (1.7,), "scal": (-0.3,), "waxpby": (0.5, -1.25),
           "copy": (), "vmul": (), "rot": (0.6, 0.8)}
INPUTS = {"axpy": 2, "scal": 1, "waxpby": 2, "copy": 1, "vmul": 2,
          "rot": 2}
REDUCTIONS = {"dot": 2, "asum": 1, "nrm2": 1, "axpydot": 3}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _n(edge, device):
    wave = window.PROGRAMS_PER_SM * common.sm_count(device) * window.BLOCK
    return {"1": 1, "block-1": window.BLOCK - 1,
            "block+1": window.BLOCK + 1, "wave-1": wave - 1,
            "wave+1": wave + 1}[edge]


def _vecs(n, k, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            .to(device, _TORCH[dtype]) for _ in range(k)]


def _eltwise(fn, name, vecs):
    scalars = ELTWISE[name]
    if name == "waxpby":                      # (alpha, x, beta, y)
        return fn(scalars[0], vecs[0], scalars[1], vecs[1])
    return fn(*scalars, *vecs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("name", sorted(ELTWISE))
def test_eltwise_walk_matches_plain_on_card(cuda_device, name, edge, dtype):
    n = _n(edge, cuda_device)
    vecs = _vecs(n, INPUTS[name], dtype, cuda_device, seed=n)
    wrapper = tops.KERNELS[name]
    before = wrapper.launches
    got = _eltwise(wrapper, name, vecs)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = _eltwise(getattr(t_axpy, f"{name}_plain"), name, vecs)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    scale = (1.0 + sum(abs(s) for s in ELTWISE[name])) * max(
        float(v.float().abs().max()) for v in vecs)
    unit = 2.0 ** -8 if dtype == "bfloat16" else 1e-6
    for g, w in zip(got, want):
        assert g.dtype == vecs[0].dtype and g.shape == (n,)
        assert float((g.float() - w.float()).abs().max()) <= unit * scale


def _reduction(name, vecs, plain=False):
    if name == "axpydot":
        fn = t_axpydot.axpydot_plain if plain else tops.axpydot
        return fn(0.9, *vecs)
    return (getattr(t_dot, f"{name}_plain") if plain
            else getattr(tops, name))(*vecs)


def _terms64(name, vecs):
    """(exact value, sum of |terms|) in float64."""
    v = [t.double() for t in vecs]
    if name == "dot":
        t = v[0] * v[1]
    elif name == "asum":
        t = v[0].abs()
    elif name == "nrm2":
        s = float((v[0] * v[0]).sum())
        return s ** 0.5, s ** 0.5
    else:                                     # axpydot, alpha 0.9
        t = (v[0] - 0.9 * v[1]) * v[2]
    return float(t.sum()), float(t.abs().sum())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("name", sorted(REDUCTIONS))
def test_reduction_walk_matches_plain_on_card(cuda_device, name, edge,
                                              dtype):
    n = _n(edge, cuda_device)
    vecs = _vecs(n, REDUCTIONS[name], dtype, cuda_device, seed=n + 1)
    wrapper = tops.KERNELS[name]
    before = (wrapper.launches, wrapper.finish_launches, wrapper.folded)
    got = _reduction(name, vecs)
    torch.cuda.synchronize()
    # one launch, whose last program folds the partials
    assert (wrapper.launches, wrapper.finish_launches, wrapper.folded) == (
        before[0] + 1, before[1], before[2] + 1)
    want = _reduction(name, vecs, plain=True)
    exact, mag = _terms64(name, vecs)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - float(want)) <= 1e-5 * mag
    assert abs(float(got) - exact) <= 1e-5 * mag


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("edge", EDGES)
def test_iamax_walk_matches_plain_on_card(cuda_device, edge, dtype):
    n = _n(edge, cuda_device)
    (x,) = _vecs(n, 1, dtype, cuda_device, seed=n + 2)
    got = tops.iamax(x)
    assert got.dtype == torch.int32
    assert int(got) == int(t_dot.iamax_plain(x))


def _tie_case(case, n, share):
    """(positions and values, the first index of the max) of one tie
    pattern on a grid of `share` elements per program."""
    b = window.BLOCK
    return {
        # equal |max| in three programs: the earliest program wins
        "across programs": ({5 * share + 17: 7.0, 9 * share + 3: -7.0,
                             n - 1: 7.0, 3: 6.5}, 5 * share + 17),
        # equal |max| in steps 1 and 3 of program 2: the earlier step
        "across one program's steps": ({2 * share + 3 * b + 1: 7.0,
                                        2 * share + b + 5: -7.0,
                                        3 * share: 7.0},
                                       2 * share + b + 5),
        # equal |max| in neighbouring lanes of one step
        "across lanes": ({share + 100: 7.0, share + 99: -7.0,
                          share + 101: 7.0}, share + 99),
    }[case]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["across programs",
                                  "across one program's steps",
                                  "across lanes"])
def test_iamax_ties_keep_the_first_index_on_card(cuda_device, case):
    n = 1 << 24
    programs, share = window.grid(n, common.sm_count(cuda_device), True)
    assert share >= 4 * window.BLOCK and programs > 9
    sets, first = _tie_case(case, n, share)
    x = torch.zeros(n, device=cuda_device)
    for pos, val in sets.items():
        x[pos] = val
    assert int(t_dot.iamax_plain(x)) == first
    assert int(tops.iamax(x)) == first


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dot", "nrm2", "asum"])
def test_reductions_repeat_bitwise_on_card(cuda_device, name):
    n = (1 << 24) + 37
    vecs = _vecs(n, REDUCTIONS[name], "float32", cuda_device, seed=5)
    runs = [_reduction(name, vecs) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


WIDE = {"name": "wide", "routines": [
    {"blas": "waxpby", "name": "wx", "scalars": {"alpha": 0.5, "beta": 2.0},
     "inputs": {"x": "x", "y": "y"}, "connections": {"out": "sc.x"}},
    {"blas": "scal", "name": "sc", "scalars": {"alpha": {"input": "a"}},
     "connections": {"out": ["dd.x", "nn.x", "im.x"]},
     "outputs": {"out": "s"}},
    {"blas": "dot", "name": "dd", "inputs": {"y": "x"},
     "outputs": {"out": "d"}},
    {"blas": "nrm2", "name": "nn", "outputs": {"out": "r"}},
    {"blas": "iamax", "name": "im", "outputs": {"out": "idx"}},
]}


@pytest.mark.cuda
@pytest.mark.parametrize("edge", EDGES)
def test_generated_group_walk_matches_reference_on_card(cuda_device, edge):
    """waxpby -> scal -> {dot, nrm2, iamax}: one generated kernel with an
    element-wise output, two sums and an index reduction."""
    n = _n(edge, cuda_device)
    x, y = _vecs(n, 2, "float32", cuda_device, seed=n + 3)
    ins = dict(x=x, y=y, a=torch.tensor(3.0, device=cuda_device))
    prog = Program.from_spec(WIDE, mode="dataflow", device=cuda_device)
    ref = Program.from_spec(WIDE, mode="reference", device=cuda_device)
    assert len(prog.groups) == 1
    before = codegen.group_kernel.launches
    got = prog(**ins)
    torch.cuda.synchronize()
    assert codegen.group_kernel.launches == before + 1
    want = ref(**ins)
    s64 = 3.0 * (0.5 * x.double() + 2.0 * y.double())
    assert float((got["s"] - want["s"]).abs().max()) <= \
        1e-6 * float(s64.abs().max())
    assert abs(float(got["d"]) - float(want["d"])) <= \
        1e-5 * float((s64 * x.double()).abs().sum())
    assert abs(float(got["r"]) - float(want["r"])) <= 1e-5 * float(want["r"])
    top = float(want["s"].abs().max())
    assert float(want["s"][int(got["idx"])].abs()) >= top * (1 - 1e-6)


# ---------------------------------------------------------------------------
# The combine folded into the walk's last program
# ---------------------------------------------------------------------------

# n = 1, one step + 1, and past 2**26
FOLD_SIZES = [1, 4097, (1 << 26) + 17]
FOLD_INPUTS = {"dot": 2, "nrm2": 1, "asum": 1, "iamax": 1,
               "axpydot group": 3}
NEG_ALPHA = -0.9


def _folded(name, vecs, device):
    """(a call of one reducing pass over `vecs`, its counted wrapper,
    its plain version): a standalone wrapper, or the AXPYDOT program's
    generated group with a device α."""
    if name != "axpydot group":
        fn = getattr(tops, name)
        return ((lambda: fn(*vecs)), fn,
                lambda: getattr(t_dot, f"{name}_plain")(*vecs))
    prog = Program.from_spec(AXPYDOT_SPEC, mode="dataflow", device=device)
    w, v, u = vecs
    ins = {"neg_alpha": torch.tensor(NEG_ALPHA, device=device), "w": w,
           "v": v, "u": u}
    return ((lambda: prog(**ins)["beta"]), codegen.group_kernel,
            lambda: t_axpydot.axpydot_plain(-NEG_ALPHA, w, v, u))


def _exact(name, vecs):
    """(exact value, sum of |terms|) in float64."""
    if name == "axpydot group":
        w, v, u = (t.double() for t in vecs)
        t = (w + NEG_ALPHA * v) * u
        return float(t.sum()), float(t.abs().sum())
    return _terms64(name, vecs)


@pytest.mark.cuda
@pytest.mark.parametrize("n", FOLD_SIZES)
@pytest.mark.parametrize("name", sorted(FOLD_INPUTS))
def test_folded_combine_repeats_bitwise_on_card(cuda_device, name, n):
    """One launch a pass, its partials folded by the program that draws
    the last ticket: 50 launches give the same bits, within the file's
    bounds of the plain version and float64 (iamax: its index), and the
    stream's ticket is 0 after every launch."""
    vecs = _vecs(n, FOLD_INPUTS[name], "float32", cuda_device, seed=n + 7)
    call, wrapper, plain = _folded(name, vecs, cuda_device)
    first = call()
    tick = cuda.tickets(cuda_device, 1)
    before = (wrapper.launches, wrapper.finish_launches, wrapper.folded)
    for _ in range(50):
        again = call()
        torch.cuda.synchronize()
        assert int(tick[0]) == 0
        assert torch.equal(again, first)
    assert (wrapper.launches, wrapper.finish_launches, wrapper.folded) == (
        before[0] + 50, before[1], before[2] + 50)
    if name == "iamax":
        assert int(first) == int(plain())
        return
    exact, mag = _exact(name, vecs)
    assert abs(float(first) - float(plain())) <= 1e-5 * mag
    assert abs(float(first) - exact) <= 1e-5 * mag


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FOLD_INPUTS))
def test_folded_combine_on_two_streams_at_once_on_card(cuda_device, name):
    """Passes on two streams at once, each stream on its own ticket:
    both streams queue behind a sleep, so their passes start together;
    20 rounds give the eager bits on each."""
    n = (1 << 24) + 37
    runs = [_folded(name, _vecs(n, FOLD_INPUTS[name], "float32",
                                cuda_device, seed=s), cuda_device)[0]
            for s in (11, 12)]
    eager = [run() for run in runs]
    sides = [torch.cuda.Stream() for _ in runs]
    got = []
    for side in sides:
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            torch.cuda._sleep(20_000_000)
    for _ in range(20):
        for run, side in zip(runs, sides):
            with torch.cuda.stream(side):
                got.append(run())
    torch.cuda.synchronize()
    for i, out in enumerate(got):
        assert torch.equal(out, eager[i % 2]), i


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FOLD_INPUTS))
def test_folded_combine_graph_replay_equals_eager_on_card(cuda_device,
                                                          name):
    """A pass captured in a CUDA graph (its ticket allocated and zeroed
    in the capture) replays to the eager bits, again and again, with an
    eager pass on the default stream between replays."""
    n = (1 << 20) + 5
    vecs = _vecs(n, FOLD_INPUTS[name], "float32", cuda_device, seed=13)
    call = _folded(name, vecs, cuda_device)[0]
    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = call()
    for _ in range(3):
        graph.replay()
        again = call()
        torch.cuda.synchronize()
        assert torch.equal(got, eager)
        assert torch.equal(again, eager)


# ---------------------------------------------------------------------------
# A device scalar read where it lives
# ---------------------------------------------------------------------------

_SCALAR = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


@pytest.mark.cuda
@pytest.mark.parametrize("vdtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("adtype", sorted(_SCALAR))
def test_device_scalar_read_in_place_at_every_alignment_on_card(
        cuda_device, monkeypatch, adtype, vdtype):
    """A 0-d α view at every offset mod 16 bytes of a pool on the card is
    read by the kernel from its own storage, with no scalar block: axpy
    (α rounded to the vectors' dtype in the kernel) and axpydot (α in
    float32) give the bits of the same α passed by value after
    `common.scalar_block`'s rounding, and axpy its plain version within
    the file's bound."""
    n = 4097
    x, y, u = (t.to(getattr(torch, vdtype)) for t in
               _vecs(n, 3, "float32", cuda_device, seed=17))
    gen = np.random.default_rng(19)
    pool = torch.from_numpy(1.0 + gen.standard_normal(64) / 3).to(
        cuda_device, _SCALAR[adtype])
    size = pool.element_size()
    rounded = [float(common.scalar_block([a], cuda_device, round_to=r)[0])
               for a in pool[:2 * (16 // size)] for r in (x.dtype, None)]
    blocks = []
    real_block = common.scalar_block

    def counted_block(*args, **kwargs):
        blocks.append(args)
        return real_block(*args, **kwargs)
    monkeypatch.setattr(common, "scalar_block", counted_block)
    for k in range(2 * (16 // size)):
        alpha = pool[k]
        assert alpha.data_ptr() % 16 == k * size % 16
        by_value_axpy, by_value_dot = rounded[2 * k], rounded[2 * k + 1]
        got = tops.axpy(alpha, x, y)
        assert torch.equal(got, tops.axpy(by_value_axpy, x, y)), k
        got_dot = tops.axpydot(alpha, x, y, u)
        assert torch.equal(got_dot, tops.axpydot(by_value_dot, x, y, u)), k
        assert blocks == []
        want = t_axpy.axpy_plain(by_value_axpy, x, y)
        blocks.clear()
        unit = 1e-6 if vdtype == "float32" else 2.0 ** -8
        scale = (1.0 + abs(by_value_axpy)) * max(
            float(v.float().abs().max()) for v in (x, y))
        assert float((got.float() - want.float()).abs().max()) <= \
            unit * scale
