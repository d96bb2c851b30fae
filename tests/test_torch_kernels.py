"""Port parity, kernel by kernel: the same seeded numpy inputs go through
the reference package (its Pallas kernels in interpret mode, its jnp
oracles) and through repro_torch on the CPU, where every wrapper runs
its plain PyTorch version.

Tolerances:
* element-wise float32: 1e-6 relative to the operands' scale (the two
  frameworks may contract a*x + y into one fused multiply-add or not);
* reductions: rtol=1e-5, atol=1e-2*sqrt(n), as the reference's own
  tests use (another summation order);
* bfloat16: compared in float32 with the bfloat16 tolerance of the
  reference's tests (2e-2), since the point here is the algorithm;
  the kernels themselves are held to their plain versions in bfloat16
  on the card (chip_smoke.py and the `cuda` tests below).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.core.runtime import inputs_from_numpy
from repro_torch.kernels import (axpy as t_axpy, common, dot as t_dot,
                                 ops as tops, ref as tref, window)

SIZES = [128, 1000, 10_000]
DTYPES = ["float32", "bfloat16"]
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _vecs(n, k, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(k)]


def _both(arrays, dtype):
    """The same values for both packages: jax arrays and CPU tensors."""
    jx = [jnp.asarray(a, dtype=_JNP[dtype]) for a in arrays]
    tx = inputs_from_numpy({str(i): np.asarray(a) for i, a in enumerate(jx)},
                           device="cpu")
    return jx, [tx[str(i)] for i in range(len(jx))]


def _f32(v):
    if torch.is_tensor(v):
        return v.float().numpy()
    return np.asarray(v, np.float32)


def _close_eltwise(got, want, dtype, scale):
    if dtype == "bfloat16":
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2,
                                   atol=2e-2)
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6,
                                   atol=1e-6 * scale)


def _close_reduction(got, want, dtype, n):
    rtol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol,
                               atol=1e-2 * np.sqrt(n))


# ---------------------------------------------------------------------------
# Row 1: element-wise level-1 (kernels/axpy.py)
# ---------------------------------------------------------------------------

ELTWISE = {
    "axpy": (lambda m, x, y: m.axpy(1.7, x, y), 2),
    "scal": (lambda m, x: m.scal(-0.3, x), 1),
    "waxpby": (lambda m, x, y: m.waxpby(0.5, x, -1.25, y), 2),
    "copy": (lambda m, x: m.copy(x), 1),
    "vmul": (lambda m, x, y: m.vmul(x, y), 2),
    "rot": (lambda m, x, y: m.rot(0.6, 0.8, x, y), 2),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", sorted(ELTWISE))
def test_eltwise_matches_reference(name, n, dtype):
    fn, k = ELTWISE[name]
    jx, tx = _both(_vecs(n, k, seed=n), dtype)
    want, got = fn(jops, *jx), fn(tops, *tx)
    if name != "rot":
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        assert g.dtype == _TORCH[dtype] and g.shape == (n,)
        _close_eltwise(g, w, dtype, scale=4.0)


def test_copy_is_exact_in_bf16():
    jx, tx = _both(_vecs(1000, 1), "bfloat16")
    np.testing.assert_array_equal(_f32(tops.copy(tx[0])),
                                  _f32(jops.copy(jx[0])))


@pytest.mark.parametrize("name", ["axpy", "scal"])
def test_scalars_cast_to_vector_dtype(name):
    """The reference casts an element-wise kernel's scalars to the
    vector's dtype (repro/kernels/axpy.py:66): in bfloat16,
    1 + 2**-10 rounds to 1, so the result is exactly x (+ y)."""
    alpha = 1.0 + 2.0 ** -10
    x, y = _vecs(1000, 2, seed=3)
    jx, tx = _both([x, y], "bfloat16")
    if name == "axpy":
        want, got = jops.axpy(alpha, *jx), tops.axpy(alpha, *tx)
        exact = (tx[0].float() + tx[1].float()).to(torch.bfloat16)
    else:
        want, got = jops.scal(alpha, jx[0]), tops.scal(alpha, tx[0])
        exact = tx[0]
    np.testing.assert_array_equal(_f32(got), _f32(want))
    np.testing.assert_array_equal(_f32(got), _f32(exact))


# ---------------------------------------------------------------------------
# Rows 2 and 3: reductions (kernels/dot.py)
# ---------------------------------------------------------------------------

REDUCTIONS = {
    "dot": (lambda m, x, y: m.dot(x, y), 2),
    "asum": (lambda m, x: m.asum(x), 1),
    "nrm2": (lambda m, x: m.nrm2(x), 1),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", sorted(REDUCTIONS))
def test_reduction_matches_reference(name, n, dtype):
    fn, k = REDUCTIONS[name]
    jx, tx = _both(_vecs(n, k, seed=n + 1), dtype)
    got = fn(tops, *tx)
    assert got.dtype == torch.float32 and got.shape == ()
    _close_reduction(got, fn(jops, *jx), dtype, n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_iamax_matches_reference(n, dtype):
    jx, tx = _both(_vecs(n, 1, seed=n + 2), dtype)
    got = tops.iamax(tx[0])
    assert got.dtype == torch.int32
    assert int(got) == int(jops.iamax(jx[0]))


IAMAX_CASES = {
    "tie_in_block": ([1.0, -3.0, 3.0, 0.5], {}),
    "all_zero": ([0.0] * 1000, {}),
    "single": ([7.0], {}),
    "max_in_tail": ([0.0] * 999 + [-5.0], {}),
    # equal maxima in two different blocks of the port's window walk
    # (and of the reference's 256-row windows): the first one wins
    "tie_across_blocks": ([0.0] * (3 * window.BLOCK + 7),
                          {100: 2.0, 5000: -3.0, 9000: 3.0}),
}


@pytest.mark.parametrize("case", sorted(IAMAX_CASES))
def test_iamax_first_occurrence(case):
    values, sets = IAMAX_CASES[case]
    x = np.asarray(values, np.float32)
    for i, v in sets.items():
        x[i] = v
    jx, tx = _both([x], "float32")
    assert int(tops.iamax(tx[0])) == int(jops.iamax(jx[0])) \
        == int(np.argmax(np.abs(x)))


# ---------------------------------------------------------------------------
# Row 4: fused axpydot (kernels/axpydot.py) and its unfused twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("fused", [True, False])
def test_axpydot_matches_reference(fused, n, dtype):
    jx, tx = _both(_vecs(n, 3, seed=n + 3), dtype)
    if fused:
        got, want = tops.axpydot(0.9, *tx), jops.axpydot(0.9, *jx)
    else:
        got, want = tops.axpydot_nodf(0.9, *tx), jops.axpydot_nodf(0.9, *jx)
    _close_reduction(got, want, dtype, n)


# ---------------------------------------------------------------------------
# ref.py: the 23 oracles against the reference's jnp oracles
# ---------------------------------------------------------------------------


def _oracle_args():
    rng = np.random.default_rng(7)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    m, n, k = 24, 40, 16
    x, y, z = r(n), r(n), r(n)
    a, b = r(m, n), r(m, n)
    xm = r(m)
    sq = r(n, n)
    return {
        "axpy": ((1.5, x, y), {}), "scal": ((-2.0, x), {}),
        "dot": ((x, y), {}), "asum": ((x,), {}), "nrm2": ((x,), {}),
        "waxpby": ((0.5, x, -1.5, y), {}), "copy": ((x,), {}),
        "vmul": ((x, y), {}), "rot": ((0.6, 0.8, x, y), {}),
        "iamax": ((x,), {}),
        "gemv": ((1.1, a, x, 0.7, xm), {}),
        "gemvt": ((1.1, a, xm, 0.7, x), {}),
        "transpose": ((a,), {}), "ger": ((0.5, xm, x, a), {}),
        "symv": ((1.3, sq, x, -0.6, y), {}),
        "gemm": ((0.8, r(m, k), r(k, n), 1.2, r(m, n)), {}),
        "matmul": ((r(m, k), r(k, n)), {}),
        "axpydot": ((0.9, x, y, z), {}),
        "gesummv": ((0.4, a, 0.6, b, x), {}),
        "atax": ((a, x), {}), "bicgk": ((a, x, xm), {}),
        "mha": ((r(2, 4, 8, 16), r(2, 2, 8, 16), r(2, 2, 8, 16)),
                {"causal": True, "window": 5}),
        "decode_attention": ((r(2, 4, 16), r(2, 2, 12, 16), r(2, 2, 12, 16),
                              np.array([5, 12], np.int32)), {"window": 4}),
    }


ORACLES = sorted(_oracle_args())


def test_oracle_inventory_is_complete():
    assert len(ORACLES) == 23
    public = {n for n in dir(jref) if not n.startswith("_")
              and callable(getattr(jref, n)) and n not in ("jax", "jnp")}
    assert public == set(ORACLES)


@pytest.mark.parametrize("name", ORACLES)
def test_oracle_matches_reference(name):
    args, kw = _oracle_args()[name]
    want = getattr(jref, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                 else a for a in args], **kw)
    got = getattr(tref, name)(*[torch.from_numpy(a)
                                if isinstance(a, np.ndarray) else a
                                for a in args], **kw)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# Rows 12-13: transpose and ger (CUDA C++ on the card; plain versions here)
# ---------------------------------------------------------------------------

# GMRES's (m, m + 1) Hessenberg buffer at m = 20, and ragged shapes
# against the reference's 256 x 256 windows
MATRIX_SHAPES = [(20, 21), (31, 300), (257, 96), (391, 133)]


def _matrix_operands(shape, seed):
    rng = np.random.default_rng(seed)
    m, n = shape
    return [rng.standard_normal(m).astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", MATRIX_SHAPES)
def test_transpose_matches_reference(shape, dtype):
    """Bitwise: the Pallas kernel (interpret mode), the oracle and the
    port all move the values as they are."""
    (ja,), (ta,) = _both(_matrix_operands(shape, sum(shape))[2:], dtype)
    got = tops.transpose(ta)
    assert got.dtype == _TORCH[dtype] and got.shape == shape[::-1]
    assert got.is_contiguous() and got.data_ptr() != ta.data_ptr()
    assert torch.equal(got, ta.t())
    for want in (jops.transpose(ja), jref.transpose(ja)):
        np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", MATRIX_SHAPES)
def test_ger_matches_reference(shape, dtype):
    """Against the Pallas kernel: the same float32 arithmetic rounded
    once to A's dtype, so within two float32 roundings of the terms
    (the compiler may fuse the multiply-add) and, in bfloat16, one
    bfloat16 unit of the result. Against `ref.ger`, which computes in
    A's dtype: three roundings of the terms in that dtype."""
    arrays = _matrix_operands(shape, 7 * sum(shape))
    (jx, jy, ja), (tx, ty, ta) = _both(arrays, dtype)
    a_before = ta.clone()
    alpha = -0.37
    got = tops.ger(alpha, tx, ty, ta)
    assert got.dtype == _TORCH[dtype] and got.shape == shape
    assert torch.equal(ta, a_before) and got.data_ptr() != ta.data_ptr()
    x, y, a = (_f32(t).astype(np.float64) for t in (tx, ty, ta))
    terms = np.abs(alpha * np.outer(x, y)) + np.abs(a)
    g = _f32(got).astype(np.float64)
    # one bfloat16 unit in the last place: the two round a float32 value
    # on either side of a tie (a fused multiply-add moves it) apart
    unit = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    want = _f32(jops.ger(alpha, jx, jy, ja)).astype(np.float64)
    tol = 2.0 ** -23 * terms + unit * np.maximum(np.abs(g), np.abs(want))
    assert np.all(np.abs(g - want) <= tol)
    want = _f32(jref.ger(alpha, jx, jy, ja)).astype(np.float64)
    u = 2.0 ** -8 if dtype == "bfloat16" else 2.0 ** -24
    assert np.all(np.abs(g - want) <= 3 * u * terms + u * np.abs(g))


@pytest.mark.parametrize("bad", [
    lambda: tops.transpose(torch.zeros(3)),                   # not 2-D
    lambda: tops.transpose(torch.zeros(3, 4).T),              # a view
    lambda: tops.ger(1.0, torch.zeros(4), torch.zeros(3),
                     torch.zeros(3, 3)),                      # x length
    lambda: tops.ger(1.0, torch.zeros(3), torch.zeros(3),
                     torch.zeros(3, 3, dtype=torch.bfloat16)),
])
def test_matrix_wrappers_reject_bad_operands(bad):
    with pytest.raises(ValueError):
        bad()


# ---------------------------------------------------------------------------
# Device rule and counters
# ---------------------------------------------------------------------------


def test_cpu_tensors_run_the_plain_version():
    x, y = (torch.from_numpy(a) for a in _vecs(300, 2))
    wrappers = list(tops.KERNELS.values())
    common.reset_counts(*wrappers)
    tops.axpydot_nodf(0.5, x, y, x)
    tops.iamax(x)
    tops.ger(0.5, x, y, tops.transpose(torch.outer(y, x)))
    assert (tops.axpy.plain_calls, tops.dot.plain_calls,
            tops.iamax.plain_calls, tops.ger.plain_calls,
            tops.transpose.plain_calls) == (1, 1, 1, 1, 1)
    assert all(w.launches == w.finish_launches == 0 for w in wrappers)


def test_device_none_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        common.resolve_device(None)
    assert common.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("bad", [
    lambda: tops.axpy(1.0, torch.zeros(3), torch.zeros(4)),
    lambda: tops.dot(torch.zeros(3), torch.zeros(3, dtype=torch.bfloat16)),
    lambda: tops.nrm2(torch.zeros(2, 2)),
    lambda: tops.asum(torch.zeros(0)),
])
def test_wrappers_reject_bad_operands(bad):
    with pytest.raises(ValueError):
        bad()


STANDALONE_BODIES = {
    **{name: t_axpy._body(name) for name in t_axpy.TL_EXPR},
    "iamax": window.WindowBody(n_scalars=0, n_inputs=1, argmaxes=("x0",)),
    "nrm2+iamax": window.WindowBody(
        n_scalars=0, n_inputs=1, sums=(("x0 * x0", "tl.sqrt"),),
        argmaxes=("x0",)),
}


@pytest.mark.parametrize("name", sorted(STANDALONE_BODIES))
def test_window_sources_compile_as_python(name):
    """One kernel a pass; a body that reduces folds its partials in the
    program that draws the last ticket, with no kernel of its own."""
    body = STANDALONE_BODIES[name]
    src = window.source(body)
    compile(src, f"<{name}>", "exec")
    assert src.count("@triton.jit") == 1
    assert "finish_kernel" not in src
    reduces = bool(body.sums or body.argmaxes)
    assert src.count("tl.atomic_") == src.count("ticket == P - 1") \
        == int(reduces)


_B = window.BLOCK
GRID_SIZES = [1, 15, 16, 17, _B - 1, _B, _B + 1, 528 * _B - 1, 528 * _B,
              528 * _B + 1, (1 << 26) - 37, 1 << 26, 2 ** 31 - 1]


@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("n", GRID_SIZES)
def test_window_grid_covers_every_element_once(n, sms):
    """Program p walks [p * share, min((p + 1) * share, n)): the shares
    tile [0, n) with none empty, each starts on SHARE_ALIGN elements,
    and the programs fit one wave of PROGRAMS_PER_SM on each SM."""
    programs, share = window.grid(n, sms, True)
    assert share % window.SHARE_ALIGN == 0
    assert (programs - 1) * share < n <= programs * share
    assert 1 <= programs <= min(window.PROGRAMS_PER_SM * sms,
                                -(-n // window.BLOCK))
    # balanced: no share exceeds the even split by a whole alignment unit
    assert share < -(-n // programs) + window.SHARE_ALIGN
    # a function of n and the SM count alone
    assert window.grid(n, sms, True) == (programs, share)
    # a body that only stores: one program per BLOCK elements
    assert window.grid(n, sms, False) == (-(-n // window.BLOCK),
                                          window.BLOCK)


def test_window_scalars_go_by_value_unless_they_are_tensors(monkeypatch):
    """Numbers need no copy to the card: they go by value (Triton's
    launcher passes a float as float32), rounded first as
    `common.scalar_block` rounds them. A floating one-element tensor on
    the launch's device goes as its own pointer, read and rounded by the
    kernel; any other tensor (not floating, or on another device) is
    read from an element of the block. Only a tensor's bit is set in the
    mask."""
    dev = torch.device("cpu")
    alpha = 1.0 + 2.0 ** -10              # rounds to 1 in bfloat16
    ptrs, values, mask = window.scalar_args([alpha, -0.3], dev)
    assert (ptrs, mask) == ([None, None], 0)
    assert values == [alpha, -0.3]
    ptrs, values, mask = window.scalar_args([alpha], dev,
                                            round_to=torch.bfloat16)
    assert (ptrs, values, mask) == ([None], [1.0], 0)
    # on the launch's device: its own storage, no block, at any dtype of
    # IN_PLACE and any offset of a pool
    pool = torch.arange(8, dtype=torch.float64) / 3
    for t in (torch.tensor(2.5), pool[5], torch.tensor([0.75]),
              torch.tensor(1.5, dtype=torch.bfloat16)):
        ptrs, values, mask = window.scalar_args([0.5, t], dev,
                                                round_to=torch.float16)
        assert mask == 2 and values == [0.5, 0.0]
        assert ptrs[0] is None and ptrs[1] is t
    # not floating: the block's element, as scalar_block fills it
    t = torch.tensor(3)
    ptrs, values, mask = window.scalar_args([0.5, t], dev)
    assert mask == 2 and values[0] == 0.5 and ptrs[0] is None
    assert ptrs[1].shape == () and ptrs[1].dtype == torch.float32
    assert torch.equal(ptrs[1], common.scalar_block([0.5, t], dev)[1])
    # a rounding the kernel does not apply: the block, rounded there
    t = torch.tensor(2.5)
    ptrs, _, mask = window.scalar_args([t], dev,
                                       round_to=torch.float8_e4m3fn)
    assert mask == 1 and ptrs[0] is not t
    # on another device: the block that scalar_block fills on `dev`
    calls = []

    def block(values, device, round_to=None):
        calls.append((list(values), device, round_to))
        return torch.tensor([7.0, 8.0])
    monkeypatch.setattr(common, "scalar_block", block)
    elsewhere = torch.empty((), device="meta")
    ptrs, values, mask = window.scalar_args([0.5, elsewhere], dev)
    assert mask == 2 and ptrs[0] is None and float(ptrs[1]) == 8.0
    assert calls == [([0.5, elsewhere], dev, None)]


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# the plain versions under the wrappers' names
PLAIN = types.SimpleNamespace(
    **{r: getattr(t_axpy, f"{r}_plain") for r in t_axpy.TL_EXPR},
    **{r: getattr(t_dot, f"{r}_plain")
       for r in ("dot", "asum", "nrm2", "iamax")})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(ELTWISE) + sorted(REDUCTIONS)
                         + ["iamax"])
def test_kernel_matches_plain_on_card(cuda_device, name, dtype):
    n = 3 * window.BLOCK + 37
    x, y = (torch.from_numpy(a).to(cuda_device).to(_TORCH[dtype])
            for a in _vecs(n, 2, seed=9))
    fn, k = {**ELTWISE, **REDUCTIONS, "iamax": (
        lambda m, x: m.iamax(x), 1)}[name]
    args = (x, y)[:k]
    wrapper = tops.KERNELS[name]
    before = wrapper.launches
    got = fn(tops, *args)
    assert wrapper.launches == before + 1
    want = fn(PLAIN, *args)
    if name == "iamax":
        assert int(got) == int(want)
        return
    if name != "rot":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g.cpu()), _f32(w.cpu()),
                                   rtol=1e-5, atol=1e-5 * np.sqrt(n))
