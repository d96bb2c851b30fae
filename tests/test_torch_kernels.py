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
# Device rule and counters
# ---------------------------------------------------------------------------


def test_cpu_tensors_run_the_plain_version():
    x, y = (torch.from_numpy(a) for a in _vecs(300, 2))
    wrappers = list(tops.KERNELS.values())
    common.reset_counts(*wrappers)
    tops.axpydot_nodf(0.5, x, y, x)
    tops.iamax(x)
    assert (tops.axpy.plain_calls, tops.dot.plain_calls,
            tops.iamax.plain_calls) == (1, 1, 1)
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
    src = window.source(STANDALONE_BODIES[name])
    compile(src, f"<{name}>", "exec")
    assert src.count("@triton.jit") == (
        2 if "iamax" in name else 1)


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
