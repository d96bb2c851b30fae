"""symv's CUDA kernel (csrc/symv.cu) on the card: against its plain
version and float64, at tile edges and at the ragged 16381, in float32,
bfloat16 and float16, on both routes, with NaN in the upper triangle,
and bitwise from call to call. This file imports torch and numpy only,
so that it runs on a card host:

    python -m pytest -q -m cuda tests/test_torch_level2_card.py

Every test skips on a host without a card. The CPU parity with the
reference's Pallas symv, and of the kernel's partial layout and fold,
is tests/test_torch_level2.py.

Tolerance (as chip_smoke.py states it): each element |got - x| <= 1e-5
* |alpha| * sum_j |S_ij x_j| + 1e-6 * |beta y_i|, x the plain version or
the float64 result (the sums run in another order); a 16-bit output
also half a unit of its dtype for each rounded side (bfloat16 2**-8,
float16 2**-11 of |got| and |want|).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops, symv as t_symv

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
