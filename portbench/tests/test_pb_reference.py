"""The benchmark's frozen reference on the CPU, against NumPy in
float64."""
import math

import torch

from portbench import reference


def test_round_tf32():
    x = torch.tensor([1.0, 1 + 2 ** -12, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                      -(1 + 2 ** -11), 3.0e-30])
    got = reference.round_tf32(x)
    assert got.tolist()[:5] == [1.0, 1.0, 1 + 2 ** -10, 1 + 2 ** -9,
                                -(1 + 2 ** -10)]
    g = torch.Generator().manual_seed(2)
    y = torch.randn(4, 1000, generator=g)
    r = reference.round_tf32(y)
    assert int((r.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float(((r - y).abs() / y.abs()).max()) <= 2 ** -11
    assert torch.equal(y, torch.randn(4, 1000,
                                      generator=torch.Generator()
                                      .manual_seed(2)))


def test_axpydot_arithmetic_against_numpy():
    g = torch.Generator().manual_seed(4)
    n = 10_000
    w, v, u = torch.randn(3, n, generator=g)
    alpha = torch.tensor([0.5, 1.25, 1.5])
    sums = reference.axpydot_sums(w, v, u)
    w64, v64, u64 = (t.double().numpy() for t in (w, v, u))
    for a, s in zip(alpha.tolist(),
                    reference.axpydot_errors(sums, alpha, torch.zeros(3))):
        z = w64 - a * v64
        want = abs(z @ u64) / math.sqrt(((z * u64) ** 2).sum())
        assert abs(float(s) - want) <= 1e-9 * want
    exact = torch.tensor([(w64 - a * v64) @ u64 for a in alpha.tolist()],
                         dtype=torch.float64)
    assert float(reference.axpydot_errors(sums, alpha, exact).max()) < 1e-13
    ctrl = reference.axpydot_tf32(w, v, u, alpha)
    assert 1e-6 < float(reference.axpydot_errors(sums, alpha, ctrl).max())
