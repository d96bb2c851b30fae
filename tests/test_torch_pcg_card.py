"""The GP predictive solve on the card: `blas.pivoted_cholesky` and
`blas.solve(..., precond=)` (PCG's stage programs on the generated and
CUDA kernels: the anchored gemv over K̂, the gemvt over the (n, 15)
factor L and the gemv-anchored group over W) at n = 16,384, against the
float64 plain reference (`solvers/plain_gp.py`), and the loop's one
host wait an iteration under a device trace. This file imports torch
only, so that it runs on a card host:

    python -m pytest -q -m cuda tests/test_torch_pcg_card.py

Every test skips on a host without a card. Limits: the true relative
residual at most 1.01 tol; the reported one within 1e-3 ‖y‖ of it
(float32 products: read 1.7e-4 ‖y‖, and up to 8.5e-4 at n = 65,536 in
the benchmark's cell; TF32 products make the solve diverge);
iterations within 10% of the plain float32 PCG's with the port's factor
(the two sum in other orders: 98-102 against 99-103 on an H100), and
between the float64 reference PCG's with its own factor and 1.35 times
it: float32 PCG takes more iterations than float64 at this size (1.12-1.20
times, against 1.8-1.9 for float32 CG without the preconditioner).
"""
import pytest
import torch

from repro_torch import blas, obs
from repro_torch.solvers import plain_gp

N, D, ELL, S2, NOISE, RANK, TOL = 16384, 8, 4.0, 1.0, 0.05, 15, 0.01


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _system(dev, seed=2 ** 31 + 99):
    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn(N, D, dtype=torch.float64, generator=gen, device=dev)
    Y = torch.randn(3, N, generator=gen, device=dev)
    return plain_gp.kernel_matrix(X, ELL, S2, NOISE), Y


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dataflow", "nodataflow"])
def test_pcg_on_the_card_matches_float64(cuda_device, mode):
    K, Y = _system(cuda_device)
    P = blas.pivoted_cholesky(K, RANK, NOISE)
    L64, pivots = plain_gp.pivoted_cholesky(K, RANK, NOISE)
    assert P.pivots.tolist() == pivots
    assert float((P.L.double() - L64).abs().max()) <= 1e-4
    _, want, _ = plain_gp.pcg(K, Y.T.double(), L64,
                              plain_gp.woodbury(L64, NOISE), NOISE,
                              tol=TOL, max_iters=1000)
    _, plain, _ = plain_gp.pcg(K, Y.T.contiguous(), P.L, P.W, NOISE,
                               tol=TOL, max_iters=1000)
    for j in range(Y.shape[0]):
        y = Y[j]
        res = blas.solve(K, y, tol=TOL, max_iters=1000, precond=P,
                         mode=mode, device=cuda_device)
        first, = res.attempts
        assert (first.solver, first.status_name) == ("pcg", "CONVERGED")
        ynorm = float(y.double().norm())
        true = float((plain_gp.matmul(K, res.x) - y.double()).norm())
        assert true <= 1.01 * TOL * ynorm
        assert abs(first.residual - true) <= 1e-3 * ynorm
        assert abs(first.iterations - int(plain[j])) <= \
            0.1 * int(plain[j])
        assert int(want[j]) <= first.iterations <= 1.35 * int(want[j])
        assert res.x.device.type == "cuda"


@pytest.mark.cuda
def test_the_stop_read_is_an_iterations_one_wait(cuda_device):
    """Under a CUDA trace and `capture(wait=False)`, every host call that
    waits for the device (a synchronisation) in a `loop.iter` span lies
    inside its `loop.stop` span."""
    from torch.profiler import ProfilerActivity, profile

    K, Y = _system(cuda_device)
    P = blas.pivoted_cholesky(K, RANK, NOISE)
    blas.pcg(K, Y[0], precond=P, device=cuda_device)     # builds kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with obs.capture(wait=False) as reg:
            res = blas.pcg(K, Y[1], precond=P, device=cuda_device)
    spans = [r for r in reg.records if r["kind"] == "span"]
    iters = [(r["start_ns"], r["end_ns"]) for r in spans
             if r["name"] == "loop.iter"]
    stops = [(r["start_ns"], r["end_ns"]) for r in spans
             if r["name"] == "loop.stop"]
    assert len(iters) == len(stops) == int(res.iterations) > 0
    waits = [(e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(("cudaStreamSynchronize",
                                     "cudaDeviceSynchronize",
                                     "cudaEventSynchronize"))]
    inside = [w for w in waits
              if any(a <= w[0] and w[1] <= b for a, b in iters)]
    assert inside
    assert all(any(a <= w[0] and w[1] <= b for a, b in stops)
               for w in inside)
