"""The port's `train_loss` and every parameter's gradient against
`jax.value_and_grad(repro.models.model.train_loss)`, for the eight
reduced configs with attention (dense GQA, sliding window, MoE, MLA,
embedding inputs), float32, with remat on and off, on the same numpy
parameters and batch. xlstm-125m and hymba-1.5b, whose scans need more
time, are in tests/test_torch_train_hybrid.py.

S 24 takes the windowed configs (window 16) through the reference's
masked-chunk branch, S 40 through its banded one.

Tolerance: |got - want| <= 1e-5 max|want| per parameter, and the loss
within 1e-5 relative. The two packages sum the same float32 products in
another order (XLA's dots against torch's CPU BLAS, sums of at most
d_ff = 128 terms; attention over at most 40 keys); measured at most
2.5e-6 (minicpm3-4b's q_norm).
"""
import pytest

from _torch_train import check_loss_and_grads
from _torch_train import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["llama3-8b", "starcoder2-3b", "h2o-danube-3-4b", "mixtral-8x22b",
         "deepseek-moe-16b", "minicpm3-4b", "musicgen-medium",
         "llava-next-34b"]


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch, remat):
    check_loss_and_grads(arch, 24, remat, 1e-5)


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "mixtral-8x22b"])
def test_train_grads_banded_window_branch(arch):
    check_loss_and_grads(arch, 40, True, 1e-5)


@pytest.mark.parametrize("arch", ["llama3-8b", "musicgen-medium"])
def test_masked_train_loss_matches_reference(arch):
    check_loss_and_grads(arch, 24, True, 1e-5, masked=True)
