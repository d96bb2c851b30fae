"""The port's `train_loss` and every parameter's gradient against
`jax.value_and_grad(repro.models.model.train_loss)` for xlstm-125m
(mLSTM and sLSTM blocks) and hymba-1.5b (windowed attention beside SSD
heads), reduced, float32, remat on and off (the other eight configs:
tests/test_torch_train_loss.py). S 24 is under the scans' 128-step
chunk, S 130 takes a second, ragged chunk of 2.

Tolerance, per parameter, |got - want| <= rel max|want|: hymba 1e-5 as
the dense configs; xlstm 1e-4, whose gradients run back through chains
of exponentials of cumulative log-gates (mLSTM's stabilised weights,
sLSTM's per-step recurrence over 6 layers), where each float32 rounding
in another order is amplified (measured 2.0e-5, its forget-gate bias
b_f). The loss: 1e-5 relative for both.
"""
import pytest

from _torch_train import check_loss_and_grads
from _torch_train import one_torch_thread  # noqa: F401 (autouse)

REL = {"xlstm-125m": 1e-4, "hymba-1.5b": 1e-5}


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", list(REL))
def test_train_loss_and_grads_match_reference(arch, remat):
    check_loss_and_grads(arch, 24, remat, REL[arch])


@pytest.mark.parametrize("arch", list(REL))
def test_train_grads_across_scan_chunks(arch):
    check_loss_and_grads(arch, 130, True, REL[arch])
