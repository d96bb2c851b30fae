"""The MoE FFN on the card (torch ops: routing, dispatch and the grouped
products of `repro_torch.models.moe`) against the same call on the CPU.
This file imports torch and numpy only, so that it runs on a card host:

    python -m pytest -q -m cuda tests/test_torch_moe_card.py

Every test skips on a host without a card. The CPU parity with the
reference's `repro.models.moe` is tests/test_torch_moe.py.

Tolerances:
* bfloat16 on the card against float32 on the CPU, from the same
  bfloat16 weights and tokens. The tokens and the router take values in
  {-1, 0, 1}, so the router logits are integers of at most 256 in
  magnitude, exact in bfloat16 and in float32: both sides route alike,
  ties included, and keep and drop the same (token, expert) pairs. The
  card then rounds the three grouped products, the activation product
  and each gated contribution to bfloat16, about eight roundings of
  2**-9 on the way; |got - want| <= 2**-5 max|want| covers them with
  room.
* float32 on the card, no drops, against the dense oracle on the card:
  2e-4 of max|want|, as tests/test_moe.py holds the reference to its
  oracle.
"""
import numpy as np
import pytest
import torch

from repro_torch.models import moe as tmoe


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _params(seed, d, e, de, shared, dtype, device):
    rng = np.random.default_rng(seed)
    p = {"router": rng.integers(-1, 2, (d, e)),
         "we_gate": rng.standard_normal((e, d, de)) * d ** -0.5,
         "we_up": rng.standard_normal((e, d, de)) * d ** -0.5,
         "we_down": rng.standard_normal((e, de, d)) * de ** -0.5}
    if shared:
        p["ws_gate"] = rng.standard_normal((d, 2 * de)) * d ** -0.5
        p["ws_up"] = rng.standard_normal((d, 2 * de)) * d ** -0.5
        p["ws_down"] = rng.standard_normal((2 * de, d)) * (2 * de) ** -0.5
    return {k: torch.from_numpy(v.astype(np.float32)).to(
        device, torch.float32 if k == "router" else dtype)
        for k, v in p.items()}


def _ternary(seed, t, d, dtype, device):
    x = np.random.default_rng(seed).integers(-1, 2, (t, d))
    return torch.from_numpy(x.astype(np.float32)).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("e,k,shared", [(8, 2, False), (64, 6, True)])
@pytest.mark.parametrize("cf", [1.25, 4.0])
def test_moe_ffn_bf16_on_card_matches_float32_on_cpu(cuda_device, e, k,
                                                     shared, cf):
    d, de, t = 256, 128, 512
    p = _params(e + k, d, e, de, shared, torch.bfloat16, cuda_device)
    x = _ternary(1, t, d, torch.bfloat16, cuda_device)
    got = tmoe.moe_ffn(p, x, n_experts=e, top_k=k, capacity_factor=cf)
    again = tmoe.moe_ffn(p, x, n_experts=e, top_k=k, capacity_factor=cf)
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    cpu = {n: w.float().cpu() for n, w in p.items()}
    xc = x.float().cpu()
    # the same routing on both sides
    _, ge = tmoe.route_topk(tmoe.dense(x, p["router"]), k)
    _, we = tmoe.route_topk(tmoe.dense(xc, cpu["router"]), k)
    assert torch.equal(ge.cpu(), we)
    want = tmoe.moe_ffn(cpu, xc, n_experts=e, top_k=k, capacity_factor=cf)
    err = float((got.float().cpu() - want).abs().max())
    assert err <= 2.0 ** -5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("e,k,shared", [(4, 2, False), (8, 6, True)])
def test_moe_ffn_on_card_matches_the_dense_oracle(cuda_device, e, k, shared):
    d, de, t = 64, 32, 256
    p = _params(3 + e, d, e, de, shared, torch.float32, cuda_device)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (t, d)).astype(np.float32)).to(cuda_device)
    assert not torch.backends.cuda.matmul.allow_tf32   # true float32
    got = tmoe.moe_ffn(p, x, n_experts=e, top_k=k, capacity_factor=float(e))
    want = tmoe.moe_ffn_reference(p, x, n_experts=e, top_k=k)
    assert got.device.type == "cuda"
    err = float((got - want).abs().max())
    assert err <= 2e-4 * float(want.abs().max())
