"""`repro_torch.obs` on the card: a dataflow call's spans down to the
window pass (`window.launch`, `window.scalars`), the `window.copies` and
`window.in_place` counters, and the spans on the clock of the CUDA
runtime's records in a `torch.profiler` trace. This file imports torch
only, so that it runs on a card host:

    python -m pytest -q -m cuda tests/test_torch_obs_card.py

Every test skips on a host without a card. The CPU tests of the same
spans are in tests/test_torch_obs.py.
"""
import pytest
import torch

from repro_torch import blas, obs
from repro_torch.core import AXPYDOT_SPEC
from repro_torch.obs import core as obs_core

N = 1 << 16
CALLS = 8
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


@pytest.fixture(autouse=True)
def fresh_registry():
    saved = obs_core._REGISTRY
    obs_core._REGISTRY = obs_core.Registry()
    yield
    obs_core._REGISTRY = saved


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _axpydot(device):
    exe = blas.compile(AXPYDOT_SPEC, device=device)
    gen = torch.Generator(device=device).manual_seed(5)
    w, v, u = torch.randn(3, N, generator=gen, device=device)
    inputs = {"neg_alpha": torch.tensor(-0.75, device=device), "w": w,
              "v": v, "u": u}
    exe.run(**inputs)                 # builds the group's kernel
    torch.cuda.synchronize()
    return exe, inputs


def _inside(events, spans, prefix):
    """How many of the host events named `prefix...` lie wholly inside
    one of `spans`, and how many there are."""
    hits = [any(lo <= a and b <= hi for lo, hi in spans)
            for name, a, b in events if name.startswith(prefix)]
    return sum(hits), len(hits)


@pytest.mark.cuda
def test_window_spans_and_copies_on_card(cuda_device):
    """Each call: program.call -> kernel.group -> window.launch ->
    window.scalars, and the device α read in place by the kernel: no
    copy (`window.copies` bumped by 0, so it reads 0 and not nothing),
    one `window.in_place` a call; the answers are the unrecorded ones."""
    exe, inputs = _axpydot(cuda_device)
    want = exe.run(**inputs).one()
    with obs.capture(wait=False) as reg:
        got = [exe.run(**inputs).one() for _ in range(CALLS)]
    torch.cuda.synchronize()
    assert all(torch.equal(r, want) for r in got)
    spans = [r for r in reg.records if r["kind"] == "span"]
    by_id = {r["id"]: r for r in spans}
    names = [r["name"] for r in spans]
    chain = ["program.call", "kernel.group", "window.launch",
             "window.scalars"]
    for name in chain:
        assert names.count(name) == CALLS, name
    for r in spans:
        if r["name"] != "program.call":
            up = by_id[r["parent"]]
            assert up["name"] == chain[chain.index(r["name"]) - 1]
            assert up["start_ns"] <= r["start_ns"] <= r["end_ns"] <= \
                up["end_ns"]
    assert reg.counters["window.copies"] == 0
    assert reg.counters["window.in_place"] == CALLS


@pytest.mark.cuda
def test_spans_bracket_the_runtime_records_on_card(cuda_device):
    """Under a CUDA-activity `torch.profiler`, a call is one kernel
    launch, inside a `window.launch` span, and no copy; with
    `wait=False` no synchronisation falls between the first call and the
    last, and with the waiting default each group's span synchronises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    exe, inputs = _axpydot(cuda_device)
    for wait in (False, True):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with obs.capture(wait=wait) as reg:
                for _ in range(CALLS):
                    exe.run(**inputs)
            torch.cuda.synchronize()
        events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CPU]

        def spans(name):
            return [(r["start_ns"], r["end_ns"]) for r in reg.records
                    if r.get("name") == name]
        calls = spans("program.call")
        lo, hi = calls[0][0], calls[-1][1]
        syncs = [a for name, a, _ in events
                 if name.startswith(SYNCS) and lo < a < hi]
        if wait:
            assert len(syncs) >= CALLS
            continue
        assert syncs == []
        hits, launches = _inside(events, spans("window.launch"),
                                 "cuLaunchKernel")
        assert launches == CALLS and hits == launches
        copies = [a for name, a, _ in events
                  if name.startswith("cudaMemcpy") and lo < a < hi]
        assert copies == []
