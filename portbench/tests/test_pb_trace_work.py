"""The trace arithmetic on synthetic intervals, and the work reckoned
from the cell's shapes."""
import pytest

from portbench import tracing, work



def test_union_and_gaps():
    merged = tracing.union([(5, 9), (0, 2), (1, 3), (8, 12), (20, 21)])
    assert merged == [(0, 3), (5, 12), (20, 21)]
    assert tracing.gaps(merged, 0, 30) == [(3, 5), (12, 20), (21, 30)]
    assert tracing.gaps(merged, -4, 21) == [(-4, 0), (3, 5), (12, 20)]


def test_summarize_spans_the_trace():
    ev = [
        ("cudaStreamSynchronize", False, 100, 120),   # the window opens
        ("cudaLaunchKernel", False, 130, 140),
        ("window_kernel", True, 150, 400),
        ("cudaMemcpyAsync", False, 150, 160),
        ("Memcpy HtoD (Pinned -> Device)", True, 400, 410),
        ("cudaLaunchKernel", False, 170, 180),
        ("window_kernel", True, 410, 650),
        ("finish_kernel", True, 640, 660),          # overlaps the one before
        ("cudaLaunchKernel", False, 700, 710),
        ("window_kernel", True, 760, 1000),
        ("cudaStreamSynchronize", False, 720, 1010),  # and closes
    ]
    s = tracing.summarize(ev)
    assert s["window_s"] == pytest.approx((1010 - 100) * 1e-9)
    busy = (660 - 150) + (1000 - 760)
    assert s["busy_s"] == pytest.approx(busy * 1e-9)
    assert s["kernels"] == 4                    # the copy is no kernel
    ops = dict(s["device_ops"])
    assert ops["window_kernel"] == pytest.approx(730e-9)
    assert ops["finish_kernel"] == pytest.approx(20e-9)
    gaps = dict(s["idle_gaps"])
    # 100-150 (its middle 125 after the opening sync, before any
    # launch), 660-760 (middle 710 at the end of the last launch),
    # 1000-1010 (in the closing sync)
    assert gaps[tracing.UNCOVERED] == pytest.approx(50e-9)
    assert gaps["cudaLaunchKernel"] == pytest.approx(100e-9)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(10e-9)
    assert sum(gaps.values()) == pytest.approx(
        s["window_s"] - s["busy_s"])


def test_an_uncovered_gap_is_named_so():
    """A gap is named whole by what covers its middle."""
    s = tracing.summarize([("k", True, 0, 10), ("cudaLaunchKernel", False,
                                                  40, 45),
                           ("k", True, 50, 60)])
    assert dict(s["idle_gaps"]) == {tracing.UNCOVERED: pytest.approx(40e-9)}


def test_summarize_needs_an_event():
    with pytest.raises(ValueError):
        tracing.summarize([])


def test_top_keeps_ten_largest():
    rows = tracing.top({f"k{i}": i for i in range(15)})
    assert len(rows) == tracing.TOP
    assert rows[0] == ["k14", 14e-9]


def test_axpydot_work():
    nbytes, flops = work.axpydot_call(2 ** 26)
    assert nbytes == 805_306_368
    assert flops == 4 * 2 ** 26
    least = work.least_seconds(nbytes, flops, work.PEAKS[
        "NVIDIA H100 80GB HBM3"])
    assert least == pytest.approx(0.2404e-3, rel=1e-3)
