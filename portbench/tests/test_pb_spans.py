"""The `spans` window: the span arithmetic on synthetic spans and events,
the six readers on a hand-built run, and the window itself in a traced
run on the CPU."""
import ast
import json
import sys
import types

import pytest

from portbench import core, manifest as mf, spans, spantrace, tracing

from .test_pb_manifest import BENCH, TINY, tiny_run

CELL = "axpydot-stream"
US = 1000
# two calls, each program.call -> kernel.group -> window.launch ->
# window.scalars, and one span outside every call (ids 1-9)
SPANS = [
    ("window.scalars", 4, 3, 130 * US, 150 * US),
    ("window.launch", 3, 2, 125 * US, 180 * US),
    ("kernel.group", 2, 1, 110 * US, 190 * US),
    ("program.call", 1, None, 100 * US, 200 * US),
    ("window.scalars", 8, 7, 320 * US, 330 * US),
    ("window.launch", 7, 6, 310 * US, 400 * US),
    ("kernel.group", 6, 5, 305 * US, 415 * US),
    ("program.call", 5, None, 300 * US, 420 * US),
    ("lowering.emit", 9, None, 40 * US, 60 * US),
]
EVENTS = [
    ("cudaDeviceSynchronize", False, 90 * US, 95 * US),   # window opens
    ("cudaMemcpyAsync", False, 135 * US, 140 * US),
    ("Memcpy HtoD (Pinned -> Device)", True, 150 * US, 152 * US),
    ("cuLaunchKernelEx", False, 160 * US, 170 * US),
    ("window_kernel", True, 172 * US, 260 * US),
    ("cudaMemcpyAsync", False, 325 * US, 328 * US),
    ("cuLaunchKernelEx", False, 350 * US, 395 * US),      # a slow launch
    ("window_kernel", True, 396 * US, 480 * US),
    ("cudaDeviceSynchronize", False, 430 * US, 481 * US),  # and closes
]
READERS = {
    # (median of call 1's and call 2's values, in us)
    "issue_api_us.program": (20 + 10) / 2,
    "issue_group_us.program": (25 + 20) / 2,
    "issue_launch_us.program": (35 + 80) / 2,
    "issue_scalars_us.program": (20 + 10) / 2,
    "copies_per_call.program": 2.0,
}


def test_self_time_less_the_children():
    got = spantrace.self_ns(SPANS)
    assert {sid: ns // US for sid, ns in got.items()} == {
        1: 20, 2: 25, 3: 35, 4: 20, 5: 10, 6: 20, 7: 80, 8: 10, 9: 20}


def test_self_time_unions_and_clips_the_children():
    s = [("p", 1, None, 0, 100), ("a", 2, 1, 10, 40), ("b", 3, 1, 30, 50),
         ("c", 4, 1, 90, 130)]              # overlapping; past the end
    assert spantrace.self_ns(s)[1] == 100 - 40 - 10


def test_per_call_sums_each_calls_spans():
    value = spantrace.self_ns(SPANS)
    assert spantrace.calls_of(SPANS, "program.call") == {
        1: 1, 2: 1, 3: 1, 4: 1, 5: 5, 6: 5, 7: 5, 8: 5}
    assert spantrace.per_call(SPANS, "program.call", "window.launch",
                              value) == [35 * US, 80 * US]
    two = SPANS + [("window.launch", 10, 2, 185 * US, 188 * US)]
    assert spantrace.per_call(two, "program.call", "window.launch",
                              spantrace.self_ns(two)) == [38 * US, 80 * US]
    assert spantrace.per_call(SPANS, "program.call", "nothing", value) == []


def test_idle_under_a_span_name():
    """Device busy 150-152, 172-260, 396-480 over the window 90-481.
    Gaps: 90-150 (middle 120, in call 1 before its launch), 152-172
    (162, in call 1's launch, under its runtime call), 260-396 (328, in
    call 2's launch) and 480-481 (480.5, outside every call)."""
    idle = spantrace.idle_under(EVENTS, SPANS, "program.call")
    assert idle == (60 + 20 + 136) * US
    assert spantrace.idle_under(EVENTS, SPANS, "window.launch") == \
        (20 + 136) * US
    assert spantrace.idle_under(EVENTS, SPANS, "nothing") == 0
    lo, hi = spantrace.window_of(EVENTS)
    whole = tracing.summarize(EVENTS)
    total = whole["window_s"] - whole["busy_s"]
    assert (hi - lo) / 1e9 == pytest.approx(whole["window_s"])
    assert total * 1e9 - idle == pytest.approx(1 * US)   # outside calls


def test_a_gap_outside_every_span():
    ev = [("k", True, 0, 10), ("k", True, 50, 60)]
    assert spantrace.idle_under(ev, [("program.call", 1, None, 5, 12)],
                                "program.call") == 0
    assert spantrace.idle_under(ev, [("program.call", 1, None, 5, 31)],
                                "program.call") == 40


def test_runtime_records_inside_their_spans():
    assert spantrace.inside(EVENTS, SPANS, "cuLaunchKernel",
                            "window.launch") == (2, 2)
    assert spantrace.inside(EVENTS, SPANS, "cudaMemcpyAsync",
                            "window.scalars") == (2, 2)
    assert spantrace.inside(EVENTS, SPANS, "cudaDevice",
                            "program.call") == (0, 2)
    assert spantrace.between(EVENTS, 100 * US, 420 * US,
                             spans.SYNCS) == 0
    assert spantrace.between(EVENTS, 80 * US, 420 * US, spans.SYNCS) == 1


def test_the_log_line_reads_the_clocks_agreement():
    w = spans.SpansWindow(core.Window(calls=2), EVENTS, SPANS, {})
    line = spans.describe(w)
    assert "program.call median 110.0 us" in line
    assert "device copies a call 0.5" in line
    assert "launches inside window.launch 2/2" in line
    assert "copies inside window.scalars 2/2" in line
    assert line.endswith("synchronisations between the first call and "
                         "the last 0")


def test_summarize_is_the_same_whatever_spans_exist():
    """The traced window's breakdown reads the events alone: the same
    events give byte for byte the same summary, before and after the
    span arithmetic has read them."""
    before = json.dumps(tracing.summarize(EVENTS))
    frozen = list(EVENTS)
    spantrace.idle_under(EVENTS, SPANS, "program.call")
    spantrace.inside(EVENTS, SPANS, "cuLaunchKernel", "window.launch")
    assert EVENTS == frozen
    assert json.dumps(tracing.summarize(EVENTS)) == before


def _hand_built(window=True):
    w = spans.SpansWindow(core.Window(elapsed_s=1.0, calls=2), EVENTS,
                          SPANS, {"window.copies": 4}) if window else None
    return types.SimpleNamespace(trace=True, state={"spans": w})


def _read(name, run):
    return mf.module("metrics", name, BENCH).read(run)


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_on_a_hand_built_run(name):
    assert _read(name, _hand_built()) == pytest.approx(READERS[name])


def test_idle_in_call_reader():
    lo, hi = spantrace.window_of(EVENTS)
    assert _read("idle_in_call.program", _hand_built()) == pytest.approx(
        100.0 * (60 + 20 + 136) * US / (hi - lo))


NEW = sorted(READERS) + ["idle_in_call.program"]


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_without_spans(name):
    assert _read(name, _hand_built(window=False)) is None
    untraced = types.SimpleNamespace(trace=False, state={})
    assert _read(name, untraced) is None
    no_device = _hand_built()
    no_device.state["spans"].events = [e for e in EVENTS if not e[1]]
    no_calls = _hand_built()
    no_calls.state["spans"].spans = [s for s in SPANS
                                     if s[0] != "program.call"]
    no_calls.state["spans"].counters = {}
    assert _read(name, no_calls) is None
    if name == "idle_in_call.program":
        assert _read(name, no_device) is None


def test_the_new_metrics_are_in_the_manifest():
    m = mf.load()
    layer = {p["name"]: p for p in m["per_layer"]}
    for name in NEW:
        assert layer[name]["workloads"] == [CELL]
        assert layer[name]["moves"] == "calls_per_s"
    names = [m["name"] for m in mf.metrics_of(m, CELL, True)]
    assert names[-len(NEW):] == [
        "issue_api_us.program", "issue_group_us.program",
        "issue_launch_us.program", "issue_scalars_us.program",
        "idle_in_call.program", "copies_per_call.program"]


def test_the_span_arithmetic_imports_the_standard_library_alone():
    tree = ast.parse((BENCH / "spantrace.py").read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert tops <= set(sys.stdlib_module_names) | {"portbench"}


def test_a_traced_run_reads_its_spans_window_on_the_cpu(store):
    """The traced run's third window runs on the CPU: the API and group
    metrics read there; a CPU call takes no window pass, copies nothing
    and has no device to be idle."""
    line = tiny_run(CELL, 1)
    assert line["correct"] is True, line["checks"]
    got = line["metrics"]
    assert got["issue_api_us.program"]["value"] > 0
    assert got["issue_group_us.program"]["value"] > 0
    assert got["issue_api_us.program"]["unit"] == "us"
    for name in ("issue_launch_us.program", "issue_scalars_us.program",
                 "idle_in_call.program", "copies_per_call.program"):
        assert name not in got


def test_an_untraced_run_runs_no_spans_window(store, monkeypatch):
    monkeypatch.setattr(spans, "measure", lambda run: pytest.fail(
        "an untraced run measured the spans window"))
    line = tiny_run(CELL, 0)
    assert set(line["metrics"]) == {"calls_per_s", "setup_s"}


def test_a_program_without_the_spans_reads_nothing(store, monkeypatch):
    """Over a program whose `obs.capture` takes no `wait` (the parent
    of the spans) the window is not run and its metrics are left out."""
    import contextlib

    from repro_torch import obs

    monkeypatch.setattr(obs, "capture", contextlib.contextmanager(
        lambda: (yield obs.get_registry())))
    line = tiny_run(CELL, 1)
    assert line["correct"] is True
    assert not set(NEW) & set(line["metrics"])
    assert "host_issue_ms.program" in line["metrics"]


def test_the_spans_window_checks_its_answers(store, monkeypatch):
    """A call that answers wrong inside the spans window makes the run
    fail, though the run's own check has passed by then."""
    from portbench.systems import vector_stream

    measure = spans.measure

    def broken(run):
        vector_stream.replace_answers(lambda out, inputs: out * 1.001,
                                      monkeypatch.setattr)
        return measure(run)
    monkeypatch.setattr(spans, "measure", broken)
    cfg, traffic = TINY[CELL]
    run = core.prepare(CELL, 7, 0.1, 1, "cpu", config_overrides=cfg,
                       traffic_overrides=traffic)
    with pytest.raises(RuntimeError, match="spans window"):
        core.execute(run, 0.0)
