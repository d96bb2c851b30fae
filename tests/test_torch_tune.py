"""Port parity for the autotuner half of `repro_torch.tune` against
`repro.tune`, on the CPU, over fresh stores (`REPRO_TORCH_CACHE_DIR` in
a temporary directory). Mirrors tests/test_tune.py's lowering-cache,
autotuner, cross-process and CLI cases (the config and store cases are
in test_torch_tune_store.py), and adds the knob map: each family's
`TileConfig` reaches the plan of the kernel the map names, checked with
the plan functions, which answer for shapes alone.

What must agree with the reference: the cache-entry behavior case for
case (two configs, two entries; a cold "auto" shares "default"'s entry;
a tuned table splits it), the table's row and artifact keys for the
same tune (sites `g{i}` / `g{i}:{name}`, patterns, buckets), and the
`tune.*` events' names. Times are not compared: on the CPU the tuner
times the plain versions, which the knobs do not change.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import lowering as jlowering
from repro.tune import autotuner as jautotuner
from repro.tune import store as jstore
from repro_torch import blas, obs
from repro_torch.core import lowering
from repro_torch.kernels import anchored, common, gemm, gemv, symv, window
from repro_torch.solvers import specs
from repro_torch.tune import autotuner
from repro_torch.tune import config as C
from repro_torch.tune import store as S
from repro_torch.tune.__main__ import SYMV_DOT, main as tune_cli

from _torch_caches import fresh_lowering_caches  # noqa: F401 (autouse)
from _torch_obs import isolated_obs_registries  # noqa: F401 (autouse)

N = 48
CPU = "cpu"
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


@pytest.fixture
def fresh_store(monkeypatch, tmp_path):
    """Isolated tables for both packages and cold lowering caches; the
    process-wide stores are re-read from the real environment after."""
    monkeypatch.setenv(S.ENV_CACHE_DIR, str(tmp_path / "torch"))
    monkeypatch.setenv(jstore.ENV_CACHE_DIR, str(tmp_path / "jax"))
    S.reset_store()
    jstore.reset_store()
    lowering.clear_cache()
    yield S.get_store()
    monkeypatch.undo()
    S.reset_store()
    jstore.reset_store()
    lowering.clear_cache()


def _chain(name):
    return dict(SYMV_DOT, name=name)


def _chain_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    return {"A": torch.from_numpy((a + a.T) / 2),
            "x": torch.from_numpy(rng.standard_normal(n).astype(
                np.float32))}


# ---------------------------------------------------------------------------
# Cache-key correctness: tiles in the lowering cache
# ---------------------------------------------------------------------------


def test_two_tile_configs_two_cache_entries(fresh_store):
    spec = _chain("tune_cache_key_chain")
    before = lowering.cache_stats()
    a = lowering.compile_cached(spec, device=CPU, tiles=C.TileConfig(
        block_m=128, block_n=128))
    b = lowering.compile_cached(spec, device=CPU, tiles=C.TileConfig(
        block_m=256, block_n=256))
    assert a is not b
    mid = lowering.cache_stats()
    assert mid["misses"] == before["misses"] + 2
    a2 = lowering.compile_cached(spec, device=CPU, tiles=C.TileConfig(
        block_m=128, block_n=128))
    assert a2 is a
    after = lowering.cache_stats()
    assert after["hits"] == mid["hits"] + 1
    assert after["misses"] == mid["misses"]


def test_auto_on_cold_store_shares_the_default_entry(fresh_store):
    spec = _chain("tune_cold_auto_chain")
    a = lowering.compile_cached(spec, device=CPU, tiles="auto")
    before = lowering.cache_stats()
    b = lowering.compile_cached(spec, device=CPU, tiles="default")
    after = lowering.cache_stats()
    assert b is a and not a.tile_plan
    assert after["hits"] == before["hits"] + 1
    assert after["misses"] == before["misses"]
    # the reference behaves the same on its own cold table
    ja = jlowering.compile_cached(spec, tiles="auto")
    assert jlowering.compile_cached(spec, tiles="default") is ja


def test_tuned_store_splits_the_cache_entry(fresh_store):
    spec = _chain("tune_split_chain")
    inputs = _chain_inputs(N)
    want = blas.compile(spec, device=CPU, tiles="default").run(**inputs)["q"]
    cfg = C.TileConfig(block_m=128, block_n=128)
    fresh_store.put_artifact(
        lowering.spec_digest(spec), "dataflow", True, True, "cpu",
        spec=spec,
        plan=C.TilePlan.from_dict({"g0": {C.shape_bucket(N, N): cfg}}),
        tuned=True)
    lowering.clear_cache()
    auto_ir = lowering.compile_cached(spec, device=CPU, tiles="auto")
    assert auto_ir.tile_plan
    default_ir = lowering.compile_cached(spec, device=CPU, tiles="default")
    assert auto_ir is not default_ir
    got = blas.compile(spec, device=CPU, tiles="auto").run(**inputs)["q"]
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# The autotuner end to end
# ---------------------------------------------------------------------------


def test_tune_program_persists_entries_and_artifact(fresh_store):
    spec = _chain("tune_e2e_chain")
    rep = autotuner.tune_program(spec, {"A": (N, N), "x": N}, device=CPU,
                                 budget=3, iters=1, store=fresh_store)
    assert rep.sweeps <= 3
    assert rep.baseline_us > 0 and rep.tuned_us > 0
    assert rep.tuned_us <= rep.baseline_us
    assert fresh_store.validate() == []
    entries = fresh_store.entries_for("symv+dot", "dataflow", True, True,
                                      "cpu")
    assert C.shape_bucket(N, N) in entries
    digest = lowering.spec_digest(spec)
    assert fresh_store.artifact_plan(digest, "dataflow", True, True,
                                     "cpu") is not None
    # the same rows and artifact keys as the reference's tune
    jrep = jautotuner.tune_program(spec, {"A": (N, N), "x": N}, budget=3,
                                   iters=1, store=jstore.get_store())
    assert jrep.digest == rep.digest

    def keys(doc):
        return ({k.rsplit("|", 1)[0] for k in doc["entries"]},
                {k.rsplit("|", 1)[0] for k in doc["artifacts"]})

    assert keys(fresh_store.doc) == keys(jstore.get_store().doc)


def test_tune_program_sites_match_the_reference(fresh_store):
    """Site keys, patterns, families, dims and the cost order of the
    reference's `_discover_sites`, program by program."""
    shapes = {"cg_matvec": {"A": (256, 256), "p": 256},
              "cg_update": {"x": 256, "p": 256, "r": 256, "q": 256},
              "block_cg_matvec": {"A": (256, 256), "P": (256, 8)}}
    for name, sh in shapes.items():
        raw = getattr(specs, name.upper())
        ir = lowering.lower(raw, device=CPU, tiles="default",
                            verify=False)
        jir = jlowering.lower(raw, tiles="default", verify=False)
        want = [(s.site, s.pattern, s.family, s.dims, s.bucket, s.cost)
                for s in jautotuner._discover_sites(jir, sh)]
        got = [(s.site, s.pattern, s.family, s.dims, s.bucket, s.cost)
               for s in autotuner._discover_sites(ir, sh)]
        assert got == want


def test_executable_tune_returns_recompiled_handle(fresh_store):
    spec = _chain("tune_exe_chain")
    inputs = _chain_inputs(N)
    exe = blas.compile(spec, device=CPU)
    want = exe.run(**inputs)["q"]
    tuned = exe.tune({"A": (N, N), "x": N}, budget=2, iters=1)
    assert tuned is not exe
    assert tuned.tune_report is not None
    assert tuned.tune_report.sweeps <= 2
    got = tuned.run(**inputs)["q"]
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_executable_tune_on_a_loop_tunes_its_stage_programs(fresh_store):
    exe = blas.compile(specs.CG_LOOP, device=CPU)
    tuned = exe.tune({"A": (64, 64), "b": 64, "x0": 64}, budget=1,
                     iters=1)
    names = [r.program for r in tuned.tune_report]
    assert names == ["nrm2", "residual", "cg_matvec", "cg_update",
                     "cg_pupdate"]
    assert tuned.kind == "loop" and tuned is not exe


def test_cross_process_artifact_hit_with_zero_sweeps(fresh_store):
    """A compile persists the artifact (a cold miss); a fresh store
    handle and cold lowering caches (a second process) hit it with
    `tune.cache.hit` and sweep nothing."""
    spec = _chain("tune_xproc_chain")
    with obs.capture() as reg1:
        blas.compile(spec, device=CPU)
    recs1 = list(reg1.records)
    assert any(r["name"] == "tune.cache.miss" for r in recs1)
    assert not any(r["name"] == "tune.measure" for r in recs1)
    S.reset_store()
    lowering.clear_cache()
    with obs.capture() as reg2:
        blas.compile(spec, device=CPU)
    recs2 = list(reg2.records)
    assert [r for r in recs2 if r["name"] == "tune.cache.hit"]
    assert not any(r["name"] == "tune.cache.miss" for r in recs2)
    assert not any(r["name"] == "tune.measure" for r in recs2)


def test_cross_process_hit_in_a_subprocess(fresh_store, tmp_path):
    """The same across a real process boundary: a tune here, then a
    `tiles="auto"` compile in a child process over the same table takes
    the tuned artifact with zero sweeps."""
    spec = _chain("tune_subprocess_chain")
    autotuner.tune_program(spec, {"A": (N, N), "x": N}, device=CPU,
                           budget=2, iters=1)
    child = (
        "import json, sys\n"
        "from repro_torch import blas, obs\n"
        "with obs.capture() as reg:\n"
        f"    exe = blas.compile(json.loads(sys.argv[1]), device='cpu')\n"
        "names = [r['name'] for r in reg.records]\n"
        "print(json.dumps({'hit': names.count('tune.cache.hit'),\n"
        "                  'miss': names.count('tune.cache.miss'),\n"
        "                  'measure': names.count('tune.measure')}))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", child, json.dumps(spec)],
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    counts = json.loads(out.stdout.strip().splitlines()[-1])
    assert counts == {"hit": 1, "miss": 0, "measure": 0}


def test_cold_compile_enqueues_no_sweeps(fresh_store):
    with obs.capture() as reg:
        blas.compile(_chain("tune_cold_chain"), device=CPU, tiles="auto")
    assert not any(r["name"] == "tune.measure" for r in reg.records)


def test_tune_events_match_the_reference_names(fresh_store):
    spec = _chain("tune_events_chain")
    with obs.capture() as reg:
        autotuner.tune_program(spec, {"A": (256, 256), "x": 256},
                               device=CPU, budget=1, iters=1)
    names = [r["name"] for r in reg.records if r["kind"] == "event"
             and r["name"].startswith("tune.")]
    assert names[0] == "tune.start" and names[-1] == "tune.done"
    assert set(names) <= {"tune.start", "tune.measure",
                          "tune.budget_exhausted", "tune.done"}


def test_tuner_refuses_the_plain_versions_beside_a_card(fresh_store,
                                                        monkeypatch):
    """No fallback: with a card present the tuner times the kernels, so
    a CPU tune raises instead of timing the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="never the plain versions"):
        autotuner.tune_program(_chain("tune_refuse"),
                               {"A": (N, N), "x": N}, device=CPU)


def test_candidates_over_the_budget_are_never_launched(fresh_store,
                                                       monkeypatch):
    """A candidate whose footprint is over the shared-memory budget (the
    analyzer's RV401 error) is dropped before it is timed."""
    spec = specs.CG_MATVEC
    ir = lowering.lower(spec, device=CPU, tiles="default", verify=False)
    info, = autotuner._discover_sites(ir, {"A": (4096, 4096), "p": 4096})
    assert autotuner._over_budget(ir, info, C.TileConfig(
        block_m=64, block_n=64), 4, 4096)
    assert not autotuner._over_budget(ir, info, C.TileConfig(
        block_m=16, block_n=128), 4, 4096)
    monkeypatch.setenv(common.ENV_SMEM_BUDGET, str(512))
    with obs.capture() as reg:
        rep = autotuner.tune_program(spec, {"A": (256, 256), "p": 256},
                                     device=CPU, budget=8, iters=1)
    assert rep.sweeps == 0
    assert not any(r["name"] == "tune.measure" for r in reg.records)


def test_tune_cli_smoke_validates_own_table(fresh_store, tmp_path, capsys):
    out = tmp_path / "table.json"
    rc = tune_cli(["--smoke", "--n", "64", "--routines", "gemv",
                   "--chains", "symv_dot", "--json", str(out),
                   "--device", "cpu"])
    assert rc == 0
    doc = json.loads(out.read_text())
    assert S.validate_doc(doc) == []
    assert doc["entries"]
    assert tune_cli(["--validate", str(out)]) == 0
    bad = dict(doc, entries={k: dict(v, us=10 * v["default_us"] + 1.0)
                             for k, v in doc["entries"].items()})
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    assert tune_cli(["--validate", str(tmp_path / "bad.json")]) == 1
    capsys.readouterr()


# ---------------------------------------------------------------------------
# The knob map: each family's TileConfig reaches its kernel's plan
# ---------------------------------------------------------------------------


def test_l1_block_rows_sets_the_walk_step():
    cfg = C.TileConfig(block_rows=1024)
    assert window.block_of(cfg) == 1024
    assert window.block_of(None) == window.BLOCK == 4096
    # the store-only walk: one program per block
    assert window.grid(2 ** 20, 132, False, window.block_of(cfg)) == \
        (1024, 1024)
    assert window.grid(2 ** 20, 132, False) == (256, 4096)
    with pytest.raises(ValueError):
        window.block_of(C.TileConfig(block_rows=1000))


def test_gemv_anchor_blocks_follow_block_m_and_block_n():
    assert anchored.gemv_blocks(None) == anchored.BLOCKS["gemv"]
    assert anchored.gemv_blocks(C.TileConfig(block_m=16, block_n=256)) \
        == (16, 256, anchored.BLOCKS["gemv"][2])
    # a tile of more accumulators than the registers hold is refused,
    # so the tuner drops it before launching
    with pytest.raises(ValueError, match="accumulators"):
        anchored.gemv_blocks(C.TileConfig(block_m=32, block_n=4096))


def test_gemv_band_rows_and_chunk_columns(monkeypatch):
    default = gemv.gemv_plan(21, 16384, 4, 132)
    assert default.band and default.rows == 21 and default.chunks == 64
    tuned = gemv.gemv_plan(21, 16384, 4, 132, **gemv.gemv_knobs(
        C.TileConfig(block_m=8, block_n=512)))
    assert (tuned.rows, tuned.chunks) == (7, 32)     # 3 bands, 4 tiles each
    # a config takes the band kernel where the default is one warp a row
    assert not gemv.gemv_plan(16384, 16384, 4, 132).band
    assert gemv.gemv_plan(16384, 16384, 4, 132, **gemv.gemv_knobs(
        C.TileConfig(block_m=32))).band
    # more bands than the fold's tickets with a split: refused
    with pytest.raises(ValueError, match="tickets"):
        gemv.gemv_plan(16384, 16384, 4, 132, **gemv.gemv_knobs(
            C.TileConfig(block_m=32, block_n=128)))
    # the wrapper's plan for a tensor: an H100's 132 SMs
    monkeypatch.setattr(common, "sm_count", lambda device: 132)
    a = torch.zeros((21, 16384))
    assert gemv.gemv_plan_for(a, C.TileConfig(block_m=8, block_n=512)) \
        == tuned


def test_gemvt_split_rows_set_the_cluster():
    assert gemv.gemvt_plan(16384, 16384, 4, 132).cluster == 2
    for rows, cluster in ((16384, 1), (4096, 4), (1024, 8)):
        plan = gemv.gemvt_plan(16384, 16384, 4, 132, **gemv.gemvt_knobs(
            C.TileConfig(block_m=rows, block_n=128)))
        assert plan.cluster == cluster
        assert (plan.cluster - 1) * plan.rows < 16384 <= \
            plan.cluster * plan.rows
    assert gemv.gemvt_plan(31, 2 ** 20, 4, 132, split_rows=16).cluster == 1


def test_symv_block_m_sets_the_chunk():
    assert symv.symv_plan(16384).chunk == 8              # 512 rows
    for rows, chunk in ((128, 2), (512, 8), (2048, 32)):
        assert symv.symv_plan(16384, **symv.symv_knobs(C.TileConfig(
            block_m=rows, block_n=rows))).chunk == chunk


def test_gemm_block_n_and_block_k_set_width_and_split(monkeypatch):
    default = gemm.gemm_plan(16384, 32, 16384, 4, 132)
    assert (default.bn, default.splits) == (32, 1)
    cfg = C.TileConfig(block_m=128, block_n=64, block_k=4096)
    plan = gemm.gemm_plan(16384, 32, 16384, 4, 132, **gemm.gemm_knobs(cfg))
    assert (plan.bn, plan.splits, plan.chunk) == (64, 4, 4096)
    monkeypatch.setattr(common, "sm_count", lambda device: 132)
    a, b = torch.zeros((16384, 16384)), torch.zeros((16384, 32))
    assert gemm.plan_for(a, b, cfg) == plan


@pytest.mark.parametrize("family", ["l1", "gemv", "symv", "gemm"])
def test_candidates_stay_inside_the_budget_at_full_width(family):
    """The footprint functions price every candidate of a family at or
    under sm_90's per-block budget for the kernels the family reaches,
    or the tuner drops it before launching."""
    budget = common.SM90_SMEM_PER_BLOCK
    for cfg in C.candidates_for(family):
        if family == "l1":
            window.block_of(cfg)
            prints = window.footprint(window.WindowBody(
                n_scalars=0, n_inputs=1, sums=(("x0", None),)))
        elif family == "symv":
            prints = symv.footprint(4, cfg)
        elif family == "gemm":
            prints = gemm.footprint(4, cfg)
        else:
            prints = gemv.gemv_footprint(4, cfg) + gemv.gemvt_footprint(
                4, cfg)
        assert all(fp.bytes <= budget for fp in prints), (cfg, prints)
