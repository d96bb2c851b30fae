"""Port parity for the tuning layer's data half, `repro_torch.tune.config`
and `repro_torch.tune.store`, against `repro.tune`: tile configs, shape
buckets and plans, and the persistent table (atomic writes, schema
version, one retry on a read error, quarantine of a corrupt file).
Mirrors the config and store half of tests/test_tune.py; the autotuner,
its CLI and `tiles="auto"` resolution are in test_torch_tune.py.

What must agree with the reference, exactly: keys, buckets, plan
digests, clamped configs and the candidates' families and fields (their
values are the Hopper kernels' own); and the table documents
two stores write for the same calls (less the schema name, which is
each package's own). The port's store lives apart from the
reference's: its own directory (`~/.cache/repro_torch`) and environment
variable, and its own device keys.
"""
import json
import pathlib

import pytest

from repro import obs as jobs
from repro.tune import config as JC
from repro.tune import store as JS
from repro_torch import obs, tune
from repro_torch.tune import config as C
from repro_torch.tune import store as S

from _torch_obs import isolated_obs_registries  # noqa: F401 (autouse)


@pytest.fixture
def fresh_store(monkeypatch, tmp_path):
    """An isolated on-disk table; restores the process-wide store after
    the test."""
    monkeypatch.setenv(S.ENV_CACHE_DIR, str(tmp_path))
    S.reset_store()
    yield S.get_store()
    monkeypatch.delenv(S.ENV_CACHE_DIR)
    S.reset_store()


def _j(cfg):
    return JC.TileConfig(**{f: getattr(cfg, f) for f in C._FIELDS})


# ---------------------------------------------------------------------------
# TileConfig / buckets / TilePlan
# ---------------------------------------------------------------------------


def test_tile_config_key_and_json_roundtrip():
    cfg = C.TileConfig(block_m=256, block_n=512)
    assert cfg.key() == "m256.n512" == _j(cfg).key()
    assert C.TileConfig().key() == "default"
    assert C.TileConfig.from_json(cfg.to_json()) == cfg
    assert C.TileConfig.from_json({}) == C.TileConfig()
    assert cfg.to_json() == _j(cfg).to_json()


def test_tile_config_rejects_bad_values():
    with pytest.raises(ValueError):
        C.TileConfig(block_m=0)
    with pytest.raises(ValueError):
        C.TileConfig.from_json({"block_q": 128})


@pytest.mark.parametrize("dims", [(), (1,), (48,), (1000,), (1024,),
                                  (1000, 2000), (16384, 32),
                                  (16381, 16379, 29)])
def test_shape_bucket_pow2(dims):
    assert C.shape_bucket(*dims) == JC.shape_bucket(*dims)
    assert [C.bucket_dim(d) for d in dims] == \
        [JC.bucket_dim(d) for d in dims]
    assert C.bucket_dim(1000) == 1024
    assert C.shape_bucket(1000, 2000) == "1024x2048"
    assert C.shape_bucket() == "scalar"


def test_clamp_is_the_sweep_dedup_key():
    big = C.TileConfig(block_m=512, block_n=1024)
    small = C.TileConfig(block_m=128, block_n=128)
    # at a tiny problem every oversized candidate clamps to one shape
    assert C.clamp(big, (64, 64)) == C.clamp(
        C.TileConfig(block_m=1024, block_n=1024), (64, 64))
    assert C.clamp(small, (64, 64)) == C.TileConfig(block_m=64,
                                                    block_n=64)
    assert C.clamp(C.TileConfig(block_rows=512), (100,)) == \
        C.TileConfig(block_rows=100)
    for fam in ("symv", "gemv", "gemm", "l1"):
        for cfg in C.candidates_for(fam):
            for dims in ((64, 64, 64), (300,), (5000, 300, 40)):
                assert C.clamp(cfg, dims).to_json() == \
                    JC.clamp(_j(cfg), dims).to_json()


def test_candidates_equal_the_reference():
    """The families and the fields each family's candidates set are the
    reference's, so table rows keep one format; the values are the
    Hopper kernels' own (tune/config.py): each family holds its default
    knob values, and every candidate maps onto a plan its kernels take
    at a full-size shape."""
    from repro_torch.kernels import anchored, gemm, symv, window

    for fam in ("symv", "gemv", "gemm", "l1"):
        fields = {tuple(sorted(c.to_json())) for c in C.candidates_for(fam)}
        assert fields == {tuple(sorted(c.to_json()))
                          for c in JC.candidates_for(fam)}
    with pytest.raises(ValueError):
        C.candidates_for("conv")
    keys = {fam: {c.key() for c in C.candidates_for(fam)}
            for fam in ("symv", "gemv", "gemm", "l1")}
    assert f"r{window.BLOCK}" in keys["l1"]
    assert "m{}.n{}".format(*anchored.BLOCKS["gemv"][:2]) in keys["gemv"]
    assert "m512.n512" in keys["symv"]          # the n = 16384 default
    assert "m128.n32.k16384" in keys["gemm"]   # block-CG's default
    for cfg in C.candidates_for("l1"):
        window.block_of(cfg)
    for cfg in C.candidates_for("symv"):
        symv.symv_plan(16384, **symv.symv_knobs(cfg))
    for cfg in C.candidates_for("gemm"):
        gemm.gemm_plan(16384, 32, 16384, 4, 132, **gemm.gemm_knobs(cfg))


def test_tile_plan_wildcard_and_lookup():
    cfg = C.TileConfig(block_m=128, block_n=128)
    plan = C.TilePlan.everywhere(cfg)
    assert plan.get("g0", "256x256") == cfg
    assert plan.lookup("g7")(1000, 1000) == cfg
    sited = C.TilePlan.from_dict({"g0": {"256x256": cfg}})
    assert sited.get("g0", "256x256") == cfg
    assert sited.get("g0", "512x512") is None
    assert sited.get("g1", "256x256") is None
    # lookup buckets the concrete dims before matching
    assert sited.lookup("g0")(200, 200) == cfg


def test_tile_plan_key_is_content_addressed():
    cfg = C.TileConfig(block_m=128)
    a = C.TilePlan.from_dict({"g0": {"*": cfg}})
    b = C.TilePlan.from_dict({"g0": {"*": C.TileConfig(block_m=128)}})
    c = C.TilePlan.from_dict({"g0": {"*": C.TileConfig(block_m=256)}})
    assert a.key() == b.key() != c.key()
    assert C.EMPTY_PLAN.key() == "default"
    assert not C.EMPTY_PLAN and a
    # the same content digests the same in both packages
    assert a.key() == JC.TilePlan.from_dict({"g0": {"*": _j(cfg)}}).key()


def test_device_kind_names_the_port_s_rows():
    """On a host without a card the port's rows are keyed "cpu"; on a
    card, the torch device name (never a reference `tpu-*` key)."""
    import torch
    kind = C.current_device_kind()
    if torch.cuda.is_available():
        assert kind == torch.cuda.get_device_name().strip().lower(
        ).replace(" ", "-")
    else:
        assert kind == "cpu"
    assert not kind.startswith("tpu")


# ---------------------------------------------------------------------------
# The on-disk store
# ---------------------------------------------------------------------------


def test_store_lives_apart_from_the_reference(monkeypatch, tmp_path):
    monkeypatch.delenv(S.ENV_CACHE_DIR, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert S.cache_dir() == tmp_path / ".cache" / "repro_torch"
    assert S.ENV_CACHE_DIR == "REPRO_TORCH_CACHE_DIR" != JS.ENV_CACHE_DIR
    monkeypatch.setenv(JS.ENV_CACHE_DIR, str(tmp_path / "ref"))
    assert S.cache_dir() == tmp_path / ".cache" / "repro_torch"
    monkeypatch.setenv(S.ENV_CACHE_DIR, str(tmp_path / "port"))
    assert S.cache_dir() == tmp_path / "port"
    assert S.SCHEMA == "repro_torch.tune/v1"
    assert S.SCHEMA_VERSION == JS.SCHEMA_VERSION


def test_store_roundtrip_and_atomic_write(fresh_store, tmp_path):
    st = fresh_store
    cfg = C.TileConfig(block_m=256, block_n=256)
    st.record_entry("symv+dot", "256x256", "dataflow", True, True,
                    "cpu", tiles=cfg, us=10.0, default_us=15.0,
                    sweeps=3)
    st.put_artifact("a" * 64, "dataflow", True, True, "cpu",
                    spec={"name": "p"}, plan=C.TilePlan.everywhere(cfg),
                    tuned=True)
    # no tmp droppings, one well-formed table
    leftovers = [p for p in tmp_path.iterdir()
                 if p.suffix == ".tmp"]
    assert not leftovers
    reread = S.TuningTable(tmp_path / S.TABLE_FILENAME)
    assert reread.validate() == []
    assert reread.entries_for("symv+dot", "dataflow", True, True,
                              "cpu") == {"256x256": cfg}
    assert reread.artifact_plan("a" * 64, "dataflow", True, True,
                                "cpu").get("g0", "64x64") == cfg
    assert reread.artifact_spec("a" * 64, "dataflow", True, True,
                                "cpu") == {"name": "p"}


def test_store_documents_equal_the_reference(tmp_path):
    """The same calls on both stores write the same sections."""
    cfg = C.TileConfig(block_m=128, block_n=512)
    docs = []
    for mod, conf, path in ((S, C, tmp_path / "port.json"),
                            (JS, JC, tmp_path / "ref.json")):
        st = mod.TuningTable(path)
        tiles = conf.TileConfig(block_m=128, block_n=512)
        st.record_entry("gemv", "1024x1024", "nodataflow", False, False,
                        "cpu", tiles=tiles, us=3.5, default_us=4.0)
        st.put_artifact("b" * 64, "dataflow", True, True, "cpu",
                        spec={"name": "q"},
                        plan=conf.TilePlan.from_dict(
                            {"g1": {"1024x1024": tiles}}))
        docs.append(json.loads(path.read_text()))
    mine, ref = docs
    assert mine.pop("schema") == S.SCHEMA and ref.pop("schema") == JS.SCHEMA
    assert mine == ref
    assert cfg.to_json() == mine["entries"][
        "gemv|1024x1024|nodataflow|fuse=0|anchor=0|cpu"]["tiles"]


def test_store_tolerates_corrupt_and_foreign_files(tmp_path):
    path = tmp_path / S.TABLE_FILENAME
    path.write_text("{not json")
    assert S.TuningTable(path).doc["entries"] == {}
    path.write_text(json.dumps({"schema": "repro_torch.tune/v999",
                                "version": 999, "entries": {"x": {}}}))
    st = S.TuningTable(path)            # unknown version: start empty
    assert st.doc["entries"] == {}
    # and a write does not resurrect the foreign content
    st.record_entry("gemv", "64x64", "dataflow", False, False, "cpu",
                    tiles=C.TileConfig(block_m=64), us=1.0,
                    default_us=1.0)
    on_disk = json.loads(path.read_text())
    assert on_disk["version"] == S.SCHEMA_VERSION
    assert "x" not in on_disk["entries"]


def test_store_retries_one_read_error(tmp_path, monkeypatch):
    """A transient read error gets one retry; two in a row give an empty
    table and a `tune.store.read_failed` event, as in the reference."""
    path = tmp_path / S.TABLE_FILENAME
    S.TuningTable(path).record_entry(
        "gemv", "64x64", "dataflow", False, False, "cpu",
        tiles=C.TileConfig(block_m=64), us=1.0, default_us=1.0)
    real = pathlib.Path.read_bytes
    monkeypatch.setattr(S.time, "sleep", lambda s: None)
    for failures, entries in ((1, 1), (2, 0)):
        left = [failures]

        def flaky(self):
            if self == path and left[0]:
                left[0] -= 1
                raise OSError("transient")
            return real(self)

        monkeypatch.setattr(pathlib.Path, "read_bytes", flaky)
        with obs.capture() as reg:
            doc = S.TuningTable._read(path)
        assert len(doc["entries"]) == entries
        assert [r["name"] for r in reg.records] == \
            ([] if entries else ["tune.store.read_failed"])
        monkeypatch.setattr(pathlib.Path, "read_bytes", real)


@pytest.mark.parametrize("content", ["{not json", "\xff\xfe", "[1, 2"])
def test_store_quarantine_records_equal_the_reference(tmp_path, content):
    """A corrupt table is moved to <name>.corrupt with the reference's
    event and counter."""
    streams = []
    for mod, capture, name in ((S, obs.capture, "port.json"),
                               (JS, jobs.capture, "ref.json")):
        path = tmp_path / name
        path.write_bytes(content.encode("latin-1"))
        with capture() as reg:
            assert mod.TuningTable(path).doc["entries"] == {}
        assert path.with_name(name + ".corrupt").exists()
        assert not path.exists()
        streams.append([(r["kind"], r["name"]) for r in reg.records])
    assert streams[0] == streams[1] == [
        ("event", "tune.store.quarantined"),
        ("counter", "tune.store.corrupt")]


def test_put_artifact_merges_shape_buckets(fresh_store):
    """A tune at one shape bucket must not erase another bucket's
    persisted winner for the same digest."""
    st = fresh_store
    small = C.TileConfig(block_m=256, block_n=256)
    large = C.TileConfig(block_m=512, block_n=512)
    st.put_artifact("d" * 64, "dataflow", True, True, "cpu",
                    spec={"name": "p"},
                    plan=C.TilePlan.from_dict({"g0": {"256x256": small}}),
                    tuned=True)
    st.put_artifact("d" * 64, "dataflow", True, True, "cpu",
                    spec={"name": "p"},
                    plan=C.TilePlan.from_dict({"g0": {"1024x1024": large}}),
                    tuned=True)
    plan = st.artifact_plan("d" * 64, "dataflow", True, True, "cpu")
    assert plan.get("g0", "256x256") == small
    assert plan.get("g0", "1024x1024") == large


def test_artifact_lookups_count_hits_and_misses(fresh_store):
    st = fresh_store
    with obs.capture() as reg:
        assert st.artifact_plan("e" * 64, "dataflow", True, True,
                                "cpu") is None
        st.put_artifact("e" * 64, "dataflow", True, True, "cpu",
                        spec={"name": "p"}, plan=C.EMPTY_PLAN)
        assert st.artifact_plan("e" * 64, "dataflow", True, True,
                                "cpu") == C.EMPTY_PLAN
    assert reg.counters == {"tune.cache.miss": 1, "tune.cache.hit": 1}


def test_validate_doc_flags_malformed_tables():
    bad = {"schema": S.SCHEMA, "version": S.SCHEMA_VERSION,
           "entries": {"too|few|parts": {"us": 1.0}},
           "artifacts": {}}
    problems = S.validate_doc(bad)
    assert any("malformed key" in p for p in problems)
    assert any("missing 'tiles'" in p for p in problems)
    assert S.validate_doc([]) != []
    ok = {"schema": S.SCHEMA, "version": S.SCHEMA_VERSION,
          "entries": {}, "artifacts": {}}
    assert S.validate_doc(ok) == []


def test_autotuner_names_load_lazily():
    """The autotuner's names (refusals naming ROADMAP Queue 1, item 12
    until it was ported) load from `tune.autotuner` on first use."""
    from repro_torch.tune import autotuner

    for name in ("tune_program", "tune_routine", "TuneReport"):
        assert getattr(tune, name) is getattr(autotuner, name)
    with pytest.raises(AttributeError):
        tune.no_such_name
