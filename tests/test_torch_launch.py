"""The port's launch tools against the reference's: `launch.roofline`
(`model_flops_for`, `Roofline.as_dict`), `launch.specs` (the meta
stand-ins of a rank's blocks) and `launch.dryrun` (a subprocess).

* `model_flops_for` equals `repro.launch.roofline.model_flops_for` for
  every config and every cell of `shape_cells`, and `long_500k`;
* `as_dict`'s keys are the reference's;
* the stand-ins, on a `sharding.MeshShape`, against the reference's
  `repro.launch.specs` on `_FakeMesh` (its `NamedSharding`s dropped,
  since a fake mesh makes none; the specs are the functions' second
  return): for every config, both production meshes and both styles,
  each stand-in is the block of the reference's global shape that its
  spec gives one rank, in the reference's dtype, and the specs equal;
* the dry run (`python -m repro_torch.launch.dryrun`) in a subprocess
  for llama3-8b `train_4k` on the pod mesh, mixtral-8x22b `train_4k` on
  the multipod mesh in "2d", deepseek-moe-16b `decode_32k`,
  h2o-danube-3-4b `long_500k` and llama3-8b `long_500k`, whose `skipped`
  record equals the reference's `run_cell`'s (in a JAX subprocess); the
  train cells' collective bytes equal `train.step_traffic` with the
  step's loss, clip and MoE token sums, byte for byte. About 30 s.
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import roofline as JRL
from repro.launch import specs as JSP
from repro_torch import configs as tconfigs
from repro_torch.launch import roofline as TRL
from repro_torch.launch import specs as TSP
from repro_torch.models import sharding as TS
from repro_torch.optim import AdamW
from repro_torch.train import step_traffic

from _torch_caches import fresh_lowering_caches  # noqa: F401

HERE = pathlib.Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")
ARCHS = tuple(tconfigs.ARCH_NAMES)
MESHES = {"pod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16}}
STYLES = ("2d", "fsdp")
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32,
          jnp.int32: torch.int32}


class _FakeMesh:
    """The reference's mesh stand-in: axis names and sizes."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.fixture
def jspecs(monkeypatch):
    """The reference's `launch.specs` on a fake mesh: no NamedSharding."""
    monkeypatch.setattr(JSP, "NamedSharding", lambda mesh, spec: None)
    monkeypatch.setattr(JSP, "_sds", lambda shape, dtype, sharding=None:
                        jax.ShapeDtypeStruct(shape, dtype))
    return JSP


def _shape_names():
    return sorted(tconfigs.SHAPES)


@pytest.mark.parametrize("shape", _shape_names())
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch, shape):
    got = TRL.model_flops_for(tconfigs.get_config(arch),
                              tconfigs.SHAPES[shape])
    want = JRL.model_flops_for(jconfigs.get_config(arch),
                               jconfigs.SHAPES[shape])
    assert got == want


def test_every_cell_and_long_500k_are_covered():
    names = {s.name for arch in ARCHS
             for s in tconfigs.shape_cells(tconfigs.get_config(arch))}
    assert names | {"long_500k"} == set(_shape_names())


def test_roofline_keys_match_reference():
    args = dict(flops=1e12, hbm_bytes=2e9, coll_bytes=3e8,
                coll_detail={"all-gather": 3e8}, model_flops=5e14,
                min_bytes=1e9, chips=256)
    got = TRL.Roofline(**args).as_dict()
    want = JRL.Roofline(**args).as_dict()
    assert list(got) == list(want)
    assert got["xla_cost_reference"] is None
    assert got["t_compute_s"] == 1e12 / 989e12
    assert got["t_memory_s"] == 2e9 / 3.35e12
    assert got["t_collective_s"] == 3e8 / 50e9


def _ranks(sizes, entry):
    if entry is None:
        return 1
    return math.prod(sizes[a] for a in ((entry,) if isinstance(entry, str)
                                        else entry))


def _block(sizes, shape, spec):
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return tuple(d // _ranks(sizes, e) for d, e in zip(shape, spec))


def _check(sizes, stand_in, want, spec):
    """A stand-in is the block of the reference's global struct `want`
    that `spec` gives one rank, on meta, in its dtype."""
    assert stand_in.device.type == "meta"
    assert tuple(stand_in.shape) == _block(sizes, want.shape, spec), (
        tuple(stand_in.shape), want.shape, spec)
    assert stand_in.dtype == DTYPES[want.dtype.type], (stand_in.dtype,
                                                       want.dtype)


def _segment_layer(cfg, i):
    for si, (_kind, count) in enumerate(cfg.segments):
        if i < count:
            return si, i
        i -= count
    raise IndexError(i)


def _ref_leaf(cfg, tree, name):
    """The reference's leaf of a port parameter name: a block's is its
    segment's stacked leaf with the layer dimension dropped."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return tree[name], False
    si, _ = _segment_layer(cfg, int(parts[1]))
    return tree["segments"][si][parts[-1]], True


def _check_params(cfg, sizes, model, structs, want_specs, got_specs):
    for name, p in model.named_parameters():
        leaf, stacked = _ref_leaf(cfg, structs, name)
        spec, _ = _ref_leaf(cfg, want_specs, name)
        spec = tuple(spec)
        if stacked:
            assert spec[0] is None
            spec = spec[1:]
            leaf = jax.ShapeDtypeStruct(leaf.shape[1:], leaf.dtype)
        assert got_specs[name] == spec, (name, got_specs[name], spec)
        _check(sizes, p, leaf, spec)


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_stand_ins_match_reference(jspecs, arch, mesh, style):
    sizes = MESHES[mesh]
    cfg = tconfigs.get_config(arch)
    jcfg = jconfigs.get_config(arch)
    from repro.optim import AdamW as JAdamW
    want, wspecs = jspecs.train_state_struct(jcfg, _FakeMesh(sizes),
                                             JAdamW(), style=style)
    got, gspecs = TSP.train_state_struct(cfg, TS.MeshShape(sizes), AdamW(),
                                         style=style)
    model = got["params"]
    _check_params(cfg, sizes, model, want["params"], wspecs["params"],
                  gspecs["params"])
    for key in ("m", "v"):
        assert gspecs["opt"][key] == gspecs["params"]
        for name, p in model.named_parameters():
            leaf, stacked = _ref_leaf(cfg, want["opt"][key], name)
            t = got["opt"][key][name]
            assert t.dtype == torch.float32 == DTYPES[leaf.dtype.type]
            assert t.shape == p.shape and t.device.type == "meta"
    assert got["step"] == 0 and tuple(wspecs["step"]) == gspecs["step"]
    # params_struct is the same placement in "2d"
    if style == "2d":
        p2, s2 = TSP.params_struct(cfg, TS.MeshShape(sizes))
        assert s2 == gspecs["params"]


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_batch_stand_ins_match_reference(jspecs, arch, mesh, style):
    sizes = MESHES[mesh]
    shape = tconfigs.SHAPES["train_4k"]
    want, wspecs = jspecs.train_batch_struct(
        jconfigs.get_config(arch), _FakeMesh(sizes),
        jconfigs.SHAPES["train_4k"], style=style)
    if shape.global_batch % _ranks(sizes, tuple(wspecs["inputs"])[0]):
        # "fsdp" on 2 x 16 x 16: 256 rows over 512 ranks, which the
        # reference's jit refuses too at lowering (dimension 0 not
        # divisible); a rank's block cannot hold half a row
        with pytest.raises(ValueError, match="does not split"):
            TSP.train_batch_struct(tconfigs.get_config(arch),
                                   TS.MeshShape(sizes), shape, style=style)
        return
    got, gspecs = TSP.train_batch_struct(tconfigs.get_config(arch),
                                         TS.MeshShape(sizes), shape,
                                         style=style)
    for key in ("inputs", "labels"):
        assert gspecs[key] == tuple(wspecs[key])
        _check(sizes, got[key], want[key], gspecs[key])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_stand_ins_match_reference(jspecs, arch, mesh):
    sizes = MESHES[mesh]
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    fake, shape_mesh = _FakeMesh(sizes), TS.MeshShape(sizes)
    for name in ("decode_32k", "long_500k"):
        tshape, jshape = tconfigs.SHAPES[name], jconfigs.SHAPES[name]
        want, wspecs = jspecs.cache_struct(jcfg, fake, jshape)
        got, gspecs = TSP.cache_struct(cfg, shape_mesh, tshape)
        assert len(got) == len(want) == len(gspecs)
        for seg, wseg, gs, ws in zip(got, want, gspecs, wspecs):
            assert set(seg) == set(wseg)
            for n, t in seg.items():
                assert gs[n] == tuple(ws[n]), (n, gs[n], ws[n])
                _check(sizes, t, wseg[n], gs[n])
        want, wspec = jspecs.decode_input_struct(jcfg, fake, jshape)
        got, gspec = TSP.decode_input_struct(cfg, shape_mesh, tshape)
        assert gspec == tuple(wspec)
        _check(sizes, got, want, gspec)
    for name in ("prefill_32k", "long_500k"):
        tshape, jshape = tconfigs.SHAPES[name], jconfigs.SHAPES[name]
        want, wspecs = jspecs.prefill_input_struct(jcfg, fake, jshape)
        got, gspecs = TSP.prefill_input_struct(cfg, shape_mesh, tshape)
        assert gspecs == {k: tuple(v) for k, v in wspecs.items()}
        _check(sizes, got, want, gspecs["inputs"])


# ---------------------------------------------------------------------------
# The dry run, in subprocesses
# ---------------------------------------------------------------------------

CELLS = (("llama3-8b", "train_4k", False),
         ("mixtral-8x22b", "train_4k", True),
         ("deepseek-moe-16b", "decode_32k", False),
         ("h2o-danube-3-4b", "long_500k", False),
         ("llama3-8b", "long_500k", False))
_DRIVER = """
import sys
from repro_torch.launch import dryrun
out = sys.argv[1]
rc = 0
for arch, shape, multi in {cells!r}:
    rc |= dryrun.main(["--arch", arch, "--shape", shape, "--out", out,
                       "--force"] + (["--multipod"] if multi else []))
sys.exit(rc)
"""
_REFERENCE = """
import json, pathlib, sys
from repro.launch.dryrun import run_cell
rec = run_cell("llama3-8b", "long_500k", multi_pod=False,
               out_dir=pathlib.Path(sys.argv[1]), skip_existing=False)
print(json.dumps(rec))
"""


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE,
                            str(tmp / "ref")], env=env, text=True,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    port = subprocess.run([sys.executable, "-c",
                           _DRIVER.format(cells=CELLS), str(tmp / "port")],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    out, err = ref.communicate(timeout=600)
    assert port.returncode == 0, port.stdout + port.stderr
    assert ref.returncode == 0, err
    recs = {}
    for arch, shape, multi in CELLS:
        tag = "multipod" if multi else "pod"
        path = tmp / "port" / f"{arch}__{shape}__{tag}.json"
        recs[(arch, shape)] = json.loads(path.read_text())
    recs["reference"] = json.loads(out.strip().splitlines()[-1])
    recs["stdout"] = port.stdout
    return recs


@pytest.mark.parametrize("cell", CELLS[:4], ids=lambda c: "-".join(
    map(str, c)))
def test_dryrun_cell_is_counted(dryrun, cell):
    arch, shape, multi = cell
    rec = dryrun[(arch, shape)]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == ("multipod" if multi else "pod")
    assert rec["chips"] == (512 if multi else 256)
    roof = rec["roofline"]
    assert list(roof) == list(TRL.Roofline(1, 1, 1, {}, 1, 1, 1).as_dict())
    assert roof["flops_per_device"] > 0 and roof["hbm_bytes_per_device"] > 0
    assert roof["model_flops"] == TRL.model_flops_for(
        tconfigs.get_config(arch), tconfigs.SHAPES[shape])
    assert 0 < roof["roofline_fraction"] <= 1
    assert roof["xla_cost_reference"] is None
    b = rec["rank_bytes"]
    assert b["arguments"] > 0 and b["peak"] >= b["arguments"]
    assert rec["count_s"] >= 0


def test_dryrun_attention_kernels_per_layer(dryrun):
    # a decode step: one decode_attention a layer over the cache's block;
    # train under remat: each layer's mha forward twice
    assert dryrun[("deepseek-moe-16b", "decode_32k")]["kernel_calls"] == {
        "decode_attention": 28}
    assert dryrun[("llama3-8b", "train_4k")]["kernel_calls"] == {"mha": 64}
    assert dryrun[("mixtral-8x22b", "train_4k")]["kernel_calls"] == {
        "mha": 112}


@pytest.mark.parametrize("arch,multi", [("llama3-8b", False),
                                        ("mixtral-8x22b", True)])
def test_dryrun_train_collectives_equal_step_traffic(dryrun, arch, multi):
    rec = dryrun[(arch, "train_4k")]
    shape = tconfigs.SHAPES["train_4k"]
    want = step_traffic(tconfigs.get_config(arch),
                        TS.MeshShape(MESHES["multipod" if multi else "pod"]),
                        style="2d", batch=(shape.global_batch,
                                           shape.seq_len))
    assert rec["roofline"]["collective_bytes_per_device"] == sum(
        want.values())
    assert rec["step_traffic"] == want
    detail = rec["roofline"]["collective_detail"]
    assert set(detail) <= {"all-gather", "all-reduce", "reduce-scatter"}


def test_long_500k_skip_equals_the_reference(dryrun):
    assert dryrun[("llama3-8b", "long_500k")] == dryrun["reference"]
    assert "[skipped-by-design] llama3-8b x long_500k" in dryrun["stdout"]


def test_long_500k_runs_on_a_long_context_config(dryrun):
    rec = dryrun[("h2o-danube-3-4b", "long_500k")]
    assert rec["status"] == "ok"
    # the window-4096 ring split over "model": 256 valid slots a rank
    assert rec["kernel_calls"] == {"decode_attention": 24}
