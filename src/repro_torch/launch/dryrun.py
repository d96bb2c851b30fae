"""Production-mesh dry run: count every (architecture x input shape) cell
of one rank on the production meshes and record its roofline terms, the
port of `repro/launch/dryrun.py`.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k [--multipod] [--style fsdp] [--out build/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]

The reference lowers and compiles each cell's jitted step for 256 or 512
forced host devices and walks its HLO. The port runs rank 0's train
step, prefill or decode step on `meta` stand-ins of its blocks
(`launch.specs`) with a `sharding.MeshShape` of the 16 x 16 or
2 x 16 x 16 mesh standing in for the process group, under the cost
counter (`launch.cost`): nothing is allocated, no collective moves a
byte, and the counts are those of one rank of the real mesh. One JSON
per cell under `--out` (default `build/dryrun/` of the checkout), named
as the reference names them, with the reference's `arch`, `shape`,
`mesh`, `chips`, `status` and `roofline` (`Roofline.as_dict`); `count_s`
(the counting's seconds) in place of `lower_s` and `compile_s`; and
`rank_bytes` in place of `memory_analysis`: this rank's arguments,
outputs, and the peak of live storages during its call (arguments
included). A decode cell runs at pos = seq_len - 1, its whole cache
valid; `long_500k` on a config without long context writes the
reference's `skipped` record. The train cells also record the bytes
`train.step_traffic` reckons.

Where a train or prefill cell's config attends nowhere (xLSTM), every
count of its call is affine in the sequence length: the scans run a
fixed cost a token (sLSTM) or a chunk (mLSTM), and nothing is quadratic.
There the per-token loop, a Python loop of ~100 ops a token and layer,
would take minutes to count at 4096 or 32768 tokens; so the cell is
counted at AFFINE_LENGTHS, the counts checked to be exactly affine
there, and extended to the cell's length (`counted_at` in the record),
as the reference counts a scan's body once times its trip count. Where
they are not affine the cell is counted at its length. Several cells
are counted at once, a process each, as many as the host gives this
process cores; a single cell is counted in the calling process.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import math
import os
import pathlib
import time
import traceback

from ..configs import ARCH_NAMES, SHAPES, get_config
from ..configs.base import shape_cells
from ..kernels import common
from ..models import sharding as S
from ..optim import AdamW
from ..train import (make_prefill_step, make_serve_step, make_train_step,
                     step_traffic)
from . import roofline as RL
from . import specs as SP
from .cost import Cost, count, tree_bytes

# the production meshes (`repro/launch/mesh.py:28-31`): a pod of 16 x 16
# and two of them, "pod" pure DP
POD = {"data": 16, "model": 16}
MULTIPOD = {"pod": 2, "data": 16, "model": 16}
# the lengths a cell whose counts are affine in its length is counted at:
# multiples of the scans' chunk (128), from two chunks on (one chunk is a
# case of its own)
AFFINE_LENGTHS = (256, 384, 512)


def production_mesh(*, multi_pod: bool = False) -> S.MeshShape:
    return S.MeshShape(MULTIPOD if multi_pod else POD)


def _global_bytes(mesh, blocks, specs) -> float:
    """The global tensors' bytes from this rank's blocks and their specs
    (each block is 1 / (its spec's ranks) of its tensor)."""
    sizes = S.mesh_sizes(mesh)

    def ranks(spec):
        return math.prod(sizes[n] for e in spec if e
                         for n in ((e,) if isinstance(e, str) else e))

    if hasattr(blocks, "named_parameters"):
        return float(sum(tree_bytes(p) * ranks(specs[n])
                         for n, p in blocks.named_parameters()))
    if isinstance(blocks, dict):
        return float(sum(_global_bytes(mesh, blocks[k], specs[k])
                         for k in blocks))
    if isinstance(blocks, list):
        return float(sum(_global_bytes(mesh, b, s)
                         for b, s in zip(blocks, specs)))
    return float(tree_bytes(blocks) * ranks(specs))


def lower_cell(cfg, shape, mesh, *, remat=True, style="2d"):
    """(the rank's call, its arguments, model_flops, min_bytes per rank)."""
    chips = mesh.size()
    if shape.kind == "train":
        optim = AdamW()
        state, sspecs = SP.train_state_struct(cfg, mesh, optim, style=style)
        step = make_train_step(cfg, optim, remat=remat,
                               grad_specs=sspecs["params"])
        batch, bspecs = SP.train_batch_struct(cfg, mesh, shape, style=style)
        # unavoidable traffic: read + write params and moments, read batch
        state_b = (_global_bytes(mesh, state["params"], sspecs["params"])
                   + _global_bytes(mesh, state["opt"], sspecs["opt"]) + 4)
        batch_b = _global_bytes(mesh, batch, {
            "inputs": bspecs["inputs"], "labels": bspecs["labels"]})
        min_bytes = (2.0 * state_b + batch_b) / chips
        fn, args = step, (state, batch)
    elif shape.kind == "prefill":
        params, pspecs = SP.params_struct(cfg, mesh)
        inputs, ispecs = SP.prefill_input_struct(cfg, mesh, shape)
        min_bytes = (_global_bytes(mesh, params, pspecs)
                     + _global_bytes(mesh, inputs, ispecs["inputs"])) / chips
        fn = make_prefill_step(cfg, max_len=shape.seq_len)
        args = (params, inputs)
    else:  # decode
        params, pspecs = SP.params_struct(cfg, mesh)
        caches, cspecs = SP.cache_struct(cfg, mesh, shape)
        inp, _ = SP.decode_input_struct(cfg, mesh, shape)
        min_bytes = (_global_bytes(mesh, params, pspecs)
                     + _global_bytes(mesh, caches, cspecs)) / chips
        fn = make_serve_step(cfg)
        args = (params, caches, inp, shape.seq_len - 1)
    return fn, args, RL.model_flops_for(cfg, shape), min_bytes


def _numbers(counted, result) -> dict:
    cost = counted.cost
    return {"flops": cost.flops, "hbm_bytes": cost.hbm_bytes,
            "coll_bytes": cost.coll_bytes,
            "coll_detail": dict(cost.coll_detail),
            "peak": counted.peak_bytes, "outputs": tree_bytes(result),
            "kernels": dict(counted.kernels)}


def _affine(runs, lengths, target):
    """The counts at `target` from those at three lengths, where each is
    exactly affine in the length over them; else None."""
    def ext(a, b, c):
        if isinstance(a, dict):
            if not a.keys() == b.keys() == c.keys():
                return None
            out = {k: ext(a[k], b[k], c[k]) for k in a}
            return None if None in out.values() else out
        if b - a != c - b:
            return None
        step = (b - a) / (lengths[1] - lengths[0])
        return a + step * (target - lengths[0])

    return ext(*runs)


def count_cell(cfg, shape, mesh, *, style="2d"):
    """(the counts of the cell's rank call, model_flops, min_bytes, the
    arguments' bytes, the lengths it was counted at or None)."""
    fn, args, model_flops, min_bytes = lower_cell(cfg, shape, mesh,
                                                  style=style)
    arg_bytes = tree_bytes(args)
    attends = any(kind in ("attn", "attn_moe", "hybrid")
                  for kind, _ in cfg.segments)
    if not attends and shape.kind != "decode" and \
            shape.seq_len > AFFINE_LENGTHS[-1]:
        del fn, args
        runs = []
        for n in AFFINE_LENGTHS:
            f, a, _, _ = lower_cell(cfg, dataclasses.replace(shape,
                                                             seq_len=n),
                                    mesh, style=style)
            result, counted = count(f, *a)
            runs.append(_numbers(counted, result))
            del f, a, result
        got = _affine(runs, AFFINE_LENGTHS, shape.seq_len)
        if got is not None:
            return got, model_flops, min_bytes, arg_bytes, AFFINE_LENGTHS
        fn, args, _, _ = lower_cell(cfg, shape, mesh, style=style)
    result, counted = count(fn, *args)
    return _numbers(counted, result), model_flops, min_bytes, arg_bytes, \
        None


def _tag(multi_pod: bool, style: str) -> str:
    tag = "multipod" if multi_pod else "pod"
    return tag if style == "2d" else f"{tag}-{style}"


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: pathlib.Path, skip_existing: bool = True,
             style: str = "2d"):
    mesh_tag = _tag(multi_pod, style)
    out = out_dir / f"{arch}__{shape_name}__{mesh_tag}.json"
    if skip_existing and out.exists():
        print(f"[skip] {out.name}")
        return json.loads(out.read_text())
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.name == "long_500k" and not cfg.supports_long_context:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "status": "skipped",
               "reason": "full attention at 500k (DESIGN.md "
                         "§Arch-applicability)"}
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rec, indent=1))
        print(f"[skipped-by-design] {arch} x {shape_name}")
        return rec

    mesh = production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
           "chips": chips, "status": "error"}
    try:
        got, model_flops, min_bytes, arg_bytes, lengths = count_cell(
            cfg, shape, mesh, style=style)
        t_count = time.time() - t0
        cost = Cost(got["flops"], got["hbm_bytes"], got["coll_bytes"],
                    got["coll_detail"])
        roof = RL.analyze(cost, model_flops=model_flops, chips=chips,
                          min_bytes=min_bytes)
        rec.update({
            "status": "ok",
            "count_s": round(t_count, 1),
            "rank_bytes": {"arguments": arg_bytes,
                           "outputs": got["outputs"],
                           "peak": arg_bytes + got["peak"]},
            "kernel_calls": got["kernels"],
            "roofline": roof.as_dict(),
        })
        if lengths is not None:
            rec["counted_at"] = list(lengths)
        if shape.kind == "train":
            # lower_cell's optimizer, `AdamW()`, clips
            rec["step_traffic"] = step_traffic(
                cfg, mesh, style=style,
                batch=(shape.global_batch, shape.seq_len),
                clip=AdamW().grad_clip is not None)
        print(f"[ok] {arch} x {shape_name} x {mesh_tag}: "
              f"bottleneck={roof.bottleneck} "
              f"frac={roof.roofline_fraction:.3f} "
              f"(count {t_count:.0f}s)")
    except Exception as e:  # noqa: BLE001 - a failed cell is recorded
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {arch} x {shape_name} x {mesh_tag}: {rec['error']}")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    return rec


def _run(work, kw):
    arch, shape_name, multi_pod = work
    return run_cell(arch, shape_name, multi_pod=multi_pod, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_NAMES))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=str(common.build_dir() / "dryrun"))
    ap.add_argument("--style", default="2d", choices=["2d", "fsdp"])
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)

    meshes = [False, True] if args.both_meshes else [args.multipod]
    cells = []
    if args.all:
        for arch in ARCH_NAMES:
            cfg = get_config(arch)
            cells.extend((arch, sh.name) for sh in shape_cells(cfg))
            if not cfg.supports_long_context:
                cells.append((arch, "long_500k"))  # records the skip
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    n = {"ok": 0, "skipped": 0, "failed": 0}
    t0 = time.time()
    work = [(arch, sh, mp) for mp in meshes for arch, sh in cells]
    # the long counts first (train, then prefill), so that the processes
    # finish together
    order = {"train": 0, "prefill": 1}
    work.sort(key=lambda w: order.get(SHAPES[w[1]].kind, 2))
    kw = dict(out_dir=out_dir, skip_existing=not args.force,
              style=args.style)
    jobs = min(len(os.sched_getaffinity(0)), len(work))
    if jobs > 1:
        with concurrent.futures.ProcessPoolExecutor(jobs) as pool:
            recs = list(pool.map(_run, work, [kw] * len(work)))
    else:
        recs = [_run(w, kw) for w in work]
    for rec in recs:
        status = rec.get("status")
        n[status if status in ("ok", "skipped") else "failed"] += 1
    print(f"done: {n['ok']} ok, {n['skipped']} skipped, {n['failed']} "
          f"failed in {time.time() - t0:.1f} s")
    return 0 if n["failed"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
