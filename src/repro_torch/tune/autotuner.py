"""The tile autotuner: sweep, measure, persist.

`tune_program` lowers one dataflow spec per candidate `TilePlan`, times
whole program calls over synthetic operands, and keeps a candidate only
when it beats the incumbent by a noise margin (IMPROVEMENT_MARGIN).
Winners land in the persistent store twice over, as in the reference:

* as **entries** keyed by (pattern, shape bucket, mode, fuse, anchor,
  device kind), so any other spec holding the same routine or fused
  group picks the configs up through `tiles="auto"`;
* as the spec's **artifact** (digest-keyed spec JSON and resolved
  plan), so recompiling this program, in this or a later process,
  resolves with one table lookup.

Timing. On the card: the whole program call between two CUDA events,
after one warm-up call that builds whatever a new plan needs (a Triton
constexpr variant, a CUDA launch plan); the minimum over `iters` calls,
each followed by a synchronize. A candidate that fails to launch raises:
nothing is skipped and nothing falls back to the plain versions. On the
CPU: the wall clock of the plain versions, which the knobs do not
change, so ties keep the defaults; the table is keyed on the device
kind, so CPU rows never serve the card.

Candidates (`config.candidates_for`) are clamped to the operand dims
(`config.clamp`, the reference's dedupe), then to the plan the site's
kernel takes (`_plan_key`): a candidate whose plan equals one already
timed (the default's included) is not timed again, one that the kernel
refuses is dropped, and so is one whose footprint is over the
shared-memory budget (`verify.passes.worst_footprint`, the static
analyzer's RV401). Sites are swept coordinate-descent style, the
largest modeled cost first, so a `budget` cap spends measurements where
they matter.
"""
from __future__ import annotations

import dataclasses
import time
import types
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core import lowering

from . import config as C
from . import store as S

DEFAULT_BUDGET = 32
DEFAULT_ITERS = 3
# a candidate must beat the incumbent by this factor to dethrone it:
# timings are noisy (kernels move by up to 3% between calls on the card)
# and ties should keep defaults
IMPROVEMENT_MARGIN = 0.97
# the SM count the plan functions dedupe with when no card is present
# (an H100 SXM's)
HOST_SMS = 132


@dataclasses.dataclass(frozen=True)
class SiteInfo:
    site: str               # plan site key ("g0" / "g1:mv")
    pattern: str            # store pattern ("symv+dot" / "gemv")
    family: str             # candidate family ("symv"/"gemv"/"gemm"/"l1")
    dims: Tuple[int, ...]   # operand dims for bucketing/clamping
    bucket: str
    cost: int               # modeled flops, for sweep ordering
    kernel: str = ""        # the anchor's or routine's blas name


@dataclasses.dataclass
class Measurement:
    site: str
    tiles: str              # TileConfig.key()
    us: float


@dataclasses.dataclass
class TuneReport:
    program: str
    digest: str
    mode: str
    fuse: bool
    anchor: bool
    device_kind: str
    baseline_us: float
    tuned_us: float
    sweeps: int
    winners: Dict[str, C.TileConfig]
    measurements: List[Measurement]

    @property
    def speedup(self) -> float:
        return self.baseline_us / max(self.tuned_us, 1e-9)

    def __str__(self):
        lines = [f"tune report: {self.program!r} mode={self.mode} "
                 f"device={self.device_kind} ({self.sweeps} sweeps)"]
        lines.append(f"  default {self.baseline_us:10.1f} us")
        lines.append(f"  tuned   {self.tuned_us:10.1f} us  "
                     f"({self.speedup:.2f}x)")
        for site, cfg in sorted(self.winners.items()):
            lines.append(f"  {site:<12} -> {cfg.key()}")
        if not self.winners:
            lines.append("  (defaults win everywhere)")
        return "\n".join(lines)


def _squarish(rdef) -> bool:
    from repro_torch.core import routines as R
    return any(k == R.MAT for k in rdef.inputs.values())


def _site_family(rspec) -> str:
    rdef = rspec.rdef
    if rdef.level == 1 or not _squarish(rdef):
        return "l1"
    if rspec.blas == "gemm":
        return "gemm"
    if rspec.blas == "symv":
        return "symv"
    return "gemv"


def _input_shapes(ir, shapes: Mapping) -> Dict[tuple, Tuple[int, ...]]:
    """(routine, port) -> shape for every non-scalar public input."""
    out = {}
    for pi in ir.io.inputs:
        if pi.kind == "scalar":
            continue
        if pi.name not in shapes:
            raise ValueError(
                f"tune: missing shape for program input {pi.name!r} "
                f"(a {pi.kind})")
        sh = shapes[pi.name]
        out[(pi.routine, pi.port)] = \
            (int(sh),) if isinstance(sh, int) else tuple(
                int(d) for d in sh)
    return out


def _discover_sites(ir, shapes: Mapping) -> List[SiteInfo]:
    """One sweepable site per fused group / standalone routine, with
    the dims the candidates are clamped and bucketed against (the
    reference's keys and cost ordering)."""
    from repro_torch.core import routines as R
    port_shapes = _input_shapes(ir, shapes)
    vec_lens = [sh[0] for sh in port_shapes.values() if len(sh) == 1]
    fallback_n = max(vec_lens) if vec_lens else 128

    def matrix_dims(name):
        rspec = ir.graph.nodes[name]
        for port, kind in rspec.rdef.inputs.items():
            if kind == R.MAT and (name, port) in port_shapes:
                return port_shapes[(name, port)]
        return None

    def cost_of(names):
        total = 0
        for name in names:
            rdef = ir.graph.nodes[name].rdef
            if rdef.cost is None:
                continue
            sh = {}
            for port in rdef.inputs:
                sh[port] = port_shapes.get(
                    (name, port),
                    matrix_dims(name) or (fallback_n,))
            try:
                fl, _ = rdef.cost(sh)
                total += int(fl)
            except Exception:
                continue
        return total

    def gemm_dims(name):
        """(m, n, k) for a gemm site (A.m, B.n, A.k), the lookup the
        tiled callable and the standalone dispatch make at call time."""
        ports = ir.graph.nodes[name].rdef.anchor_ports or {}
        a = port_shapes.get((name, ports.get("mat", "A")))
        b = port_shapes.get((name, ports.get("cols", "B")))
        m = a[0] if a else fallback_n
        k = a[1] if a is not None and len(a) > 1 else m
        n = b[1] if b is not None and len(b) > 1 else k
        return (m, n, k)

    sites = []
    for gi, g in enumerate(ir.groups or ()):
        if g.fused and len(g.nodes) >= 2:
            pattern = "+".join(ir.graph.nodes[n].blas for n in g.nodes)
            if g.anchor:
                family = _site_family(ir.graph.nodes[g.anchor])
                if family == "gemm":
                    dims = gemm_dims(g.anchor)
                else:
                    dims = matrix_dims(g.anchor) or (fallback_n,
                                                     fallback_n)
                kernel = ir.graph.nodes[g.anchor].blas
            else:
                dims, family, kernel = (fallback_n,), "l1", "group"
            sites.append(SiteInfo(
                site=f"g{gi}", pattern=pattern, family=family,
                dims=dims, bucket=C.shape_bucket(*dims),
                cost=cost_of(g.nodes), kernel=kernel))
            continue
        for name in g.nodes:
            rspec = ir.graph.nodes[name]
            if rspec.rdef.kernel is None:
                continue                    # reference-only routine
            family = _site_family(rspec)
            if family == "l1":
                dims = (fallback_n,)
            elif rspec.blas == "gemm":
                dims = gemm_dims(name)
            else:
                dims = matrix_dims(name) or (fallback_n, fallback_n)
            sites.append(SiteInfo(
                site=f"g{gi}:{name}", pattern=rspec.blas,
                family=family, dims=dims,
                bucket=C.shape_bucket(*dims), cost=cost_of([name]),
                kernel=rspec.blas))
    sites.sort(key=lambda s: -s.cost)
    return sites


def _plan_key(info: SiteInfo, cfg: Optional[C.TileConfig], itemsize: int,
              sms: int):
    """The plan the site's kernel takes under `cfg` at the site's dims,
    as a hashable value (what the sweep dedupes on); raises ValueError
    where the kernel refuses the config."""
    from repro_torch.kernels import anchored, gemm, gemv, symv, window

    dims = info.dims
    if info.family == "l1":
        return ("l1", window.block_of(cfg))
    if info.kernel == "gemm":
        m, n, k = dims
        return gemm.gemm_plan(m, n, k, itemsize, sms,
                              **gemm.gemm_knobs(cfg),
                              route=gemm.shape_route(k, n, itemsize))
    if info.kernel == "symv":
        return symv.symv_plan(dims[0], **symv.symv_knobs(cfg))
    if info.kernel == "gemvt":
        return gemv.gemvt_plan(dims[0], dims[1], itemsize, sms,
                               **gemv.gemvt_knobs(cfg))
    if ":" in info.site:              # a standalone gemv
        return gemv.gemv_plan(dims[0], dims[1], itemsize, sms,
                              **gemv.gemv_knobs(cfg))
    return ("anchored", anchored.gemv_blocks(cfg))


def _over_budget(ir, info: SiteInfo, cfg, itemsize: int,
                 budget: int) -> bool:
    """True where a kernel of the site would ask for more shared memory
    per thread block than `budget` under `cfg` (the analyzer's RV401
    error)."""
    from repro_torch.verify import passes

    gi = int(info.site[1:].split(":")[0])
    group = ir.groups[gi]
    if ":" in info.site:                # one standalone member
        group = types.SimpleNamespace(
            nodes=[info.site.split(":", 1)[1]], fused=False, anchor=None)
    prints = passes.group_footprint(ir.graph, group, itemsize, cfg)
    return passes.worst_footprint(prints, budget)[0] == "error"


def _synthesize(ir, shapes: Mapping):
    from repro_torch.core.runtime import Program
    prog = Program.from_ir(ir)
    sizes = {}
    for pi in ir.io.inputs:
        if pi.kind == "scalar":
            sizes[pi.name] = ()
        else:
            sh = shapes[pi.name]
            sizes[pi.name] = (sh,) if isinstance(sh, int) else tuple(sh)
    return prog.synthetic_inputs(sizes)


def time_call(fn, inputs, iters: int, device: torch.device) -> float:
    """Minimum time (us) of `fn(dict(inputs))` over `iters` calls after
    one warm-up call: CUDA events on the card, the wall clock on the
    CPU. The minimum, not the mean: noise only ever adds time."""
    out = fn(dict(inputs))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        best = float("inf")
        for _ in range(max(1, iters)):
            start.record()
            fn(dict(inputs))
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e3)
        return best
    del out
    best = float("inf")
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        fn(dict(inputs))
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def tune_program(raw, shapes: Mapping, *, mode: str = "dataflow",
                 fuse: Optional[bool] = None,
                 anchor: Optional[bool] = None, device=None,
                 budget: Optional[int] = None,
                 iters: int = DEFAULT_ITERS,
                 store: Optional[S.TuningTable] = None,
                 persist: bool = True) -> TuneReport:
    """Sweep tile candidates for every site of one dataflow spec and
    persist the winners (entries + digest-keyed artifact). `budget`
    caps the number of timed candidate measurements (the baseline's
    timing is free); `persist=False` runs a dry sweep. `device`
    defaults to the card; the plain versions are timed only where the
    caller asks for the CPU on a host with no card."""
    from repro_torch.kernels import common

    raw = lowering._canonical_raw(raw)
    digest = lowering.spec_digest(raw)
    if fuse is None:
        fuse = mode == "dataflow"
    if anchor is None:
        anchor = fuse
    device = common.resolve_device(device)
    if device.type == "cpu" and torch.cuda.is_available():
        raise ValueError(
            "tune: a card is present; the tuner times the kernels on it, "
            "never the plain versions (pass device='cuda' or None)")
    budget = DEFAULT_BUDGET if budget is None else int(budget)
    store = store if store is not None else S.get_store()
    dk = lowering._device_kind(device)
    sms = common.sm_count(device) if device.type == "cuda" else HOST_SMS
    limit = common.smem_budget()

    def lower_with(plan):
        # candidate sweeps re-lower an already-verified spec; the
        # analyzer does not run again per plan
        return lowering.lower(raw, mode=mode, fuse=fuse, anchor=anchor,
                              device=device, tiles=plan, verify=False)

    ir0 = lower_with(C.EMPTY_PLAN)
    itemsize = ir0.spec.dtype.itemsize
    inputs = _synthesize(ir0, shapes)
    sites = _discover_sites(ir0, shapes)
    baseline_us = time_call(ir0.fn, inputs, iters, device)
    obs.event("tune.start", program=ir0.spec.name, digest=digest[:12],
              mode=mode, device=dk, sites=len(sites),
              baseline_us=baseline_us)

    plan_sites: Dict[str, Dict[str, C.TileConfig]] = {}
    winners: Dict[str, C.TileConfig] = {}
    measurements: List[Measurement] = []
    site_best: Dict[str, float] = {}
    sweeps = 0
    current_us = baseline_us

    for info in sites:
        seen = {C.clamp(C.TileConfig(), info.dims).key()}
        plans = {repr(_plan_key(info, None, itemsize, sms))}
        best_us, best_cfg = current_us, None
        for cand in C.candidates_for(info.family):
            eff = C.clamp(cand, info.dims)
            if eff.key() in seen:
                continue                 # clamps to an already-timed shape
            seen.add(eff.key())
            try:
                plan = repr(_plan_key(info, cand, itemsize, sms))
            except ValueError:
                continue                 # the kernel refuses the config
            if plan in plans:
                continue                 # the same kernel plan, timed
            plans.add(plan)
            if _over_budget(ir0, info, cand, itemsize, limit):
                continue                 # over the RV401 limit
            if sweeps >= budget:
                break
            trial = dict(plan_sites)
            trial[info.site] = {info.bucket: cand}
            ir = lower_with(C.TilePlan.from_dict(trial))
            us = time_call(ir.fn, inputs, iters, device)
            sweeps += 1
            measurements.append(Measurement(info.site, cand.key(), us))
            obs.event("tune.measure", site=info.site, tiles=cand.key(),
                      us=us, baseline_us=current_us)
            if us < best_us:
                best_us, best_cfg = us, cand
        if best_cfg is not None and \
                best_us < current_us * IMPROVEMENT_MARGIN:
            plan_sites[info.site] = {info.bucket: best_cfg}
            winners[info.site] = best_cfg
            site_best[info.site] = best_us
            current_us = best_us
        if sweeps >= budget and info is not sites[-1]:
            obs.event("tune.budget_exhausted", budget=budget,
                      remaining_sites=[
                          s.site for s in sites[sites.index(info) + 1:]])
            break

    final_plan = C.TilePlan.from_dict(plan_sites)
    tuned_us = current_us

    if persist:
        for info in sites:
            cfg = winners.get(info.site)
            store.record_entry(
                info.pattern, info.bucket, mode, fuse, anchor, dk,
                tiles=cfg if cfg is not None
                else C.clamp(C.TileConfig(), info.dims),
                us=site_best.get(info.site, baseline_us),
                default_us=baseline_us, sweeps=sweeps)
        store.put_artifact(digest, mode, fuse, anchor, dk, spec=raw,
                           plan=final_plan, tuned=True)

    obs.event("tune.done", program=ir0.spec.name, digest=digest[:12],
              sweeps=sweeps, baseline_us=baseline_us,
              tuned_us=tuned_us, winners={s: c.key()
                                          for s, c in winners.items()})
    return TuneReport(
        program=ir0.spec.name, digest=digest, mode=mode, fuse=fuse,
        anchor=anchor, device_kind=dk, baseline_us=baseline_us,
        tuned_us=tuned_us, sweeps=sweeps, winners=winners,
        measurements=measurements)


def tune_routine(name: str, n: int = 256, *, mode: str = "dataflow",
                 **kw) -> TuneReport:
    """Tune one registry routine as a single-routine program at size
    n (matrices are (n, n)). The winning tiles land under the routine
    name's pattern, so every program containing that routine benefits."""
    from repro_torch.blas.functional import routine_spec
    from repro_torch.core import routines as R
    spec = routine_spec(name)
    rdef = R.get(name)
    shapes = {}
    for port, kind in rdef.inputs.items():
        if kind == R.MAT:
            shapes[port] = (n, n)
        elif kind == R.VEC:
            shapes[port] = (n,)
    return tune_program(spec, shapes, mode=mode, **kw)
