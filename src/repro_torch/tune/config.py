"""Tile configurations, shape buckets, and sweep candidate sets.

The port's own copy of the reference package's tuning vocabulary. A
`TileConfig` names block-shape knobs (`block_m`/`block_n` for level-2
windows, `block_k` for gemm's contraction axis, `block_rows` for the
level-1 window walk). A `TilePlan` maps emission *sites* (fusion-group
index, or `g{i}:{routine}` for standalone nodes) and *shape buckets*
to configs. Which of the port's kernel plans (`gemv_plan`,
`gemm_plan`, ...) each knob drives, and the autotuner that fills a
plan, are ROADMAP Queue 1, item 12: until then the port's lowering
runs its kernels' default plans, and this module and `tune.store` are
the persistent table's data layer.

Buckets are next-power-of-two per dimension ("1024" for vectors,
"1024x2048" for matrices): tuning at one size serves every size that
rounds to the same bucket.

Everything here is stdlib except `current_device_kind()`, which
imports torch at call time.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Mapping, Optional, Tuple

_FIELDS = ("block_m", "block_n", "block_k", "block_rows")


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One block-shape choice. Unset fields mean "keep the kernel's
    default" — kernels clamp blocks to the actual dims, so a config
    tuned at one bucket stays valid (if not optimal) at another."""
    block_m: Optional[int] = None
    block_n: Optional[int] = None
    block_k: Optional[int] = None
    block_rows: Optional[int] = None

    def __post_init__(self):
        for f in _FIELDS:
            v = getattr(self, f)
            if v is not None and (not isinstance(v, int) or v < 1):
                raise ValueError(
                    f"TileConfig.{f} must be a positive int or None, "
                    f"got {v!r}")

    def key(self) -> str:
        parts = [f"{f.split('_')[1][0]}{getattr(self, f)}"
                 for f in _FIELDS if getattr(self, f) is not None]
        return ".".join(parts) if parts else "default"

    def to_json(self) -> dict:
        return {f: getattr(self, f) for f in _FIELDS
                if getattr(self, f) is not None}

    @classmethod
    def from_json(cls, d: Mapping) -> "TileConfig":
        unknown = sorted(set(d) - set(_FIELDS))
        if unknown:
            raise ValueError(f"unknown TileConfig fields {unknown}")
        return cls(**{f: int(v) for f, v in d.items() if v is not None})


def bucket_dim(d: int) -> int:
    """Round one dimension up to the next power of two (min 1)."""
    d = int(d)
    return 1 if d <= 1 else 1 << (d - 1).bit_length()


def shape_bucket(*dims: int) -> str:
    """Pow2 bucket string for a shape: shape_bucket(1000, 2000) ->
    '1024x2048'."""
    if not dims:
        return "scalar"
    return "x".join(str(bucket_dim(d)) for d in dims)


# ---------------------------------------------------------------------------
# TilePlan: per-site, per-bucket configs
# ---------------------------------------------------------------------------

WILDCARD = "*"


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Canonical, hashable {site: {bucket: TileConfig}} mapping. The
    lowering cache keys on `key()`, so two plans with the same content
    share one compiled program."""
    sites: Tuple[Tuple[str, Tuple[Tuple[str, TileConfig], ...]], ...] = ()

    @classmethod
    def from_dict(cls, d: Mapping) -> "TilePlan":
        sites = []
        for site in sorted(d):
            buckets = d[site]
            if isinstance(buckets, TileConfig):
                buckets = {WILDCARD: buckets}
            sites.append((site, tuple(
                (b, cfg) for b, cfg in sorted(buckets.items()))))
        return cls(sites=tuple(sites))

    @classmethod
    def everywhere(cls, cfg: TileConfig) -> "TilePlan":
        """A plan applying one config at every site and bucket — what
        an explicit `tiles=TileConfig(...)` request lowers to."""
        return cls.from_dict({WILDCARD: {WILDCARD: cfg}})

    def to_dict(self) -> dict:
        return {site: {b: cfg.to_json() for b, cfg in buckets}
                for site, buckets in self.sites}

    @classmethod
    def from_json(cls, d: Mapping) -> "TilePlan":
        return cls.from_dict({
            site: {b: TileConfig.from_json(cfg)
                   for b, cfg in buckets.items()}
            for site, buckets in d.items()})

    def __bool__(self):
        return bool(self.sites)

    def key(self) -> str:
        if not self.sites:
            return "default"
        canon = json.dumps(self.to_dict(), sort_keys=True,
                           separators=(",", ":"))
        return hashlib.sha256(canon.encode()).hexdigest()[:16]

    def get(self, site: str, bucket: str) -> Optional[TileConfig]:
        """Most-specific match: exact site/bucket, then the wildcard
        fallbacks an `everywhere` plan or a coarse table provides."""
        as_map = dict(self.sites)
        for s in (site, WILDCARD):
            buckets = as_map.get(s)
            if buckets is None:
                continue
            bmap = dict(buckets)
            for b in (bucket, WILDCARD):
                cfg = bmap.get(b)
                if cfg is not None:
                    return cfg
        return None

    def lookup(self, site: str):
        """A call-time resolver for one emission site: fn(*dims) ->
        TileConfig | None, bucketing the actual operand dims."""
        def resolve(*dims):
            return self.get(site, shape_bucket(*dims))
        return resolve


EMPTY_PLAN = TilePlan()


# ---------------------------------------------------------------------------
# Sweep candidates
# ---------------------------------------------------------------------------

# Per site family. Effective blocks are clamped to the operand dims at
# call time, so the sweep dedupes candidates by their clamped values —
# at n=128 the whole level-2 set collapses to one or two measurements.
_L2_SQUARE = (128, 256, 512, 1024)                       # symv (bm==bn)
_L2_RECT = ((128, 256), (128, 512), (256, 256), (256, 512),
            (256, 1024), (512, 512), (512, 1024), (1024, 1024))
_L3_BLOCKS = ((128, 128, 256), (256, 256, 256), (256, 256, 512),
              (512, 512, 256))
_L1_ROWS = (128, 256, 512, 1024)


def candidates_for(family: str) -> Tuple[TileConfig, ...]:
    """Sweep candidates for one site family: 'symv' (square level-2
    windows), 'gemv' (rectangular), 'gemm' (adds block_k), 'l1'
    (block_rows window walks)."""
    if family == "symv":
        return tuple(TileConfig(block_m=b, block_n=b)
                     for b in _L2_SQUARE)
    if family == "gemv":
        return tuple(TileConfig(block_m=m, block_n=n)
                     for m, n in _L2_RECT)
    if family == "gemm":
        return tuple(TileConfig(block_m=m, block_n=n, block_k=k)
                     for m, n, k in _L3_BLOCKS)
    if family == "l1":
        return tuple(TileConfig(block_rows=r) for r in _L1_ROWS)
    raise ValueError(f"unknown candidate family {family!r}")


def clamp(cfg: TileConfig, dims: Tuple[int, ...]) -> TileConfig:
    """The effective config after the kernels' min(block, dim) clamp —
    the sweep's dedup key. `dims` is (m, n[, k]) for level-2/3 sites,
    (n,) for level-1."""
    def c(v, d):
        return None if v is None else min(v, max(int(d), 1))
    if cfg.block_rows is not None:
        return TileConfig(block_rows=c(cfg.block_rows, dims[0]))
    m = dims[0]
    n = dims[1] if len(dims) > 1 else dims[0]
    k = dims[2] if len(dims) > 2 else None
    return TileConfig(
        block_m=c(cfg.block_m, m), block_n=c(cfg.block_n, n),
        block_k=None if cfg.block_k is None or k is None
        else c(cfg.block_k, k))


def current_device_kind() -> str:
    """The tuning-table device key: "cpu" on a host without a CUDA
    card, else the card's torch device name normalized
    ("nvidia-h100-80gb-hbm3"), so the port's rows never collide with
    the reference's `cpu` / `tpu-*` rows."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    kind = torch.cuda.get_device_name(torch.cuda.current_device())
    return str(kind).strip().lower().replace(" ", "-") or "unknown"
