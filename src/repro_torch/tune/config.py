"""Tile configurations, shape buckets, and sweep candidate sets.

The port's own copy of the reference package's tuning vocabulary. A
`TileConfig` keeps the reference's four fields and file format; a
`TilePlan` maps emission *sites* (fusion-group index, or
`g{i}:{routine}` for standalone nodes) and *shape buckets* to configs.
What each field drives is the Hopper kernel's own knob (each kernel
module's `*_knobs` function maps a config onto its plan):

* `l1` (the standalone level-1 kernels and the generated level-1
  groups, `kernels/window.py`): `block_rows` -> the elements of one
  step of a program's walk (default 4096);
* `gemv`, gemv-anchored group (`kernels/anchored.py`): `block_m`,
  `block_n` -> rows per program, columns per step (default 32, 128);
* `gemv`, standalone gemv (`gemv.gemv_plan`): `block_m` -> a band's
  rows (at most 32), `block_n` -> the columns of a chunk; either one
  takes the band kernel (default: one warp per row where the rows fill
  the card, else bands of at most 32 rows);
* `gemv`, gemvt and the gemvt anchor (`gemv.gemvt_plan`): `block_m` ->
  the rows of a split, from which the cluster follows (default: the
  cluster from the card's SMs);
* `symv`, symv and the symv anchor (`symv.symv_plan`): `block_m` -> a
  chunk's rows, in whole 64-row tiles (default nt(nt+1)/2/4096 tiles);
* `gemm`, gemm and the tiled group's product (`gemm.gemm_plan`):
  `block_n` -> the tile width (32, 64 or 128), `block_k` -> the K of a
  split; `block_m` is BM = 128, fixed (default: the width after n, K
  split only where the tiles leave most SMs idle). On the 16-bit wgmma
  route the same knobs are mapped, not refused: `block_n` -> the
  narrowest of its widths (64, 128) that holds the FFMA width,
  `block_k` -> the K of a split in whole 64-deep stages; its BM (64
  where m <= 64, else 128) follows m (default: K split where the tiles
  leave any SM idle).

Left unswept, as compile-time constants of a CUDA source: gemv's and
gemvt's ring depths, symv's 64-row tile and ring, gemm's BM, ring and
warp roles.

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

# Per site family, the values each family's knobs accept (powers of
# two; gemm's widths). The sweep clamps a candidate to the operand dims
# (`clamp`) and then to the plan its site's kernel takes, timing each
# distinct plan once, and drops one whose footprint is over the
# shared-memory budget (the static analyzer's RV401) before launching
# it. Each set holds its family's default values: l1 4096, the gemv
# anchor's (32, 128), symv's 512 rows at n = 16384, gemm's width 32 and
# unsplit K at block-CG's shape. (32, 16384) gives standalone gemv one
# chunk a band, the only band plan whose fold needs no tickets where the
# bands outnumber them (16384 rows: 512 bands).
_L1_ROWS = (1024, 2048, 4096, 8192, 16384)
_GEMV = ((32, 128), (16, 128), (64, 64), (32, 256), (16, 512),
         (8, 1024), (32, 16384), (4096, 128), (16384, 128))
_SYMV = (128, 256, 512, 1024, 2048)
_GEMM = ((128, 32, 16384), (128, 32, 4096), (128, 32, 2048),
         (128, 64, 16384), (128, 128, 16384), (128, 128, 4096))


def candidates_for(family: str) -> Tuple[TileConfig, ...]:
    """Sweep candidates for one site family, with the reference's
    fields: 'symv' (block_m = block_n), 'gemv' (block_m, block_n),
    'gemm' (adds block_k), 'l1' (block_rows)."""
    if family == "symv":
        return tuple(TileConfig(block_m=b, block_n=b) for b in _SYMV)
    if family == "gemv":
        return tuple(TileConfig(block_m=m, block_n=n) for m, n in _GEMV)
    if family == "gemm":
        return tuple(TileConfig(block_m=m, block_n=n, block_k=k)
                     for m, n, k in _GEMM)
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
