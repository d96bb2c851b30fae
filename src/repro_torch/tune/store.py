"""The persistent tuning table + compiled-artifact store of the port.

One JSON document under `~/.cache/repro_torch/` (override with
`REPRO_TORCH_CACHE_DIR`), apart from the reference package's
`~/.cache/repro/`, written atomically (tmp + `os.replace`) with a
versioned schema, holding two keyed sections:

* **entries** — tuning measurements keyed by
  `pattern|bucket|mode|fuse|anchor|device_kind`, where `pattern` is a
  routine name (`gemv`) or a fused-group shape (`symv+dot`). Each
  entry records the winning `TileConfig`, its measured wall clock, and
  the default config's wall clock.
* **artifacts** — the persistent compiled-artifact cache keyed by
  `spec digest|mode|fuse|anchor|device_kind`: the canonical spec JSON
  plus the resolved `TilePlan`, so a fleet of serving processes tunes
  and resolves each program once. A lookup fires the `tune.cache.hit`
  obs counter (miss: `tune.cache.miss`). `core.lowering` reads the
  artifact first when it resolves `tiles="auto"`; the autotuner
  (`tune.autotuner`) writes the entries and tuned artifacts.

The store is loaded once per process (`get_store()`); `generation`
bumps on every mutation so a resolution memo can invalidate itself. A
file with an unknown schema version is ignored, not deleted —
forward-compatible readers start from an empty table. A
file that no longer parses (crashed writer, disk fault) is
quarantined to `<name>.corrupt` and the table rebuilds from empty;
transient read errors get one retry before giving up.
"""
from __future__ import annotations

import json
import os
import pathlib
import tempfile
import time
from typing import Dict, Mapping, Optional

from repro_torch import obs

from .config import TileConfig, TilePlan

SCHEMA = "repro_torch.tune/v1"
SCHEMA_VERSION = 1
TABLE_FILENAME = "tuning_table.json"
ENV_CACHE_DIR = "REPRO_TORCH_CACHE_DIR"
MAX_ARTIFACTS = 256


def cache_dir() -> pathlib.Path:
    root = os.environ.get(ENV_CACHE_DIR)
    if root:
        return pathlib.Path(root).expanduser()
    return pathlib.Path("~/.cache/repro_torch").expanduser()


def _empty_doc() -> dict:
    return {"schema": SCHEMA, "version": SCHEMA_VERSION, "seq": 0,
            "entries": {}, "artifacts": {}}


def _flag(v) -> str:
    return "1" if v else "0"


def entry_key(pattern: str, bucket: str, mode: str, fuse, anchor,
              device_kind: str) -> str:
    return (f"{pattern}|{bucket}|{mode}|fuse={_flag(fuse)}|"
            f"anchor={_flag(anchor)}|{device_kind}")


def artifact_key(digest: str, mode: str, fuse, anchor,
                 device_kind: str) -> str:
    return (f"{digest}|{mode}|fuse={_flag(fuse)}|"
            f"anchor={_flag(anchor)}|{device_kind}")


def validate_doc(doc) -> list:
    """Schema validation (the CI tune-smoke gate). Returns a list of
    problems; empty means the document is a well-formed v1 table."""
    bad = []
    if not isinstance(doc, Mapping):
        return [f"table must be a JSON object, got {type(doc).__name__}"]
    if doc.get("schema") != SCHEMA:
        bad.append(f"schema is {doc.get('schema')!r}, want {SCHEMA!r}")
    if doc.get("version") != SCHEMA_VERSION:
        bad.append(f"version is {doc.get('version')!r}, "
                   f"want {SCHEMA_VERSION}")
    for section, required in (("entries", ("tiles", "us", "default_us")),
                              ("artifacts", ("spec", "plan"))):
        recs = doc.get(section)
        if not isinstance(recs, Mapping):
            bad.append(f"{section!r} section missing or not an object")
            continue
        for key, rec in recs.items():
            if key.count("|") != (5 if section == "entries" else 4):
                bad.append(f"{section}[{key!r}]: malformed key")
            if not isinstance(rec, Mapping):
                bad.append(f"{section}[{key!r}]: record not an object")
                continue
            for field in required:
                if field not in rec:
                    bad.append(f"{section}[{key!r}]: missing {field!r}")
            try:
                if section == "entries" and "tiles" in rec:
                    TileConfig.from_json(rec["tiles"])
                if section == "artifacts" and "plan" in rec:
                    TilePlan.from_json(rec["plan"])
            except (ValueError, TypeError, AttributeError) as e:
                bad.append(f"{section}[{key!r}]: bad tile config: {e}")
    return bad


class TuningTable:
    """In-memory view of one on-disk table. Mutations bump
    `generation` and write through (`save()`), merging over whatever
    is on disk so concurrent processes lose at most a race, not each
    other's sections."""

    def __init__(self, path: Optional[pathlib.Path] = None):
        self.path = pathlib.Path(path) if path else \
            cache_dir() / TABLE_FILENAME
        self.generation = 0
        self.doc = _empty_doc()
        self.reload()

    # -- persistence ---------------------------------------------------

    def reload(self) -> None:
        self.doc = self._read(self.path)
        self.generation += 1

    @staticmethod
    def _read(path: pathlib.Path) -> dict:
        data = None
        for attempt in (0, 1):
            try:
                data = path.read_bytes()
                break
            except FileNotFoundError:
                return _empty_doc()
            except OSError as e:
                # transient I/O (NFS hiccup, EINTR): one retry, then
                # start from an empty table rather than crash a compile
                if attempt:
                    obs.event("tune.store.read_failed",
                              path=str(path), error=str(e))
                    return _empty_doc()
                time.sleep(0.05)
        try:
            doc = json.loads(data.decode("utf-8"))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            # corrupt/truncated table (crashed writer, disk fault):
            # quarantine the evidence and rebuild from empty — the
            # next save() writes a fresh well-formed document
            quarantine = path.with_name(path.name + ".corrupt")
            try:
                os.replace(path, quarantine)
            except OSError:
                quarantine = None
            obs.event("tune.store.quarantined", path=str(path),
                      quarantine=(str(quarantine)
                                  if quarantine else None),
                      error=str(e))
            obs.counter("tune.store.corrupt")
            return _empty_doc()
        if not isinstance(doc, Mapping) or \
                doc.get("version") != SCHEMA_VERSION:
            obs.event("tune.store.ignored", path=str(path),
                      version=doc.get("version")
                      if isinstance(doc, Mapping) else None)
            return _empty_doc()
        doc = dict(doc)
        doc.setdefault("seq", 0)
        doc.setdefault("entries", {})
        doc.setdefault("artifacts", {})
        return doc

    def save(self) -> None:
        on_disk = self._read(self.path)
        merged = dict(on_disk)
        merged["schema"], merged["version"] = SCHEMA, SCHEMA_VERSION
        merged["seq"] = max(on_disk.get("seq", 0),
                            self.doc.get("seq", 0))
        merged["entries"] = {**on_disk.get("entries", {}),
                             **self.doc["entries"]}
        merged["artifacts"] = {**on_disk.get("artifacts", {}),
                               **self.doc["artifacts"]}
        arts = merged["artifacts"]
        if len(arts) > MAX_ARTIFACTS:
            keep = sorted(arts, key=lambda k: arts[k].get("seq", 0),
                          reverse=True)[:MAX_ARTIFACTS]
            merged["artifacts"] = {k: arts[k] for k in keep}
        self.doc = merged
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                   prefix=self.path.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(merged, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- entries (tuning measurements) ---------------------------------

    def record_entry(self, pattern: str, bucket: str, mode: str, fuse,
                     anchor, device_kind: str, *, tiles: TileConfig,
                     us: float, default_us: float,
                     sweeps: int = 0) -> None:
        key = entry_key(pattern, bucket, mode, fuse, anchor,
                        device_kind)
        self.doc["seq"] += 1
        self.doc["entries"][key] = {
            "tiles": tiles.to_json(), "us": float(us),
            "default_us": float(default_us), "sweeps": int(sweeps),
            "seq": self.doc["seq"],
        }
        self.generation += 1
        self.save()

    def entries_for(self, pattern: str, mode: str, fuse, anchor,
                    device_kind: str) -> Dict[str, TileConfig]:
        """All tuned buckets for one pattern/configuration: the
        {bucket: TileConfig} map a resolved TilePlan site adopts."""
        prefix = f"{pattern}|"
        suffix = (f"|{mode}|fuse={_flag(fuse)}|anchor={_flag(anchor)}|"
                  f"{device_kind}")
        out = {}
        for key, rec in self.doc["entries"].items():
            if not (key.startswith(prefix) and key.endswith(suffix)):
                continue
            bucket = key[len(prefix):-len(suffix)]
            if "|" in bucket:
                continue
            try:
                out[bucket] = TileConfig.from_json(rec["tiles"])
            except (ValueError, TypeError, KeyError):
                continue
        return out

    # -- artifacts (persistent compiled-spec cache) --------------------

    def put_artifact(self, digest: str, mode: str, fuse, anchor,
                     device_kind: str, *, spec: Mapping,
                     plan: TilePlan, tuned: bool = False) -> None:
        key = artifact_key(digest, mode, fuse, anchor, device_kind)
        prev = self.doc["artifacts"].get(key)
        plan_dict = plan.to_dict()
        if prev is not None:
            # merge per site+bucket over the stored plan: a tune at
            # one shape bucket must not erase another bucket's winner
            merged = {s: dict(b) for s, b in
                      (prev.get("plan") or {}).items()
                      if isinstance(b, Mapping)}
            for site, buckets in plan_dict.items():
                merged.setdefault(site, {}).update(buckets)
            plan_dict = merged
            tuned = bool(tuned) or bool(prev.get("tuned", False))
        record = {"spec": spec, "plan": plan_dict,
                  "tuned": bool(tuned)}
        if prev is not None and \
                all(prev.get(k) == v for k, v in record.items()):
            return                      # identical: no churn, no bump
        self.doc["seq"] += 1
        self.doc["artifacts"][key] = dict(record, seq=self.doc["seq"])
        self.generation += 1
        self.save()

    def artifact_plan(self, digest: str, mode: str, fuse, anchor,
                      device_kind: str) -> Optional[TilePlan]:
        """Digest-keyed artifact lookup; the `tune.cache.hit`/`miss`
        obs counters fire here — the across-process acceptance signal
        that a compile consulted the persisted store."""
        rec = self.doc["artifacts"].get(
            artifact_key(digest, mode, fuse, anchor, device_kind))
        if rec is None:
            obs.counter("tune.cache.miss", digest=digest[:12],
                        mode=mode, device=device_kind)
            return None
        obs.counter("tune.cache.hit", digest=digest[:12], mode=mode,
                    device=device_kind,
                    tuned=bool(rec.get("tuned", False)))
        try:
            return TilePlan.from_json(rec.get("plan", {}))
        except (ValueError, TypeError, AttributeError):
            return None

    def artifact_spec(self, digest: str, mode: str, fuse, anchor,
                      device_kind: str) -> Optional[Mapping]:
        rec = self.doc["artifacts"].get(
            artifact_key(digest, mode, fuse, anchor, device_kind))
        return None if rec is None else rec.get("spec")

    def validate(self) -> list:
        return validate_doc(self.doc)


_STORE: Optional[TuningTable] = None


def get_store() -> TuningTable:
    """The process-wide table (path fixed by REPRO_TORCH_CACHE_DIR at
    first use; `reset_store()` re-reads the environment — tests monkeypatch
    the env var and call it)."""
    global _STORE
    if _STORE is None:
        _STORE = TuningTable()
    return _STORE


def reset_store() -> None:
    global _STORE
    _STORE = None
