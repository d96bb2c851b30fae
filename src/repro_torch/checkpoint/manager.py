"""Fault-tolerant checkpointing, the port of `repro/checkpoint/manager.py`,
with its on-disk format:

- step-atomic: a step is written to `step_XXXXXXXXXX.tmp/`, one `.npy`
  file per array with its CRC32 in `manifest.json`, then published by
  an atomic rename; a crash mid-write never corrupts the last good step;
- async: the tree is copied to the host on the caller's thread (so the
  caller may go on writing its tensors in place), then written on a
  background thread; a save re-raises the previous save's error, so a
  failure is never silent;
- restore picks the newest step whose manifest and CRCs verify, so a
  torn step is skipped; `keep_last` steps are kept;
- arrays are stored whole, and `restore(step, like, device=)` places
  them on any device (the reference's `shardings=` re-mesh).

A tree is nested dicts, lists and tuples of torch tensors, numpy arrays
or Python numbers, flattened to "/"-joined keys (dict keys sorted, as
jax flattens them). numpy has no bfloat16: a bfloat16 tensor is stored
as its raw 16 bits (int16) with "dtype": "bfloat16" in the manifest, and
restored bitwise.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

_SEP = "/"
BF16 = "bfloat16"


def _flatten(tree, prefix: str = ""):
    """{key path: leaf} in jax's leaf order."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), t) for i, t in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, t in items:
        out.update(_flatten(t, f"{prefix}{_SEP}{k}" if prefix else k))
    return out


def _unflatten(like, leaves, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves,
                              f"{prefix}{_SEP}{k}" if prefix else str(k))
                for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(t, leaves, f"{prefix}{_SEP}{i}"
                                     if prefix else str(i))
                          for i, t in enumerate(like))
    return leaves[prefix]


def _to_host(leaf):
    """A host copy of a leaf: (numpy array to write, manifest dtype)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        return t.numpy(), str(t.numpy().dtype)
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _from_host(arr, dtype: str, device):
    t = torch.from_numpy(np.asarray(arr, order="C"))
    if dtype == BF16:
        t = t.view(torch.bfloat16)
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory, keep_last: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save -----------------------------------------------------------

    def save(self, step: int, tree: Any, *, blocking: bool = False):
        """Snapshot to the host, then write asynchronously. Raises any
        error of the PREVIOUS async save (so failures are never silent)."""
        self.wait()
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}

        def work():
            try:
                self._write(step, host)
            except Exception as e:  # noqa: BLE001 (re-raised by wait())
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host):
        tmp = self.dir / f"step_{step:010d}.tmp"
        final = self.dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        manifest = {"step": step, "arrays": {}}
        for i, (key, (arr, dtype)) in enumerate(sorted(host.items())):
            fname = f"arr_{i:05d}.npy"
            # asarray, not ascontiguousarray: that would make a 0-d array
            # (the step) 1-d, as the reference's files have it
            np.save(tmp / fname, np.asarray(arr, order="C"))
            crc = zlib.crc32((tmp / fname).read_bytes())
            manifest["arrays"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype,
                "crc32": crc}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)          # atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # -- restore ----------------------------------------------------------

    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp":
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def _verify(self, step: int) -> bool:
        d = self.dir / f"step_{step:010d}"
        mf = d / "manifest.json"
        if not mf.exists():
            return False
        manifest = json.loads(mf.read_text())
        for meta in manifest["arrays"].values():
            f = d / meta["file"]
            if not f.exists():
                return False
            if zlib.crc32(f.read_bytes()) != meta["crc32"]:
                return False
        return True

    def latest_valid_step(self) -> Optional[int]:
        for s in reversed(self.all_steps()):
            if self._verify(s):
                return s
        return None

    def restore(self, step: int, like: Any, *, device=None):
        """Restore into the structure of `like` (its values ignored), as
        torch tensors in the stored dtypes: on `device` when given, else
        on each `like` leaf's device where it is a tensor, else the
        host."""
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat_like = _flatten(like)
        missing = set(flat_like) - set(manifest["arrays"])
        if missing:
            raise ValueError(f"checkpoint missing arrays: {missing}")
        leaves = {}
        for key, like_leaf in flat_like.items():
            meta = manifest["arrays"][key]
            dev = device if device is not None else (
                like_leaf.device if torch.is_tensor(like_leaf) else "cpu")
            leaves[key] = _from_host(np.load(d / meta["file"]),
                                     meta["dtype"], dev)
        return _unflatten(like, leaves)

    def restore_latest(self, like, *, device=None):
        step = self.latest_valid_step()
        if step is None:
            return None, None
        return step, self.restore(step, like, device=device)
