"""Shared helpers for the port's kernels: device resolution, operand
checks, launch counters, and loading generated Triton sources.

`default_interpret()` in the reference picked Pallas interpret mode off
the TPU. Its counterpart here is `resolve_device`: entry points run on
the CUDA card unless the caller asks for the CPU, and a kernel wrapper
follows the device of the tensors it is given (kernel on CUDA, plain
PyTorch version on CPU). There is no fallback from one to the other.

Block sizes are the port's own. The reference walks (block_rows, 128)
windows because the TPU vector unit works on (8, 128) tiles; that
geometry does not carry over to Hopper, whose kernels here walk flat
1-D blocks (`window.BLOCK`). The spec's `window_size` and
`vector_width` are still parsed and validated exactly as before, but
they do not set the port's block sizes.
"""
from __future__ import annotations

import hashlib
import importlib.util
import os
import pathlib
import sys
from numbers import Number
from typing import Optional, Sequence

import torch

INT32_MAX = 2 ** 31 - 1


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU. Raises when no card is present and none was named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def on_card(*tensors: torch.Tensor) -> bool:
    """True when the operands lie on a CUDA device (the kernel runs),
    False when they lie on the CPU (the plain version runs)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands lie on different devices: "
                         f"{sorted(str(d) for d in devices)}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")


def check_vectors(*vectors: torch.Tensor, same_dtype: bool = True) -> int:
    """Validate 1-D operands of one level-1 call; returns their length.

    The tail is masked inside the kernels, so any length from 1 up to
    the int32 index range is accepted."""
    for v in vectors:
        if not torch.is_tensor(v) or v.ndim != 1:
            raise ValueError(
                f"expected 1-D tensors, got "
                f"{getattr(v, 'shape', type(v).__name__)}")
    n = vectors[0].shape[0]
    for v in vectors[1:]:
        if v.shape[0] != n:
            raise ValueError(f"vector lengths disagree: {n} vs "
                             f"{v.shape[0]}")
        if same_dtype and v.dtype != vectors[0].dtype:
            raise ValueError(f"vector dtypes disagree: "
                             f"{vectors[0].dtype} vs {v.dtype}")
    if not 1 <= n <= INT32_MAX:
        raise ValueError(f"vector length {n} outside [1, 2**31 - 1]")
    return n


def scalar_block(values: Sequence, device: torch.device,
                 round_to: Optional[torch.dtype] = None) -> torch.Tensor:
    """The scalar operands of one launch as a (len(values),) float32
    tensor on `device`. `round_to` first rounds each value to that dtype:
    the reference casts an element-wise kernel's scalars to the vector's
    dtype (`repro/kernels/axpy.py:66`)."""
    rounding = round_to is not None and round_to != torch.float32
    t = torch.tensor([float(v) if isinstance(v, Number) else 0.0
                      for v in values], dtype=torch.float32)
    if rounding:
        t = t.to(round_to).float()
    if device.type != "cpu":
        # pinned + non_blocking: the upload queues behind earlier work on
        # the stream instead of making the host wait for it
        t = t.pin_memory().to(device, non_blocking=True)
    for i, v in enumerate(values):
        if not isinstance(v, Number):   # a tensor: copied on the device
            s = torch.as_tensor(v, dtype=torch.float32,
                                device=device).reshape(())
            t[i] = s.to(round_to).float() if rounding else s
    return t


def counted(fn):
    """Give a kernel wrapper its integer counters: `launches` (main
    kernel launches on the card), `finish_launches` (the fixed-order
    combine of a reduction's per-block partials) and `plain_calls`
    (plain-version runs on CPU tensors)."""
    fn.launches = 0
    fn.finish_launches = 0
    fn.plain_calls = 0
    return fn


def reset_counts(*wrappers) -> None:
    for w in wrappers:
        w.launches = w.finish_launches = w.plain_calls = 0


# ---------------------------------------------------------------------------
# Generated Triton sources
# ---------------------------------------------------------------------------


def build_dir() -> pathlib.Path:
    """Where generated kernel sources and Triton's cache go: `build/` at
    the checkout's root (listed in .gitignore), or $REPRO_TORCH_BUILD."""
    root = os.environ.get("REPRO_TORCH_BUILD")
    if root:
        return pathlib.Path(root)
    return pathlib.Path(__file__).resolve().parents[3] / "build"


def load_source(stem: str, source: str):
    """Write a kernel's Triton source to the build directory and import
    it. Triton's JIT reads a kernel's source text, so every kernel is a
    real file, named by its content."""
    key = f"{stem}_{hashlib.sha256(source.encode()).hexdigest()[:16]}"
    root = build_dir()
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "triton_cache"))
    os.environ.setdefault("TRITON_HOME", str(root))
    path = root / "kernels" / f"{key}.py"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{key}.{os.getpid()}.tmp")
        tmp.write_text(source)
        os.replace(tmp, path)
    spec = importlib.util.spec_from_file_location(
        f"repro_torch_build_{key}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod
