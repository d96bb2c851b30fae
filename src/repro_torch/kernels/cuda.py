"""Build the port's CUDA C++ kernels (`src/repro_torch/csrc/*.cu`) and
load them with ctypes.

Each source becomes its own shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/cuda/lib<stem>_<hash>.so
         csrc/<stem>.cu

at first use on a CUDA tensor, never at import. The ptxas report
(registers and spill bytes per kernel) is kept beside the library and
read by `ptxas_report`. The hash covers the source and the shared
headers, so an edited kernel is rebuilt and an unchanged one is loaded
as it is. A library is written under a
temporary name and moved into place, so concurrent builds cannot leave
a half-written file. `build()` starts one `nvcc` per missing source, all
at once, and waits for them together.

There is no fallback: with no `nvcc`, or a failed build, the call
raises with the compiler's output. A kernel launch that fails returns
its `cudaGetLastError()` code, and `check` raises on it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
from typing import Dict, Iterable

import torch

from . import common

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of csrc/common.cuh
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

P, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
F32 = ctypes.c_float
LLP = ctypes.POINTER(ctypes.c_longlong)
# C entry points per source: name -> argtypes (every pointer and the
# stream as c_void_p, or ctypes would cut them to 32 bits)
ENTRIES = {
    "gemv": {
        "repro_gemv": [INT, P, P, P, P, P, P, I64, P, F32, F32, I64, I64,
                       INT, INT, INT, INT, P],
        "repro_gemvt": [INT, P, P, P, P, P, F32, F32, I64, I64, I64, INT,
                        INT, P],
        "repro_gemvt_acc": [INT, P, P, P, I64, I64, I64, INT, INT, P],
        "repro_capture_state": [P, ctypes.POINTER(ctypes.c_ulonglong)],
        "repro_gemv_smem": [INT, INT, INT, INT, LLP],
        "repro_smem_optin": [INT, ctypes.POINTER(ctypes.c_int)],
    },
    "symv": {
        "repro_symv": [INT, P, P, P, P, P, P, I64, I64, INT, P],
        "repro_symv_acc": [INT, P, P, P, P, I64, I64, INT, P],
        "repro_symv_smem": [INT, INT, LLP],
    },
    "gemm": {
        "repro_gemm": [INT, P, P, P, P, P, P, I64, I64, I64, I64, I64, INT,
                       INT, P],
        "repro_gemm_acc": [INT, P, P, P, I64, I64, I64, I64, I64, INT, INT,
                           P],
        "repro_gemm_smem": [INT, INT, LLP],
        "repro_gemm_wgmma": [INT, P, P, P, P, P, P, I64, I64, I64, I64,
                             I64, I64, INT, P],
        "repro_gemm_wgmma_acc": [INT, P, P, P, I64, I64, I64, I64, I64,
                                 I64, INT, P],
        "repro_gemm_wgmma_smem": [INT, INT, INT, LLP],
    },
    "transpose": {
        "repro_transpose": [INT, P, P, I64, I64, P],
        "repro_transpose_smem": [INT, LLP],
    },
    "ger": {
        "repro_ger": [INT, P, P, P, P, P, I64, I64, P],
        "repro_ger_smem": [INT, INT, LLP],
    },
    "attention": {
        "repro_mha_ffma": [INT, P, P, P, P, *[I64] * 7, *[I64] * 9, INT,
                           I64, F32, P],
        "repro_mha_wgmma": [INT, P, P, P, P, *[I64] * 7, *[I64] * 9, INT,
                            I64, F32, P],
    },
    "decode_attention": {
        "repro_decode_attention_simt": [INT, *[P] * 10, *[I64] * 5,
                                        *[I64] * 6, I64, F32, INT, P],
        "repro_decode_attention_mma": [INT, *[P] * 10, *[I64] * 5,
                                       *[I64] * 6, I64, F32, INT, P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
        "port's CUDA kernels are built from src/repro_torch/csrc at "
        "first use and need the CUDA toolkit")


def library_path(stem: str) -> pathlib.Path:
    """Where the library of `csrc/<stem>.cu` goes, named by the hash of
    the source and the shared headers."""
    h = hashlib.sha256()
    for p in [CSRC / f"{stem}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return common.build_dir() / "cuda" / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build(stems: Iterable[str] = tuple(ENTRIES)) -> None:
    """Compile every source in `stems` whose library is missing, one
    `nvcc` each, all started together."""
    jobs = []
    for stem in stems:
        path = library_path(stem)
        if path.exists():
            continue
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{stem}.cu")]
        jobs.append((stem, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for stem, path, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{stem}.cu "
                          f"(exit {proc.returncode}):\n{out}")
            continue
        report_path(path).write_text(out)
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))


def report_path(library: pathlib.Path) -> pathlib.Path:
    return library.with_name(f"{library.stem}.ptxas.txt")


def ptxas_report(stem: str) -> Dict[str, dict]:
    """Registers and spill bytes of each kernel of `csrc/<stem>.cu`, from
    the `-Xptxas -v` report of its build: {mangled name: {"registers",
    "spill_stores", "spill_loads"}}."""
    return parse_ptxas(report_path(library_path(stem)).read_text())


def parse_ptxas(text: str) -> Dict[str, dict]:
    kernels: Dict[str, dict] = {}
    name = None
    for line in text.splitlines():
        found = re.search(r"Function properties for (\S+)", line)
        if found:
            name = found.group(1)
            kernels[name] = {}
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if found and name:
            kernels[name]["spill_stores"] = int(found.group(1))
            kernels[name]["spill_loads"] = int(found.group(2))
        found = re.search(r"Used (\d+) registers", line)
        if found and name:
            kernels[name]["registers"] = int(found.group(1))
    return kernels


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<stem>.cu`, built if missing."""
    lib = _LIBS.get(stem)
    if lib is None:
        build([stem])
        lib = ctypes.CDLL(str(library_path(stem)))
        for name, argtypes in ENTRIES[stem].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[stem] = lib
    return lib


def dtype_code(t: torch.Tensor) -> int:
    code = DTYPE_CODE.get(t.dtype)
    if code is None:
        raise ValueError(f"the CUDA kernels take float32, bfloat16 or "
                         f"float16, got {t.dtype}")
    return code


def ptr(t) -> int:
    """A tensor's device address for a C argument (0 for None)."""
    return 0 if t is None else t.data_ptr()


def raw_stream(device: torch.device) -> int:
    """The handle of the current stream on `device`: no Stream object
    and no device switch (together about 12 us of host time a call on
    an H100 host)."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def launch(stem: str, entry: str, like: torch.Tensor, *args) -> None:
    """Call the C entry point `entry` of `csrc/<stem>.cu` on the device
    and current stream of `like`, with `like`'s dtype code first and the
    stream last; raise when it reports a CUDA error (a refused launch
    never runs, and a later synchronise would not report it)."""
    fn = getattr(load(stem), entry)
    index = like.device.index
    if index is None or index == torch.cuda.current_device():
        err = fn(dtype_code(like), *args, raw_stream(like.device))
    else:
        with torch.cuda.device(index):
            err = fn(dtype_code(like), *args, raw_stream(like.device))
    check(err, entry)


def smem_bytes(stem: str, entry: str, dtype: torch.dtype, *args) -> int:
    """The shared memory one block of a kernel of `csrc/<stem>.cu`
    requests, as its `repro_<stem>_smem` entry reports it: static bytes
    from cudaFuncGetAttributes plus the dynamic bytes its launch passes
    (`args` pick the kernel and its plan; see each entry's comment). For
    the check of the footprint functions; builds the library if
    missing."""
    found = ctypes.c_longlong(0)
    check(getattr(load(stem), entry)(DTYPE_CODE[dtype], *args,
                                     ctypes.byref(found)), entry)
    return int(found.value)


def smem_optin(device: torch.device) -> int:
    """The card's per-block shared-memory opt-in maximum, as the CUDA
    runtime reports it (cudaDevAttrMaxSharedMemoryPerBlockOptin)."""
    found = ctypes.c_int(0)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    check(load("gemv").repro_smem_optin(index, ctypes.byref(found)),
          "repro_smem_optin")
    return int(found.value)


def capture_id(device: torch.device):
    """The id of the CUDA-graph capture running on the current stream of
    `device`, or None where that stream is not capturing (one runtime
    call, `cudaStreamGetCaptureInfo`)."""
    found = ctypes.c_ulonglong(0)
    state = load("gemv").repro_capture_state(raw_stream(device),
                                             ctypes.byref(found))
    if state < 0:
        raise RuntimeError(f"cudaStreamGetCaptureInfo: CUDA error {-state}")
    if state == 2:
        raise RuntimeError("the current stream's CUDA-graph capture was "
                           "invalidated by an earlier call")
    return found.value if state == 1 else None


def capturing(device: torch.device) -> bool:
    """Whether the current stream of `device` is capturing a CUDA graph
    (or its capture was invalidated). For the current device PyTorch
    answers, so an eager launch builds no library of csrc/."""
    index = device.index
    if index is None or index == torch.cuda.current_device():
        return torch.cuda.is_current_stream_capturing()
    return capture_id(device) is not None


_TICKETS: dict = {}    # (device index, raw stream, count) -> int32 tickets
_CAPTURED: dict = {}   # the same key -> (capture id, int32 tickets)


def tickets(device: torch.device, count: int) -> torch.Tensor:
    """`count` int32 tickets for a launch on the current stream of
    `device` whose last block to finish a group of blocks folds the
    group's partials (csrc/gemv.cu's band fold, kernels/window.py's
    combine): each counter is 0 between launches, since the last block
    resets it. Launches on one stream run in order, so a buffer that
    only one stream's launches use never has two of them counting at
    once. Guaranteed:

    - an eager launch gets its stream's buffer of `count`, allocated and
      zeroed outside any capture at the stream's first such launch and
      never replaced;
    - a launch under CUDA-graph capture gets a buffer of that capture,
      stream and count, allocated from the graph's pool at the capture's
      first such launch on the stream, its zeroing captured with it (so
      every replay starts from zeros) and never used by an eager launch
      or another capture. Two graphs, captured on one stream, replay at
      once on two streams without sharing a counter.

    A graph's own launches on one stream share its buffer in stream
    order, and CUDA runs one graph's replays one after another."""
    key = (device.index, raw_stream(device), count)
    if capturing(device):
        capture = capture_id(device)
        found = _CAPTURED.get(key)
        if found is None or found[0] != capture:
            found = (capture, _zeroed(device, count))
            _CAPTURED[key] = found
        return found[1]
    found = _TICKETS.get(key)
    if found is None:
        found = _zeroed(device, count)
        _TICKETS[key] = found
    return found


def _zeroed(device: torch.device, count: int) -> torch.Tensor:
    return torch.zeros(count, dtype=torch.int32, device=device)


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
