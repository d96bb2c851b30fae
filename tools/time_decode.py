#!/usr/bin/env python3
"""Time the public decode_attention entry point
(`repro_torch.kernels.ops.decode_attention`) of whichever tree of the
port is on PYTHONPATH at the serve path's decode steps, bfloat16, over
the cache views the models pass: h2o-danube-3-4b's ring (B 8, 32 query
heads on 8, W 4096 slots, D 120) with every slot valid, with the
lengths short of W that `chip_smoke.py`'s phase 2f uses, and with every
slot valid and `return_lse=True`; llama3-8b's step (B 8, 32 on 8, a
cache of 1813, length 1797, D 128), hymba-1.5b's ring (B 8, 25 on 5,
W 1024, D 64) and musicgen-medium's step (B 8, 24 heads, a cache of
1717, D 64), each with every slot valid, beside them. Card only; it
measures, and checks nothing.

    PYTHONPATH=src python3 tools/time_decode.py [label]

One JSON line per case: the route the tree takes, `ms` (20 calls
between CUDA events, after warm-up calls for at least half a second, so
that the card's clock has settled whatever ran before), `graph_ms` (20
calls captured in a CUDA graph, replayed 3 times), `host_ms` (the
host's time to issue one call, 5 back to back), or null with the error
where the tree refuses the operands; the same two times of one
F.scaled_dot_product_attention call over the view (a boolean key mask
where lengths fall short; none beside the lse case, which no one call
returns); and the bound, the valid K and V rows, q, the output (and the
lse) moved once at 3.35 TB/s. Then the card's name and power limit. To
compare two trees, run each in turns in one call (parent, change,
change, parent).
"""
import json
import pathlib
import subprocess
import sys

import torch
import torch.nn.functional as F

from repro_torch.kernels import decode_attention as k_dec, ops
from time_mha import event_ms

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import graph_ms, host_call_ms  # noqa: E402

HBM_BYTES_PER_S = 3.35e12

# (name, B, Hq, Hkv, slots, D, lengths: "full", "short" or an int, lse)
CASES = [("h2o-danube-3-4b ring, full", 8, 32, 8, 4096, 120, "full", False),
         ("h2o-danube-3-4b ring, short", 8, 32, 8, 4096, 120, "short",
          False),
         ("h2o-danube-3-4b ring, full, lse", 8, 32, 8, 4096, 120, "full",
          True),
         ("llama3-8b step", 8, 32, 8, 1813, 128, 1797, False),
         ("hymba-1.5b ring, full", 8, 25, 5, 1024, 64, "full", False),
         ("musicgen-medium step, full", 8, 24, 24, 1717, 64, "full",
          False)]


def times(fn):
    """{"ms", "graph_ms", "host_ms"} of fn, or nulls and the error."""
    try:
        return {"ms": event_ms(fn), "graph_ms": graph_ms(fn),
                "host_ms": host_call_ms(fn)}
    except (ValueError, RuntimeError) as exc:
        return {"ms": None, "graph_ms": None, "host_ms": None,
                "error": str(exc).splitlines()[0][:200]}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    label = sys.argv[1] if len(sys.argv) > 1 else None
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    for name, b, hq, hkv, slots, d, fill, lse in CASES:
        q = randn(b, hq, d)
        k, v = (randn(b, slots, hkv, d).permute(0, 2, 1, 3)
                for _ in range(2))
        if fill == "full":
            lens = torch.full((b,), slots, dtype=torch.int32, device="cuda")
        elif fill == "short":
            lens = torch.tensor([(i * 997) % slots + 1 for i in range(b)],
                                dtype=torch.int32, device="cuda")
        else:
            lens = torch.full((b,), fill, dtype=torch.int32, device="cuda")
        keys = int(lens.sum())
        nbytes = (2 * 2 * keys * hkv * d + 2 * 2 * b * hq * d
                  + (4 * b * hq if lse else 0))
        row = {"label": label, "case": name,
               "shape": [b, hq, hkv, slots, d], "return_lse": lse,
               "route": k_dec.decode_route(q, k, v),
               **times(lambda: ops.decode_attention(q, k, v, lens,
                                                    return_lse=lse)),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        if not lse:
            mask = (None if bool((lens == slots).all()) else
                    (torch.arange(slots, device="cuda")[None]
                     < lens[:, None])[:, None, None])
            lib = times(lambda: F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=mask, enable_gqa=True))
            row["library_ms"] = lib.pop("ms")
            row["library_graph_ms"] = lib.pop("graph_ms")
            row["library_host_ms"] = lib.pop("host_ms")
            row.update({f"library_{key}": val for key, val in lib.items()})
        print(json.dumps(row), flush=True)
        del q, k, v
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
