"""`python -m repro_torch.obs` — inspect exported JSONL observability files.

    python -m repro_torch.obs summarize trace.jsonl
        aggregate spans (count/total/mean/max), counters, events

    python -m repro_torch.obs trace trace.jsonl [--kind span] [--limit N]
        chronological record listing, spans indented by nesting path

    python -m repro_torch.obs diff a.jsonl b.jsonl
        compare two files: span means with B/A ratios, counter deltas
"""
from __future__ import annotations

import argparse
import sys

from .report import (diff_summaries, format_summary, load_jsonl,
                     summarize_records)


def _fmt_attrs(attrs: dict) -> str:
    if not attrs:
        return ""
    return " " + " ".join(f"{k}={v}" for k, v in attrs.items())


def cmd_summarize(args) -> int:
    recs = load_jsonl(args.file)
    print(f"# {args.file}: {len(recs)} records")
    print(format_summary(summarize_records(recs)))
    return 0


def cmd_trace(args) -> int:
    recs = load_jsonl(args.file)
    if args.kind:
        recs = [r for r in recs if r.get("kind") == args.kind]
    shown = recs if args.limit is None else recs[:args.limit]
    for r in shown:
        kind = r.get("kind", "?")
        name = r.get("name", "?")
        attrs = _fmt_attrs(r.get("attrs", {}))
        if kind == "span":
            depth = max(0, r.get("path", name).count("/"))
            print(f"{r.get('t', 0.0):>10.6f}s {'  ' * depth}"
                  f"[span] {name} {1e3 * r.get('dur_s', 0.0):.3f}ms"
                  f"{attrs}")
        elif kind == "counter":
            print(f"{'':>11} [ctr ] {name} +{r.get('n', 1)}{attrs}")
        else:
            print(f"{r.get('t', 0.0):>10.6f}s [evt ] {name}{attrs}")
    if len(shown) < len(recs):
        print(f"... {len(recs) - len(shown)} more "
              f"(raise --limit)")
    return 0


def cmd_diff(args) -> int:
    a = summarize_records(load_jsonl(args.a))
    b = summarize_records(load_jsonl(args.b))
    print(f"# A = {args.a}\n# B = {args.b}")
    print(diff_summaries(a, b))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Inspect repro_torch.obs JSONL exports.")
    sub = ap.add_subparsers(dest="cmd")

    p = sub.add_parser("summarize",
                       help="aggregate spans/counters/events")
    p.add_argument("file")
    p.set_defaults(fn=cmd_summarize)

    p = sub.add_parser("trace", help="chronological record listing")
    p.add_argument("file")
    p.add_argument("--kind", choices=("span", "counter", "event"))
    p.add_argument("--limit", type=int, default=200,
                   help="max records to print (default 200)")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser("diff", help="compare two JSONL files")
    p.add_argument("a")
    p.add_argument("b")
    p.set_defaults(fn=cmd_diff)

    args = ap.parse_args(argv)
    if not getattr(args, "fn", None):
        ap.print_help()
        return 0
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
